"""Multi-process initialisation: the counterpart of
qaray_tpu/parallel/distributed.py on torch.distributed.

The reference spreads tiles over MPI ranks (Renderer_MPI.cpp:35-53); the
JAX package runs one process a host under jax.distributed. Here each
process is a rank of a torch.distributed group and owns one device: card
(LOCAL_RANK or rank) % device_count, or the CPU. Every rank loads the
whole scene and renders its contiguous share of each dispatch's lanes
(parallel/mesh.py), and the shares are gathered so that every rank holds
the whole result, as after JAX's process_allgather.

    from qaray_tpu_torch.parallel.distributed import init_distributed
    init_distributed("localhost:29500", 2, rank)   # or from the environment
    # ... Renderer(RendererParam(num_devices=world), device=local_device())

Backend: the group is created with gloo, and every rank's (host, device)
is exchanged once. Where every rank owns a distinct card, the collectives
then run on an NCCL group; otherwise (the CPU, or several ranks sharing a
card, which NCCL refuses) they stay on gloo, with the tensors copied to
the host.
"""

from __future__ import annotations

import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

# Set by init_distributed: this rank's device, every rank's device in rank
# order, and the group the collectives run on (None: the default gloo
# group).
_local = None
_rank_devices = None
_group = None
_backend = None


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device="cuda"):
    """torch.distributed.init_process_group, then the backend choice.

    With arguments the group meets at tcp://coordinator_address; without,
    it reads MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE (env://), the
    counterpart of JAX's discovery from the environment. device "cuda"
    gives this rank card (LOCAL_RANK or rank) % device_count; "cpu" keeps
    it on the host. Returns (rank, world size)."""
    global _local, _rank_devices, _group, _backend
    if coordinator_address is not None:
        dist.init_process_group("gloo",
                                init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    else:
        dist.init_process_group("gloo", init_method="env://")
    rank, world = dist.get_rank(), dist.get_world_size()
    if torch.device(device).type == "cuda":
        index = int(os.environ.get("LOCAL_RANK", rank))
        _local = torch.device("cuda", index % torch.cuda.device_count())
        torch.cuda.set_device(_local)
    else:
        _local = torch.device("cpu")
    seen = [None] * world
    dist.all_gather_object(seen, (socket.gethostname(), str(_local)))
    _rank_devices = [torch.device(d) for _, d in seen]
    # Decided from what every rank sees, so that all of them agree.
    on_cards = all(d.type == "cuda" for d in _rank_devices)
    if on_cards and len(set(seen)) == world and dist.is_nccl_available():
        _group = dist.new_group(backend="nccl")
        _backend = "nccl"
    else:
        _group = None
        _backend = "gloo"
    return rank, world


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """Rank-0 check (the reference's `mpiRank == 0` gating for IO)."""
    return process_index() == 0


def local_device() -> Optional[torch.device]:
    """This rank's device (None before init_distributed)."""
    return _local


def rank_devices():
    """Every rank's device, in rank order (None before init_distributed)."""
    return _rank_devices


def backend() -> Optional[str]:
    """'nccl' or 'gloo': where the collectives run (None before init)."""
    return _backend


def group():
    """The process group of the collectives (None: the default group)."""
    return _group


def shutdown():
    """Leave the group (every rank calls it at the end of a run)."""
    global _local, _rank_devices, _group, _backend
    if dist.is_initialized():
        dist.destroy_process_group()
    _local = _rank_devices = _group = _backend = None
