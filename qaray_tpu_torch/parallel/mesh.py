"""Device-mesh sharding of the render: the counterpart of
qaray_tpu/parallel/mesh.py.

The reference distributes tiles round-robin over MPI ranks and gathers
their buffers to rank 0 (Renderer_MPI.cpp:103-207); the JAX package shards
the lane axis of a dispatch over a 1-D mesh of chips and lets XLA gather
the outputs. Here the mesh is a list of devices in rank-major order, each
owned by one process; a dispatch's lanes split into contiguous shards in
mesh order, each process renders its shards with engine.render_batch on
its replica of the scene, and the outputs come back in the original lane
order: torch.cat within a process, all_gather across processes. Every
rank then holds the whole dispatch's result, as after JAX's
process_allgather, which the Renderer's fold expects (the Welford fold is
order-sensitive).

The JAX Renderer pads a dispatch to a power-of-two bucket and its mesh
splits the padded axis evenly; the port does not pad, and splits the n
lanes into shards of ceil(n / k), the last ones shorter, which is how the
JAX mesh splits an axis padded to a multiple of k.

A mesh may name one device several times (["cpu"] * 4, ["cuda:0"] * 2):
the stand-in for JAX's forced host device count, so that the split and the
gather run on the CPU and on one card.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.distributed as dist

from qaray_tpu_torch.integrators.engine import render_batch
from qaray_tpu_torch.parallel import distributed
from qaray_tpu_torch.utils.timing import span

# Collectives of shard_render_batch in this process: the all_gathers and
# the host seconds blocked in them (the spans mesh.all_gather).
stats = {"all_gathers": 0, "all_gather_s": 0.0}


class MeshDevice(NamedTuple):
    """A device of the mesh and the rank of the process that owns it."""

    rank: int
    device: torch.device


class RenderMesh:
    """1-D mesh over devices in rank-major order; its one axis shards the
    lanes of a dispatch."""

    def __init__(self, devices):
        self.devices = list(devices)
        ranks = [d.rank for d in self.devices]
        if ranks != sorted(ranks):
            raise ValueError(f"mesh devices must be rank-major: {ranks}")
        me = distributed.process_index()
        self.local = [i for i, d in enumerate(self.devices) if d.rank == me]
        self.multiprocess = distributed.process_count() > 1
        if not self.local:
            raise ValueError(f"rank {me} owns no device of the mesh: every "
                             "rank renders a shard of each dispatch")

    @property
    def size(self) -> int:
        return len(self.devices)

    def local_devices(self):
        """The distinct devices of this process's shards, in mesh order."""
        out = []
        for i in self.local:
            if self.devices[i].device not in out:
                out.append(self.devices[i].device)
        return out

    def __repr__(self):
        return f"RenderMesh({[(d.rank, str(d.device)) for d in self.devices]})"


def default_devices(kind="cuda"):
    """Every device a mesh may span, rank-major: in one process every card
    (or the CPU for kind "cpu"); across processes each rank's own device
    (distributed.local_device)."""
    world = distributed.process_count()
    if world > 1:
        if torch.device(kind).type == "cpu":
            return [MeshDevice(r, torch.device("cpu")) for r in range(world)]
        return [MeshDevice(r, d)
                for r, d in enumerate(distributed.rank_devices())]
    if torch.device(kind).type == "cpu":
        return [MeshDevice(0, torch.device("cpu"))]
    return [MeshDevice(0, torch.device("cuda", i))
            for i in range(torch.cuda.device_count())]


def _mesh_device(d) -> MeshDevice:
    if isinstance(d, MeshDevice):
        return d
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return MeshDevice(distributed.process_index(), d)


def make_render_mesh(devices=None) -> RenderMesh:
    """1-D mesh over all (or the given) devices. Plain devices or names
    ("cuda:0", "cpu") belong to this process; repeats are allowed."""
    devices = default_devices() if devices is None else devices
    return RenderMesh(_mesh_device(d) for d in devices)


def device_scope(device):
    """The current device set to `device` within the block, where it is a
    card: the kernels launch on the current device's stream, so a shard on
    another card than the current one launches under this scope."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def shard_bounds(n: int, k: int):
    """Lane bounds of k contiguous shards of n lanes: ceil(n / k) each, the
    last ones shorter (or empty)."""
    step = -(-n // k)
    return [min(i * step, n) for i in range(k + 1)]


def tree_to(tree, device):
    """A tree of NamedTuples, tuples and lists with its tensors on
    `device`. Tensors kept on the host on purpose (a photon map's radius)
    stay there when the target is a card."""
    device = torch.device(device)
    if isinstance(tree, torch.Tensor):
        if tree.device == device or (tree.device.type == "cpu"
                                     and device.type == "cuda"):
            return tree
        return tree.to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_to(x, device) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_to(x, device) for x in tree)
    return tree


class Replicas:
    """One copy of a tree (the compiled scene, the photon maps) for each
    distinct device of this process's shards."""

    def __init__(self, copies):
        self.copies = copies

    def on(self, device):
        return self.copies[str(torch.device(device))]


def device_put_replicated(tree, mesh: RenderMesh) -> Replicas:
    """Replicate a compiled scene (or the photon maps) over the mesh: one
    copy a distinct local device, made once (the Renderer calls it at
    compute_scene, as every MPI rank loads the whole scene,
    Renderer_MPI.cpp:54)."""
    if isinstance(tree, Replicas):
        return tree
    return Replicas({str(d): tree_to(tree, d) for d in mesh.local_devices()})


def device_put_sharded_batch(arr, mesh: RenderMesh):
    """This process's shards of a lane-major tensor, each on its device."""
    cuts = shard_bounds(arr.shape[0], mesh.size)
    return [arr[cuts[i]:cuts[i + 1]].to(mesh.devices[i].device)
            for i in mesh.local]


def _all_gather(outs, cuts, mesh: RenderMesh):
    """Every rank's lanes of each output, in lane order: the outputs packed
    as float32 columns (bools and float32 exact), each rank's rows padded
    to the longest, one all_gather."""
    world = distributed.process_count()
    rows = [0] * world  # a rank's lanes, contiguous in a rank-major mesh
    for i, d in enumerate(mesh.devices):
        rows[d.rank] += cuts[i + 1] - cuts[i]
    longest = max(rows)
    dev = outs[0].device
    on_card = distributed.backend() == "nccl"
    cols = [o.reshape(o.shape[0], -1) for o in outs]
    widths = [c.shape[1] for c in cols]
    packed = torch.cat([c.to(torch.float32) for c in cols], dim=1)
    packed = packed if on_card else packed.cpu()
    pad = packed.new_zeros((longest, packed.shape[1]))
    pad[:packed.shape[0]] = packed
    parts = [torch.empty_like(pad) for _ in range(world)]
    with span("mesh.all_gather") as timed:
        dist.all_gather(parts, pad, group=distributed.group())
    stats["all_gathers"] += 1
    stats["all_gather_s"] += timed.seconds
    whole = torch.cat([p[:m] for p, m in zip(parts, rows)]).to(dev)
    out, c = [], 0
    for o, w in zip(outs, widths):
        part = whole[:, c:c + w].reshape((whole.shape[0],) + o.shape[1:])
        out.append(part.to(o.dtype))
        c += w
    return tuple(out)


def shard_render_batch(mesh: RenderMesh):
    """Sharded engine.render_batch: run(scene, meta, cfg, px, py,
    sample_ids, key_words, photon_maps=None, want_aux=False) returns
    render_batch's outputs for every lane, on px's device.

    scene and photon_maps are Replicas (device_put_replicated) or trees,
    replicated on the call. Each of this process's shards renders on its
    device from its replica; a lane's result does not depend on the batch
    it renders in, so the outputs equal one render_batch's bit for bit."""

    def run(scene, meta, cfg, px, py, sample_ids, key_words,
            photon_maps=None, want_aux=False):
        scenes = device_put_replicated(scene, mesh)
        maps = (None if photon_maps is None
                else device_put_replicated(photon_maps, mesh))
        cuts = shard_bounds(px.shape[0], mesh.size)
        dev = px.device
        shards = []
        for i in mesh.local:
            d = mesh.devices[i].device
            a, b = cuts[i], cuts[i + 1]
            with device_scope(d):
                shards.append(render_batch(
                    scenes.on(d), meta, cfg, px[a:b].to(d), py[a:b].to(d),
                    sample_ids[a:b].to(d), key_words,
                    None if maps is None else maps.on(d),
                    want_aux=want_aux))
        if len(shards) == 1:
            outs = tuple(o.to(dev) for o in shards[0])
        else:
            outs = tuple(torch.cat([s[j].to(dev) for s in shards])
                         for j in range(len(shards[0])))
        if mesh.multiprocess:
            outs = _all_gather(outs, cuts, mesh)
        return outs

    return run
