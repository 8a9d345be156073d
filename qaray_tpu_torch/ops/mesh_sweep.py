"""Culled mesh sweep kernel (K3, csrc/tiles.cu walk_kernel<kDense>)
beside its plain version.

Counterpart of qaray_tpu/ops/pallas_mesh.py (pallas_sweep_closest ->
_sweep_kernel): each ray's closest triangle and runner-up over a world
mesh, with the linear-in-t predicate of ops/mesh_stream.py. The Pallas
kernel sweeps every row for every ray; here one CUDA thread walks one ray
over a tree of Morton clusters of WALK_LEAF rows (build_walk), the same
walk as the tiled route's K4a, and folds (t, world triangle id)
lexicographically, so the result is the dense sweep's on every ray:
t of the first of {(t_cur, -1)} and every hit, its id where that t is
below t_cur, and the second's id where its t is below BIGFLOAT. With t_cur
set to a shadow ray's budget, the any hit (sweep_occluded) stops a ray at
its first occluder (ops/trace.py, as the JAX package's trace_shadow does
on the TPU).

The wrappers take the dense [Fp, 16] coefficient table of pack_coeff16 and
the walk's tables (SweepWalk, the compiled scene's stream_rows, stream_gid
and stream_tree: walk_of). For tensors on the CPU they run the plain
versions, stream_closest and stream_any_hit (ops/mesh_stream.py), on the
dense table; for CUDA tensors they launch the kernel on the walk's tables,
never falling back from one to the other. `launches` counts kernel
launches.
"""

from typing import NamedTuple

import numpy as np
import torch

from qaray_tpu_torch.ops.mesh_stream import (
    StreamTris,
    stream_any_hit,
    stream_closest,
)

# The compiler's route limit for the dense sweep (the JAX package's VMEM
# budget of its coefficient table): above it a world mesh takes the tiled
# route. Kept so that the compiled meta equals the JAX package's.
PALLAS_MESH_MAX_TRIS = 65536
ROW_ALIGN = 128  # pack_coeff16 pads rows to a multiple of this
# Rows a cluster of the walk: a ray tests a visited cluster's rows in
# full, and mesh_scene's 320 triangles make 5 such clusters (2 of 256). On
# the card it beat leaves of 256 rows on mesh_scene and on ico5 (PERF.md).
WALK_LEAF = 64

launches = {"K3": 0}

_fns = {}


class SweepWalk(NamedTuple):
    """The walk's tables: the dense rows in Morton order, WALK_LEAF to a
    cluster, each row's world triangle id, and the clusters' tree."""

    rows: torch.Tensor  # [C * WALK_LEAF, 16] pack_coeff16 rows, Morton order
    gid: torch.Tensor  # [C * WALK_LEAF] int32 world triangle id (-1 padding)
    tree: torch.Tensor  # [2L, 8] tiles.cluster_tree of the clusters' boxes


def _lib(host: bool = False):
    """qr_mesh_walk of the CUDA library, or with host=True of the same
    source built for the CPU (_build.load_host; tests only)."""
    if host not in _fns:
        from qaray_tpu_torch.ops import _build

        lib = (_build.load_host if host else _build.load)("tiles")
        _fns[host] = _build.bind(lib, "qr_mesh_walk", "ppppppiiiippppppp")
    return _fns[host]


def pack_coeff16(stream_coeff, stream_const) -> np.ndarray:
    """Sweep coefficients -> the [Fp, 16] table the kernels read.

    cols: 0-2 n, 3-5 A, 6-8 B, 9 k, 10 a0, 11 b0, 12 |n|, 13-15 zero. Rows
    pad to a multiple of 128 with zeros, which never hit."""
    coeff = np.asarray(stream_coeff, np.float32)  # [F,3,3]
    const = np.asarray(stream_const, np.float32)  # [F,4]
    f = coeff.shape[0]
    out = np.zeros((f, 16), np.float32)
    out[:, 0:9] = coeff.reshape(f, 9)
    out[:, 9:13] = const
    pad = (-f) % ROW_ALIGN
    if pad:
        out = np.concatenate([out, np.zeros((pad, 16), np.float32)])
    return out


def unpack_coeff16(coeff16) -> StreamTris:
    """The [Fp, 16] table as the plain versions' StreamTris (views)."""
    return StreamTris(coeff16[:, 0:9].reshape(-1, 3, 3), coeff16[:, 9:13])


def build_walk(tri_v) -> SweepWalk:
    """The walk's tables of world triangles tri_v [F, 3, 3] (CPU tensors):
    ops/mesh_tiles.build_tiles' Morton clusters of WALK_LEAF rows, whose
    coefficients are pack_coeff16's numbers row for row."""
    from qaray_tpu_torch.ops.mesh_tiles import build_tiles
    from qaray_tpu_torch.ops.tiles import cluster_tree

    tm = build_tiles(tri_v, cluster=WALK_LEAF)
    rows = pack_coeff16(tm.coeff, tm.const)[: tm.coeff.shape[0]]
    return SweepWalk(torch.from_numpy(np.ascontiguousarray(rows)), tm.gid,
                     cluster_tree(tm.cbounds))


def walk_of(mesh) -> SweepWalk:
    """The compiled scene's walk tables (scene.arrays.MeshArrays)."""
    return SweepWalk(mesh.stream_rows, mesh.stream_gid, mesh.stream_tree)


def _check(p, d, t_cur, coeff16):
    dev = p.device
    for t in (d, t_cur, coeff16):
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
    for t in (p, d):
        if t.dtype != torch.float32 or t.ndim != 2 or t.shape[1] != 3:
            raise ValueError(f"rays must be float32 [B, 3], got {t.dtype} "
                             f"{tuple(t.shape)}")
    if d.shape != p.shape:
        raise ValueError("p and d differ in shape")
    if t_cur.dtype != torch.float32 or t_cur.shape != p.shape[:1]:
        raise ValueError("t_cur must be float32 [B]")
    if (coeff16.dtype != torch.float32 or coeff16.ndim != 2
            or coeff16.shape[1] != 16 or coeff16.shape[0] % ROW_ALIGN
            or not coeff16.is_contiguous()):
        raise ValueError("coeff16 must be contiguous float32 [Fp, 16] with "
                         "Fp a multiple of 128 (pack_coeff16)")


def _check_walk(walk, device):
    if walk is None:
        raise ValueError("the kernel walks the compiled scene's tables: "
                         "pass walk=walk_of(scene.mesh)")
    rows, gid, tree = walk
    leaves = tree.shape[0] // 2
    if (any(t.device != device for t in (rows, gid, tree))
            or rows.dtype != torch.float32 or rows.ndim != 2
            or rows.shape[1] != 16 or rows.shape[0] % WALK_LEAF
            or gid.dtype != torch.int32 or gid.shape != rows.shape[:1]
            or tree.dtype != torch.float32 or tree.shape != (2 * leaves, 8)
            or leaves & (leaves - 1) or leaves * WALK_LEAF < rows.shape[0]
            or not all(t.is_contiguous() for t in (rows, gid, tree))):
        raise ValueError("walk must be build_walk's tables (contiguous "
                         "float32 rows, int32 gid, a cluster_tree of their "
                         "clusters) on the rays' device")


def _plain_chunk(coeff16):
    return 256 if coeff16.shape[0] % 256 == 0 else ROW_ALIGN


def _launch(fn, p, d, t_cur, walk, any_hit, steps, stream):
    n = p.shape[0]
    dev = p.device
    t = torch.empty(n, dtype=torch.float32, device=dev)
    row = torch.empty(n, dtype=torch.int32, device=dev)
    row2 = torch.empty(n, dtype=torch.int32, device=dev)
    flag = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        from qaray_tpu_torch.ops import _build

        p, d, t_cur = p.contiguous(), d.contiguous(), t_cur.contiguous()
        rc = fn(p.data_ptr(), d.data_ptr(), t_cur.data_ptr(),
                walk.rows.data_ptr(), walk.gid.data_ptr(),
                walk.tree.data_ptr(), n, walk.tree.shape[0] // 2, WALK_LEAF,
                int(any_hit), t.data_ptr(), row.data_ptr(), row2.data_ptr(),
                flag.data_ptr(),
                steps.data_ptr() if steps is not None else None, None,
                stream)
        _build.check(rc, "K3 mesh walk")
    return flag if any_hit else (t, row, row2)


def _run(p, d, t_cur, walk, any_hit, steps):
    _check_walk(walk, p.device)
    if steps is not None and (steps.device != p.device
                              or steps.dtype != torch.int32
                              or steps.shape != t_cur.shape
                              or not steps.is_contiguous()):
        raise ValueError("steps must be contiguous int32 [B] on the rays' "
                         "device")
    out = _launch(_lib(), p, d, t_cur, walk, any_hit, steps,
                  torch.cuda.current_stream().cuda_stream)
    if p.shape[0]:
        launches["K3"] += 1
    return out


def sweep_closest(p, d, t_cur, coeff16, walk=None, steps=None, plain=False):
    """Closest triangle below t_cur per ray: (t [B], row [B] or -1, row2
    [B] runner-up or -1), the dense sweep's (t, row, row2) on every ray.
    Rows index coeff16 (the world triangle ids). walk: the compiled scene's
    tables (walk_of), which the kernel reads; steps: optional int32 [B]
    filled on the card with the clusters each ray visited. plain: the
    plain version on any device (QARAY_NO_PALLAS, meta.force_xla)."""
    _check(p, d, t_cur, coeff16)
    if p.device.type == "cpu" or plain:
        return stream_closest(p, d, t_cur, unpack_coeff16(coeff16),
                              chunk=_plain_chunk(coeff16))
    return _run(p, d, t_cur, walk, False, steps)


def sweep_occluded(p, d, t_max, coeff16, walk=None, steps=None, plain=False):
    """Occluded [B] bool: some triangle has BIAS < t < t_max. On the card,
    the walk stops a ray at its first occluder (plain: as sweep_closest)."""
    _check(p, d, t_max, coeff16)
    if p.device.type == "cpu" or plain:
        return stream_any_hit(p, d, t_max, unpack_coeff16(coeff16),
                              chunk=_plain_chunk(coeff16))
    return _run(p, d, t_max, walk, True, steps)


def sweep_host(p, d, t_cur, walk, any_hit=False):
    """The kernel source (csrc/tiles.cu) built for the CPU by g++
    (_build.load_host) and run one ray at a time on CPU tensors: the outputs
    of sweep_closest or sweep_occluded, and the clusters each ray visited.
    For tests that hold the source to the plain version where there is no
    card; counts no launch."""
    for t in (p, d, t_cur):
        if t.device.type != "cpu":
            raise ValueError("sweep_host takes CPU tensors")
    _check_walk(walk, p.device)
    steps = torch.zeros(p.shape[0], dtype=torch.int32)
    return _launch(_lib(host=True), p, d, t_cur, walk, any_hit, steps,
                   None), steps
