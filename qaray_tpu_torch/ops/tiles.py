"""Tiled cluster march kernels (K4a closest, K4b any hit, csrc/tiles.cu).

Counterpart of qaray_tpu/ops/pallas_tiles.py (pallas_tiled_sweep ->
_closest_kernel / _anyhit_kernel, and tiled_closest_twophase). The torch
glue around a launch is the JAX package's XLA glue around its Pallas call:
rays are cut into packets of PACKET_ROWS * 128 consecutive rays; per
packet, a conservative interval-arithmetic cull of every cluster AABB
(packet_cull_entry) gives the hit clusters and a lower bound on each one's
entry distance; the clusters are sorted front to back by that bound. The
kernel then marches each packet through its sorted clusters:

- closest (K4a): stop when no later entry bound beats any lane's
  min(best t, root-box exit), or after max_steps clusters; per-lane top-2
  and `resolved` (no unvisited cluster can still improve the lane);
- any hit (K4b): stop when every lane with budget is occluded.

Winners equal ops/mesh_tiles.tiled_sweep's (front-to-back termination
skips only clusters that cannot improve any lane). The runner-up may
differ: a runner-up in a cluster the march never visits is missed, which
the exact re-test's fallback tolerates (pallas_tiles.py:25-31).

march_plain is the kernels' plain version, with the same termination,
budget and resolved flag; tiled_sweep_kernel runs it for tensors on the
CPU and launches K4a/K4b for CUDA tensors, never falling back from one to
the other. The kernels mask the ragged last packet instead of padding it,
so padded lanes take no part in termination; march_plain does the same.
`launches` counts kernel launches.
"""

import numpy as np
import torch

from qaray_tpu_torch.core.constants import BIAS, BIGFLOAT
from qaray_tpu_torch.ops.mesh_stream import _chunk_test, merge_top2, top2
from qaray_tpu_torch.ops.mesh_sweep import pack_coeff16, unpack_coeff16
from qaray_tpu_torch.ops.mesh_tiles import (
    CLUSTER,
    TiledMesh,
    coherence_order,
    pad_packets,
    packet_entry_exit,
)

LANES = 128
# Rays per packet = PACKET_ROWS * 128, the JAX package's default. The
# kernel holds at most 2048 rays in a block.
PACKET_ROWS = 16
MAX_PACKET = 2048

launches = {"K4a": 0, "K4b": 0}

_fns = {}


def _lib():
    if not _fns:
        from qaray_tpu_torch.ops import _build

        lib = _build.load("tiles")
        _fns["march"] = _build.bind(lib, "qr_tiles_march",
                                    "ppppppppiiiiiippppppp")
    return _fns["march"]


def pack_coeffT(tile_coeff, tile_const) -> np.ndarray:
    """Tiled coefficients -> [Fp/8, 128]: the [Fp, 16] pack_coeff16 rows, 8
    to a 128-wide row (the JAX package's table; the kernels read it as
    [Fp, 16] rows, the same memory)."""
    c16 = pack_coeff16(tile_coeff, tile_const)
    c16 = c16[: np.asarray(tile_coeff).shape[0]]
    if c16.shape[0] % 8:
        raise ValueError("tiled rows must be a multiple of 8")
    return c16.reshape(-1, 128)


def packet_cull_entry(po, pd, t_hi, cbounds):
    """mesh_tiles._packet_cull extended with each cluster's entry lower
    bound: (hit [G, C], entry [G, C] clamped at 0)."""
    entry, exit_ = packet_entry_exit(po, pd, cbounds)
    nonempty = (cbounds[:, :3] <= cbounds[:, 3:6]).all(dim=-1)[None, :]
    hit = ((entry <= exit_) & (exit_ > BIAS) & (entry < t_hi[:, None])
           & nonempty)
    return hit, torch.clamp_min(entry, 0.0)


def _box_exit(p, d, cbounds):
    """Each ray's exit distance from the mesh's root box (every triangle
    lies inside it), padded up; BIGFLOAT where a direction component is
    under 1e-7."""
    root_lo = cbounds[:, :3].amin(dim=0)
    root_hi = cbounds[:, 3:6].amax(dim=0)
    safe_d = torch.where(torch.abs(d) < 1e-7, torch.full_like(d, 1e-7), d)
    inv = 1.0 / safe_d
    t1 = (root_lo[None, :] - p) * inv
    t2 = (root_hi[None, :] - p) * inv
    t_far = torch.maximum(t1, t2).amin(dim=-1)
    mixed = (torch.abs(d) < 1e-7).any(dim=-1)
    box_exit = torch.where(mixed, torch.full_like(t_far, BIGFLOAT),
                           t_far * 1.0001 + 1e-3)
    return torch.clamp_min(box_exit, 0.0)


def march_tables(p, d, t_cur, cbounds, packet):
    """The glue of a march: (order [G, C] int32, entry [G, C] sorted front
    to back, count [G] int32, box_exit [B]). The cull sees the packets
    padded as the JAX package pads them."""
    po, pd, pt = pad_packets(p, d, t_cur, packet)
    masks, entries = packet_cull_entry(po, pd, pt.amax(dim=1), cbounds)
    counts = masks.sum(dim=-1).to(torch.int32)
    key = torch.where(masks, entries, torch.full_like(entries, BIGFLOAT))
    order = torch.argsort(key, dim=-1, stable=True)
    entry = torch.gather(key, 1, order)
    return (order.to(torch.int32).contiguous(), entry.contiguous(), counts,
            _box_exit(p, d, cbounds))


def march_plain(p, d, t_cur, coeffT, order, entry, count, box_exit, packet,
                any_hit=False, max_steps=0):
    """The kernels' plain version: the front-to-back march of every packet
    in lock step, each packet stopping on its own condition.

    closest: (t [B], row [B], row2 [B], resolved [B] bool); any_hit:
    occluded [B] bool."""
    num = p.shape[0]
    dev = p.device
    g, n_clusters = order.shape
    pad = g * packet - num
    valid = (torch.arange(g * packet, device=dev) < num).reshape(g, packet)
    po = torch.cat([p, p.new_zeros((pad, 3))]).reshape(g, packet, 3)
    pd = torch.cat([d, d.new_ones((pad, 3))]).reshape(g, packet, 3)
    pt = torch.cat([t_cur, t_cur.new_zeros(pad)]).reshape(g, packet)
    cap = torch.cat([box_exit, box_exit.new_zeros(pad)]).reshape(g, packet)
    tab = unpack_coeff16(coeffT.reshape(-1, 16))
    ar = torch.arange(g, device=dev)
    rows = torch.arange(CLUSTER, device=dev)
    count = count.long()
    neg = torch.full_like(pt, -BIGFLOAT)

    def cluster_t(j):
        cid = order[ar, min(j, n_clusters - 1)].long()
        idx = cid[:, None] * CLUSTER + rows[None, :]
        return cid, _chunk_test(po, pd, tab.coeff[idx], tab.const[idx])

    def ent_at(j):
        return entry[ar, torch.clamp(j, max=n_clusters - 1)]

    running = torch.ones(g, dtype=torch.bool, device=dev)
    j = torch.zeros(g, dtype=torch.long, device=dev)
    if any_hit:
        occ = torch.zeros((g, packet), dtype=torch.bool, device=dev)
        while True:
            open_lanes = torch.where(
                valid & ~occ, torch.minimum(pt, cap),
                torch.where(valid, torch.zeros_like(pt), neg)).amax(dim=1)
            running &= ((j < count) & (open_lanes > BIAS)
                        & (ent_at(j) <= open_lanes))
            if not bool(running.any()):
                break
            step = int(j[running][0].item())
            _, t = cluster_t(step)
            hit = (t < pt[:, :, None]).any(dim=-1)
            occ = occ | (hit & running[:, None])
            j = j + running.long()
        return occ.reshape(-1)[:num]

    t_in = pt.reshape(-1)
    t_b = t_in.clone()
    r_b = torch.full_like(t_b, -1, dtype=torch.int32)
    t2_b = torch.full_like(t_b, BIGFLOAT)
    r2_b = r_b.clone()
    while True:
        live = j < count
        if max_steps:
            live &= j < max_steps
        reach = torch.where(valid, torch.minimum(t_b.reshape(g, packet), cap),
                            neg).amax(dim=1)
        running &= live & (ent_at(j) <= reach)
        if not bool(running.any()):
            break
        step = int(j[running][0].item())
        cid, t = cluster_t(step)
        t = torch.where(running[:, None, None], t, torch.full_like(t,
                                                                  BIGFLOAT))
        t1, i1, t2, i2 = top2(t.reshape(g * packet, CLUSTER))
        base = (cid.to(torch.int32) * CLUSTER).repeat_interleave(packet)
        t_b, r_b, t2_b, r2_b = merge_top2(t_b, r_b, t2_b, r2_b, t1, base + i1,
                                          t2, base + i2)
        j = j + running.long()
    lane_t = torch.minimum(t_b.reshape(g, packet), cap)
    resolved = (j >= count)[:, None] | (ent_at(j)[:, None] > lane_t)
    row = torch.where(t_b < t_in, r_b, torch.full_like(r_b, -1))
    row2 = torch.where(t2_b < BIGFLOAT, r2_b, torch.full_like(r2_b, -1))
    return (t_b[:num], row[:num], row2[:num], resolved.reshape(-1)[:num])


def _check(p, d, t_cur, coeffT):
    dev = p.device
    for t in (d, t_cur, coeffT):
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
    if (coeffT.dtype != torch.float32 or coeffT.ndim != 2
            or coeffT.shape[1] != 128 or (coeffT.shape[0] * 8) % CLUSTER
            or not coeffT.is_contiguous()):
        raise ValueError("coeffT must be contiguous float32 [Fp/8, 128] with "
                         "Fp a multiple of 256 (pack_coeffT)")


def _launch(p, d, t_cur, coeffT, order, entry, count, box_exit, packet,
            any_hit, max_steps, steps=None, work=None):
    n = p.shape[0]
    dev = p.device
    t = torch.empty(n, dtype=torch.float32, device=dev)
    row = torch.empty(n, dtype=torch.int32, device=dev)
    row2 = torch.empty(n, dtype=torch.int32, device=dev)
    flag = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        from qaray_tpu_torch.ops import _build

        p, d, t_cur = p.contiguous(), d.contiguous(), t_cur.contiguous()
        box_exit = box_exit.contiguous()
        rc = _lib()(
            p.data_ptr(), d.data_ptr(), t_cur.data_ptr(), box_exit.data_ptr(),
            coeffT.data_ptr(), order.data_ptr(), entry.data_ptr(),
            count.data_ptr(), n, order.shape[0], order.shape[1], packet,
            int(any_hit), max_steps, t.data_ptr(), row.data_ptr(),
            row2.data_ptr(), flag.data_ptr(),
            steps.data_ptr() if steps is not None else None,
            work.data_ptr() if work is not None else None,
            torch.cuda.current_stream().cuda_stream)
        _build.check(rc, "K4b tiled any hit" if any_hit else
                     "K4a tiled closest")
        launches["K4b" if any_hit else "K4a"] += 1
    if any_hit:
        return flag
    return t, row, row2, flag


def tiled_sweep_kernel(p, d, t_cur, tiles: TiledMesh, coeffT,
                       any_hit=False, max_steps=0, steps=None, work=None):
    """Counterpart of pallas_tiled_sweep.

    closest: (t [B], row [B], row2 [B], resolved [B] bool), sorted-row ids
    (-1 = none); max_steps > 0 caps each packet's march (phase 1 of
    tiled_closest_twophase). any_hit: occluded [B] bool (t_cur is each
    ray's budget). coeffT: [Fp/8, 128] from pack_coeffT. steps: optional
    int32 [G] tensor the kernel fills with the clusters each packet
    visited; work: optional int32 [B] tensor it fills with the triangle
    tests each ray needed, 256 for every visited cluster whose entry bound
    is within the ray's own reach (min(best t, box exit); any hit: only
    while the ray is open and has budget). Both CUDA only, for roofline
    bounds."""
    _check(p, d, t_cur, coeffT)
    packet = PACKET_ROWS * LANES
    if packet > MAX_PACKET:
        raise ValueError(f"packets of {packet} rays: the kernel holds at "
                         f"most {MAX_PACKET}")
    tables = march_tables(p, d, t_cur, tiles.cbounds, packet)
    if p.device.type == "cpu":
        return march_plain(p, d, t_cur, coeffT, *tables, packet,
                           any_hit=any_hit, max_steps=max_steps)
    for name, out, shape in (("steps", steps, tables[2].shape),
                             ("work", work, t_cur.shape)):
        if out is not None and (out.device != p.device
                                or out.dtype != torch.int32
                                or out.shape != shape
                                or not out.is_contiguous()):
            raise ValueError(f"{name} must be contiguous int32 "
                             f"{list(shape)} on the rays' device")
    return _launch(p, d, t_cur, coeffT, *tables, packet, any_hit, max_steps,
                   steps, work)


def tiled_closest_twophase(p, d, t_cur, tiles: TiledMesh, coeffT,
                           budget: int = 12):
    """Divergence-compacted closest hit: a march of at most `budget`
    clusters per packet on coherence-sorted rays; the lanes left unresolved
    are packed together (stable sort by the resolved flag) and finished by
    an unlimited march. Resolved lanes ride along with t = -1, which no hit
    beats and which no packet waits for. Returns (t, row, row2) in the
    caller's ray order."""
    lo = tiles.cbounds[:, :3].amin(dim=0)
    hi = tiles.cbounds[:, 3:6].amax(dim=0)
    perm = coherence_order(p, d, lo, hi)
    inv = torch.argsort(perm)
    ps, ds, ts = p[perm], d[perm], t_cur[perm]
    if budget <= 0:
        t, r, r2, _ = tiled_sweep_kernel(ps, ds, ts, tiles, coeffT)
        return t[inv], r[inv], r2[inv]
    t1, r1, r21, res = tiled_sweep_kernel(ps, ds, ts, tiles, coeffT,
                                          max_steps=budget)
    iota = torch.arange(ps.shape[0], dtype=torch.int64, device=p.device)
    perm2 = torch.argsort(torch.where(res, iota + (1 << 30), iota))
    inv2 = torch.argsort(perm2)
    t_seed = torch.where(res, torch.full_like(t1, -1.0), t1)
    t2, r2b, r22, _ = tiled_sweep_kernel(ps[perm2], ds[perm2], t_seed[perm2],
                                         tiles, coeffT)
    t2, r2b, r22 = t2[inv2], r2b[inv2], r22[inv2]
    improved = r2b >= 0
    t_f = torch.where(improved, t2, t1)
    r_f = torch.where(improved, r2b, r1)
    r2_f = torch.where(improved, r22, r21)
    return t_f[inv], r_f[inv], r2_f[inv]
