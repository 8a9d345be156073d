"""Tiled packet-culled mesh traversal: the reference of kernels K4a/K4b.

Counterpart of qaray_tpu/ops/mesh_tiles.py. The host build sorts the
triangles by the Morton code of their centroids, groups them into clusters
of CLUSTER contiguous rows with one AABB each, and keeps the sweep
coefficients (ops/mesh_stream.py) in sorted order with a row -> original
triangle map. tiled_sweep partitions the rays into packets, culls the
clusters per packet with a conservative interval-arithmetic slab test
(_packet_cull), and sweeps each packet's surviving clusters in lock step.
It returns sorted-row ids: exact_winner_rows re-tests the winners with the
reference formula and maps them through `gid` to the original triangles.

tiled_sweep is what the kernels of ops/tiles.py must agree with on every
winner and runner-up; their own plain version (ops/tiles.walk_plain) walks
each ray on its own and stops it as soon as no unvisited cluster can change
its top-2.
"""

from typing import NamedTuple

import numpy as np
import torch

from qaray_tpu_torch.core.constants import BIAS, BIGFLOAT
from qaray_tpu_torch.ops.intersect import intersect_triangles
from qaray_tpu_torch.ops.mesh_stream import (
    _chunk_test,
    build_stream,
    merge_top2,
    top2,
)

CLUSTER = 256  # triangles per cluster == sweep chunk
PACKET = 4096  # rays per packet


class TiledMesh(NamedTuple):
    coeff: torch.Tensor  # [Fp, 3, 3] sweep coefficients, Morton order
    const: torch.Tensor  # [Fp, 4]
    gid: torch.Tensor  # [Fp] original triangle id (int32; -1 padding)
    cbounds: torch.Tensor  # [C, 6] cluster AABBs (min xyz, max xyz)


def _morton3(x: np.ndarray) -> np.ndarray:
    """[N,3] float -> 30-bit interleaved Morton codes."""
    lo = x.min(axis=0)
    ext = np.maximum(x.max(axis=0) - lo, 1e-12)
    q = np.clip(((x - lo) / ext * 1023.0), 0, 1023).astype(np.uint64)

    def spread(v):
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v

    return (spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1))
            | (spread(q[:, 2]) << np.uint64(2)))


def build_tiles(tri_v: np.ndarray, cluster: int = CLUSTER) -> TiledMesh:
    """Host build (CPU tensors): Morton sort, sweep coefficients, cluster
    AABBs. Clusters made entirely of padding get an inverted box that no
    cull accepts."""
    tri_v = np.asarray(tri_v, np.float32)
    num = tri_v.shape[0]
    if num == 0:
        empty = np.array([[1.0, 1.0, 1.0, -1.0, -1.0, -1.0]], np.float32)
        return TiledMesh(torch.zeros((cluster, 3, 3)),
                         torch.zeros((cluster, 4)),
                         torch.full((cluster,), -1, dtype=torch.int32),
                         torch.from_numpy(empty))
    order = np.argsort(_morton3(tri_v.mean(axis=1)), kind="stable")
    sorted_v = tri_v[order]
    stream = build_stream(sorted_v, chunk=cluster)
    fp = stream.coeff.shape[0]
    gid = np.full(fp, -1, np.int32)
    gid[:num] = order.astype(np.int32)
    nc = fp // cluster
    # A partly padded tail cluster repeats the last triangle for its box
    # (padding rows never hit).
    pad_rows = fp - num
    padded = np.concatenate(
        [sorted_v] + ([np.broadcast_to(sorted_v[-1:], (pad_rows, 3, 3))]
                      if pad_rows else [])).reshape(nc, cluster * 3, 3)
    cb = np.concatenate([padded.min(axis=1), padded.max(axis=1)],
                        axis=1).astype(np.float32)
    all_pad = np.arange(nc) * cluster >= num
    cb[all_pad, 0:3] = 1.0
    cb[all_pad, 3:6] = -1.0
    return TiledMesh(stream.coeff, stream.const, torch.from_numpy(gid),
                     torch.from_numpy(cb))


def packet_bounds(po, pd):
    """Conservative per-packet bounds of rays po, pd [G, Q, 3]: origin box
    (o_lo, o_hi), reciprocal-direction interval (r_lo, r_hi) and the axes
    whose direction interval spans or touches zero (`mixed`), each [G, 3].
    """
    o_lo, o_hi = po.amin(dim=1), po.amax(dim=1)
    d_lo, d_hi = pd.amin(dim=1), pd.amax(dim=1)
    eps = 1e-7
    mixed = (d_lo < eps) & (d_hi > -eps)
    safe_lo = torch.where(torch.abs(d_lo) < eps, torch.full_like(d_lo, eps),
                          d_lo)
    safe_hi = torch.where(torch.abs(d_hi) < eps, torch.full_like(d_hi, eps),
                          d_hi)
    r1, r2 = 1.0 / safe_lo, 1.0 / safe_hi
    return o_lo, o_hi, torch.minimum(r1, r2), torch.maximum(r1, r2), mixed


def packet_entry_exit(po, pd, cbounds):
    """Interval-arithmetic slab test of every packet against every cluster:
    (entry [G, C], exit [G, C]) bounds that every ray of the packet obeys.

    Per ray and axis, the slab times (b - o) * inv lie inside the interval
    product of (b - o_hi .. b - o_lo) and (r_lo .. r_hi), so a ray that hits
    a cluster implies entry <= exit for its packet: the cull only
    over-accepts. Axes whose direction spans zero get (-inf, +inf)."""
    o_lo, o_hi, r_lo, r_hi, mixed = (x[:, None, :] for x in
                                      packet_bounds(po, pd))

    def interval(b):  # b [C, 3] -> lo, hi [G, C, 3] of (b - o) * r
        a_lo = b[None] - o_hi
        a_hi = b[None] - o_lo
        prods = torch.stack([a_lo * r_lo, a_lo * r_hi, a_hi * r_lo,
                             a_hi * r_hi])
        return prods.amin(dim=0), prods.amax(dim=0)

    lo1, hi1 = interval(cbounds[:, :3])
    lo2, hi2 = interval(cbounds[:, 3:6])
    near_lo = torch.minimum(lo1, lo2)
    far_hi = torch.maximum(hi1, hi2)
    near_lo = torch.where(mixed, torch.full_like(near_lo, -BIGFLOAT), near_lo)
    far_hi = torch.where(mixed, torch.full_like(far_hi, BIGFLOAT), far_hi)
    return near_lo.amax(dim=-1), far_hi.amin(dim=-1)


def _packet_cull(po, pd, t_hi, cbounds):
    """Hit mask [G, C] of the conservative packet-vs-cluster test; t_hi [G]
    is each packet's upper bound on useful t."""
    entry, exit_ = packet_entry_exit(po, pd, cbounds)
    nonempty = (cbounds[:, :3] <= cbounds[:, 3:6]).all(dim=-1)[None, :]
    return ((entry <= exit_) & (exit_ > BIAS) & (entry < t_hi[:, None])
            & nonempty)


def pad_packets(p, d, t_cur, packet):
    """Rays padded to a packet multiple (origin 0, direction (1,1,1),
    budget 0) and reshaped to [G, packet, ...]."""
    num = p.shape[0]
    pad = (-num) % packet
    pp = torch.cat([p, p.new_zeros((pad, 3))])
    dd = torch.cat([d, d.new_ones((pad, 3))])
    tt = torch.cat([t_cur, t_cur.new_zeros(pad)])
    g = (num + pad) // packet
    return pp.reshape(g, packet, 3), dd.reshape(g, packet, 3), \
        tt.reshape(g, packet)


def _cluster_rows(tiles: TiledMesh, cid, cluster):
    """Coefficients of cluster cid [G] per packet: ([G, K, 3, 3], [G, K, 4])."""
    rows = cid.long()[:, None] * cluster + torch.arange(
        cluster, device=cid.device)[None, :]
    return tiles.coeff[rows], tiles.const[rows]


def tiled_sweep(p, d, t_cur, tiles: TiledMesh, packet: int = PACKET,
                cluster: int = CLUSTER, any_hit: bool = False):
    """Closest (default) or any-hit sweep over the tiled mesh.

    closest: (t_sweep [B], row [B] sorted-row id or -1, row2 [B] runner-up)
    -- rows, not original ids. any_hit: occluded [B] (t_cur is each ray's
    budget t_max)."""
    num = p.shape[0]
    po, pd, pt = pad_packets(p, d, t_cur, packet)
    g = po.shape[0]
    n_clusters = tiles.cbounds.shape[0]
    masks = _packet_cull(po, pd, pt.amax(dim=1), tiles.cbounds)
    counts = masks.sum(dim=-1)
    # Hit clusters first, in spatial order.
    order = torch.argsort((~masks).to(torch.int8), dim=-1, stable=True)
    ar = torch.arange(g, device=p.device)
    steps = int(counts.max().item()) if g else 0

    if any_hit:
        occ = torch.zeros((g, packet), dtype=torch.bool, device=p.device)
        for j in range(steps):
            live = (j < counts) & ~(occ | (pt <= 0.0)).all(dim=-1)
            if not bool(live.any()):
                break
            cid = order[ar, min(j, n_clusters - 1)]
            coeff, const = _cluster_rows(tiles, cid, cluster)
            t = _chunk_test(po, pd, coeff, const)
            new = occ | (t < pt[:, :, None]).any(dim=-1)
            occ = torch.where((j < counts)[:, None], new, occ)
        return occ.reshape(-1)[:num]

    t_best = pt.reshape(-1).clone()
    row_best = torch.full_like(t_best, -1, dtype=torch.int32)
    t2_best = torch.full_like(t_best, BIGFLOAT)
    row2_best = row_best.clone()
    for j in range(steps):
        active = (j < counts)
        cid = order[ar, min(j, n_clusters - 1)]
        coeff, const = _cluster_rows(tiles, cid, cluster)
        t = _chunk_test(po, pd, coeff, const)
        t = torch.where(active[:, None, None], t, torch.full_like(t, BIGFLOAT))
        t1, i1, t2, i2 = top2(t.reshape(g * packet, cluster))
        base = (cid.to(torch.int32) * cluster).repeat_interleave(packet)
        t_best, row_best, t2_best, row2_best = merge_top2(
            t_best, row_best, t2_best, row2_best, t1, base + i1, t2,
            base + i2)
    row2_best = torch.where(t2_best < BIGFLOAT, row2_best,
                            torch.full_like(row2_best, -1))
    return t_best[:num], row_best[:num], row2_best[:num]


def coherence_order(p, d, scene_lo, scene_hi):
    """Sort key for ray coherence: a 15-bit Morton code of the origin (high
    bits) then one of the direction. Packets of sorted rays share tight
    origin boxes and narrow direction intervals, which is what the packet
    cull needs. Returns the permutation [B]; sorting and unsorting is
    neutral on results."""
    ext = torch.clamp_min(scene_hi - scene_lo, 1e-12)
    q = torch.clamp((p - scene_lo) / ext * 31.0, 0.0, 31.0).to(torch.int64)
    qd = torch.clamp((d + 1.0) * 15.999, 0.0, 31.0).to(torch.int64)

    def spread5(v):  # 5 bits -> every 3rd position
        v = (v | (v << 8)) & 0x0100F
        v = (v | (v << 4)) & 0x010C3
        v = (v | (v << 2)) & 0x09249
        return v

    def morton(a):
        return (spread5(a[:, 0]) | (spread5(a[:, 1]) << 1)
                | (spread5(a[:, 2]) << 2))

    key = (morton(q) << 15) | morton(qd)
    return torch.argsort(key, stable=True)


def exact_winner_rows(p, d, rows, tiles: TiledMesh, tri_v):
    """Exact re-test of each ray's winner row: (t, bary, front, valid, gid)
    with gid the ORIGINAL triangle id."""
    gid = tiles.gid[rows.clamp_min(0).long()]
    valid_row = (rows >= 0) & (gid >= 0)
    v = tri_v[gid.clamp_min(0).long()]
    t, bary, front, hit = intersect_triangles(
        p, d, v[:, 0], v[:, 1], v[:, 2],
        torch.full(p.shape[:1], BIGFLOAT, device=p.device))
    valid = hit & valid_row
    return (torch.where(valid, t, torch.full_like(t, BIGFLOAT)), bary, front,
            valid, gid)
