"""Dense triangle sweep: the plain version of kernel K3.

Counterpart of qaray_tpu/ops/mesh_stream.py. The triangle test is the
reference's own (plane hit + dominant-axis 2D barycentric,
objects/objects.cpp:212-248) rewritten linear in the hit point, so one
ray x triangle test is a handful of products:

    t = (k - P.n) / (D.n)             k = v0.n precomputed
    a = A0 + A.P + t (A.D)            A, A0: barycentric-row coefficients
    b = B0 + B.P + t (B.D)            on the tri's dominant axis, /2S
    hit = !parallel & t>BIAS & a>=0 & b>=0 & 1-a-b>=0

The sweep finds each ray's winning triangle (and runner-up); the winner's
exact attributes come from the reference formula afterwards
(exact_winner). The products are written out left to right, the order the
kernels use (csrc/mesh.cuh), so the plain version and the kernels round
alike.
"""

from typing import NamedTuple

import numpy as np
import torch

from qaray_tpu_torch.core.constants import BIAS, BIGFLOAT
from qaray_tpu_torch.ops.intersect import intersect_triangles

STREAM_CHUNK = 256  # triangles per sweep step


class StreamTris(NamedTuple):
    """Per-triangle sweep coefficients, padded to a chunk multiple."""

    coeff: torch.Tensor  # [Fp, 3, 3] rows n, A, B
    const: torch.Tensor  # [Fp, 4] k = v0.n, A0, B0, |n|


def build_stream(tri_v: np.ndarray, chunk: int = STREAM_CHUNK) -> StreamTris:
    """tri_v [F,3,3] -> StreamTris (CPU tensors) with F padded to a chunk
    multiple. Padding rows are all zero: t = 0 fails t > BIAS, so they never
    hit."""
    tri_v = np.asarray(tri_v, np.float32)
    num = tri_v.shape[0]
    if num == 0:
        return StreamTris(torch.zeros((chunk, 3, 3)), torch.zeros((chunk, 4)))
    v0, v1, v2 = tri_v[:, 0], tri_v[:, 1], tri_v[:, 2]
    n = np.cross(v1 - v0, v2 - v0)
    k = np.sum(v0 * n, axis=-1)
    # Dominant axis by the reference's strict comparisons.
    an = np.abs(n)
    ax = np.where((an[:, 0] > an[:, 1]) & (an[:, 0] > an[:, 2]), 0,
                  np.where(an[:, 1] > an[:, 2], 1, 2))
    i_idx = np.where(ax == 0, 1, 0)
    j_idx = np.where(ax == 2, 1, 2)
    ar = np.arange(num)
    v0i, v0j = v0[ar, i_idx], v0[ar, j_idx]
    v1i, v1j = v1[ar, i_idx], v1[ar, j_idx]
    v2i, v2j = v2[ar, i_idx], v2[ar, j_idx]
    s = (v1i - v0i) * (v2j - v0j) - (v2i - v0i) * (v1j - v0j)
    s = np.where(np.abs(s) < 1e-30, 1e-30, s)
    # area(hp,v1,v2)/s and area(hp,v2,v0)/s expanded linearly in hp.
    a0 = (v1i * v2j - v2i * v1j) / s
    avec = np.zeros((num, 3), np.float64)
    avec[ar, i_idx] = (v1j - v2j) / s
    avec[ar, j_idx] = (v2i - v1i) / s
    b0 = (v2i * v0j - v0i * v2j) / s
    bvec = np.zeros((num, 3), np.float64)
    bvec[ar, i_idx] = (v2j - v0j) / s
    bvec[ar, j_idx] = (v0i - v2i) / s

    coeff = np.stack([n, avec, bvec], axis=1).astype(np.float32)
    const = np.stack([k, a0, b0, np.linalg.norm(n, axis=-1)],
                     axis=-1).astype(np.float32)
    pad = (-num) % chunk
    if pad:
        coeff = np.concatenate([coeff, np.zeros((pad, 3, 3), np.float32)])
        const = np.concatenate([const, np.zeros((pad, 4), np.float32)])
    return StreamTris(torch.from_numpy(coeff), torch.from_numpy(const))


def _dots(r, w):
    """[..., B, CH] = r . w for rays r [..., B, 3] and rows w [..., CH, 3],
    summed left to right."""
    return (r[..., 0:1] * w[..., None, :, 0] + r[..., 1:2] * w[..., None, :, 1]
            + r[..., 2:3] * w[..., None, :, 2])


def _chunk_test(p, d, coeff, const):
    """All rays vs one triangle chunk (coeff [..., CH, 3, 3], const
    [..., CH, 4]; leading dims batch rays [..., B, 3] against their own
    chunk): t [..., B, CH], BIGFLOAT where the predicate fails."""
    n, av, bv = coeff[..., 0, :], coeff[..., 1, :], coeff[..., 2, :]
    pn, dn = _dots(p, n), _dots(d, n)
    pa, da = _dots(p, av), _dots(d, av)
    pb, db = _dots(p, bv), _dots(d, bv)
    k, a0, b0, nl = (const[..., None, :, i] for i in range(4))
    safe = torch.where(torch.abs(dn) < 1e-30, torch.full_like(dn, 1e-30), dn)
    t = (k - pn) / safe
    parallel = torch.abs(dn) < 1e-7 * nl
    a = pa + t * da + a0
    b = pb + t * db + b0
    c = 1.0 - a - b
    ok = ~parallel & (t > BIAS) & (a >= 0.0) & (b >= 0.0) & (c >= 0.0)
    return torch.where(ok, t, torch.full_like(t, BIGFLOAT))


def top2(t):
    """Per row of t [B, K]: (t1, i1, t2, i2), the smallest and the runner-up
    (first index on ties, as jnp.argmin)."""
    i1 = torch.argmin(t, dim=1)
    t1 = torch.gather(t, 1, i1[:, None])[:, 0]
    col = torch.arange(t.shape[1], device=t.device)[None, :]
    t_wo = torch.where(col == i1[:, None], torch.full_like(t, BIGFLOAT), t)
    i2 = torch.argmin(t_wo, dim=1)
    t2 = torch.gather(t_wo, 1, i2[:, None])[:, 0]
    return t1, i1.to(torch.int32), t2, i2.to(torch.int32)


def merge_top2(t_best, r_best, t2_best, r2_best, t1, r1, t2, r2):
    """Merge a running top-2 with a step's top-2 (stable: earlier wins
    ties)."""
    cand_t = torch.stack([t_best, t2_best, t1, t2], dim=1)
    cand_r = torch.stack([r_best, r2_best, r1, r2], dim=1)
    order = torch.argsort(cand_t, dim=1, stable=True)[:, :2]
    top_t = torch.gather(cand_t, 1, order)
    top_r = torch.gather(cand_r, 1, order)
    return top_t[:, 0], top_r[:, 0], top_t[:, 1], top_r[:, 1]


def stream_closest(p, d, t_cur, stream: StreamTris,
                   chunk: int = STREAM_CHUNK):
    """Dense sweep closest hit: (t [B], gid [B] or -1, gid2 [B] or -1).

    t is the sweep's winner distance; exact attributes come from
    exact_winner. gid2 is the runner-up: the linear-in-t predicate can
    disagree with the exact test near triangle edges, and a caller falls
    back to it when the winner fails the exact re-test."""
    num = p.shape[0]
    total = stream.coeff.shape[0]
    if total % chunk:
        raise ValueError(f"stream length {total} is not a multiple of the "
                         f"chunk {chunk}")
    dev = p.device
    t_best = t_cur.clone()
    gid_best = torch.full((num,), -1, dtype=torch.int32, device=dev)
    t2_best = torch.full((num,), BIGFLOAT, device=dev)
    gid2_best = gid_best.clone()
    for c in range(total // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        t = _chunk_test(p, d, stream.coeff[sl], stream.const[sl])
        t1, i1, t2, i2 = top2(t)
        t_best, gid_best, t2_best, gid2_best = merge_top2(
            t_best, gid_best, t2_best, gid2_best, t1, i1 + c * chunk, t2,
            i2 + c * chunk)
    # The runner-up counts only where it is a live hit (not the t_cur seed).
    gid2_best = torch.where(t2_best < BIGFLOAT, gid2_best,
                            torch.full_like(gid2_best, -1))
    return t_best, gid_best, gid2_best


def stream_any_hit(p, d, t_max, stream: StreamTris,
                   chunk: int = STREAM_CHUNK):
    """Dense sweep occlusion: True where a triangle has BIAS < t < t_max."""
    total = stream.coeff.shape[0]
    if total % chunk:
        raise ValueError(f"stream length {total} is not a multiple of the "
                         f"chunk {chunk}")
    occ = torch.zeros(p.shape[0], dtype=torch.bool, device=p.device)
    for c in range(total // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        t = _chunk_test(p, d, stream.coeff[sl], stream.const[sl])
        occ = occ | (t < t_max[:, None]).any(dim=1)
    return occ


def exact_winner(p, d, gid, tri_v):
    """The reference-exact triangle test of each ray's winning triangle:
    (t, bary, front, hit), t BIGFLOAT where there is none."""
    v = tri_v[gid.clamp_min(0).long()]
    t, bary, front, hit = intersect_triangles(
        p, d, v[:, 0], v[:, 1], v[:, 2],
        torch.full(p.shape[:1], BIGFLOAT, device=p.device))
    valid = hit & (gid >= 0)
    return (torch.where(valid, t, torch.full_like(t, BIGFLOAT)), bary, front,
            valid)
