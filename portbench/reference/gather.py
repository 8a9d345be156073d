"""Exact photon irradiance estimates in plain PyTorch.

Counterpart of qaray_tpu/photon/gather.py, which computes all of this
outside any Pallas kernel. The reference gathers with a kd-tree
(cyPhotonMap.h EstimateIrradiance<100>): up to the 100 nearest photons
within the radius, the quadratic filter 1 - d^2/r^2, the area pi/2 * r^2
and a filter-weighted mean photon direction. Here every query scores every
photon: the filtered sums are [Qc, P] x [P, 3] products, and the cap is
applied exactly. The kd heap's final dist2[0] is the distance of the
100th-nearest photon when more than 100 lie in the radius, and both the
filter and the area then use it. That distance is the k-th smallest entry
of the query's distance row (torch.topk of -d^2; the k-th value is the
same whichever algorithm finds it).

The wavefront engine uses these (gather_blinn); the megakernel route
gathers with the cluster-culled kernels instead (ops/photon.py) and sends
lanes over the cap back here.
"""

import math
from typing import NamedTuple, Optional

import torch

from . import precision as PR

from .constants import COLOR_LUMA_THRESHOLD
from .vecmath import dot, luma, normalize, pow_safe


class PhotonMapData(NamedTuple):
    pos: torch.Tensor  # [P, 3]
    power: torch.Tensor  # [P, 3] RGB power (already 1/numEmitted scaled)
    max_power: torch.Tensor  # [P] max component (direction weighting)
    direction: torch.Tensor  # [P, 3] incoming photon direction
    # [] float32 gather radius, kept on the CPU: the gathers and kernels
    # take its value as an argument.
    radius: torch.Tensor
    valid: torch.Tensor  # [P] bool (padding mask)
    # Clustered tables of photon/cluster.py for the gather kernels (K5,
    # K1d); None on maps that feed only the exact gathers below.
    ctable: Optional[torch.Tensor] = None  # [Fp, 16]
    cbounds: Optional[torch.Tensor] = None  # [C, 8]


def radius2(radius) -> float:
    """A radius (float or 0-d tensor) -> its square as float32 arithmetic
    gives it, as a float."""
    r = torch.as_tensor(radius, dtype=torch.float32).cpu()
    return float(r * r)


# Above this map size the one-shot [Qc, P] distance block and the top-k over
# P give way to the two-pass streaming gather.
_STREAM_THRESHOLD = 32768
_P_CHUNK = 2048  # photon chunk of the streaming passes
# Query rows per step: the JAX package's 1,024 on the CPU; on a card, as
# many as keep one [Qc, P] float32 block near 1 GiB.
_CPU_Q_CHUNK = 1024
_CUDA_BLOCK_FLOATS = 1 << 28


def _q_chunk(q_chunk, p, num_cols: int) -> int:
    if q_chunk is None:
        q_chunk = (_CPU_Q_CHUNK if p.device.type == "cpu"
                   else max(_CPU_Q_CHUNK, _CUDA_BLOCK_FLOATS // num_cols))
    return max(1, min(q_chunk, p.shape[0]))


def _pad_rows(a, pad: int, value=0):
    if not pad:
        return a
    return torch.cat([a, torch.full((pad,) + tuple(a.shape[1:]), value,
                                    dtype=a.dtype, device=a.device)])


def _d2(q, pos):
    """[Q, 3] x [P, 3] -> [Q, P] squared distances, summed x, y, z."""
    dx = q[:, None, 0] - pos[None, :, 0]
    dy = q[:, None, 1] - pos[None, :, 1]
    dz = q[:, None, 2] - pos[None, :, 2]
    return dx * dx + dy * dy + dz * dz


def estimate_irradiance(pmap: PhotonMapData, p, chunk: int = 512,
                        max_photons: Optional[int] = 100, q_chunk=None):
    """Quadratic-filtered irradiance [B, 3] and mean direction [B, 3] at
    query points p [B, 3] (cyPhotonMap::EstimateIrradiance,
    FILTER_TYPE_QUADRATIC):

        irrad = sum_i (1 - d_i^2 / r_eff^2) * power_i / (pi/2 * r_eff^2)
        dir   = normalize(sum_i (1 - d_i^2 / r_eff^2) * maxPower_i * dir_i)

    with r_eff^2 = min(radius^2, d^2 of the max_photons-th nearest photon)
    where more than max_photons lie in the radius (cyPhotonMap.h:356-357,
    385). max_photons=None drops the cap (all in-radius photons, r_eff =
    radius) and sweeps photon chunks of `chunk`."""
    if max_photons is not None:
        if pmap.pos.shape[0] > _STREAM_THRESHOLD:
            return _estimate_capped_stream(pmap, p, max_photons, q_chunk)
        return _estimate_capped(pmap, p, max_photons, q_chunk)
    return _estimate_uncapped(pmap, p, chunk)


def _capped_radius(count, kth, r2: float, k: int):
    """dist2[0] shrinks to the k-th nearest distance only when STRICTLY
    MORE than k photons lie in the radius (cyPhotonMap.h:497)."""
    r_eff2 = torch.where(count > k, torch.clamp_max(kth, r2),
                         torch.full_like(kth, r2))
    return torch.clamp_min(r_eff2, 1e-30)


def _estimate_capped_stream(pmap: PhotonMapData, p, max_photons: int,
                            q_chunk=None):
    """The exact capped estimate at large maps (100k-1M photons), with the
    photon axis streamed in chunks: pass 1 merges a running top-k set of
    distances per query and counts in-radius photons, which gives the
    shrunken radius; pass 2 streams the chunks again and sums the filtered
    terms as [Qc, C] x [C, 3] products. Memory O(Qc * (k + C))."""
    num_photons = pmap.pos.shape[0]
    r2 = radius2(pmap.radius)
    k = min(max_photons, num_photons)
    pad = (-num_photons) % _P_CHUNK
    pos = _pad_rows(pmap.pos, pad)
    power = _pad_rows(pmap.power, pad)
    maxp = _pad_rows(pmap.max_power, pad)
    pdir = _pad_rows(pmap.direction, pad)
    valid = _pad_rows(pmap.valid, pad, False)
    n_pc = (num_photons + pad) // _P_CHUNK
    qc_rows = _q_chunk(q_chunk, p, _P_CHUNK + k)
    irr_out, dir_out = [], []
    for lo in range(0, p.shape[0], qc_rows):
        qc = p[lo:lo + qc_rows]
        topk = torch.full((qc.shape[0], k), math.inf, dtype=PR.dtype(),
                          device=p.device)
        count = torch.zeros(qc.shape[0], dtype=torch.int64, device=p.device)
        for c in range(n_pc):
            sl = slice(c * _P_CHUNK, (c + 1) * _P_CHUNK)
            d2 = torch.where(valid[None, sl], _d2(qc, pos[sl]), math.inf)
            merged = torch.cat([topk, d2], dim=1)
            topk = -torch.topk(-merged, k, dim=1).values
            count = count + (d2 < r2).sum(dim=-1)
        r_eff2 = _capped_radius(count, topk[:, -1], r2, k)
        irrad = torch.zeros((qc.shape[0], 3), dtype=PR.dtype(),
                            device=p.device)
        dsum = torch.zeros_like(irrad)
        for c in range(n_pc):
            sl = slice(c * _P_CHUNK, (c + 1) * _P_CHUNK)
            d2 = torch.where(valid[None, sl], _d2(qc, pos[sl]), math.inf)
            w = torch.clamp_min(1.0 - d2 / r_eff2[:, None], 0.0)
            irrad = irrad + w @ power[sl]
            dsum = dsum + (w * maxp[None, sl]) @ pdir[sl]
        area = math.pi * 0.5 * r_eff2
        irr_out.append(irrad / area[:, None])
        dir_out.append(normalize(dsum, eps=1e-30))
    return _cat(irr_out, p), _cat(dir_out, p)


def _cat(parts, p):
    if not parts:
        return torch.zeros((0, 3), dtype=PR.dtype(), device=p.device)
    return torch.cat(parts)


def _estimate_capped(pmap: PhotonMapData, p, max_photons: int,
                     q_chunk=None):
    num_photons = pmap.pos.shape[0]
    r2 = radius2(pmap.radius)
    pad = (-num_photons) % 128
    pos = _pad_rows(pmap.pos, pad)
    power = _pad_rows(pmap.power, pad)
    maxp = _pad_rows(pmap.max_power, pad)
    pdir = _pad_rows(pmap.direction, pad)
    valid = _pad_rows(pmap.valid, pad, False)
    k = min(max_photons, num_photons + pad)
    qc_rows = _q_chunk(q_chunk, p, num_photons + pad)
    irr_out, dir_out = [], []
    for lo in range(0, p.shape[0], qc_rows):
        qc = p[lo:lo + qc_rows]
        d2 = torch.where(valid[None, :], _d2(qc, pos), math.inf)
        kth = -torch.topk(-d2, k, dim=1).values[:, -1]
        count = (d2 < r2).sum(dim=-1)
        r_eff2 = _capped_radius(count, kth, r2, k)
        w = torch.clamp_min(1.0 - d2 / r_eff2[:, None], 0.0)  # inf -> 0
        irrad = w @ power
        dsum = (w * maxp[None, :]) @ pdir
        del d2, w
        area = math.pi * 0.5 * r_eff2
        irr_out.append(irrad / area[:, None])
        dir_out.append(normalize(dsum, eps=1e-30))
    return _cat(irr_out, p), _cat(dir_out, p)


def _estimate_uncapped(pmap: PhotonMapData, p, chunk: int = 512):
    num_photons = pmap.pos.shape[0]
    r2 = radius2(pmap.radius)
    irrad = torch.zeros((p.shape[0], 3), dtype=PR.dtype(),
                        device=p.device)
    dsum = torch.zeros_like(irrad)
    for lo in range(0, num_photons, chunk):
        sl = slice(lo, lo + chunk)
        d2 = _d2(p, pmap.pos[sl])
        w = torch.clamp_min(1.0 - d2 / r2, 0.0)
        w = torch.where((d2 < r2) & pmap.valid[None, sl], w, 0.0)
        irrad = irrad + w @ pmap.power[sl]
        dsum = dsum + (w * pmap.max_power[None, sl]) @ pmap.direction[sl]
    area = max(float(torch.tensor(math.pi * 0.5, dtype=torch.float32)
                     * torch.tensor(r2, dtype=torch.float32)), 1e-30)
    return irrad / area, normalize(dsum, eps=1e-30)


def gather_blinn(pmap: PhotonMapData, p, n, v, diffuse, specular,
                 glossiness):
    """Blinn-weighted photon gather (MtlBlinn_PhotonMap.cpp:426-458):
        L = -normalize(D); H = normalize(V + L)
        contribution = I * cosNL * (diffuse + specular * cosNH^gloss)
    zeroed where the estimate's luma is under the reference threshold."""
    irrad, d = estimate_irradiance(pmap, p)
    l_dir = -d
    h = normalize(v + l_dir, eps=1e-30)
    cos_nl = torch.clamp_min(dot(n, l_dir), 0.0)
    cos_nh = torch.clamp_min(dot(n, h), 0.0)
    c = irrad * cos_nl[:, None] * (
        diffuse + specular * pow_safe(cos_nh, glossiness)[:, None])
    return torch.where((luma(irrad) > COLOR_LUMA_THRESHOLD)[:, None], c, 0.0)
