"""Cluster-culled photon gather (kernel K5, csrc/photon.cu) beside its plain
version, and the record gather of the megakernel's global map.

Counterpart of qaray_tpu/ops/pallas_photon.py: pallas_gather ->
photon_gather, _morton_keys, gather_apply. photon_gather sweeps a
clustered photon map (photon/cluster.py) for each query point and returns
the un-normalized sums (irradiance sum [B,3], direction sum [B,3], count
[B]): divided by pi/2 r^2 they equal photon/gather.py's capped estimate
wherever at most GATHER_K photons lie in the radius; callers flag the
other lanes for the exact estimate.

For tensors on the CPU photon_gather runs the plain version,
photon_gather_plain, which sums the same terms in the same row order; for
CUDA tensors it launches K5 (a warp to each active query, culled against
that query alone), never falling back from one to the other. gather_apply
sorts the queries with a record to the front and passes their count in
device memory, so that only those take a warp. `launches` counts kernel
launches.
"""

import math

import numpy as np
import torch

from qaray_tpu_torch.core.constants import BIGFLOAT, COLOR_LUMA_THRESHOLD
from qaray_tpu_torch.core.krng import MASK
from qaray_tpu_torch.core.vecmath import dot, luma, normalize, pow_safe
from qaray_tpu_torch.photon.cluster import GATHER_K, PHOTON_CLUSTER
from qaray_tpu_torch.photon.gather import radius2

launches = {"K5": 0}

# K5's grid: blocks of GATHER_WARPS warps, a warp a query, at most
# GATHER_MAX_BLOCKS blocks (16 blocks of 128 threads on each of the H100's
# 132 SMs), which stride over the queries.
GATHER_WARPS = 4
GATHER_MAX_BLOCKS = 132 * 16
HOST_BLOCKS = 2  # photon_gather_host's grid

_fns = {}


def _kernel(host: bool = False):
    """qr_photon_gather of the CUDA library, or with host=True of the same
    source built for the CPU (_build.load_host; tests only)."""
    if host not in _fns:
        from qaray_tpu_torch.ops import _build

        lib = (_build.load_host if host else _build.load)("photon")
        _fns[host] = _build.bind(lib, "qr_photon_gather", "ppppifipippp")
        if host:
            _fns["host_block"] = _build.bind(lib, "qr_host_set_block", "i")
    return _fns[host]


def gather_warps(num: int) -> int:
    """Warps of K5's grid for num queries."""
    return min(-(-num // GATHER_WARPS), GATHER_MAX_BLOCKS) * GATHER_WARPS


def check_tables(ctable, cbounds, device):
    """Raise unless (ctable, cbounds) are the contiguous float32 [C*128, 16]
    and [C, 8] tables of photon/cluster.py on `device`."""
    for t, cols in ((ctable, 16), (cbounds, 8)):
        if (t is None or t.device != device or t.dtype != torch.float32
                or t.ndim != 2 or t.shape[1] != cols
                or not t.is_contiguous()):
            raise ValueError(f"photon tables must be contiguous float32 "
                             f"[rows, {cols}] on {device} "
                             "(photon.cluster.cluster_photon_map)")
    if ctable.shape[0] != cbounds.shape[0] * PHOTON_CLUSTER:
        raise ValueError(f"{ctable.shape[0]} photon rows for "
                         f"{cbounds.shape[0]} clusters of {PHOTON_CLUSTER}")


def _check(ctable, cbounds, p, active):
    check_tables(ctable, cbounds, p.device)
    if p.dtype != torch.float32 or p.ndim != 2 or p.shape[1] != 3:
        raise ValueError(f"queries must be float32 [B, 3], got {p.dtype} "
                         f"{tuple(p.shape)}")
    if active.device != p.device or active.shape != p.shape[:1]:
        raise ValueError("active must be [B] on the queries' device")


def photon_gather_plain(ctable, cbounds, radius, p, active=None):
    """The plain version of K5: every query against every photon row in row
    order, with the kernel's operations (no cull: a culled cluster adds
    only zeros)."""
    num = p.shape[0]
    act = (torch.ones(num, dtype=torch.float32, device=p.device)
           if active is None else active.to(torch.float32))
    _check(ctable, cbounds, p, act)
    r2 = radius2(radius)
    inv_r2 = float(np.float32(1.0) / np.float32(r2))
    acc = torch.zeros((num, 6), dtype=torch.float32, device=p.device)
    cnt = torch.zeros(num, dtype=torch.float32, device=p.device)
    for lo in range(0, ctable.shape[0], PHOTON_CLUSTER):
        rows = ctable[lo:lo + PHOTON_CLUSTER]
        ex = p[:, 0:1] - rows[None, :, 0]
        ey = p[:, 1:2] - rows[None, :, 1]
        ez = p[:, 2:3] - rows[None, :, 2]
        d2 = ex * ex + ey * ey + ez * ez
        inr = d2 < r2
        w = torch.where(inr, 1.0 - d2 * inv_r2, 0.0)
        inr = inr.to(torch.float32)
        vals = rows[:, 3:9]
        for j in range(rows.shape[0]):
            acc = acc + w[:, j:j + 1] * vals[j]
            cnt = cnt + inr[:, j]
    acc = acc * act[:, None]
    return acc[:, 0:3], acc[:, 3:6], cnt * act


def photon_gather(ctable, cbounds, radius, p, active=None, count=None,
                  work=None):
    """Filtered power sums [B,3], direction sums [B,3] and in-radius counts
    [B] (float32) of the clustered map (ctable, cbounds) at query points p
    [B,3]; zeros where active [B] is false or 0. K5 on a card, the plain
    version on the CPU.

    count: optional int32 tensor of one element on the queries' device, the
    number of leading queries among which every active one lies (none after
    it), so that the kernel gathers only those and no host sync is needed
    (gather_apply). work: optional int32 [B], filled with the clusters each
    query visited (CUDA only)."""
    num = p.shape[0]
    act = (torch.ones(num, dtype=torch.float32, device=p.device)
           if active is None else active.to(torch.float32))
    if p.device.type == "cpu":
        return photon_gather_plain(ctable, cbounds, radius, p, act)
    out = _gather(_kernel(), torch.cuda.current_stream().cuda_stream,
                  ctable, cbounds, radius, p, act, count, work)
    if num:
        launches["K5"] += 1
    return out


def photon_gather_host(ctable, cbounds, radius, p, active=None, count=None,
                       work=None):
    """photon_gather's kernel source run on the CPU on CPU tensors
    (_build.load_host), each warp a block of 32 threads, in a grid of
    HOST_BLOCKS blocks that strides over the queries (a host thread is
    dear). For tests without a card: no entry point calls it and it counts
    no launch."""
    if p.device.type != "cpu":
        raise ValueError("photon_gather_host takes CPU tensors")
    num = p.shape[0]
    act = (torch.ones(num, dtype=torch.float32)
           if active is None else active.to(torch.float32))
    fn = _kernel(host=True)
    from qaray_tpu_torch.ops import _build

    _build.check(_fns["host_block"](32), "host block size")
    try:
        return _gather(fn, None, ctable, cbounds, radius, p, act, count, work,
                       HOST_BLOCKS)
    finally:
        _fns["host_block"](1)


def _gather(fn, stream, ctable, cbounds, radius, p, act, count, work,
            max_blocks=GATHER_MAX_BLOCKS):
    """Check the tables and call qr_photon_gather `fn` on `stream` with at
    most max_blocks blocks."""
    _check(ctable, cbounds, p, act)
    num = p.shape[0]
    dev = p.device
    if count is not None and (count.device != dev
                              or count.dtype != torch.int32
                              or count.numel() != 1):
        raise ValueError("count must be one int32 on the queries' device")
    if work is not None and (work.device != dev or work.dtype != torch.int32
                             or work.shape != (num,)
                             or not work.is_contiguous()):
        raise ValueError("work must be a contiguous int32 [B] tensor on "
                         "the queries' device")
    out = torch.empty((num, 7), dtype=torch.float32, device=dev)
    if num:
        from qaray_tpu_torch.ops import _build

        p, act = p.contiguous(), act.contiguous()
        rc = fn(p.data_ptr(), act.data_ptr(), ctable.data_ptr(),
                cbounds.data_ptr(), cbounds.shape[0], radius2(radius), num,
                count.data_ptr() if count is not None else None,
                min(gather_warps(num) // GATHER_WARPS, max_blocks),
                out.data_ptr(),
                work.data_ptr() if work is not None else None, stream)
        _build.check(rc, "K5 photon gather")
    return out[:, 0:3], out[:, 3:6], out[:, 6]


# ---------------------------------------------------------------------------
# Record gathering: Morton-sort the queries, gather those with a record
# ---------------------------------------------------------------------------


def _spread(v):
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v & MASK


def _morton_keys(p, valid):
    """[B,3] points -> 30-bit Morton codes over the valid points' box, as
    int64 tensors. Invalid lanes get 0x7FFFFFFF, so the sort packs them at
    the tail, past the valid lanes K5 gathers."""
    lo = torch.where(valid[:, None], p, BIGFLOAT).amin(dim=0)
    hi = torch.where(valid[:, None], p, -BIGFLOAT).amax(dim=0)
    ext = torch.clamp_min(hi - lo, 1e-12)
    q = torch.clamp((p - lo) / ext * 1023.0, 0.0, 1023.0).to(torch.int64)
    key = (_spread(q[:, 0]) | (_spread(q[:, 1]) << 1)
           | (_spread(q[:, 2]) << 2)) & MASK
    return torch.where(valid, key, 0x7FFFFFFF)


def gather_apply(gmap, rec):
    """Per-lane gather records against a clustered photon map.

    rec: 17 [B] float32 tensors in the megakernel's capture order: p(3),
    n(3), v(3), beta*diffuse(3), beta*specular(3), glossiness, valid. The
    records are Morton-sorted (a stable sort), gathered (photon_gather: K5
    on a card), normalized by pi/2 r^2, Blinn-combined with gather_blinn's
    luma gate (photon/gather.py) and put back in lane order. Returns the
    contribution [B,3] (beta folded in, zero on invalid lanes) and the
    escalation mask [B]: valid lanes whose count exceeds GATHER_K."""
    packed = torch.stack(list(rec), dim=-1)  # [B, 17]
    num = packed.shape[0]
    if num == 0:
        return packed[:, 0:3], packed[:, 16] > 0.5
    valid = packed[:, 16] > 0.5
    _, si = torch.sort(_morton_keys(packed[:, 0:3], valid), stable=True)
    ps = packed[si]
    act_s = ps[:, 16]
    # The sort puts the lanes with a record first: K5 gathers only those.
    irr_sums, dirsum, cnt = photon_gather(
        gmap.ctable, gmap.cbounds, gmap.radius, ps[:, 0:3].contiguous(),
        act_s, count=valid.sum(dtype=torch.int32).reshape(1))
    r2 = radius2(gmap.radius)
    irrad = irr_sums / float(np.float32(math.pi * 0.5) * np.float32(r2))
    # gather_blinn's combine (MtlBlinn_PhotonMap.cpp:426-458).
    l_dir = -normalize(dirsum, eps=1e-30)
    n = ps[:, 3:6]
    v = ps[:, 6:9]
    h = normalize(v + l_dir, eps=1e-30)
    cos_nl = torch.clamp_min(dot(n, l_dir), 0.0)
    cos_nh = torch.clamp_min(dot(n, h), 0.0)
    c = irrad * cos_nl[:, None] * (
        ps[:, 9:12] + ps[:, 12:15] * pow_safe(cos_nh, ps[:, 15])[:, None])
    gate = (act_s > 0.5) & (luma(irrad) > COLOR_LUMA_THRESHOLD)
    c = torch.where(gate[:, None], c, 0.0)
    esc_s = (act_s > 0.5) & (cnt > float(GATHER_K))
    inv = torch.empty_like(si)
    inv[si] = torch.arange(num, device=si.device)
    return c[inv], esc_s[inv]
