"""Analytic closest-hit and shadow kernels, each beside its plain version.

Counterpart of qaray_tpu/ops/pallas_analytic.py. The kernels live in
csrc/analytic.cu:

    K2a  closest          (t, prim)                 <- _kernel
    K2b  closest_full     closest hit + attributes  <- _kernel_full
    K2c  shadow           any hit below t_max       <- _shadow_kernel

A wrapper runs the plain PyTorch version for tensors on the CPU and the
kernel for CUDA tensors; it never falls back from one to the other.
`launches` counts kernel launches, one per call that launched.

closest and closest_full are differentiable, as the JAX package's
closest_analytic_pallas and closest_analytic_full_pallas custom_vjp are:
two torch.autograd.Functions whose forward is the kernel (or, on the CPU,
its plain version) and whose backward re-derives only the winner's t in
plain torch (_winner_t), giving gradients for p, d, m_w2o and t_o2w. In
the JAX package that backward is XLA code, not a Pallas kernel, so plain
torch is its counterpart here. The winner's attributes (n, uvw, p, front)
carry no gradient: they hold only geometry sensitivities, which the
detached-sampling estimator leaves out (diff.py).
"""

import torch

from qaray_tpu_torch.core.constants import BIAS, BIGFLOAT, PLANE_EPS
from qaray_tpu_torch.ops import intersect as I
from qaray_tpu_torch.scene.arrays import KIND_SPHERE, AnalyticPrims

launches = {"K2a": 0, "K2b": 0, "K2c": 0}

_fns = {}


def _lib():
    if not _fns:
        from qaray_tpu_torch.ops import _build

        lib = _build.load("analytic")
        _fns["closest"] = _build.bind(lib, "qr_closest", "ppippippp")
        _fns["full"] = _build.bind(lib, "qr_closest_full",
                                   "ppipppipppppppp")
        _fns["shadow"] = _build.bind(lib, "qr_shadow", "pppippipp")
        _fns["check"] = _build.check
    return _fns


def _check_rays(p, d, prims: AnalyticPrims, t_max=None):
    """Device, dtype, shape and contiguity checks of a kernel call."""
    tensors = [p, d, prims.table, prims.kind]
    if t_max is not None:
        tensors.append(t_max)
    dev = p.device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
    for t in (p, d):
        if t.dtype != torch.float32 or t.ndim != 2 or t.shape[1] != 3:
            raise ValueError(f"rays must be float32 [B, 3], got {t.dtype} "
                             f"{tuple(t.shape)}")
    if d.shape != p.shape:
        raise ValueError("p and d differ in shape")
    if t_max is not None and (t_max.dtype != torch.float32
                              or t_max.shape != p.shape[:1]):
        raise ValueError("t_max must be float32 [B]")
    num_p = prims.kind.shape[0]
    if (prims.table.dtype != torch.float32
            or prims.table.shape != (num_p, 12)
            or not prims.table.is_contiguous()
            or any(t.dtype != torch.int32 or not t.is_contiguous()
                   for t in (prims.kind, prims.mtl))):
        raise ValueError("prims.table must be contiguous float32 [P, 12], "
                         "prims.kind and prims.mtl contiguous int32 [P] "
                         "(analytic_prims)")


def _ptr(t):
    return t.data_ptr()


def _stream():
    return torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------------------
# K2a: closest (t, prim)
# ---------------------------------------------------------------------------


def closest_plain(p, d, prims: AnalyticPrims):
    return I.closest_analytic(p, d, prims)


def closest(p, d, prims: AnalyticPrims):
    """Closest analytic hit: (t [B] float32, prim [B] int32);
    differentiable in t (_Closest)."""
    _check_rays(p, d, prims)
    return _Closest.apply(p, d, prims.m_w2o, prims.t_o2w, prims)


def _closest_fwd(p, d, prims: AnalyticPrims):
    if p.device.type == "cpu":
        return closest_plain(p, d, prims)
    n = p.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=p.device)
    idx = torch.empty(n, dtype=torch.int32, device=p.device)
    if n == 0:
        return t, idx
    tab, kinds = prims.table, prims.kind
    p, d = p.contiguous(), d.contiguous()
    f = _lib()
    f["check"](f["closest"](_ptr(p), _ptr(d), n, _ptr(tab), _ptr(kinds),
                            tab.shape[0], _ptr(t), _ptr(idx), _stream()),
               "K2a closest")
    launches["K2a"] += 1
    return t, idx


# ---------------------------------------------------------------------------
# K2b: closest hit + attributes
# ---------------------------------------------------------------------------


def closest_full_plain(p, d, prims: AnalyticPrims):
    t, idx = I.closest_analytic(p, d, prims)
    t_attr = torch.where(t < BIGFLOAT, t, torch.ones_like(t))
    out = I.analytic_hit_attrs(p, d, t_attr, idx, prims)
    out["t"] = t
    out["prim_idx"] = idx
    return out


_FULL_KEYS = ("t", "prim_idx", "mtl", "n", "uvw", "front", "p",
              "has_texture")


def closest_full(p, d, prims: AnalyticPrims):
    """Closest hit and the winner's attributes: t, prim_idx, p (world hit
    point at t, or at t=1 on a miss), n (world, unit), uvw, front, mtl,
    has_texture. Miss lanes carry benign values (prim 0 on the kernel; the
    plain version evaluates prim 0 at t=1). Differentiable in t only
    (_ClosestFull)."""
    _check_rays(p, d, prims)
    out = _ClosestFull.apply(p, d, prims.m_w2o, prims.t_o2w, prims)
    return dict(zip(_FULL_KEYS, out))


def _closest_full_fwd(p, d, prims: AnalyticPrims):
    if p.device.type == "cpu":
        return closest_full_plain(p, d, prims)
    n = p.shape[0]
    dev = p.device
    t = torch.empty(n, dtype=torch.float32, device=dev)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    nrm = torch.empty((n, 3), dtype=torch.float32, device=dev)
    uvw = torch.empty((n, 3), dtype=torch.float32, device=dev)
    front = torch.empty(n, dtype=torch.bool, device=dev)
    mtl = torch.empty(n, dtype=torch.int32, device=dev)
    hp = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if n:
        tab, kinds = prims.table, prims.kind
        p, d = p.contiguous(), d.contiguous()
        f = _lib()
        f["check"](f["full"](_ptr(p), _ptr(d), n, _ptr(tab), _ptr(kinds),
                             _ptr(prims.mtl), tab.shape[0], _ptr(t),
                             _ptr(idx), _ptr(nrm), _ptr(uvw), _ptr(front),
                             _ptr(mtl), _ptr(hp), _stream()),
                   "K2b closest_full")
        launches["K2b"] += 1
    return {
        "t": t,
        "prim_idx": idx,
        "mtl": mtl,
        "n": nrm,
        "uvw": uvw,
        "front": front,
        "p": hp,
        "has_texture": torch.ones(n, dtype=torch.bool, device=dev),
    }


# ---------------------------------------------------------------------------
# Backward rules (pallas_analytic._closest_bwd / _closest_full_bwd)
# ---------------------------------------------------------------------------


def _winner_t(p, d, m_w2o, t_o2w, kind, idx, t_fwd):
    """Differentiable re-derivation of the winning primitive's t
    (pallas_analytic._winner_t): the winner alone per lane, the kernels'
    sphere and plane math with the square root's argument clamped to
    1e-12 (finite gradients at grazing hits). Miss lanes give 0."""
    i = idx.long()
    m = m_w2o[i]
    po = I._apply(m, p - t_o2w[i])
    do = I._apply(m, d)
    a = (do * do).sum(-1)
    b = 2.0 * (po * do).sum(-1)
    c = (po * po).sum(-1) - 1.0
    sq = torch.sqrt(torch.clamp_min(b * b - 4.0 * a * c, 1e-12))
    rcp2a = 0.5 / torch.clamp_min(a, 1e-20)
    t1 = (-b - sq) * rcp2a
    t2 = (-b + sq) * rcp2a
    t_sph = torch.where(t1 > BIAS, t1, t2)
    doz = do[..., 2]
    safe = torch.where(torch.abs(doz) < PLANE_EPS,
                       torch.full_like(doz, PLANE_EPS), doz)
    t_pln = -po[..., 2] / safe
    tw = torch.where(kind[i] == KIND_SPHERE, t_sph, t_pln)
    return torch.where(t_fwd < BIGFLOAT, tw, torch.zeros_like(tw))


def _winner_grads(ctx, dt):
    """Gradients of the saved winner's t for (p, d, m_w2o, t_o2w)."""
    p, d, m_w2o, t_o2w, t, idx = ctx.saved_tensors
    need = ctx.needs_input_grad[:4]
    if dt is None or not any(need):
        return (None,) * 4
    with torch.enable_grad():
        ins = [x.detach().requires_grad_(w)
               for x, w in zip((p, d, m_w2o, t_o2w), need)]
        tw = _winner_t(*ins, ctx.kind, idx, t)
        wrt = [x for x, w in zip(ins, need) if w]
        got = iter(torch.autograd.grad(tw, wrt, dt, allow_unused=True))
    return tuple(next(got) if w else None for w in need)


class _Closest(torch.autograd.Function):
    """closest_analytic_pallas: K2a (plain version on the CPU) forward,
    winner-only backward."""

    @staticmethod
    def forward(ctx, p, d, m_w2o, t_o2w, prims):
        t, idx = _closest_fwd(p, d, prims)
        ctx.kind = prims.kind
        ctx.save_for_backward(p, d, m_w2o, t_o2w, t, idx)
        ctx.mark_non_differentiable(idx)
        return t, idx

    @staticmethod
    def backward(ctx, dt, _didx):
        return (*_winner_grads(ctx, dt), None)


class _ClosestFull(torch.autograd.Function):
    """closest_analytic_full_pallas: K2b (plain version on the CPU)
    forward, winner-only backward; the attributes are detached."""

    @staticmethod
    def forward(ctx, p, d, m_w2o, t_o2w, prims):
        full = _closest_full_fwd(p, d, prims)
        out = tuple(full[k] for k in _FULL_KEYS)
        ctx.kind = prims.kind
        ctx.save_for_backward(p, d, m_w2o, t_o2w, full["t"],
                              full["prim_idx"])
        ctx.mark_non_differentiable(*out[1:])
        return out

    @staticmethod
    def backward(ctx, dt, *_attrs):
        return (*_winner_grads(ctx, dt), None)


# ---------------------------------------------------------------------------
# K2c: shadow any-hit
# ---------------------------------------------------------------------------


def shadow_plain(p, d, t_max, prims: AnalyticPrims):
    t_all = I.intersect_analytic_t(p, d, prims)
    return (t_all < t_max[:, None]).any(dim=-1)


def shadow(p, d, t_max, prims: AnalyticPrims):
    """Occluded [B] bool: some primitive has BIAS < t < t_max."""
    _check_rays(p, d, prims, t_max)
    if p.device.type == "cpu":
        return shadow_plain(p, d, t_max, prims)
    n = p.shape[0]
    occ = torch.empty(n, dtype=torch.bool, device=p.device)
    if n == 0:
        return occ
    tab, kinds = prims.table, prims.kind
    p, d, t_max = p.contiguous(), d.contiguous(), t_max.contiguous()
    f = _lib()
    f["check"](f["shadow"](_ptr(p), _ptr(d), _ptr(t_max), n, _ptr(tab),
                           _ptr(kinds), tab.shape[0], _ptr(occ), _stream()),
               "K2c shadow")
    launches["K2c"] += 1
    return occ
