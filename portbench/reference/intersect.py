"""Batched ray-primitive intersection: unit sphere, unit plane, triangle.

Counterpart of qaray_tpu/ops/intersect.py (reference
objects/objects.cpp:55-248): B rays against all P analytic
primitives as one [B, P] computation, and the exact triangle test that
re-derives the mesh sweeps' winners. Bias 0.005 rejects self-hits; spheres take the
smaller root above the bias; planes are the [-1,1]^2 square at z=0 with a
1e-7 parallel guard. These are also the plain versions of the analytic
kernels (ops/analytic.py); the object-space transform is written out in the
kernels' order so both round alike.
"""

import math

import torch

from .constants import (
    BIAS,
    BIGFLOAT,
    PLANE_EPS,
    RCP_DX,
    RCP_DY,
)
from .vecmath import cross, normalize
from .arrays import KIND_SPHERE, AnalyticPrims


def _apply(m, v):
    """m [..., 3, 3] @ v [..., 3], each row summed left to right."""
    return torch.stack(
        [m[..., i, 0] * v[..., 0] + m[..., i, 1] * v[..., 1]
         + m[..., i, 2] * v[..., 2] for i in range(3)],
        dim=-1,
    )


def _apply_t(m, v):
    """m^T @ v for m [..., 3, 3], v [..., 3]."""
    return torch.stack(
        [m[..., 0, i] * v[..., 0] + m[..., 1, i] * v[..., 1]
         + m[..., 2, i] * v[..., 2] for i in range(3)],
        dim=-1,
    )


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def intersect_analytic_t(p, d, prims: AnalyticPrims):
    """Distance-only pass. Returns t [B, P] (BIGFLOAT where missed)."""
    rel = p[:, None, :] - prims.t_o2w[None, :, :]
    p_obj = _apply(prims.m_w2o[None], rel)
    d_obj = _apply(prims.m_w2o[None], d[:, None, :])

    # Sphere: a t^2 + b t + c = 0 (objects.cpp:55-85).
    a = _dot(d_obj, d_obj)
    b = 2.0 * _dot(p_obj, d_obj)
    c = _dot(p_obj, p_obj) - 1.0
    delta = b * b - 4.0 * a * c
    sq = torch.sqrt(torch.clamp_min(delta, 0.0))
    rcp2a = 0.5 / a
    t1 = (-b - sq) * rcp2a
    t2 = (-b + sq) * rcp2a
    big = torch.full_like(t1, BIGFLOAT)
    t_sph = torch.where(t1 > BIAS, t1, torch.where(t2 > BIAS, t2, big))
    t_sph = torch.where(delta >= 0.0, t_sph, big)

    # Plane: z=0, |x|,|y| <= 1 (objects.cpp:149-161).
    dz = d_obj[..., 2]
    t_pl = -p_obj[..., 2] / torch.where(torch.abs(dz) < PLANE_EPS,
                                        torch.full_like(dz, math.inf), dz)
    hit_xy = (
        (torch.abs(p_obj[..., 0] + t_pl * d_obj[..., 0]) <= 1.0)
        & (torch.abs(p_obj[..., 1] + t_pl * d_obj[..., 1]) <= 1.0)
    )
    t_pl = torch.where((t_pl > BIAS) & hit_xy, t_pl, big)

    is_sphere = (prims.kind == KIND_SPHERE)[None, :]
    return torch.where(is_sphere, t_sph, t_pl)


def closest_analytic(p, d, prims: AnalyticPrims):
    """(t [B], prim_idx [B] int32) of the closest analytic hit; ties and
    all-miss lanes take the first index, as jnp.argmin does."""
    t = intersect_analytic_t(p, d, prims)
    idx = torch.argmin(t, dim=-1)
    return torch.gather(t, 1, idx[:, None])[:, 0], idx.to(torch.int32)


def analytic_hit_attrs(p, d, t, prim_idx, prims: AnalyticPrims):
    """Hit attributes of the winning primitive only: p (world), n (world,
    unit), uvw, front, mtl, has_texture. Texture coordinates follow
    Sphere_TexCoord / Plane_TexCoord (objects.cpp:48-53, 144-147)."""
    idx = prim_idx.long()
    m = prims.m_w2o[idx]
    p_obj = _apply(m, p - prims.t_o2w[idx])
    d_obj = _apply(m, d)
    hp = p_obj + t[:, None] * d_obj
    zero = torch.zeros_like(t)

    n_sph = normalize(hp, eps=1e-30)
    uv_sph = torch.stack([
        0.5 - torch.atan2(hp[..., 0], hp[..., 1]) / (2.0 * math.pi),
        0.5 + torch.asin(torch.clamp(n_sph[..., 2], -1.0, 1.0)) / math.pi,
        zero,
    ], dim=-1)
    n_pl = torch.stack([zero, zero, torch.ones_like(t)], dim=-1)
    uv_pl = torch.stack(
        [(hp[..., 0] + 1.0) * 0.5, (hp[..., 1] + 1.0) * 0.5, zero], dim=-1
    )
    is_sphere = (prims.kind[idx] == KIND_SPHERE)[:, None]
    n_obj = torch.where(is_sphere, n_sph, n_pl)
    return {
        "p": p + t[:, None] * d,
        "n": normalize(_apply_t(m, n_obj), eps=1e-30),
        "uvw": torch.where(is_sphere, uv_sph, uv_pl),
        "front": _dot(n_obj, d_obj) <= 0.0,
        "mtl": prims.mtl[idx],
        "has_texture": torch.ones_like(t, dtype=torch.bool),
    }


def analytic_diff_uv(p, d, px, dx, py, dy, t, prim_idx, prims: AnalyticPrims,
                     uvw):
    """Texture-coordinate derivatives from differential rays.

    The diff-hit blocks of Sphere/Plane::IntersectRay (objects.cpp:107-135,
    174-202): each offset ray is intersected with the hit primitive's local
    plane (the tangent plane at the hit for spheres, z=0 for planes) and
    duvw = RCP_DX * (uv_offset - uv), all in object space. Returns
    (duvw0, duvw1) [B, 3]. Also the plain version of the megakernel's
    footprints (K1b)."""
    idx = prim_idx.long()
    m = prims.m_w2o[idx]
    t0 = prims.t_o2w[idx]
    is_sphere = prims.kind[idx] == KIND_SPHERE

    hp = _apply(m, p - t0) + t[:, None] * _apply(m, d)
    zero = torch.zeros_like(t)
    # Local plane: the tangent plane through hp for spheres, z=0 for planes.
    n_pl = torch.stack([zero, zero, torch.ones_like(t)], dim=-1)
    n_loc = torch.where(is_sphere[:, None], normalize(hp, eps=1e-30), n_pl)
    anchor = torch.where(is_sphere[:, None], hp, torch.zeros_like(hp))

    def offset_uv(pw, dw):
        po = _apply(m, pw - t0)
        do = _apply(m, dw)
        denom = _dot(do, n_loc)
        denom = torch.where(torch.abs(denom) < 1e-20,
                            torch.full_like(denom, 1e-20), denom)
        t_off = -_dot(po - anchor, n_loc) / denom
        hpo = po + t_off[:, None] * do
        # Sphere uv at the tangent-plane point, asin corrected by the
        # radius (Sphere_TexCoord with rcp_l = 1/|p|, objects.cpp:122-125).
        r = torch.sqrt(torch.clamp_min(_dot(hpo, hpo), 1e-30))
        uv_s = torch.stack([
            0.5 - torch.atan2(hpo[..., 0], hpo[..., 1]) / (2.0 * math.pi),
            0.5 + torch.asin(torch.clamp(hpo[..., 2] / r, -1.0, 1.0))
            / math.pi,
            zero,
        ], dim=-1)
        uv_p = torch.stack([(hpo[..., 0] + 1.0) * 0.5,
                            (hpo[..., 1] + 1.0) * 0.5, zero], dim=-1)
        return torch.where(is_sphere[:, None], uv_s, uv_p)

    return (RCP_DX * (offset_uv(px, dx) - uvw),
            RCP_DY * (offset_uv(py, dy) - uvw))


def intersect_triangles(p_obj, d_obj, v0, v1, v2, t_max):
    """Batched triangle test (objects/objects.cpp:212-248), all inputs
    [B, ...]; returns (t [B], bary [B, 3], front [B], hit [B]). The
    reference's dominant-axis 2D-area barycentric construction."""
    n = cross(v1 - v0, v2 - v0)  # unnormalized face normal
    dz = _dot(d_obj, n)
    pz = _dot(p_obj - v0, n)
    safe_dz = torch.where(torch.abs(dz) < 1e-30,
                          torch.full_like(dz, 1e-30), dz)
    t = -pz / safe_dz
    n_len = torch.sqrt(torch.clamp_min(_dot(n, n), 1e-30))
    parallel = torch.abs(dz) / n_len < 1e-7
    hp = p_obj + t[:, None] * d_obj

    def area(i, j, a, b, c):
        return ((b[..., i] - a[..., i]) * (c[..., j] - a[..., j])
                - (c[..., i] - a[..., i]) * (b[..., j] - a[..., j]))

    abs_n = torch.abs(n)
    axis0 = (abs_n[..., 0] > abs_n[..., 1]) & (abs_n[..., 0] > abs_n[..., 2])
    axis1 = ~axis0 & (abs_n[..., 1] > abs_n[..., 2])

    def baryc(i, j):
        s = area(i, j, v0, v1, v2)
        s = torch.where(torch.abs(s) < 1e-30, torch.full_like(s, 1e-30), s)
        return area(i, j, hp, v1, v2) / s, area(i, j, hp, v2, v0) / s

    a0, b0 = baryc(1, 2)
    a1, b1 = baryc(0, 2)
    a2, b2 = baryc(0, 1)
    a = torch.where(axis0, a0, torch.where(axis1, a1, a2))
    b = torch.where(axis0, b0, torch.where(axis1, b1, b2))
    c = 1.0 - a - b
    inside = (a >= 0.0) & (b >= 0.0) & (c >= 0.0)
    hit = ~parallel & (t > BIAS) & (t < t_max) & inside
    bary = torch.stack([a, b, c], dim=-1)
    return (torch.where(hit, t, torch.full_like(t, BIGFLOAT)), bary,
            dz <= 0.0, hit)
