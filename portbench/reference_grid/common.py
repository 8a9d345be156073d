"""Shared shading machinery: material gather, Fresnel, direct lighting.

A copy of portbench/reference/common.py whose shadow rays take the mesh
field's any-hit walk (trace.py) and whose work counts add the shadow rays
a mesh blocks (work.py). Counterpart of qaray_tpu/integrators/common.py
(reference
materials/MtlBlinn_*.cpp, lights/lights.cpp): virtual dispatch
becomes table gathers by material id, scalar branches masked selects over
the ray batch.
"""

from typing import NamedTuple

import torch

from ..reference import precision as PR
from . import work

from ..reference import rng as RNG
from ..reference.constants import (
    BIGFLOAT,
    TOTAL_REFLECTION_THRESHOLD,
)
from ..reference.vecmath import cross, dot, normalize, pow_safe
from ..reference.warps import uniform_ball_ref
from ..reference.texture import (
    sample_textured_color,
    sample_textured_color_filtered,
)
from .trace import trace_shadow
from ..reference.arrays import (
    LIGHT_AMBIENT,
    LIGHT_DIRECT,
    LIGHT_SPOT,
    SLOT_DIFFUSE,
    SLOT_EMISSION,
    SLOT_REFLECTION,
    SLOT_REFRACTION,
    SLOT_SPECULAR,
    SceneArrays,
)


class MtlSamples(NamedTuple):
    """Per-lane textured material samples at the hit point."""

    diffuse: torch.Tensor  # [B,3]
    specular: torch.Tensor
    emission: torch.Tensor
    reflection: torch.Tensor
    refraction: torch.Tensor
    absorption: torch.Tensor
    glossiness: torch.Tensor  # [B]
    reflection_glossiness: torch.Tensor
    refraction_glossiness: torch.Tensor
    ior: torch.Tensor


def gather_materials(scene: SceneArrays, mtl_id, uvw, has_texture,
                     duvw=None, textured: bool = True) -> MtlSamples:
    """Gather and texture-sample every material parameter for B lanes.

    duvw: optional (duvw0, duvw1) texture footprints; with them, textured
    slots go through the reference's 32-sample elliptic footprint filter
    (primary hits; core/texture.cpp:32-52), without them they point-sample.
    textured: static flag (meta.has_mtl_textures); False skips all texture
    sampling, which is exact for scenes without a live material texture."""
    mt = scene.materials
    mid = torch.clamp_min(mtl_id, 0).long()

    def slot(colors, slot_idx):
        if not textured:
            return colors[mid]
        args = (scene.textures, colors[mid], mt.tex_id[mid, slot_idx],
                mt.tex_m[mid, slot_idx], mt.tex_t[mid, slot_idx], uvw)
        if duvw is not None:
            return sample_textured_color_filtered(*args, duvw[0], duvw[1],
                                                  has_texture)
        return sample_textured_color(*args, has_texture)

    return MtlSamples(
        diffuse=slot(mt.diffuse, SLOT_DIFFUSE),
        specular=slot(mt.specular, SLOT_SPECULAR),
        emission=slot(mt.emission, SLOT_EMISSION),
        reflection=slot(mt.reflection, SLOT_REFLECTION),
        refraction=slot(mt.refraction, SLOT_REFRACTION),
        absorption=mt.absorption[mid],
        glossiness=mt.glossiness[mid],
        reflection_glossiness=mt.reflection_glossiness[mid],
        refraction_glossiness=mt.refraction_glossiness[mid],
        ior=mt.ior[mid],
    )


class Fresnel(NamedTuple):
    t_dir: torch.Tensor  # [B,3] transmission direction
    r_dir: torch.Tensor  # [B,3] mirror reflection direction
    t_ratio: torch.Tensor  # [B] transmit coefficient (1 - rC)
    r_ratio: torch.Tensor  # [B] Schlick reflect coefficient
    total_reflection: torch.Tensor  # [B] bool
    y_axis: torch.Tensor  # [B,3] N oriented toward the viewer


def compute_fresnel(n, v, front, ior) -> Fresnel:
    """MtlBlinn_PhotonMap::ComputeFresnel (MtlBlinn_PhotonMap.cpp:65-105)."""
    cos_nv = dot(n, v)
    y = torch.where((cos_nv > 0.0)[..., None], n, -n)
    z = cross(v, y)
    x = normalize(cross(y, z), eps=1e-30)
    n_ior = torch.where(front, 1.0 / ior, ior)
    cos_i = cos_nv
    sin_i = torch.sqrt(torch.clamp_min(1.0 - cos_i * cos_i, 0.0))
    sin_o = torch.clamp(sin_i * n_ior, 0.0, 1.0)
    cos_o = torch.sqrt(torch.clamp_min(1.0 - sin_o * sin_o, 0.0))
    t_dir = -x * sin_o[..., None] - y * cos_o[..., None]
    r_dir = 2.0 * n * cos_nv[..., None] - v
    total = (n_ior * sin_i) > TOTAL_REFLECTION_THRESHOLD
    c0 = (n_ior - 1.0) * (n_ior - 1.0) / ((n_ior + 1.0) * (n_ior + 1.0))
    r_ratio = c0 + (1.0 - c0) * torch.pow(1.0 - torch.abs(cos_i), 5.0)
    return Fresnel(t_dir, r_dir, 1.0 - r_ratio, r_ratio, total, y)


def glossy_jitter_dir(center_dir, y_axis, gloss, keys, want_up, attempts=4,
                      ball_attempts=4):
    """Rejection jitter around a direction with the UniformBall quirk
    (SampleTransmit/ReflectionBxDF, MtlBlinn_PhotonMap.cpp:152-200):
    normalize(normalize(center) + UniformBall(2 gloss)), rejected while on
    the wrong side of `y_axis`; both rejection loops are fixed attempts,
    first success wins, the centre is the fallback."""
    u = RNG.uniform(keys, (attempts, ball_attempts, 2))  # [B, Ao, Ai, 2]
    balls = uniform_ball_ref(u, 2.0 * gloss[:, None])  # [B, Ao, 3]
    c = normalize(center_dir, eps=1e-30)
    cand = normalize(c[:, None, :] + balls, eps=1e-30)
    side = dot(cand, y_axis[:, None, :])
    ok = side >= 0.0 if want_up else side <= 0.0
    idx = torch.arange(attempts, device=u.device)
    first = torch.where(ok, idx, attempts).amin(dim=-1)
    pick = torch.gather(
        cand, 1, torch.clamp_max(first, attempts - 1)[:, None, None]
        .expand(-1, 1, 3))[:, 0, :]
    return torch.where((first < attempts)[:, None], pick, c)


def light_direction(scene: SceneArrays, meta, light_idx: int, p):
    """Light::Direction(p): direction FROM the light TO the point (unit)."""
    lt = scene.lights
    if meta.light_kinds[light_idx] == LIGHT_DIRECT:
        return lt.direction[light_idx].expand(p.shape)
    return normalize(p - lt.position[light_idx], eps=1e-30)


def spot_attenuation(scene, light_idx, dir_to_point):
    """SpotLight::GetAttenuation (lights/lights.cpp:128-144)."""
    lt = scene.lights
    cos_t = dot(dir_to_point, lt.direction[light_idx].expand(
        dir_to_point.shape))
    r = (torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
         / torch.clamp_min(cos_t, 1e-20))
    inner = lt.inner[light_idx]
    outer = lt.outer[light_idx]
    ring = (outer - r) / torch.clamp_min(outer - inner, 1e-20)
    ring = ring * ring
    att = torch.where(r < inner, 1.0, torch.where(r > outer, 0.0, ring))
    return torch.where(cos_t < 0.0, 0.0, att)


def _falloff(cfg, vec):
    if not cfg.inverse_square_falloff:
        return torch.ones(vec.shape[:-1], dtype=vec.dtype, device=vec.device)
    return torch.clamp_max(1.0 / torch.clamp_min(dot(vec, vec), 1e-20), 1.0)


def illuminate(scene, meta, cfg, light_idx: int, p, keys):
    """GenLight-family Illuminate: per-lane RGB intensity with shadowing.

    - DirectLight: one shadow ray along -direction (lights/lights.h:66-71)
    - Point/spot with size > 0.01: the reference's adaptive soft shadows
      (lights/lights.cpp:50-74): shadow_spp samples for every lane, then up
      to shadow_spp_max for lanes whose estimate went fractional, with the
      in-loop falloff recurrence
          inshadow += (shadow_s - inshadow) * falloff_s / (s + 1)
    - Spot: point behaviour times the cone attenuation (lights.cpp:83-109).
    """
    lt = scene.lights
    kind = meta.light_kinds[light_idx]
    intensity = lt.intensity[light_idx]
    num = p.shape[0]
    if kind == LIGHT_AMBIENT:
        return intensity.expand(num, 3)
    if kind == LIGHT_DIRECT:
        d = normalize(-lt.direction[light_idx].expand(p.shape))
        t_max = torch.full((num,), BIGFLOAT, dtype=PR.dtype(),
                           device=p.device)
        vis = 1.0 - trace_shadow(scene, meta, p, d, t_max).float()
        return vis[:, None] * intensity

    pos = lt.position[light_idx]
    if meta.light_soft[light_idx]:
        s_min = cfg.shadow_spp
        s_max = max(cfg.shadow_spp_max, s_min)
        k = RNG.fold(keys, RNG.P_SHADOW + 101 * light_idx)
        u = RNG.uniform(k, (s_max, 2, 2))  # quirk-ball uniforms per sample
        balls = uniform_ball_ref(u, lt.size[light_idx])  # [B, s_max, 3]
        vec = pos + balls - p[:, None, :]
        dist = torch.sqrt(torch.clamp_min(dot(vec, vec), 1e-20))
        dirs = vec / dist[..., None]
        fall = _falloff(cfg, vec)  # [B, s_max]

        def trace_phase(lo, hi, budget=None):
            """Shadow-trace samples [lo, hi); budget zeroes t_max on lanes
            that do not escalate (nothing then counts as a hit)."""
            d_ = dist[:, lo:hi]
            if budget is not None:
                d_ = d_ * budget[:, None]
            flat_p = p[:, None, :].expand(-1, hi - lo, 3).reshape(-1, 3)
            occ, by_mesh = trace_shadow(scene, meta, flat_p,
                                        dirs[:, lo:hi].reshape(-1, 3),
                                        d_.reshape(-1), parts=True)
            if work.enabled and work.alive is not None:
                work.add("mesh_blocked", (by_mesh.reshape(num, hi - lo)
                                          & work.alive[:, None]).sum())
            return 1.0 - occ.reshape(num, hi - lo).float()

        def recurrence(i, s0, xs, fs, gate=None):
            frac = torch.zeros(num, dtype=torch.bool, device=p.device)
            for j in range(xs.shape[1]):
                upd = i + (xs[:, j] - i) * fs[:, j] / (s0 + j + 1.0)
                if gate is not None:
                    upd = torch.where(gate, upd, i)
                frac = frac | ((upd > 0.0) & (upd < 1.0))
                i = upd
            return i, frac

        zero = torch.zeros(num, dtype=PR.dtype(), device=p.device)
        in_shadow, escalate = recurrence(zero, 0, trace_phase(0, s_min),
                                         fall[:, :s_min])
        if work.enabled and work.alive is not None:
            live = work.alive
            work.add("shadow_rays", live.sum() * s_min
                     + (live & escalate).sum() * (s_max - s_min))
        if s_max > s_min:
            in_shadow, _ = recurrence(
                in_shadow, s_min,
                trace_phase(s_min, s_max, escalate.float()),
                fall[:, s_min:], gate=escalate)
        out = in_shadow[:, None] * intensity
    else:
        vec = pos - p
        dist = torch.sqrt(torch.clamp_min(dot(vec, vec), 1e-20))
        occ, by_mesh = trace_shadow(scene, meta, p, vec / dist[:, None],
                                    dist, parts=True)
        if work.enabled and work.alive is not None:
            work.add("shadow_rays", work.alive.sum())
            work.add("mesh_blocked", (work.alive & by_mesh).sum())
        out = ((1.0 - occ.float()) * _falloff(cfg, vec))[:, None] * intensity

    if kind == LIGHT_SPOT:
        att = spot_attenuation(scene, light_idx,
                               light_direction(scene, meta, light_idx, p))
        out = out * att[:, None]
    return out


def blinn_direct(scene, meta, cfg, p, n, v, diffuse, specular, glossiness,
                 keys, skip_ambient: bool, norm_power: int,
                 spec_cos_nl: bool = True):
    """Sum of Blinn direct lighting over the lights, in light order.

    norm_power: 0 -> no 1/L normalization (Basic, MtlBlinn_Basic.cpp:168-182),
    1 -> PhotonMap convention (MtlBlinn_PhotonMap.cpp:482-498),
    2 -> PathTracing's double-normalization quirk (MtlBlinn_PathTracing.cpp:
    163-175). spec_cos_nl: False -> the MC-GI variant, whose specular term
    omits the cosNL factor (MtlBlinn_MonteCarloGI.cpp:190-196).
    """
    total = torch.zeros_like(p)
    if meta.num_lights == 0:
        return total
    norm = (1.0 / meta.num_lights) ** norm_power
    for li in range(meta.num_lights):
        if meta.light_kinds[li] == LIGHT_AMBIENT:
            if not skip_ambient:
                total = total + diffuse * illuminate(scene, meta, cfg, li, p,
                                                     keys)
            continue
        intensity = illuminate(scene, meta, cfg, li, p, keys) * norm
        l_dir = normalize(-light_direction(scene, meta, li, p), eps=1e-30)
        h = normalize(v + l_dir, eps=1e-30)
        cos_nl = torch.clamp_min(dot(n, l_dir), 0.0)
        cos_nh = torch.clamp_min(dot(n, h), 0.0)
        spec = specular * pow_safe(cos_nh, glossiness)[:, None]
        if spec_cos_nl:
            total = total + intensity * cos_nl[:, None] * (diffuse + spec)
        else:
            total = total + intensity * (diffuse * cos_nl[:, None] + spec)
    return total
