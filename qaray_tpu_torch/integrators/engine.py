"""Wavefront integrator engine.

Counterpart of qaray_tpu/integrators/engine.py, all six integrators and
the photon-map gathers. A batch of B rays advances through the bounces in
lock step; the recursion of the reference's Material::Shade becomes a loop
carrying the path throughput `beta`, with masked lanes for dead paths:

    L = sum_k beta_k * (emission_k + direct_k [+ gather_k]),
    beta_0 = 1, beta_{k+1} = beta_k * BxDF_k / PDF_k

- "photonmap": MtlBlinn_PhotonMap::Shade (the reference's default MtlBlinn):
  luma-weighted 4-way lobe select with kill = 0.1 whose probability is not
  divided out, hasDiffuseHit gating, Beer absorption on back-face
  continuations; with photon maps (cfg.use_photon_map) the exact
  EstimateIrradiance<100> gathers of the caustics map at diffuse-selected
  vertices and of the global map at those after a diffuse bounce
  (photon/gather.py).
- "pathtrace": MtlBlinn_PathTracing::Shade: colorMax-weighted 4-lobe
  roulette with the probability divided out, the double 1/numLights
  direct-light quirk, no absorption.
- "basic" / "whitted", "phong", "mcgi": the Whitted family
  (_basic_family_vertex), one child per vertex by Russian roulette.

Bounce-0 misses shade from the screen-space background, deeper misses from
the environment map (renderer.cpp:335-339 against Shade's
SampleEnvironment).

render_batch routes pathtrace and photonmap on scenes of analytic
primitives and world meshes up to 65,536 triangles, untextured or with
checker textures only, with photon maps whose tables fit the megakernel's
budget, to the path-trace megakernel (ops/megakernel.py, kernels K1a, K1b,
K1c and K1d); this engine is that kernel's plain version and the route for
everything else: file textures, textured backgrounds and environments,
textured meshes, larger photon maps, the other four integrators. With
threefry key words both compute the same function draw for draw.
"""

import os
from typing import NamedTuple

import torch

from qaray_tpu_torch.core import rng as RNG
from qaray_tpu_torch.core.constants import (
    BIGFLOAT,
    COLOR_LUMA_THRESHOLD,
    DIFF_DX,
    DIFF_DY,
    PHOTON_KILL,
    REFLECTION_COLOR_THRESHOLD,
    REFRACTION_COLOR_THRESHOLD,
)
from qaray_tpu_torch.core.halton import halton
from qaray_tpu_torch.core.vecmath import (
    cross,
    dot,
    luma,
    normalize,
    pow_safe,
    to_local_frame,
)
from qaray_tpu_torch.core.warps import (
    concentric_disc,
    cos_weighted_hemisphere,
    uniform_ball_ref,
)
from qaray_tpu_torch.integrators import common as C
from qaray_tpu_torch.ops.texture import sample_background, sample_environment
from qaray_tpu_torch.ops.trace import trace_closest
from qaray_tpu_torch.photon.gather import gather_blinn
from qaray_tpu_torch.scene.arrays import (
    LIGHT_AMBIENT,
    SceneArrays,
    SceneMeta,
)

# Lanes the wavefront engine has rendered (render_batch_wavefront calls),
# so a caller can show that a run went through the megakernel only.
wavefront_lanes = 0


class IntegratorConfig(NamedTuple):
    """Static (hashable) integrator configuration."""

    integrator: str = "photonmap"
    max_bounce: int = 5  # Material::maxBounce (CLI -bounce)
    shadow_spp: int = 16  # GenLight::shadow_spp_min
    shadow_spp_max: int = 64  # GenLight::shadow_spp_max (adaptive escalation)
    inverse_square_falloff: bool = True  # off for basic and phong
    use_photon_map: bool = False
    glossy_attempts: int = 4
    mc_samples: int = 10  # MtlBlinn_MonteCarloGI maxMCSample


# ---------------------------------------------------------------------------
# Camera ray generation (reference renderer.cpp:302-327)
# ---------------------------------------------------------------------------


def generate_camera_rays(scene: SceneArrays, meta: SceneMeta, px, py,
                         sample_ids, keys):
    """px, py: [B] pixel coordinates; sample_ids: [B] sample indices.

    Sub-pixel jitter is Halton(s, 11), Halton(s, 13), the same for every
    pixel at a sample index (scene/scene.cpp:99-102); with a depth of field
    the origin moves on the lens disc (scene/scene.cpp:104-111). Returns
    (origin, direction, tx, ty, diff): tx, ty the jittered pixel
    coordinates, diff = (px, dx, py, dy) the differential rays through the
    screen points DIFF_DX right of and DIFF_DY below the sample (DiffRay
    ctor, renderer.cpp:314-326), which feed the texture footprints."""
    cam = scene.camera
    tx = px.to(torch.float32) + halton(sample_ids, 11)
    ty = py.to(torch.float32) + halton(sample_ids, 13)
    cpt = (cam.screen_a[None, :] + tx[:, None] * cam.screen_u[None, :]
           + ty[:, None] * cam.screen_v[None, :])
    campos = cam.pos.expand(cpt.shape)
    if meta.has_dof:
        lens = concentric_disc(
            RNG.uniform(RNG.fold(keys, RNG.P_DOF), (2,)), cam.dof)
        campos = (campos + lens[:, 0:1] * cam.screen_x[None, :]
                  + lens[:, 1:2] * cam.screen_y[None, :])
    xpt = cpt + DIFF_DX * cam.screen_u[None, :]
    ypt = cpt + DIFF_DY * cam.screen_v[None, :]
    diff = (campos, normalize(xpt - campos), campos, normalize(ypt - campos))
    return campos, normalize(cpt - campos), tx, ty, diff


# ---------------------------------------------------------------------------
# Vertices
# ---------------------------------------------------------------------------


def _gather_lanes(pmap, do, p, n, v, mtl):
    """gather_blinn of `pmap` on the lanes `do` selects, zero elsewhere."""
    out = torch.zeros_like(p)
    idx = torch.nonzero(do)[:, 0]
    if idx.numel():
        out[idx] = gather_blinn(pmap, p[idx], n[idx], v[idx],
                                mtl.diffuse[idx], mtl.specular[idx],
                                mtl.glossiness[idx])
    return out


def _photonmap_vertex(scene, meta, cfg, hits, mtl, v, keys, has_diffuse_hit,
                      bounce_remaining, photon_maps=None):
    """One vertex of MtlBlinn_PhotonMap::Shade."""
    n = hits["n"]
    fr = C.compute_fresnel(n, v, hits["front"], mtl.ior)
    tot = fr.total_reflection[:, None]
    sample_transmission = torch.where(
        tot, 0.0, mtl.refraction * fr.t_ratio[:, None])
    sample_reflection = torch.where(
        tot, mtl.reflection + mtl.refraction,
        mtl.reflection + mtl.refraction * fr.r_ratio[:, None])
    luma_t = luma(sample_transmission)
    luma_r = luma(sample_reflection)
    luma_d = luma(mtl.diffuse)

    # RandomSelectMtl (MtlBlinn_PhotonMap.cpp:107-150).
    r = RNG.uniform(RNG.fold(keys, RNG.P_LOBE_SELECT))
    coef_t = luma_t
    coef_r = coef_t + luma_r
    coef_d = coef_r + luma_d
    select = r * (coef_d + PHOTON_KILL)
    sel_transmit = (select < coef_t) & (luma_t > COLOR_LUMA_THRESHOLD)
    sel_reflect = (~sel_transmit & (select < coef_r)
                   & (luma_r > COLOR_LUMA_THRESHOLD))
    sel_diffuse = (~sel_transmit & ~sel_reflect & (select < coef_d)
                   & (luma_d > COLOR_LUMA_THRESHOLD))

    direct = C.blinn_direct(
        scene, meta, cfg, hits["p"], n, v, mtl.diffuse, mtl.specular,
        mtl.glossiness, keys, skip_ambient=True, norm_power=1,
    )
    vertex_color = mtl.emission + direct

    # Photon-map mode (MtlBlinn_PhotonMap.cpp:344-368, 420-458): vertices
    # that selected the diffuse lobe gather the caustics map, those after a
    # diffuse bounce also the global map (and end there), both under the
    # luma(sampleDiffuse) guard. Only the selected lanes are gathered.
    if cfg.use_photon_map and photon_maps is not None:
        gmap, cmap = photon_maps
        diffuse_ok = luma_d > COLOR_LUMA_THRESHOLD
        do_photon = sel_diffuse & has_diffuse_hit & diffuse_ok
        do_caustics = sel_diffuse & diffuse_ok
        p = hits["p"]
        vertex_color = vertex_color + _gather_lanes(gmap, do_photon, p, n, v,
                                                    mtl)
        vertex_color = vertex_color + _gather_lanes(cmap, do_caustics, p, n,
                                                    v, mtl)

    # Continuation sampling.
    ks = RNG.fold(keys, RNG.P_LOBE_SAMPLE)
    if meta.has_glossy:
        refl_dir = torch.where(
            (mtl.reflection_glossiness > 0.0)[:, None],
            C.glossy_jitter_dir(fr.r_dir, fr.y_axis,
                                mtl.reflection_glossiness, RNG.fold(ks, 11),
                                want_up=True, attempts=cfg.glossy_attempts),
            fr.r_dir)
        trans_dir = torch.where(
            (mtl.refraction_glossiness > 0.0)[:, None],
            C.glossy_jitter_dir(fr.t_dir, fr.y_axis,
                                mtl.refraction_glossiness, RNG.fold(ks, 12),
                                want_up=False, attempts=cfg.glossy_attempts),
            fr.t_dir)
    else:
        refl_dir = fr.r_dir
        trans_dir = fr.t_dir

    # Diffuse: cosine hemisphere around N (SampleDiffuseBxDF).
    diff_dir = to_local_frame(
        n, cos_weighted_hemisphere(RNG.uniform(RNG.fold(ks, 13), (2,))))
    h = normalize(v + normalize(diff_dir, eps=1e-30), eps=1e-30)
    cos_nh = torch.clamp_min(dot(n, h), 0.0)
    diff_bxdf = (mtl.diffuse
                 + mtl.specular * pow_safe(cos_nh, mtl.glossiness)[:, None])

    can_bounce = bounce_remaining > 0
    go_reflect = sel_reflect & (luma_r > COLOR_LUMA_THRESHOLD) & can_bounce
    go_transmit = sel_transmit & (luma_t > COLOR_LUMA_THRESHOLD) & can_bounce
    go_diffuse = (sel_diffuse & ~has_diffuse_hit
                  & (luma_d > COLOR_LUMA_THRESHOLD) & hits["front"]
                  & can_bounce)
    new_dir = torch.where(go_transmit[:, None], trans_dir,
                          torch.where(go_diffuse[:, None], diff_dir, refl_dir))
    weight = torch.where(
        go_transmit[:, None], sample_transmission,
        torch.where(go_diffuse[:, None], diff_bxdf, sample_reflection))
    alive = go_reflect | go_transmit | go_diffuse
    # Reflect/transmit continuations reset hasDiffuseHit, diffuse sets it
    # (ComputeSecondaryRay, MtlBlinn_PhotonMap.h:139).
    return vertex_color, new_dir, weight, alive, go_diffuse, mtl.absorption


def _pathtrace_vertex(scene, meta, cfg, hits, mtl, v, keys, has_diffuse_hit,
                      bounce_remaining, photon_maps=None):
    """One vertex of MtlBlinn_PathTracing::Shade (:69-300)."""
    n = normalize(hits["n"], eps=1e-30)
    front = hits["front"]
    fr = C.compute_fresnel(n, v, front, mtl.ior)
    tot = fr.total_reflection[:, None]
    sample_refraction = torch.where(
        tot, 0.0, mtl.refraction * fr.t_ratio[:, None])
    sample_reflection = torch.where(
        tot, mtl.reflection + mtl.refraction,
        mtl.reflection + mtl.refraction * fr.r_ratio[:, None])

    coef = torch.stack([sample_refraction.amax(-1),
                        sample_reflection.amax(-1),
                        mtl.specular.amax(-1), mtl.diffuse.amax(-1)])
    coef_sum = torch.clamp_min(((coef[0] + coef[1]) + coef[2]) + coef[3],
                               1e-20)
    c_refr, c_refl, c_spec, c_diff = coef / coef_sum
    sum_refl = c_refr + c_refl
    sum_spec = sum_refl + c_spec

    select = RNG.uniform(RNG.fold(keys, RNG.P_LOBE_SELECT))
    sel_refr = (select <= c_refr) & (c_refr > 1e-6)
    sel_refl = ~sel_refr & (select < sum_refl) & (c_refl > 1e-6)
    sel_spec = ~sel_refr & ~sel_refl & (select < sum_spec) & (c_spec > 1e-6)
    sel_diff = ~sel_refr & ~sel_refl & ~sel_spec & (c_diff > 1e-6)

    direct = C.blinn_direct(
        scene, meta, cfg, hits["p"], n, v, mtl.diffuse, mtl.specular,
        mtl.glossiness, keys, skip_ambient=True, norm_power=2,
    )
    vertex_color = mtl.emission + direct

    # Hemisphere around the faceforwarded normal (:182-186).
    hemi = normalize(cos_weighted_hemisphere(
        RNG.uniform(RNG.fold(keys, RNG.P_LOBE_SAMPLE), (2,))), eps=1e-30)
    hemi_world = to_local_frame(fr.y_axis, hemi)

    refr_glossy = (mtl.refraction_glossiness > 0.0)[:, None]
    refl_glossy = (mtl.reflection_glossiness > 0.0)[:, None]
    refr_dir = torch.where(refr_glossy, -hemi_world, fr.t_dir)
    refr_bxdf = torch.where(
        refr_glossy,
        sample_refraction * pow_safe(torch.clamp_min(dot(v, fr.t_dir), 0.0),
                                     mtl.refraction_glossiness)[:, None],
        sample_refraction)
    refl_dir = torch.where(refl_glossy, hemi_world, fr.r_dir)
    refl_bxdf = torch.where(
        refl_glossy,
        sample_reflection * pow_safe(torch.clamp_min(dot(v, fr.r_dir), 0.0),
                                     mtl.reflection_glossiness)[:, None],
        sample_reflection)
    h = normalize(v + normalize(hemi_world, eps=1e-30), eps=1e-30)
    spec_bxdf = mtl.specular * pow_safe(torch.clamp_min(dot(n, h), 0.0),
                                        mtl.glossiness)[:, None]

    can_bounce = bounce_remaining > 0
    go_refr = sel_refr & can_bounce
    go_refl = sel_refl & can_bounce
    go_spec = sel_spec & front & can_bounce
    go_diff = sel_diff & front & can_bounce

    new_dir = torch.where(go_refr[:, None], refr_dir,
                          torch.where(go_refl[:, None], refl_dir, hemi_world))
    pdf = torch.where(go_refr, c_refr, torch.where(
        go_refl, c_refl, torch.where(go_spec, c_spec, c_diff)))
    bxdf = torch.where(go_refr[:, None], refr_bxdf, torch.where(
        go_refl[:, None], refl_bxdf,
        torch.where(go_spec[:, None], spec_bxdf, mtl.diffuse)))
    # Detached sampling: the lobe pdf carries no parameter gradient (see
    # diff.py), as the JAX engine's stop_gradient on it.
    weight = bxdf / torch.clamp_min(pdf, 1e-20).detach()[:, None]
    alive = go_refr | go_refl | go_spec | go_diff
    return (vertex_color, new_dir, weight, alive, has_diffuse_hit,
            torch.zeros_like(mtl.absorption))


def _basic_family_vertex(scene, meta, cfg, hits, mtl, v, keys,
                         has_diffuse_hit, bounce_remaining, photon_maps=None,
                         phong=False, mcgi=False, direct_lighting=True):
    """Whitted-family vertex: MtlBlinn_Basic / MtlPhong_Basic /
    MtlBlinn_MonteCarloGI (materials/MtlBlinn_Basic.cpp:30-185,
    MtlPhong_Basic.cpp, MtlBlinn_MonteCarloGI.cpp).

    The reference recurses into both the refraction and the reflection
    child (MC-GI adds N diffuse GI samples). A branching tree does not fit
    a fixed-width wavefront, so, as in the JAX package, one child per
    vertex is picked by Russian roulette in proportion to the children's
    luma and reweighted by the selection probability: the same
    expectation, the variance left to the samples per pixel."""
    n = normalize(hits["n"], eps=1e-30)
    p = hits["p"]
    front = hits["front"]

    # Frame (MtlBlinn_Basic.cpp:49-50): X = norm((N x V) x N), Y = N sign(N.V).
    x_axis = normalize(cross(cross(n, v), n), eps=1e-30)
    y_axis = n * torch.sign(dot(n, v))[:, None]

    # Glossy normal jitter with the reference's quirk ball
    # (MtlBlinn_Basic.cpp:58-66; the radius is the raw glossiness value).
    if meta.has_glossy:
        kb = RNG.fold(keys, RNG.P_GLOSSY)
        tj = normalize(n + uniform_ball_ref(
            RNG.uniform(RNG.fold(kb, 0), (4, 2)), mtl.refraction_glossiness),
            eps=1e-30)
        rj = normalize(n + uniform_ball_ref(
            RNG.uniform(RNG.fold(kb, 1), (4, 2)), mtl.reflection_glossiness),
            eps=1e-30)
        tjn = torch.where((mtl.refraction_glossiness > 0.001)[:, None], tj, n)
        rjn = torch.where((mtl.reflection_glossiness > 0.001)[:, None], rj, n)
    else:
        tjn = rjn = n

    n_ior = torch.where(front, 1.0 / mtl.ior, mtl.ior)
    cos_i = dot(tjn, v)
    sin_i = torch.sqrt(torch.clamp_min(1.0 - cos_i * cos_i, 0.0))
    sin_o = torch.clamp(sin_i * n_ior, 0.0, 1.0)
    cos_o = torch.sqrt(torch.clamp_min(1.0 - sin_o * sin_o, 0.0))
    t_dir = -x_axis * sin_o[:, None] - y_axis * cos_o[:, None]
    r_dir = 2.0 * rjn * dot(rjn, v)[:, None] - v

    c0 = (n_ior - 1.0) ** 2 / (n_ior + 1.0) ** 2
    r_c = c0 + (1.0 - c0) * torch.pow(1.0 - torch.abs(cos_i), 5.0)
    t_c = 1.0 - r_c
    tot = ((n_ior * sin_i) > 1.001)[:, None]
    t_k = torch.where(tot, 0.0, mtl.refraction * t_c[:, None])
    r_k = torch.where(tot, mtl.reflection + mtl.refraction,
                      mtl.reflection + mtl.refraction * r_c[:, None])

    # Direct lighting: front hits only, no normalization. Basic and Phong
    # include the ambient light; MC-GI skips it (the hemisphere integral
    # replaces it, MtlBlinn_MonteCarloGI.cpp:187-188) and its specular term
    # carries no cosNL (:190-196). direct_lighting=False skips it all: the
    # extra replicas of the MC-GI expansion only need continuation draws.
    zero = torch.zeros_like(p)
    if not direct_lighting:
        vertex_color = zero
    elif phong:
        vertex_color = torch.where(
            front[:, None], _phong_direct(scene, meta, cfg, p, n, v, mtl,
                                          keys), zero)
    else:
        direct = C.blinn_direct(
            scene, meta, cfg, p, n, v, mtl.diffuse, mtl.specular,
            mtl.glossiness, keys, skip_ambient=mcgi, norm_power=0,
            spec_cos_nl=not mcgi)
        vertex_color = torch.where(front[:, None], direct, zero)
        if mcgi:
            # MC-GI seeds the colour with emission before the front-hit
            # gate (MtlBlinn_MonteCarloGI.cpp:113-115); Basic and Phong
            # start from black (MtlBlinn_Basic.cpp:37).
            vertex_color = vertex_color + mtl.emission

    # Children.
    can_bounce = bounce_remaining > 0
    spawn_t = (t_k.amax(-1) > REFRACTION_COLOR_THRESHOLD) & can_bounce
    spawn_r = (r_k.amax(-1) > REFLECTION_COLOR_THRESHOLD) & can_bounce
    if mcgi:
        u = RNG.uniform(RNG.fold(keys, RNG.P_LOBE_SAMPLE), (2,))
        d_dir = to_local_frame(
            n, normalize(cos_weighted_hemisphere(u), eps=1e-30))
        h = normalize(v + d_dir, eps=1e-30)
        cos_nh = torch.clamp_min(dot(n, h), 0.0)
        cos_nl = torch.clamp_min(dot(n, d_dir), 0.0)
        # MtlBlinn_MonteCarloGI.cpp:255-260 estimator weight.
        d_k = (mtl.specular
               * (cos_nl * pow_safe(cos_nh, mtl.glossiness))[:, None]
               + mtl.diffuse)
        # The GI loop runs for every front hit with bounces left (no
        # diffuse gate: the weight has a specular term, :258-260).
        spawn_d = front & can_bounce & (
            (luma(mtl.diffuse) > 1e-6) | (luma(mtl.specular) > 1e-6))
    else:
        d_dir = r_dir
        d_k = zero
        spawn_d = torch.zeros_like(front)

    # Roulette among the active children, in proportion to their luma; the
    # selection probability is detached (detached sampling, see diff.py).
    w_t = torch.where(spawn_t, torch.clamp_min(luma(t_k), 1e-6), 0.0)
    w_r = torch.where(spawn_r, torch.clamp_min(luma(r_k), 1e-6), 0.0)
    w_d = torch.where(spawn_d, torch.clamp_min(luma(d_k), 1e-6), 0.0)
    w_sum = w_t + w_r + w_d
    any_child = w_sum > 0.0
    r = (RNG.uniform(RNG.fold(keys, RNG.P_LOBE_SELECT))
         * torch.clamp_min(w_sum, 1e-30))
    pick_t = any_child & (r < w_t)
    pick_r = any_child & ~pick_t & (r < w_t + w_r)
    prob = (torch.where(pick_t, w_t, torch.where(pick_r, w_r, w_d))
            / torch.clamp_min(w_sum, 1e-30))
    new_dir = torch.where(pick_t[:, None], t_dir,
                          torch.where(pick_r[:, None], r_dir, d_dir))
    weight = (torch.where(pick_t[:, None], t_k,
                          torch.where(pick_r[:, None], r_k, d_k))
              / torch.clamp_min(prob, 1e-30).detach()[:, None])
    return (vertex_color, new_dir, weight, any_child, has_diffuse_hit,
            mtl.absorption)


def _phong_direct(scene, meta, cfg, p, n, v, mtl, keys):
    """Phong direct lighting (MtlPhong_Basic.cpp:169-183): the specular
    term is (V.R)^gloss with R the reflected light direction and carries
    no cosNL; the ambient light contributes diffuse * I."""
    total = torch.zeros_like(p)
    for li in range(meta.num_lights):
        intensity = C.illuminate(scene, meta, cfg, li, p, keys)
        if meta.light_kinds[li] == LIGHT_AMBIENT:
            total = total + mtl.diffuse * intensity
            continue
        l_dir = normalize(-C.light_direction(scene, meta, li, p), eps=1e-30)
        r_vec = 2.0 * dot(l_dir, n)[:, None] * n - l_dir
        cos_nl = torch.clamp_min(dot(n, l_dir), 0.0)
        cos_vr = torch.clamp_min(dot(v, r_vec), 0.0)
        total = total + mtl.diffuse * intensity * cos_nl[:, None]
        total = total + (mtl.specular * intensity
                         * pow_safe(cos_vr, mtl.glossiness)[:, None])
    return total


def _basic_vertex(*args, **kw):
    return _basic_family_vertex(*args, **kw, phong=False, mcgi=False)


def _phong_vertex(*args, **kw):
    return _basic_family_vertex(*args, **kw, phong=True, mcgi=False)


def _mcgi_vertex(*args, **kw):
    return _basic_family_vertex(*args, **kw, phong=False, mcgi=True)


_VERTEX_FNS = {
    "photonmap": _photonmap_vertex,
    "pathtrace": _pathtrace_vertex,
    "basic": _basic_vertex,
    "whitted": _basic_vertex,
    "phong": _phong_vertex,
    "mcgi": _mcgi_vertex,
}
INTEGRATORS = tuple(_VERTEX_FNS)


def _check_supported(cfg: IntegratorConfig):
    if cfg.integrator not in _VERTEX_FNS:
        raise ValueError(f"unknown integrator {cfg.integrator!r}: one of "
                         f"{', '.join(INTEGRATORS)}")


# ---------------------------------------------------------------------------
# The wavefront loop
# ---------------------------------------------------------------------------


def integrate(scene: SceneArrays, meta: SceneMeta, cfg: IntegratorConfig,
              p, d, ray_keys, screen_uv=None, photon_maps=None, diff=None):
    """Trace B primary rays to full radiance: (radiance [B,3], t0 [B],
    irrad0 [B]), irrad0 the irradiance debug plane (photonmap with photon
    maps: the primary vertex is a photon surface; False elsewhere).

    screen_uv: [B,3] screen-space coordinates of the samples, for a
    textured background; photon_maps: the (global, caustics) PhotonMapData
    gathered with cfg.use_photon_map; diff: the primary rays'
    differentials, for the texture footprints at the first hit."""
    _check_supported(cfg)
    vertex_fn = _VERTEX_FNS[cfg.integrator]
    num = p.shape[0]
    dev = p.device
    radiance = torch.zeros((num, 3), dtype=torch.float32, device=dev)
    beta = torch.ones((num, 3), dtype=torch.float32, device=dev)
    alive = torch.ones(num, dtype=torch.bool, device=dev)
    has_diffuse_hit = torch.zeros(num, dtype=torch.bool, device=dev)
    pending_absorption = torch.zeros((num, 3), dtype=torch.float32,
                                     device=dev)
    t0 = torch.full((num,), BIGFLOAT, dtype=torch.float32, device=dev)
    irrad0 = torch.zeros(num, dtype=torch.bool, device=dev)
    # MC-GI first-vertex sample count (maxMCSample): above 1 the wavefront
    # widens after the primary hit.
    mc_n = cfg.mc_samples if cfg.integrator == "mcgi" else 1
    radiance0 = None
    # Footprints feed texture filtering only: untextured scenes skip them.
    if not meta.has_mtl_textures:
        diff = None

    for bounce in range(cfg.max_bounce + 1):
        hits = trace_closest(scene, meta, p, d,
                             diff=diff if bounce == 0 else None)
        hit = hits["hit"] & alive
        miss = ~hits["hit"] & alive
        if bounce == 0:
            t0 = torch.where(hits["hit"], hits["t"], BIGFLOAT)
            if screen_uv is not None and meta.has_bg_texture:
                miss_color = sample_background(scene.textures,
                                               scene.background, screen_uv)
            else:
                miss_color = scene.background.color
        elif meta.has_env_texture:
            miss_color = sample_environment(scene.textures,
                                            scene.environment, d)
        else:
            miss_color = scene.environment.color
        radiance = radiance + torch.where(miss[:, None], beta * miss_color,
                                          0.0)
        alive = hit
        # Back-face continuation absorption (ComputeSecondaryRay,
        # MtlBlinn_PhotonMap.cpp:246-249): Beer attenuation with the parent
        # vertex's absorption over the traveled distance.
        att = torch.exp(-pending_absorption * hits["t"][:, None])
        beta = torch.where((hit & ~hits["front"])[:, None], beta * att, beta)

        mtl = C.gather_materials(
            scene, hits["mtl"], hits["uvw"], hits["has_texture"],
            duvw=(hits["duvw0"], hits["duvw1"]) if "duvw0" in hits else None,
            textured=meta.has_mtl_textures)
        if (bounce == 0 and cfg.integrator == "photonmap"
                and cfg.use_photon_map):
            # Irradiance-computation debug plane: the primary vertex is a
            # photon-gather surface (IsPhotonSurface, MtlBlinn_PhotonMap.h
            # :74-77, diffuse luma > 0).
            irrad0 = hit & (luma(mtl.diffuse) > 0.0)
        v = -d
        keys = RNG.fold(ray_keys, 1000 + bounce)
        lanes = p.shape[0]
        remaining = torch.full((lanes,), cfg.max_bounce - bounce,
                               dtype=torch.int32, device=dev)

        if bounce == 0 and mc_n > 1:
            # MC-GI first-vertex expansion (MtlBlinn_MonteCarloGI.cpp:21-22,
            # 176-178: maxMCSample indirect samples at the first bounce,
            # then 1). Direct lighting is evaluated once; the wavefront
            # then widens to mc_n replicas a lane, each with its own
            # continuation draw and a weight of 1/mc_n.
            dirs, wts, conts, hdhs = [], [], [], []
            for rep in range(mc_n):
                krep = keys if rep == 0 else RNG.fold(keys, 50000 + rep)
                vc, nd, wt, ct, nh, pa = vertex_fn(
                    scene, meta, cfg, hits, mtl, v, krep, has_diffuse_hit,
                    remaining, photon_maps, direct_lighting=(rep == 0))
                if rep == 0:
                    vertex_color, pend = vc, pa
                dirs.append(nd)
                wts.append(wt)
                conts.append(ct)
                hdhs.append(nh)
            radiance = radiance + torch.where(alive[:, None],
                                              beta * vertex_color, 0.0)
            if bounce == cfg.max_bounce:
                break

            def xrep(x):
                return torch.cat([x] * mc_n, dim=0)

            alive = xrep(alive) & torch.cat(conts, dim=0)
            beta = torch.where(alive[:, None],
                               xrep(beta) * torch.cat(wts, dim=0) / mc_n,
                               xrep(beta))
            has_diffuse_hit = torch.where(alive, torch.cat(hdhs, dim=0),
                                          xrep(has_diffuse_hit))
            pending_absorption = xrep(pend)
            p = xrep(hits["p"])
            # Detached sampling, as below.
            d = normalize(torch.cat(dirs, dim=0), eps=1e-30).detach()
            folded = [RNG.fold(ray_keys, 777000 + rep) for rep in range(mc_n)]
            ray_keys = (torch.cat([k[0] for k in folded]),
                        torch.cat([k[1] for k in folded]))
            # Later terms land in an accumulator of the expanded width,
            # folded back at the end.
            radiance0 = radiance
            radiance = torch.zeros((mc_n * num, 3), dtype=torch.float32,
                                   device=dev)
            continue

        vertex_color, new_dir, weight, cont, new_hdh, pend = vertex_fn(
            scene, meta, cfg, hits, mtl, v, keys, has_diffuse_hit,
            remaining, photon_maps,
        )
        radiance = radiance + torch.where(alive[:, None],
                                          beta * vertex_color, 0.0)
        if bounce == cfg.max_bounce:
            break
        alive = alive & cont
        beta = torch.where(alive[:, None], beta * weight, beta)
        has_diffuse_hit = torch.where(alive, new_hdh, has_diffuse_hit)
        pending_absorption = pend
        p = hits["p"]
        # Detached sampling: continuation directions carry no parameter
        # gradient (reparameterized/detached estimator: the correct gradient
        # of the discrete-lobe expectation keeps BxDF sensitivities and
        # drops direction/PDF sensitivities; see diff.py).
        d = normalize(new_dir, eps=1e-30).detach()
    if radiance0 is not None:
        radiance = radiance0 + radiance.reshape(mc_n, num, 3).sum(dim=0)
    return radiance, t0, irrad0


def lane_fold_data(px, py, sample_ids, width: int):
    """Per-ray fold datum rid * 65536 + sid with rid = py * width + px,
    wrapped to 32 bits as the reference's int32 arithmetic wraps it
    (at 800x600, rid * 65536 exceeds 2^31)."""
    rid = py.to(torch.int64) * width + px.to(torch.int64)
    return (rid * 65536 + sample_ids.to(torch.int64)) & 0xFFFFFFFF


def render_batch_wavefront(scene: SceneArrays, meta: SceneMeta,
                           cfg: IntegratorConfig, px, py, sample_ids,
                           key_words, photon_maps=None,
                           want_aux: bool = False):
    """One sample per (px, py) lane on the wavefront engine: (radiance [B,3],
    primary depth [B]), with want_aux also the irradiance debug flag [B].
    Counterpart of engine.render_batch_xla_impl and the plain version of
    kernel K1a (and of K1d with photon_maps: the exact gathers).

    key_words: the base key's words (2 for threefry2x32; the 4 of a jax
    'rbg' key fold to 2, see core.rng.fold_words). The draws are those of
    jax.random under the threefry key with the folded words; for an 'rbg'
    key this departs from JAX's wavefront engine, whose XLA rbg stream
    PyTorch cannot reproduce, and agrees with the reference megakernel.
    """
    global wavefront_lanes
    wavefront_lanes += px.shape[0]
    keys = RNG.ray_keys(RNG.fold_words(key_words),
                        lane_fold_data(px, py, sample_ids, meta.img_width))
    campos, d, tx, ty, diff = generate_camera_rays(scene, meta, px, py,
                                                   sample_ids, keys)
    screen_uv = torch.stack([tx / meta.img_width, ty / meta.img_height,
                             torch.zeros_like(tx)], dim=-1)
    radiance, t0, irrad0 = integrate(scene, meta, cfg, campos, d, keys,
                                     screen_uv, photon_maps, diff)
    if want_aux:
        return radiance, t0, irrad0
    return radiance, t0


# Combined photon-table rows (global + caustics) the megakernel route takes:
# the JAX package's VMEM budget, kept so that both packages route alike.
# Reference defaults are 10,112 + 1,024 rows; larger maps take the
# wavefront engine's exact gathers.
MEGA_PHOTON_ROW_BUDGET = 32768


def _mega_photon_ok(cfg: IntegratorConfig, photon_maps) -> bool:
    """May the megakernel serve this photon-gathering config?"""
    if not cfg.use_photon_map:
        return True  # no gathering asked for: maps are irrelevant
    if cfg.integrator != "photonmap" or photon_maps is None:
        return False
    gmap, cmap = photon_maps[0], photon_maps[1]
    if gmap.ctable is None or cmap.ctable is None:
        return False
    return gmap.ctable.shape[0] + cmap.ctable.shape[0] <= \
        MEGA_PHOTON_ROW_BUDGET


def use_pathtrace_mega(meta: SceneMeta, cfg: IntegratorConfig,
                       photon_maps=None) -> bool:
    """Gate of the path-trace megakernel: pathtrace or photonmap on scenes
    whose meshes, if any, carry the megakernel's mesh tables
    (meta.mesh_mega), whose material textures, if any, are all checkers
    off those meshes (meta.mega_tex_ok), whose background and environment
    are plain colours, and, with photon gathering, whose clustered maps fit
    MEGA_PHOTON_ROW_BUDGET (lanes over the gather cap are the Renderer's
    to escalate). QARAY_NO_MEGAKERNEL set sends everything to the
    wavefront engine."""
    if os.environ.get("QARAY_NO_MEGAKERNEL"):
        return False
    return (
        cfg.integrator in ("pathtrace", "photonmap")
        and (meta.num_mesh_instances == 0 or meta.mesh_mega)
        and (meta.num_analytic > 0 or meta.mesh_mega)
        and len(meta.analytic_kinds) == meta.num_analytic
        and len(meta.analytic_mtls) == meta.num_analytic
        and (not meta.has_mtl_textures or meta.mega_tex_ok)
        and not meta.has_bg_texture
        and not meta.has_env_texture
        and _mega_photon_ok(cfg, photon_maps)
    )


def render_batch(scene: SceneArrays, meta: SceneMeta, cfg: IntegratorConfig,
                 px, py, sample_ids, key_words, photon_maps=None,
                 want_aux: bool = False):
    """Render one sample for each (px, py) lane: (radiance [B,3], depth [B]).

    With want_aux=True the tuple gains the per-lane irradiance debug flag
    (the fb plane). On the megakernel route with photon gathering it gains
    a last per-lane escalation flag: lanes whose gather saw more than
    GATHER_K photons in the radius need the exact estimate, which the
    Renderer gets by rendering them again on the wavefront engine (same
    key words, same paths). These are the tuples of the JAX package's
    render_batch.

    Deterministic in (key words, pixel, sample): independent of how lanes
    are batched. Eligible scenes go to the megakernel (K1a with K1b, K1c and
    K1d on CUDA tensors, its plain version on the CPU); the rest to the
    wavefront engine.
    """
    if use_pathtrace_mega(meta, cfg, photon_maps):
        from qaray_tpu_torch.ops.megakernel import mega_render

        if cfg.use_photon_map:
            radiance, t0, irr0, esc = mega_render(
                scene, meta, cfg, px, py, sample_ids, key_words,
                photon_maps=photon_maps)
            if want_aux:
                return radiance, t0, irr0, esc
            return radiance, t0, esc
        radiance, t0 = mega_render(scene, meta, cfg, px, py, sample_ids,
                                   key_words)
        if want_aux:
            # pathtrace never writes the irradiance debug plane.
            return radiance, t0, torch.zeros_like(px, dtype=torch.bool)
        return radiance, t0
    return render_batch_wavefront(scene, meta, cfg, px, py, sample_ids,
                                  key_words, photon_maps, want_aux)
