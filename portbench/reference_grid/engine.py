"""Wavefront integrator engine, the plain reference of the path-trace
megakernel.

A copy of portbench/reference/engine.py whose closest hits take the mesh
field (trace.py) and whose work counts add the closest hits on a mesh
(work.py).

A frozen copy of the program's plain engine, cut to the photonmap and
pathtrace integrators. A batch of B rays advances through the bounces in
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
  (gather.py).
- "pathtrace": MtlBlinn_PathTracing::Shade: colorMax-weighted 4-lobe
  roulette with the probability divided out, the double 1/numLights
  direct-light quirk, no absorption.

Bounce-0 misses shade from the screen-space background, deeper misses from
the environment map (renderer.cpp:335-339 against Shade's
SampleEnvironment). Every draw is a threefry draw keyed on (key words,
pixel, sample), so a lane's radiance does not depend on its batch.
"""

from typing import NamedTuple

import torch

from ..reference import precision as PR
from . import work

from ..reference import rng as RNG
from ..reference.constants import (
    BIGFLOAT,
    COLOR_LUMA_THRESHOLD,
    DIFF_DX,
    DIFF_DY,
    PHOTON_KILL,
    REFLECTION_COLOR_THRESHOLD,
    REFRACTION_COLOR_THRESHOLD,
)
from ..reference.halton import halton
from ..reference.vecmath import (
    cross,
    dot,
    luma,
    normalize,
    pow_safe,
    to_local_frame,
)
from ..reference.warps import (
    concentric_disc,
    cos_weighted_hemisphere,
    uniform_ball_ref,
)
from . import common as C
from ..reference.texture import sample_background, sample_environment
from .trace import trace_closest
from ..reference.gather import gather_blinn
from ..reference.arrays import (
    LIGHT_AMBIENT,
    SceneArrays,
    SceneMeta,
)



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
    tx = px.to(PR.dtype()) + halton(sample_ids, 11)
    ty = py.to(PR.dtype()) + halton(sample_ids, 13)
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
    """gather_blinn of `pmap` on the lanes `do` selects, zero elsewhere.
    Every lane is gathered and the selected ones kept, as the JAX engine
    does (qaray_tpu/integrators/engine.py:161-167): no host read of the
    selection, so a batch's launches do not depend on its data and the
    engine can be captured (utils/compiled.py). A lane's gather does not
    depend on the others, so the selected lanes get the bits of a gather
    of those lanes alone."""
    out = gather_blinn(pmap, p, n, v, mtl.diffuse, mtl.specular,
                       mtl.glossiness)
    return torch.where(do[:, None], out, 0.0)


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


_VERTEX_FNS = {
    "photonmap": _photonmap_vertex,
    "pathtrace": _pathtrace_vertex,
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
    radiance = torch.zeros((num, 3), dtype=PR.dtype(), device=dev)
    beta = torch.ones((num, 3), dtype=PR.dtype(), device=dev)
    alive = torch.ones(num, dtype=torch.bool, device=dev)
    has_diffuse_hit = torch.zeros(num, dtype=torch.bool, device=dev)
    pending_absorption = torch.zeros((num, 3), dtype=PR.dtype(),
                                     device=dev)
    t0 = torch.full((num,), BIGFLOAT, dtype=PR.dtype(), device=dev)
    irrad0 = torch.zeros(num, dtype=torch.bool, device=dev)
    # Footprints feed texture filtering only: untextured scenes skip them.
    if not meta.has_mtl_textures:
        diff = None

    if work.enabled:
        work.add("lanes", num)
    for bounce in range(cfg.max_bounce + 1):
        hits = trace_closest(scene, meta, p, d,
                             diff=diff if bounce == 0 else None)
        hit = hits["hit"] & alive
        if work.enabled:
            work.add("closest_rays", alive.sum())
            work.add("mesh_closest", (hits["mesh"] & alive).sum())
            work.add("vertices", hit.sum())
            work.alive = hit
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
    return radiance, t0, irrad0


def lane_fold_data(px, py, sample_ids, width: int):
    """Per-ray fold datum rid * 65536 + sid with rid = py * width + px,
    wrapped to 32 bits as the reference's int32 arithmetic wraps it
    (at 800x600, rid * 65536 exceeds 2^31)."""
    rid = py.to(torch.int64) * width + px.to(torch.int64)
    return (rid * 65536 + sample_ids.to(torch.int64)) & 0xFFFFFFFF


def render_lanes(scene: SceneArrays, meta: SceneMeta,
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
