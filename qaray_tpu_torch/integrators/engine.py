"""Wavefront integrator engine.

Counterpart of qaray_tpu/integrators/engine.py for the pathtrace and
photonmap integrators (photonmap without photon gathering). A batch of B
rays advances through the bounces in lock step; the recursion of the
reference's Material::Shade becomes a loop carrying the path throughput
`beta`, with masked lanes for dead paths:

    L = sum_k beta_k * (emission_k + direct_k),
    beta_0 = 1, beta_{k+1} = beta_k * BxDF_k / PDF_k

- "photonmap": MtlBlinn_PhotonMap::Shade (the reference's default MtlBlinn):
  luma-weighted 4-way lobe select with kill = 0.1 whose probability is not
  divided out, hasDiffuseHit gating, Beer absorption on back-face
  continuations.
- "pathtrace": MtlBlinn_PathTracing::Shade: colorMax-weighted 4-lobe
  roulette with the probability divided out, the double 1/numLights
  direct-light quirk, no absorption.

Bounce-0 misses shade with the background colour, deeper misses with the
environment colour (renderer.cpp:335-339).

render_batch routes untextured scenes of analytic primitives and world
meshes up to 65,536 triangles to the path-trace megakernel
(ops/megakernel.py, kernels K1a and K1c); this engine is that kernel's
plain version and the route for everything else. With threefry key words
both compute the same function draw for draw.
"""

import os
from typing import NamedTuple

import torch

from qaray_tpu_torch.core import rng as RNG
from qaray_tpu_torch.core.constants import (
    BIGFLOAT,
    COLOR_LUMA_THRESHOLD,
    PHOTON_KILL,
)
from qaray_tpu_torch.core.halton import halton
from qaray_tpu_torch.core.vecmath import (
    dot,
    luma,
    normalize,
    pow_safe,
    to_local_frame,
)
from qaray_tpu_torch.core.warps import concentric_disc, cos_weighted_hemisphere
from qaray_tpu_torch.integrators import common as C
from qaray_tpu_torch.ops.trace import trace_closest
from qaray_tpu_torch.scene.arrays import SceneArrays, SceneMeta

# Lanes the wavefront engine has rendered (render_batch_wavefront calls),
# so a caller can show that a run went through the megakernel only.
wavefront_lanes = 0


class IntegratorConfig(NamedTuple):
    """Static (hashable) integrator configuration."""

    integrator: str = "photonmap"
    max_bounce: int = 5  # Material::maxBounce (CLI -bounce)
    shadow_spp: int = 16  # GenLight::shadow_spp_min
    shadow_spp_max: int = 64  # GenLight::shadow_spp_max (adaptive escalation)
    inverse_square_falloff: bool = True
    use_photon_map: bool = False
    glossy_attempts: int = 4
    mc_samples: int = 10


# ---------------------------------------------------------------------------
# Camera ray generation (reference renderer.cpp:302-327)
# ---------------------------------------------------------------------------


def generate_camera_rays(scene: SceneArrays, meta: SceneMeta, px, py,
                         sample_ids, keys):
    """px, py: [B] pixel coordinates; sample_ids: [B] sample indices.

    Sub-pixel jitter is Halton(s, 11), Halton(s, 13), the same for every
    pixel at a sample index (scene/scene.cpp:99-102); with a depth of field
    the origin moves on the lens disc (scene/scene.cpp:104-111). Returns
    (origin, direction). The differential rays of the reference's DiffRay
    feed texture footprints only and come with the texture slice."""
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
    return campos, normalize(cpt - campos)


# ---------------------------------------------------------------------------
# Vertices
# ---------------------------------------------------------------------------


def _photonmap_vertex(scene, meta, cfg, hits, mtl, v, keys, has_diffuse_hit,
                      bounce_remaining):
    """One vertex of MtlBlinn_PhotonMap::Shade, without photon gathering."""
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
                      bounce_remaining):
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
    weight = bxdf / torch.clamp_min(pdf, 1e-20)[:, None]
    alive = go_refr | go_refl | go_spec | go_diff
    return (vertex_color, new_dir, weight, alive, has_diffuse_hit,
            torch.zeros_like(mtl.absorption))


_VERTEX_FNS = {"photonmap": _photonmap_vertex, "pathtrace": _pathtrace_vertex}


def _check_supported(meta: SceneMeta, cfg: IntegratorConfig):
    if cfg.integrator not in _VERTEX_FNS:
        raise NotImplementedError(
            f"integrator {cfg.integrator!r}: basic, whitted, phong and mcgi "
            "come with the integrators slice of the port")
    if cfg.use_photon_map:
        raise NotImplementedError("photon maps come with the photon slice")
    if meta.has_mtl_textures or meta.has_bg_texture or meta.has_env_texture:
        raise NotImplementedError("textures come with the texture slice")


# ---------------------------------------------------------------------------
# The wavefront loop
# ---------------------------------------------------------------------------


def integrate(scene: SceneArrays, meta: SceneMeta, cfg: IntegratorConfig,
              p, d, ray_keys):
    """Trace B primary rays to full radiance: (radiance [B,3], t0 [B])."""
    _check_supported(meta, cfg)
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

    for bounce in range(cfg.max_bounce + 1):
        hits = trace_closest(scene, meta, p, d)
        hit = hits["hit"] & alive
        miss = ~hits["hit"] & alive
        if bounce == 0:
            t0 = torch.where(hits["hit"], hits["t"], BIGFLOAT)
            miss_color = scene.background.color
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

        mtl = C.gather_materials(scene, hits["mtl"])
        keys = RNG.fold(ray_keys, 1000 + bounce)
        remaining = torch.full((num,), cfg.max_bounce - bounce,
                               dtype=torch.int32, device=dev)
        vertex_color, new_dir, weight, cont, new_hdh, pend = vertex_fn(
            scene, meta, cfg, hits, mtl, -d, keys, has_diffuse_hit,
            remaining,
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
        d = normalize(new_dir, eps=1e-30)
    return radiance, t0


def lane_fold_data(px, py, sample_ids, width: int):
    """Per-ray fold datum rid * 65536 + sid with rid = py * width + px,
    wrapped to 32 bits as the reference's int32 arithmetic wraps it
    (at 800x600, rid * 65536 exceeds 2^31)."""
    rid = py.to(torch.int64) * width + px.to(torch.int64)
    return (rid * 65536 + sample_ids.to(torch.int64)) & 0xFFFFFFFF


def render_batch_wavefront(scene: SceneArrays, meta: SceneMeta,
                           cfg: IntegratorConfig, px, py, sample_ids,
                           key_words):
    """One sample per (px, py) lane on the wavefront engine: (radiance [B,3],
    primary depth [B]). Counterpart of engine.render_batch_xla_impl and the
    plain version of kernel K1a.

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
    campos, d = generate_camera_rays(scene, meta, px, py, sample_ids, keys)
    return integrate(scene, meta, cfg, campos, d, keys)


def use_pathtrace_mega(meta: SceneMeta, cfg: IntegratorConfig) -> bool:
    """Gate of the path-trace megakernel: pathtrace or photonmap (without
    photon gathering) on untextured scenes whose meshes, if any, carry the
    megakernel's mesh tables (meta.mesh_mega).
    QARAY_NO_MEGAKERNEL set sends everything to the wavefront engine."""
    if os.environ.get("QARAY_NO_MEGAKERNEL"):
        return False
    return (
        cfg.integrator in ("pathtrace", "photonmap")
        and not cfg.use_photon_map
        and (meta.num_mesh_instances == 0 or meta.mesh_mega)
        and (meta.num_analytic > 0 or meta.mesh_mega)
        and len(meta.analytic_kinds) == meta.num_analytic
        and len(meta.analytic_mtls) == meta.num_analytic
        and not meta.has_mtl_textures
        and not meta.has_bg_texture
        and not meta.has_env_texture
    )


def render_batch(scene: SceneArrays, meta: SceneMeta, cfg: IntegratorConfig,
                 px, py, sample_ids, key_words):
    """Render one sample for each (px, py) lane: (radiance [B,3], depth [B]).

    Deterministic in (key words, pixel, sample): independent of how lanes
    are batched. Eligible scenes go to the megakernel (K1a on CUDA tensors,
    its plain version on the CPU); the rest to the wavefront engine.
    """
    if use_pathtrace_mega(meta, cfg):
        from qaray_tpu_torch.ops.megakernel import mega_render

        return mega_render(scene, meta, cfg, px, py, sample_ids, key_words)
    return render_batch_wavefront(scene, meta, cfg, px, py, sample_ids,
                                  key_words)
