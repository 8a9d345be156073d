"""Photon map construction as batched emission passes, in plain torch.

A frozen copy of the program's photon build. The reference builds its maps
with a serial loop over photons (renderer.cpp:119-290): pick a light, emit,
bounce with MtlBlinn_PhotonMap::RandomPhotonBounce, store at diffuse
surfaces after the first bounce (the caustics map only before any diffuse
hit). Here batches of photon paths advance in lock step, each bounce one
closest-hit trace, and the host loop collects stores until the map is
full.

Semantics kept:
- photon sources are point lights only (PointLight::IsPhotonSource;
  SpotLight returns false, lights/lights.h:114,156)
- intensity per path = light intensity / numPhotonLights (renderer.cpp:163)
- the light pick floors r * n for the global map and takes the ceiling for
  the caustics map (renderer.cpp:151-157 against 225-231)
- store gate: luma of the BASE diffuse > 0 (IsPhotonSurface), bounce != 0
- power update c *= BxDF / (PDF * scale) with the roulette's selection
  scale (RandomPhotonBounce, MtlBlinn_PhotonMap.cpp:566-571); photon-mode
  diffuse sampling is the uniform hemisphere with PDF 0.5, and its
  specular lobe uses a plain power, not pow_safe
- Beer attenuation on back faces over the segment just traveled
- ScalePhotonPowers(1 / numOfEmittedRays) at the end, an "emitted ray"
  being a path that stored at least one photon (renderer.cpp:195-198)

Random draws are those of jax.random under the threefry key
PRNGKey(seed + 7919 * batch + 100000 for caustics), whose words are
(0, that value): the two packages build the same maps.
"""


import numpy as np
import torch

from . import rng as RNG
from .constants import COLOR_LUMA_THRESHOLD, PHOTON_KILL
from .vecmath import dot, luma, normalize, to_local_frame
from .warps import uniform_hemisphere, uniform_sphere
from . import common as C
from .trace import trace_closest
from .gather import PhotonMapData
from .arrays import LIGHT_POINT


def _photon_bounce(scene, meta, hits, mtl, v, keys, glossy_attempts=4):
    """RandomPhotonBounce: (new direction, power factor, alive)."""
    n = hits["n"]
    front = hits["front"]
    fr = C.compute_fresnel(n, v, front, mtl.ior)
    tot = fr.total_reflection[:, None]
    t_k = mtl.refraction
    r_k = mtl.reflection
    sample_transmission = torch.where(tot, 0.0, t_k * fr.t_ratio[:, None])
    sample_reflection = torch.where(tot, r_k + t_k,
                                    r_k + t_k * fr.r_ratio[:, None])
    luma_t = luma(sample_transmission)
    luma_r = luma(sample_reflection)
    luma_d = luma(mtl.diffuse)

    r = RNG.uniform(RNG.fold(keys, RNG.P_LOBE_SELECT))
    coef_t = luma_t
    coef_r = coef_t + luma_r
    coef_d = coef_r + luma_d
    coef_sum = coef_d + PHOTON_KILL
    select = r * coef_sum
    sel_t = (select < coef_t) & (luma_t > COLOR_LUMA_THRESHOLD)
    sel_r = ~sel_t & (select < coef_r) & (luma_r > COLOR_LUMA_THRESHOLD)
    sel_d = (~sel_t & ~sel_r & (select < coef_d)
             & (luma_d > COLOR_LUMA_THRESHOLD))
    rcp = 1.0 / coef_sum
    scale = torch.where(
        sel_t, luma_t * rcp,
        torch.where(sel_r, luma_r * rcp,
                    torch.where(sel_d, luma_d * rcp, 1.0)))

    ks = RNG.fold(keys, RNG.P_LOBE_SAMPLE)
    if meta.has_glossy:
        refl_dir = torch.where(
            (mtl.reflection_glossiness > 0.0)[:, None],
            C.glossy_jitter_dir(fr.r_dir, fr.y_axis,
                                mtl.reflection_glossiness, RNG.fold(ks, 11),
                                want_up=True, attempts=glossy_attempts),
            fr.r_dir)
        trans_dir = torch.where(
            (mtl.refraction_glossiness > 0.0)[:, None],
            C.glossy_jitter_dir(fr.t_dir, fr.y_axis,
                                mtl.refraction_glossiness, RNG.fold(ks, 12),
                                want_up=False, attempts=glossy_attempts),
            fr.t_dir)
    else:
        refl_dir = fr.r_dir
        trans_dir = fr.t_dir
    # Photon-mode diffuse: uniform hemisphere, PDF 0.5 (SampleDiffuseBxDF
    # with photonMap=true, MtlBlinn_PhotonMap.cpp:203-224).
    u = RNG.uniform(RNG.fold(ks, 13), (2,))
    diff_dir = to_local_frame(n, uniform_hemisphere(u))
    h = normalize(v + normalize(diff_dir, eps=1e-30), eps=1e-30)
    cos_nh = torch.clamp_min(dot(n, h), 0.0)
    diff_bxdf = (mtl.diffuse
                 + mtl.specular * torch.pow(cos_nh, mtl.glossiness)[:, None])

    go_t = sel_t
    go_r = sel_r
    go_d = sel_d & front
    alive = go_t | go_r | go_d
    new_dir = torch.where(go_t[:, None], trans_dir,
                          torch.where(go_d[:, None], diff_dir, refl_dir))
    bxdf = torch.where(go_t[:, None], sample_transmission,
                       torch.where(go_d[:, None], diff_bxdf,
                                   sample_reflection))
    pdf = torch.where(go_d, 0.5, 1.0)
    factor = bxdf / (pdf * torch.clamp_min(scale, 1e-30))[:, None]
    # Beer attenuation for the segment just traveled inside a medium.
    att = torch.exp(-mtl.absorption * hits["t"][:, None])
    factor = torch.where((~front)[:, None], factor * att, factor)
    return normalize(new_dir, eps=1e-30), factor, alive


def _trace_photon_paths(scene, meta, base_words, num_paths: int,
                        bounces: int, caustics: bool):
    """Trace a batch of photon paths: per-(path, bounce) stores.

    base_words: the batch's threefry key words, two ints or an int64
    tensor [2] (on the scene's device: an input of the captured batch).
    Returns [num_paths, bounces] tensors: store mask, position, incoming
    direction, power. Inside a path the order is the reference's
    sequential fill (path-major, bounce minor)."""
    photon_lights = [i for i, k in enumerate(meta.light_kinds)
                     if k == LIGHT_POINT]
    if not photon_lights:
        raise ValueError("photon maps need at least one point light")
    light_scale = 1.0 / len(photon_lights)
    dev = scene.lights.position.device
    if isinstance(base_words, torch.Tensor):
        base_words = (base_words[0], base_words[1])
    keys = RNG.ray_keys(base_words, torch.arange(num_paths, device=dev))
    ke = RNG.fold(keys, RNG.P_PHOTON_EMIT)

    nl = len(photon_lights)
    r = RNG.uniform(RNG.fold(ke, 0))
    pick = torch.ceil(r * nl) if caustics else torch.floor(r * nl)
    pick = torch.clamp_max(pick.to(torch.int64), nl - 1)
    light_ids = torch.full_like(pick, photon_lights[0])
    for j, li in enumerate(photon_lights[1:], 1):
        light_ids = torch.where(pick == j, li, light_ids)
    p = scene.lights.position[light_ids]
    # PointLight::RandomPhoton (lights.cpp:76-80).
    d = uniform_sphere(RNG.uniform(RNG.fold(ke, 1), (2,)))
    power = scene.lights.intensity[light_ids] * light_scale

    alive = torch.ones(num_paths, dtype=torch.bool, device=dev)
    has_diffuse = torch.zeros_like(alive)
    masks, positions, dirs, powers = [], [], [], []
    for bounce in range(bounces):
        hits = trace_closest(scene, meta, p, d)
        alive = alive & hits["hit"]
        mtl = C.gather_materials(scene, hits["mtl"], hits["uvw"],
                                 hits["has_texture"],
                                 textured=meta.has_mtl_textures)
        base = scene.materials.diffuse[torch.clamp_min(hits["mtl"], 0).long()]
        is_photon_surface = luma(base) > 0.0
        store = alive & is_photon_surface & (bounce != 0)
        if caustics:
            store = store & ~has_diffuse
        masks.append(store)
        positions.append(hits["p"])
        dirs.append(d)
        powers.append(power)

        kb = RNG.fold(keys, 2000 + bounce)
        new_dir, factor, cont = _photon_bounce(scene, meta, hits, mtl, -d, kb)
        power = torch.where((alive & cont)[:, None], power * factor, power)
        has_diffuse = has_diffuse | (alive & is_photon_surface)
        alive = alive & cont
        p = hits["p"]
        d = new_dir
    return (torch.stack(masks, dim=1), torch.stack(positions, dim=1),
            torch.stack(dirs, dim=1), torch.stack(powers, dim=1))


trace_photon_paths = _trace_photon_paths


def _build_one_map(scene, meta, param, size, bounces, radius, caustics, seed,
                   batch=4096):
    """Emit batches until `size` photons are stored (renderer.cpp:148-198,
    225-277). The batch doubles while the store rate so far says more paths
    are needed, up to 2^20. After 8 batches in a row with no store a
    caustics map with nothing stored is left empty (the reference would
    spin forever) and a global map raises RuntimeError."""
    dev = scene.lights.position.device
    pos_all, dir_all, pow_all = [], [], []
    emitted_with_store = 0
    total = 0
    b = 0
    zero_batches = 0
    while total < size:
        words = torch.tensor(RNG.key_words(
            "threefry2x32", seed + 7919 * b + (100000 if caustics else 0)),
            dtype=torch.int64, device=dev)
        mask, pos, pdir, ppow = trace_photon_paths(scene, meta, words, batch,
                                                   bounces, caustics)
        emitted_with_store += int(mask.any(dim=1).sum())
        idx = torch.nonzero(mask.reshape(-1))[:, 0]
        pos_all.append(pos.reshape(-1, 3)[idx].float().cpu().numpy())
        dir_all.append(pdir.reshape(-1, 3)[idx].float().cpu().numpy())
        pow_all.append(ppow.reshape(-1, 3)[idx].float().cpu().numpy())
        stored = int(idx.shape[0])
        total += stored
        b += 1
        zero_batches = zero_batches + 1 if stored == 0 else 0
        if zero_batches >= 8:
            if caustics and total == 0:
                # A caustics photon needs a first hit on a zero-diffuse
                # surface (renderer.cpp:248-271): where every material has
                # diffuse luma > 0 the reference's build loop never ends.
                print("\nWARNING: caustics map cannot fill (no zero-diffuse "
                      "first-hit surface; the reference would hang here) — "
                      "using an empty caustics map.")
                break
            raise RuntimeError(
                f"photon map cannot fill: 8 consecutive emission batches "
                f"({8 * batch} paths) stored no photons "
                f"({'caustics' if caustics else 'global'} map, "
                f"{total}/{size} stored)")
        if total and total < size:
            rate = total / (b * batch * mask.shape[1])
            need_paths = (size - total) / max(rate * mask.shape[1], 1e-9)
            while batch < need_paths and batch < (1 << 20):
                batch *= 2
    pos = (np.concatenate(pos_all)[:size] if pos_all
           else np.zeros((0, 3), np.float32))
    pdir = np.concatenate(dir_all)[:size]
    ppow = np.concatenate(pow_all)[:size]
    n = pos.shape[0]
    ppow = ppow * (1.0 / max(emitted_with_store, 1))
    pad = size - n

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    return PhotonMapData(
        pos=put(np.pad(pos, ((0, pad), (0, 0)))),
        power=put(np.pad(ppow, ((0, pad), (0, 0)))),
        max_power=put(np.pad(ppow.max(axis=1), (0, pad))),
        direction=put(np.pad(pdir, ((0, pad), (0, 0)))),
        radius=torch.tensor(radius, dtype=torch.float32),
        valid=put(np.pad(np.ones(n, bool), (0, pad))),
    )


def build_photon_maps(scene, meta, param):
    """(global, caustics) photon maps per RendererParam (renderer.cpp:
    119-290 without the kd balance: the gathers need no tree)."""
    gmap = _build_one_map(scene, meta, param, param.photon_map_size,
                          param.photon_map_bounce, param.photon_map_radius,
                          caustics=False, seed=param.seed + 31337)
    cmap = _build_one_map(scene, meta, param, param.caustics_map_size,
                          param.caustics_map_bounce,
                          param.caustics_map_radius, caustics=True,
                          seed=param.seed + 77777)
    return gmap, cmap
