"""The reference's entry points: a scene from its XML, photon maps, whole
images by the adaptive loop, and the inverse-rendering loss and gradients.

Every function takes the scene as this package compiles it and the key
words as the seed gives them; nothing here reads a table, a map or a
buffer the program made. Images are rendered in blocks of lanes, so that
an 800x600 or 1920x1080 image at 64 samples fits beside nothing else on
the device.
"""

from __future__ import annotations

import types

import torch

from . import precision as PR
from .build import build_photon_maps
from .compiler import compile_scene
from .engine import IntegratorConfig, render_lanes
from .rng import key_words
from .xml_parser import load_scene

__all__ = ["IntegratorConfig", "key_words", "load", "build_maps",
           "render_image", "value_and_grad", "PARAM_FIELDS"]

# The inverse-rendering parameters, in the program's DiffParams order.
PARAM_FIELDS = ("mtl_diffuse", "mtl_specular", "mtl_emission",
                "mtl_reflection", "mtl_refraction", "mtl_glossiness",
                "light_intensity", "texture_texels", "background",
                "environment")


def load(xml_path: str, width: int, height: int, device):
    """(SceneArrays, SceneMeta) of the XML at width x height, its float
    tables in the reference's precision (precision.py)."""
    desc = load_scene(xml_path)
    desc.camera.img_width, desc.camera.img_height = width, height
    arrays, meta = compile_scene(desc, device=device)
    return _cast(arrays, PR.dtype()), meta


def _cast(tree, dtype):
    """Every floating tensor of a tree of NamedTuples in `dtype`."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_cast(x, dtype) for x in tree))
    return tree


def build_maps(arrays, meta, seed: int, photon_map_size=10000,
               photon_map_bounce=20, photon_map_radius=0.2,
               caustics_map_size=1000, caustics_map_bounce=20,
               caustics_map_radius=1.0):
    """(global, caustics) photon maps of the scene for a RendererParam
    seed, with the upstream defaults."""
    param = types.SimpleNamespace(
        seed=seed, photon_map_size=photon_map_size,
        photon_map_bounce=photon_map_bounce,
        photon_map_radius=photon_map_radius,
        caustics_map_size=caustics_map_size,
        caustics_map_bounce=caustics_map_bounce,
        caustics_map_radius=caustics_map_radius)
    gmap, cmap = build_photon_maps(arrays, meta, param)
    return _cast(gmap, PR.dtype()), _cast(cmap, PR.dtype())


def _welford(mean, std, count, colors):
    """The reference's incremental mean and std (scene/scene.cpp:113-123):
    dc = (x - mean) / (s + 1), mean += dc, std += s > 0 ? dc^2 (s + 1) -
    std / s : 0."""
    s = count.to(mean.dtype)[:, None]
    dc = (colors - mean) / (s + 1.0)
    upd = dc * dc * (s + 1.0) - std / torch.clamp_min(s, 1.0)
    return mean + dc, std + torch.where(s > 0, upd, 0.0), count + 1


def render_image(arrays, meta, cfg: IntegratorConfig, words, spp_min: int,
                 spp_max: int, threshold, maps=None, block: int = 1 << 20,
                 rows=None):
    """One image by the Renderer's loop: spp_min samples of every pixel,
    then rounds of one sample of each pixel whose std is over `threshold`
    in any channel at exactly that count, up to spp_max. Sample s of pixel
    i is keyed on (words, i, s). rows: the image rows to render (all by
    default). Returns (mean [N, 3], count [N]) over the rows' N pixels, in
    row-major order."""
    w, h = meta.img_width, meta.img_height
    dev = arrays.camera.pos.device
    rows = torch.arange(h, device=dev) if rows is None else rows.to(dev)
    pix = (rows[:, None] * w + torch.arange(w, device=dev)[None, :]
           ).reshape(-1).to(torch.int64)
    n = pix.shape[0]
    mean = torch.zeros((n, 3), dtype=PR.dtype(), device=dev)
    std = torch.zeros((n, 3), dtype=PR.dtype(), device=dev)
    count = torch.zeros(n, dtype=torch.int32, device=dev)
    th = torch.tensor(threshold, dtype=PR.dtype(), device=dev)

    def rounds_of(sel, s0, k):
        """Samples s0..s0+k-1 of the pixels `sel`, rendered together (a
        lane's radiance does not depend on its batch) and folded one
        sample after the other."""
        for a in range(0, sel.shape[0], max(1, block // k)):
            rows_i = sel[a:a + max(1, block // k)]
            ids = pix[rows_i].repeat(k)
            sid = (torch.arange(s0, s0 + k, dtype=torch.int32, device=dev)
                   .repeat_interleave(rows_i.shape[0]))
            rad, _ = render_lanes(arrays, meta, cfg, (ids % w).to(torch.int32),
                                  (ids // w).to(torch.int32), sid, words,
                                  maps)
            for j in range(k):
                part = rad[j * rows_i.shape[0]:(j + 1) * rows_i.shape[0]]
                m, sd, c = _welford(mean[rows_i], std[rows_i], count[rows_i],
                                    part.to(mean.dtype))
                mean[rows_i], std[rows_i], count[rows_i] = m, sd, c

    everyone = torch.arange(n, device=dev)
    with torch.no_grad():
        per_call = max(1, min(spp_min, block // max(n, 1)))
        for s in range(0, spp_min, per_call):
            rounds_of(everyone, s, min(per_call, spp_min - s))
        for s in range(spp_min, spp_max):
            active = torch.nonzero(((std > th[None, :]).any(dim=1))
                                   & (count == s))[:, 0]
            if active.numel() == 0:
                break
            rounds_of(active, s, 1)
    return mean, count


def _splice(arrays, params: dict):
    """arrays with the inverse-rendering parameters in place of its own."""
    return arrays._replace(
        materials=arrays.materials._replace(
            diffuse=params["mtl_diffuse"], specular=params["mtl_specular"],
            emission=params["mtl_emission"],
            reflection=params["mtl_reflection"],
            refraction=params["mtl_refraction"],
            glossiness=params["mtl_glossiness"]),
        lights=arrays.lights._replace(intensity=params["light_intensity"]),
        textures=arrays.textures._replace(texels=params["texture_texels"]),
        background=arrays.background._replace(color=params["background"]),
        environment=arrays.environment._replace(
            color=params["environment"]))


def params_of(arrays) -> dict:
    """The inverse-rendering parameters of a scene, by PARAM_FIELDS."""
    m = arrays.materials
    return dict(mtl_diffuse=m.diffuse, mtl_specular=m.specular,
                mtl_emission=m.emission, mtl_reflection=m.reflection,
                mtl_refraction=m.refraction, mtl_glossiness=m.glossiness,
                light_intensity=arrays.lights.intensity,
                texture_texels=arrays.textures.texels,
                background=arrays.background.color,
                environment=arrays.environment.color)


def value_and_grad(arrays, meta, cfg: IntegratorConfig, params: dict, px, py,
                   sample_ids, words, target):
    """(loss, {field: gradient}) of mean((radiance - target)^2) over one
    sample of each lane, radiance a function of `params` (the fields of
    PARAM_FIELDS) by autograd through the engine; a field the loss does
    not reach gets zeros. The estimator is the program's: sampling
    decisions and continuation directions are detached."""
    leaves = {k: params[k].detach().to(PR.dtype()).clone().requires_grad_()
              for k in PARAM_FIELDS}
    with torch.enable_grad():
        rad, _ = render_lanes(_splice(arrays, leaves), meta, cfg, px, py,
                              sample_ids, words)
        loss = ((rad - target.to(PR.dtype())) ** 2).mean()
        grads = torch.autograd.grad(loss, [leaves[k] for k in PARAM_FIELDS],
                                    allow_unused=True)
    return loss.detach(), {
        k: torch.zeros_like(leaves[k]) if g is None else g.detach()
        for k, g in zip(PARAM_FIELDS, grads)}
