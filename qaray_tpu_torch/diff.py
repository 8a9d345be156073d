"""Differentiable rendering: gradients of radiance with respect to scene
parameters.

Counterpart of qaray_tpu/diff.py. The wavefront engine is plain torch, so
autograd flows through its shading; what makes the estimator right is
detached sampling (the lobe pdfs, the roulette probabilities and the
sampled continuation directions are detached inside the engine):

    E[L] = sum_lobes p_i * (BxDF_i / p_i) * L_i = sum_i BxDF_i * L_i
    dE/dtheta = sum_i d(BxDF_i)/dtheta * L_i   (+ light/texture terms)

so the gradient of the expectation keeps the BxDF, light and texture
sensitivities and drops those of the pdfs and directions. Geometry edge
terms are out of scope: the parameters are material, light and texture
values. Gradients are taken with respect to a DiffParams bundle spliced
into the scene.

render_value_and_grad has the JAX package's two routes: on scenes the
fused adjoint serves (ops/adjoint.adjoint_supported) and the megakernel
renders, the megakernel's forward (K1a) and one launch of the adjoint
(K6); elsewhere autograd through render_with_params, whose forward runs
the wavefront engine (K2, K3 or K4 on a card) and whose backward is
autograd with K2's winner-only rule (ops/analytic.py). On CPU tensors the
kernels' plain versions run in their place.
"""

from typing import NamedTuple

import numpy as np
import torch

from qaray_tpu_torch.scene.arrays import SceneArrays


class DiffParams(NamedTuple):
    """The differentiable parameter bundle (a sub-tree of SceneArrays)."""

    mtl_diffuse: torch.Tensor  # [M, 3]
    mtl_specular: torch.Tensor  # [M, 3]
    mtl_emission: torch.Tensor  # [M, 3]
    mtl_reflection: torch.Tensor  # [M, 3]
    mtl_refraction: torch.Tensor  # [M, 3]
    mtl_glossiness: torch.Tensor  # [M]
    light_intensity: torch.Tensor  # [L, 3]
    texture_texels: torch.Tensor  # [T, 3]
    background: torch.Tensor  # [3]
    environment: torch.Tensor  # [3]


def extract_params(scene: SceneArrays) -> DiffParams:
    return DiffParams(
        mtl_diffuse=scene.materials.diffuse,
        mtl_specular=scene.materials.specular,
        mtl_emission=scene.materials.emission,
        mtl_reflection=scene.materials.reflection,
        mtl_refraction=scene.materials.refraction,
        mtl_glossiness=scene.materials.glossiness,
        light_intensity=scene.lights.intensity,
        texture_texels=scene.textures.texels,
        background=scene.background.color,
        environment=scene.environment.color,
    )


def splice_params(scene: SceneArrays, params: DiffParams) -> SceneArrays:
    """scene with params in place of its own. The megakernel's tables
    (scene.kernel), where the scene has them, get the new values too, as
    constants: gradients reach the parameters through the leaves."""
    out = scene._replace(
        materials=scene.materials._replace(
            diffuse=params.mtl_diffuse,
            specular=params.mtl_specular,
            emission=params.mtl_emission,
            reflection=params.mtl_reflection,
            refraction=params.mtl_refraction,
            glossiness=params.mtl_glossiness,
        ),
        lights=scene.lights._replace(intensity=params.light_intensity),
        textures=scene.textures._replace(texels=params.texture_texels),
        background=scene.background._replace(color=params.background),
        environment=scene.environment._replace(color=params.environment),
    )
    tabs = scene.kernel
    if tabs is None:
        return out
    with torch.no_grad():
        # Columns 0-15 of a material row, 0-2 of a light row and 19-24 of
        # the camera vector (scene.arrays.with_kernel_tables).
        mtl = torch.cat([params.mtl_diffuse, params.mtl_specular,
                         params.mtl_emission, params.mtl_reflection,
                         params.mtl_refraction,
                         params.mtl_glossiness[:, None], tabs.mtl[:, 16:]],
                        dim=1)
        light = torch.cat([params.light_intensity, tabs.light[:, 3:]], dim=1)
        cam = torch.cat([tabs.cam[:19], params.background,
                         params.environment])

    def f32(t):
        return t.to(torch.float32).contiguous()

    return out._replace(kernel=tabs._replace(mtl=f32(mtl), light=f32(light),
                                             cam=f32(cam)))


def render_with_params(scene, meta, cfg, params: DiffParams, px, py,
                       sample_ids, key_words):
    """Radiance [B, 3] as a function of the differentiable bundle.

    Drives the wavefront engine directly (as the JAX package drives its
    XLA engine): under autograd the megakernel's backward would run that
    engine anyway (ops/megakernel.py), so this saves the megakernel's
    forward. render_batch (and its megakernel) stays differentiable for
    callers who backpropagate through it themselves."""
    from qaray_tpu_torch.integrators.engine import render_batch_wavefront

    radiance, _ = render_batch_wavefront(splice_params(scene, params), meta,
                                         cfg, px, py, sample_ids, key_words)
    return radiance


def _unpack_adjoint(flat, meta, scene) -> DiffParams:
    """ops/adjoint.param_layout flat vector -> DiffParams (the texels, which
    the fused adjoint does not serve, get zeros)."""
    m = meta.num_materials
    ll = meta.num_lights
    mt = flat[: m * 16].reshape(m, 16)
    lb = m * 16
    return DiffParams(
        mtl_diffuse=mt[:, 0:3],
        mtl_specular=mt[:, 3:6],
        mtl_emission=mt[:, 6:9],
        mtl_reflection=mt[:, 9:12],
        mtl_refraction=mt[:, 12:15],
        mtl_glossiness=mt[:, 15],
        light_intensity=flat[lb: lb + ll * 3].reshape(ll, 3),
        texture_texels=torch.zeros_like(scene.textures.texels),
        background=flat[lb + ll * 3: lb + ll * 3 + 3],
        environment=flat[lb + ll * 3 + 3: lb + ll * 3 + 6],
    )


def _loss(radiance, target):
    if target is None:
        return radiance.mean()
    return ((radiance - target) ** 2).mean()


def render_value_and_grad(scene, meta, cfg, px, py, sample_ids, key_words,
                          target=None):
    """(loss, DiffParams gradients) for one sample round.

    loss = mean(radiance) when target is None, else mean((radiance -
    target)^2), the inverse-rendering objective. key_words: 2 threefry
    words or the 4 of an rbg key (core.rng.fold_words).

    Fast route, where adjoint_supported(meta, cfg) and
    use_pathtrace_mega(meta, cfg): the megakernel's forward, the loss's
    cotangent ct on its radiance, and one launch of the fused adjoint
    (ops/adjoint.adjoint_render), which replays the forward's draws: the
    exact gradient of the same estimator. A kernel that does not build or
    launch raises. Otherwise autograd through render_with_params."""
    from qaray_tpu_torch.integrators.engine import use_pathtrace_mega
    from qaray_tpu_torch.ops.adjoint import adjoint_render, adjoint_supported

    if adjoint_supported(meta, cfg) and use_pathtrace_mega(meta, cfg):
        from qaray_tpu_torch.ops.megakernel import mega_render

        with torch.no_grad():
            radiance, _ = mega_render(scene, meta, cfg, px, py, sample_ids,
                                      key_words)
            n = radiance.numel()
            loss = _loss(radiance, target)
            if target is None:
                ct = torch.full_like(radiance, 1.0 / n)
            else:
                ct = 2.0 * (radiance - target) / n
        flat = adjoint_render(scene, meta, cfg, px, py, sample_ids,
                              key_words, ct)
        return loss, _unpack_adjoint(flat, meta, scene)

    params = DiffParams(*(t.detach().requires_grad_()
                          for t in extract_params(scene)))
    with torch.enable_grad():
        loss = _loss(render_with_params(scene, meta, cfg, params, px, py,
                                        sample_ids, key_words), target)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss.detach(), DiffParams(*(
        torch.zeros_like(p) if g is None else g
        for p, g in zip(params, grads)))


def params_from_numpy(params, device="cuda") -> DiffParams:
    """The JAX package's DiffParams with numpy leaves (jax.tree.map(
    np.asarray, params)) -> the port's DiffParams on `device`, field by
    field; the counterpart of scene.convert.from_numpy_arrays for the
    parameter bundle."""
    return DiffParams(*(torch.as_tensor(np.array(getattr(params, f)),
                                        device=device)
                        for f in DiffParams._fields))
