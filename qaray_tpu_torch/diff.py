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
autograd with K2's winner-only rule (ops/analytic.py). Both routes' steps
are captured on a card (utils/compiled.py). On CPU tensors the kernels'
plain versions run in their place.

Each step is one program span, grad.fast or grad.autograd after its route
(utils/timing.span; its id the process's step count): the spans' calls in
timing.totals count each route's steps, a mesh's shards inside one.
"""

from typing import NamedTuple

import numpy as np
import torch

from qaray_tpu_torch.integrators.engine import _plain_walks
from qaray_tpu_torch.scene.arrays import SceneArrays
from qaray_tpu_torch.utils.compiled import jit
from qaray_tpu_torch.utils import timing

GRAD_SPANS = ("grad.fast", "grad.autograd")


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
    callers who backpropagate through it themselves. Under such a caller's
    autograd on a card both replay captured graphs, a forward without a
    tape and a backward step (utils/compiled.py)."""
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


def _loss(radiance, target, n=None):
    """The mean of radiance (or of (radiance - target)^2) over its
    elements; with n, their sum over n (a shard's part of the mean over n
    elements)."""
    err = radiance if target is None else (radiance - target) ** 2
    return err.mean() if n is None else err.sum() / n


def render_value_and_grad(scene, meta, cfg, px, py, sample_ids, key_words,
                          target=None, mesh=None):
    """(loss, DiffParams gradients) for one sample round.

    loss = mean(radiance) when target is None, else mean((radiance -
    target)^2), the inverse-rendering objective. key_words: 2 threefry
    words or the 4 of an rbg key (core.rng.fold_words).

    Fast route, where adjoint_supported(meta, cfg) and
    use_pathtrace_mega(meta, cfg): the megakernel's forward, the loss's
    cotangent ct on its radiance, and one launch of the fused adjoint
    (ops/adjoint.adjoint_render), which replays the forward's draws: the
    exact gradient of the same estimator. A kernel that does not build or
    launch raises. Otherwise autograd through render_with_params.

    With a mesh (parallel.mesh.RenderMesh) the lanes are sharded over it:
    each of this process's shards takes its route on its device with the
    global element count in its cotangent, and the losses and gradients
    are summed over the shards and all-reduced across processes: the
    explicit counterpart of the psum XLA inserts for the JAX package. The
    sum's order is not one device's, so the result agrees with the
    unsharded one to rounding, not bit for bit."""
    step = 1 + sum(timing.totals.get(k, (0.0, 0))[1] for k in GRAD_SPANS)
    with timing.span(GRAD_SPANS[not _fast_route(meta, cfg)],
                     id=f"step {step}"):
        if mesh is not None:
            return _sharded_value_and_grad(scene, meta, cfg, px, py,
                                           sample_ids, key_words, target,
                                           mesh)
        return _value_and_grad(scene, meta, cfg, px, py, sample_ids,
                               key_words, target)


def _fast_route(meta, cfg) -> bool:
    """Whether a step takes the fast route (see render_value_and_grad)."""
    from qaray_tpu_torch.integrators.engine import use_pathtrace_mega
    from qaray_tpu_torch.ops.adjoint import adjoint_supported

    return adjoint_supported(meta, cfg) and use_pathtrace_mega(meta, cfg)


def _value_and_grad(scene, meta, cfg, px, py, sample_ids, key_words, target,
                    n=None):
    """render_value_and_grad on one device; with n, of the loss's part
    sum / n over these lanes' n-element share."""
    with torch.no_grad():  # the caller's tape does not reach the steps
        if _fast_route(meta, cfg):
            loss, flat = _fast_step(scene, meta, cfg, px, py, sample_ids,
                                    key_words, target, n)
            return loss, _unpack_adjoint(flat, meta, scene)
        return _autograd_step(scene, meta, cfg, px, py, sample_ids,
                              key_words, target, n)


def _autograd_value_and_grad(scene, meta, cfg, px, py, sample_ids, key_words,
                             target, n):
    """The autograd route's step: leaves made from the scene's DiffParams
    fields, render_with_params on them (the wavefront engine on the step's
    own tape), the loss and its gradients; zeros for the fields the loss
    does not reach."""
    params = DiffParams(*(t.detach().requires_grad_()
                          for t in extract_params(scene)))
    with torch.enable_grad():
        loss = _loss(render_with_params(scene, meta, cfg, params, px, py,
                                        sample_ids, key_words), target, n)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss.detach(), DiffParams(*(
        torch.zeros_like(p) if g is None else g
        for p, g in zip(params, grads)))


def _fast_value_and_grad(scene, meta, cfg, px, py, sample_ids, key_words,
                         target, n):
    """The fast route's step: the megakernel's forward, the loss, its
    cotangent and the fused adjoint: (loss, flat gradient)."""
    from qaray_tpu_torch.ops.adjoint import adjoint_render
    from qaray_tpu_torch.ops.megakernel import mega_render

    with torch.no_grad():
        radiance, _ = mega_render(scene, meta, cfg, px, py, sample_ids,
                                  key_words)
        loss = _loss(radiance, target, n)
        n = radiance.numel() if n is None else n
        if target is None:
            ct = torch.full_like(radiance, 1.0 / n)
        else:
            ct = 2.0 * (radiance - target) / n
    flat = adjoint_render(scene, meta, cfg, px, py, sample_ids, key_words,
                          ct)
    return loss, flat


# The fast route's step under capture (utils/compiled.py), the counterpart
# of the JAX package's jitted render_value_and_grad (qaray_tpu/diff.py:118).
# The parameters of each step reach it spliced into the scene's material
# and light tables, which the graph reads from buffers they are copied into
# when they change: a loop over changing parameters replays one graph.
_fast_step = jit(_fast_value_and_grad, static_argnames=("meta", "cfg"),
                 inputs=("px", "py", "sample_ids", "target"))


# The autograd route's step under capture, one forward and one backward in
# one graph (the JAX package's jit covers this route too); its parameters
# reach it through the tables as the fast route's do. The plain walks on
# the card run it eagerly, as render_batch does.
_autograd_step = jit(_autograd_value_and_grad,
                     static_argnames=("meta", "cfg"),
                     inputs=("px", "py", "sample_ids", "target"),
                     eager_if=_plain_walks)


def _sharded_value_and_grad(scene, meta, cfg, px, py, sample_ids, key_words,
                            target, mesh):
    """render_value_and_grad over the mesh's shards (see there), on px's
    device."""
    import torch.distributed as dist

    from qaray_tpu_torch.parallel import distributed
    from qaray_tpu_torch.parallel.mesh import (
        device_put_replicated,
        device_scope,
        shard_bounds,
    )

    scenes = device_put_replicated(scene, mesh)
    n = px.shape[0] * 3
    cuts = shard_bounds(px.shape[0], mesh.size)
    dev = px.device
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    grads = [torch.zeros_like(t, device=dev) for t in extract_params(scene)]
    for i in mesh.local:
        a, b = cuts[i], cuts[i + 1]
        if a == b:
            continue
        d = mesh.devices[i].device
        with device_scope(d):
            part, g = _value_and_grad(
                scenes.on(d), meta, cfg, px[a:b].to(d), py[a:b].to(d),
                sample_ids[a:b].to(d), key_words,
                None if target is None else target[a:b].to(d), n)
        loss = loss + part.to(dev)
        grads = [x + y.to(dev) for x, y in zip(grads, g)]
    if mesh.multiprocess:
        flat = torch.cat([loss.reshape(1)] + [g.reshape(-1) for g in grads])
        flat = flat if distributed.backend() == "nccl" else flat.cpu()
        dist.all_reduce(flat, group=distributed.group())
        flat = flat.to(dev)
        loss, c = flat[0], 1
        for j, g in enumerate(grads):
            grads[j] = flat[c:c + g.numel()].reshape(g.shape)
            c += g.numel()
    return loss, DiffParams(*grads)


def params_from_numpy(params, device="cuda") -> DiffParams:
    """The JAX package's DiffParams with numpy leaves (jax.tree.map(
    np.asarray, params)) -> the port's DiffParams on `device`, field by
    field; the counterpart of scene.convert.from_numpy_arrays for the
    parameter bundle."""
    return DiffParams(*(torch.as_tensor(np.array(getattr(params, f)),
                                        device=device)
                        for f in DiffParams._fields))
