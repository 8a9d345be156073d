"""The port's gradients (qaray_tpu_torch.diff, the K2 and K1 backward rules)
against qaray_tpu's.

Both packages compute the same estimator under a threefry key (detached
sampling, the same draws), so their gradients agree to rounding: the bar
is tests/test_megakernel.py::test_mega_grad_matches_xla's, |a - b| <= 1e-4
* (1 + max|b|) per DiffParams field. Scenes come from tests/assets and are
compiled once by qaray_tpu and carried into the port
(scene.convert.from_numpy_arrays); the cotangent is one numpy draw from
RandomState(0) handed to both. The JAX side runs as its own tests run it on
the CPU: its XLA engine (force_xla), and the Pallas analytic kernels in
interpret mode.

The two packages' forward renders differ on a few lanes, as
tests/test_torch_engine.py's bars allow (0.2 % of lanes above 1e-3
relative, a median under 1e-6): a last-bit difference of a hit distance
between XLA's and torch's CPU code flips a shadow ray or a lobe there, and
such a lane follows another path in each package, with other gradients.
Lanes whose radiance differs by more than 1e-4 relative (a hundred times
the rounding of a lane that follows the same path) get a zero cotangent on
both sides; there may be at most one of them (0.2 % of the largest image
here, rounded up). On the glass scene one lane is such: its primary hit
differs by 1e-5 in t, a soft-shadow ray of the light grazes a sphere in
one package only, and the lane's radiance differs by 9.4e-4 relative,
which alone moves the diffuse gradient by 2e-4 of 1 + max|b|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qaray_tpu import diff as jdiff
from qaray_tpu.integrators.engine import IntegratorConfig as JaxConfig
from qaray_tpu.integrators.engine import render_batch_xla_impl
from qaray_tpu.ops.pallas_analytic import (
    closest_analytic_full_pallas,
    closest_analytic_pallas,
)
from qaray_tpu.scene.compiler import compile_scene
from qaray_tpu.scene.xml_parser import load_scene
from qaray_tpu_torch import diff
from qaray_tpu_torch.integrators import engine
from qaray_tpu_torch.integrators.engine import IntegratorConfig
from qaray_tpu_torch.ops import analytic, megakernel
from qaray_tpu_torch.ops.adjoint import (
    adjoint_supported,
    pack_grads,
    param_layout,
)
from qaray_tpu_torch.scene.convert import from_numpy_arrays
from qaray_tpu_torch.scene.procedural import with_glass, with_texture
from qaray_tpu_torch.scene.textures import load_image
from test_torch_engine import lanes

KW = dict(integrator="pathtrace", max_bounce=2, shadow_spp=2,
          shadow_spp_max=4)
KEY = 3


def grad_scene(name):
    """(JAX arrays, JAX meta, port arrays, port meta, resolution) of one
    gradient scene: spot_scene, mesh_scene, the glass scene (softdof with
    its depth of field 0 and its middle sphere glass) or spot_scene with
    tests/assets/colorBuffer.png on the ball's diffuse slot."""
    res = (16, 12)
    if name == "glass":
        desc = with_glass(load_scene("tests/assets/softdof_scene.xml"), "mid")
        desc.camera.depth_of_field = 0.0
        res = (24, 18)
    elif name == "texture":
        desc = with_texture(load_scene("tests/assets/spot_scene.xml"),
                            ("mat2", "diffuse"),
                            image=load_image("tests/assets/colorBuffer.png"))
    else:
        desc = load_scene(f"tests/assets/{name}_scene.xml")
    desc.camera.img_width, desc.camera.img_height = res
    arrays, meta = compile_scene(desc)
    tarr, tmeta = from_numpy_arrays(jax.tree.map(np.asarray, arrays), meta,
                                    "cpu")
    assert not meta.has_dof
    return arrays, meta, tarr, tmeta, res


def cotangent(n, seed=0):
    return np.random.RandomState(seed).standard_normal((n, 3)).astype(
        np.float32)


def words():
    kd = jax.random.key_data(jax.random.key(KEY, impl="threefry2x32"))
    return tuple(int(w) for w in np.asarray(kd))


def assert_fields(got, want, what, bar=1e-4):
    """Per field: |a - b| <= bar * (1 + max|b|); returns the largest
    difference over (1 + max|b|)."""
    worst = 0.0
    for f in diff.DiffParams._fields:
        a = getattr(got, f).detach().numpy()
        b = np.asarray(getattr(want, f))
        assert a.shape == b.shape, (what, f, a.shape, b.shape)
        err = np.abs(a - b).max(initial=0.0) / (1.0 + np.abs(b).max(
            initial=0.0))
        assert err <= bar, f"{what}: {f} off by {err:.3g} of 1 + max|b|"
        worst = max(worst, err)
    return worst


def jax_vjp(arrays, meta, kw, px, py, sid, ct, rad_port):
    """jax.vjp of render_batch_xla_impl (force_xla) with respect to the
    JAX package's DiffParams, at the cotangent ct zeroed on the lanes whose
    radiance differs from the port's rad_port by more than 1e-4 relative:
    (gradients, the mask of lanes kept)."""
    meta_x = meta._replace(force_xla=True)
    key = jax.random.key(KEY, impl="threefry2x32")

    @jax.jit
    def run(arrays, params, ct, rad_port):
        def f(p):
            return render_batch_xla_impl(jdiff.splice_params(arrays, p),
                                         meta_x, JaxConfig(**kw), px, py,
                                         sid, key)[0]

        rad, vjp = jax.vjp(f, params)
        rel = (jnp.abs(rad - rad_port).max(-1)
               / (1.0 + jnp.abs(rad).max(-1)))
        keep = rel <= 1e-4
        return vjp(jnp.where(keep[:, None], ct, 0.0))[0], keep

    grads, keep = run(arrays, jdiff.extract_params(arrays), jnp.asarray(ct),
                      jnp.asarray(rad_port))
    return grads, np.asarray(keep)


def port_vjp(tarr, tmeta, kw, px, py, sid, ct):
    """(radiance, DiffParams gradients of sum(radiance * ct)) of
    render_with_params; ct may be a function of the radiance."""
    params = diff.DiffParams(*(t.detach().requires_grad_()
                               for t in diff.extract_params(tarr)))
    rad = diff.render_with_params(tarr, tmeta, IntegratorConfig(**kw),
                                  params, px, py, sid, words())
    if callable(ct):
        ct = ct(rad.detach())
    grads = torch.autograd.grad((rad * ct).sum(), params, allow_unused=True)
    return rad.detach(), diff.DiffParams(*(
        torch.zeros_like(p) if g is None else g
        for p, g in zip(params, grads)))


@pytest.mark.parametrize("name", ["spot", "mesh", "glass", "texture"])
def test_render_with_params_grad_matches_jax(name, monkeypatch):
    """Autograd through render_with_params against jax.vjp of the XLA
    engine: every DiffParams field, texels included on the textured
    scene (the ball's diffuse texture) and refraction on the glass one.
    mesh_scene runs the dense sweep (K3's plain version) on both sides."""
    if name == "mesh":
        monkeypatch.setenv("QARAY_MESH_PATH", "stream")
        jax.clear_caches()
    arrays, meta, tarr, tmeta, res = grad_scene(name)
    px, py, sid = lanes(res, 1)
    ct = cotangent(px.shape[0])
    rad, _ = engine.render_batch_wavefront(
        tarr, tmeta, IntegratorConfig(**KW), torch.tensor(px),
        torch.tensor(py), torch.tensor(sid), words())
    want, keep = jax_vjp(arrays, meta, KW, jnp.asarray(px), jnp.asarray(py),
                         jnp.asarray(sid), ct, rad.numpy())
    assert (~keep).sum() <= 1, (~keep).sum()
    _, got = port_vjp(tarr, tmeta, KW, torch.tensor(px), torch.tensor(py),
                      torch.tensor(sid), torch.tensor(ct * keep[:, None]))
    err = assert_fields(got, want, name)
    print(f"{name}: {(~keep).sum()} lanes of {keep.size} apart in the "
          f"forward, worst field {err:.3g} of 1 + max|b|")
    if name == "texture":
        assert float(np.abs(np.asarray(want.texture_texels)).max()) > 0.0
        assert tmeta.has_mtl_textures
    if name == "glass":
        assert float(np.abs(np.asarray(want.mtl_refraction)).max()) > 0.0
    if name == "mesh":
        assert tmeta.mesh_mega and not tmeta.mesh_mega_stream
        jax.clear_caches()


@pytest.mark.parametrize("route", ["fast", "autograd"])
@pytest.mark.parametrize("loss", ["mean", "mse"])
def test_render_value_and_grad_matches_jax(route, loss, monkeypatch):
    """render_value_and_grad on spot_scene by both routes (on the CPU the
    fast route is the megakernel's plain version and adjoint_render_plain;
    QARAY_NO_MEGAKERNEL forces autograd through render_with_params)
    against the JAX package's, which takes its autograd route here."""
    arrays, meta, tarr, tmeta, res = grad_scene("spot")
    px, py, sid = lanes(res, 1)
    cfg = IntegratorConfig(**KW)
    target = None
    if loss == "mse":
        target = np.random.RandomState(1).uniform(
            0.0, 1.0, (px.shape[0], 3)).astype(np.float32)
    key = jax.random.key(KEY, impl="threefry2x32")
    loss_j, want = jdiff.render_value_and_grad(
        arrays, meta, JaxConfig(**KW), jnp.asarray(px), jnp.asarray(py),
        jnp.asarray(sid), key,
        None if target is None else jnp.asarray(target))
    if route == "autograd":
        monkeypatch.setenv("QARAY_NO_MEGAKERNEL", "1")
    fast = (adjoint_supported(tmeta, cfg)
            and engine.use_pathtrace_mega(tmeta, cfg))
    assert fast == (route == "fast")
    loss_t, got = diff.render_value_and_grad(
        tarr, tmeta, cfg, torch.tensor(px), torch.tensor(py),
        torch.tensor(sid), words(),
        None if target is None else torch.tensor(target))
    assert not loss_t.requires_grad
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    assert_fields(got, want, f"{route} {loss}")


def random_rays(n=1024, seed=0):
    """Rays from a box around softdof_scene's spheres, aimed near them."""
    rs = np.random.RandomState(seed)
    p = rs.uniform(-30.0, 30.0, (n, 3)).astype(np.float32)
    p[:, 2] = rs.uniform(1.0, 25.0, n)
    target = rs.uniform(-8.0, 8.0, (n, 3)).astype(np.float32)
    target[:, 2] = rs.uniform(0.0, 8.0, n)
    d = target - p
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return p, d.astype(np.float32)


@pytest.mark.parametrize("full", [False, True])
def test_k2_backward_matches_jax(full):
    """The K2 Functions' gradients of sum(w * t) for p, d, m_w2o and t_o2w
    against jax.grad through closest_analytic_pallas(interpret=True) and
    closest_analytic_full_pallas on 1,024 random rays at softdof's
    primitives (the winner-only backward on both sides)."""
    arrays, meta, tarr, tmeta, _ = grad_scene("glass")
    p, d = random_rays()
    w = np.random.RandomState(2).standard_normal(p.shape[0]).astype(
        np.float32)
    prims = arrays.analytic

    def loss_j(p_, d_, m_, tr_):
        pr = prims._replace(m_w2o=m_, t_o2w=tr_)
        if full:
            t = closest_analytic_full_pallas(p_, d_, pr, meta.analytic_kinds,
                                             False, True)["t"]
        else:
            t = closest_analytic_pallas(p_, d_, pr, meta.analytic_kinds,
                                        True)[0]
        return jnp.sum(jnp.where(t < 1e29, t, 0.0) * w)

    want = jax.grad(loss_j, argnums=(0, 1, 2, 3))(
        jnp.asarray(p), jnp.asarray(d), prims.m_w2o, prims.t_o2w)
    tp = tarr.analytic
    ins = [torch.tensor(p).requires_grad_(), torch.tensor(d).requires_grad_(),
           tp.m_w2o.clone().requires_grad_(),
           tp.t_o2w.clone().requires_grad_()]
    prims_t = tp._replace(m_w2o=ins[2], t_o2w=ins[3])
    if full:
        out = analytic.closest_full(ins[0], ins[1], prims_t)
        t = out["t"]
        assert not any(out[k].requires_grad for k in ("n", "uvw", "p"))
    else:
        t = analytic.closest(ins[0], ins[1], prims_t)[0]
    hit = t < 1e29
    assert 0.3 < float(hit.double().mean()) < 1.0
    loss = torch.where(hit, t, torch.zeros_like(t)) @ torch.tensor(w)
    got = torch.autograd.grad(loss, ins)
    for g, h, what in zip(got, want, ("p", "d", "m_w2o", "t_o2w")):
        h = np.asarray(h)
        err = np.abs(g.numpy() - h).max() / (1.0 + np.abs(h).max())
        assert err <= 1e-4, f"{what}: off by {err:.3g} of 1 + max|b|"


def test_param_layout_and_unpack_match_jax():
    """param_layout and _unpack_adjoint against the JAX package's on a
    synthetic flat vector; pack_grads inverts _unpack_adjoint."""
    from qaray_tpu.ops.pallas_adjoint import param_layout as jax_layout

    arrays, meta, tarr, tmeta, _ = grad_scene("glass")
    for m, ll in ((1, 1), (3, 2), (8, 8)):
        assert param_layout(m, ll) == jax_layout(m, ll)
    n = param_layout(tmeta.num_materials, tmeta.num_lights)
    flat = np.arange(n, dtype=np.float32) * 0.5 - 3.0
    want = jdiff._unpack_adjoint(jnp.asarray(flat), meta, arrays)
    got = diff._unpack_adjoint(torch.tensor(flat), tmeta, tarr)
    for f in diff.DiffParams._fields:
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(want, f))), f
    assert torch.equal(pack_grads(got, tmeta), torch.tensor(flat))
    moved = diff.params_from_numpy(jax.tree.map(np.asarray, want), "cpu")
    for f in diff.DiffParams._fields:
        assert torch.equal(getattr(moved, f), getattr(got, f)), f


def test_mega_render_function_matches_render_with_params():
    """mega_render's autograd Function (the megakernel's backward rule; on
    the CPU its forward is the engine) gives render_with_params'
    gradients, through engine.render_batch on the megakernel route, in
    backward batches smaller than the lane count."""
    _, _, tarr, tmeta, res = grad_scene("spot")
    cfg = IntegratorConfig(**KW)
    assert engine.use_pathtrace_mega(tmeta, cfg)
    px, py, sid = (torch.tensor(a) for a in lanes(res, 2))
    ct = torch.tensor(cotangent(px.shape[0]))
    want = port_vjp(tarr, tmeta, KW, px, py, sid, ct)[1]
    params = diff.DiffParams(*(t.detach().requires_grad_()
                               for t in diff.extract_params(tarr)))
    scene = diff.splice_params(tarr, params)
    old = megakernel.BWD_BATCH
    megakernel.BWD_BATCH = 100
    try:
        rad, t0 = engine.render_batch(scene, tmeta, cfg, px, py, sid,
                                      words())
        assert rad.grad_fn is not None and not t0.requires_grad
        grads = torch.autograd.grad((rad * ct).sum(), params,
                                    allow_unused=True)
    finally:
        megakernel.BWD_BATCH = old
    got = diff.DiffParams(*(torch.zeros_like(p) if g is None else g
                            for p, g in zip(params, grads)))
    for f in diff.DiffParams._fields:
        torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                   rtol=1e-5, atol=1e-6)
    flat = pack_grads(got, tmeta)
    assert flat.shape == (param_layout(tmeta.num_materials,
                                       tmeta.num_lights),)
