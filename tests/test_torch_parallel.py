"""The port's sharded render and gradients (qaray_tpu_torch.parallel.mesh,
diff.render_value_and_grad(mesh=...)) against one device and against the
JAX package's sharded execution on its 8-device CPU mesh: the counterparts
of tests/test_sharded.py::test_sharded_{forward,gradient}_matches_single,
on in-repo scenes.

A mesh of ["cpu"] * 4 splits the lanes into four shards on the CPU, as
JAX's forced host device count does for its mesh. A lane's draws depend
only on (key words, pixel, sample), so the sharded outputs equal one
render_batch's bit for bit, under threefry and rbg words, and whether the
lane count divides by the mesh or not. The gradients are sums over the
shards, in another order than one device's: atol 1e-5, the JAX test's bar.
Against the JAX package the bars are tests/test_torch_engine.py's (the
forward) and tests/test_torch_grad.py's (the gradients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from qaray_tpu.diff import extract_params as jax_extract
from qaray_tpu.diff import render_with_params as jax_render_with_params
from qaray_tpu.integrators.engine import IntegratorConfig as JaxConfig
from qaray_tpu.integrators.engine import render_batch as jax_render_batch
from qaray_tpu.parallel.mesh import make_render_mesh as jax_mesh
from qaray_tpu_torch import diff
from qaray_tpu_torch.core.rng import key_words
from qaray_tpu_torch.integrators import engine
from qaray_tpu_torch.ops.adjoint import adjoint_supported
from qaray_tpu_torch.parallel.mesh import (
    device_put_replicated,
    device_put_sharded_batch,
    make_render_mesh,
    shard_bounds,
    shard_render_batch,
)
from test_torch_engine import compare, lanes, scenes
from test_torch_grad import KW as GRAD_KW
from test_torch_grad import assert_fields, grad_scene, words

KW = dict(integrator="pathtrace", max_bounce=2, shadow_spp=4)
RES = (32, 32)


@pytest.fixture(scope="module")
def spot():
    return scenes("spot", RES)


def test_shard_bounds_split_like_a_padded_axis():
    assert shard_bounds(1024, 4) == [0, 256, 512, 768, 1024]
    assert shard_bounds(1021, 4) == [0, 256, 512, 768, 1021]
    assert shard_bounds(5, 4) == [0, 2, 4, 5, 5]
    mesh = make_render_mesh(["cpu"] * 4)
    parts = device_put_sharded_batch(torch.arange(1021), mesh)
    assert [p.shape[0] for p in parts] == [256, 256, 256, 253]
    assert torch.equal(torch.cat(parts), torch.arange(1021))


@pytest.mark.parametrize("n", [1024, 1021])
@pytest.mark.parametrize("impl", ["threefry2x32", "rbg"])
def test_sharded_forward_matches_single(spot, impl, n):
    """Four shards on the CPU against one render_batch: radiance, depth and
    the aux plane bit for bit, with the scene passed as a tree and as its
    replicas."""
    _, _, tarr, tmeta = spot
    px, py, sid = (torch.tensor(x[:n]) for x in lanes(RES, 1))
    w = key_words(impl, 7)
    cfg = engine.IntegratorConfig(**KW)
    want = engine.render_batch(tarr, tmeta, cfg, px, py, sid, w,
                               want_aux=True)
    mesh = make_render_mesh(["cpu"] * 4)
    run = shard_render_batch(mesh)
    for scene in (tarr, device_put_replicated(tarr, mesh)):
        got = run(scene, tmeta, cfg, px, py, sid, w, want_aux=True)
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_sharded_forward_matches_jax(spot):
    """The same lanes through JAX's render_batch on its 8-device CPU mesh
    (the scene replicated, the lanes sharded, as tests/test_sharded.py
    places them) and the port's over four shards, under one threefry key:
    tests/test_torch_engine.py's bars."""
    arrays, meta, tarr, tmeta = spot
    px, py, sid = lanes(RES, 1)
    key = jax.random.key(7, impl="threefry2x32")
    mesh = jax_mesh(jax.devices()[:8])
    sharded, replicated = NamedSharding(mesh, P("rays")), NamedSharding(
        mesh, P())
    rad_x, t0_x = jax_render_batch(
        jax.device_put(arrays, replicated), meta, JaxConfig(**KW),
        jax.device_put(jnp.asarray(px), sharded),
        jax.device_put(jnp.asarray(py), sharded),
        jax.device_put(jnp.asarray(sid), sharded),
        jax.device_put(key, replicated))
    w = tuple(int(x) for x in np.asarray(jax.random.key_data(key)))
    rad, t0 = shard_render_batch(make_render_mesh(["cpu"] * 4))(
        tarr, tmeta, engine.IntegratorConfig(**KW), torch.tensor(px),
        torch.tensor(py), torch.tensor(sid), w)
    compare(np.asarray(rad_x), np.asarray(t0_x), rad.numpy(), t0.numpy())


@pytest.fixture(scope="module")
def grad_spot():
    return grad_scene("spot")


@pytest.mark.parametrize("loss", ["mean", "mse"])
@pytest.mark.parametrize("route", ["fast", "autograd"])
def test_sharded_gradient_matches_single(grad_spot, route, loss,
                                         monkeypatch):
    """render_value_and_grad over four shards against one device, by both
    routes (QARAY_NO_MEGAKERNEL forces autograd): the loss and every
    DiffParams field within atol 1e-5."""
    _, _, tarr, tmeta, res = grad_spot
    if route == "autograd":
        monkeypatch.setenv("QARAY_NO_MEGAKERNEL", "1")
    px, py, sid = (torch.tensor(x) for x in lanes(res, 1))
    target = None
    if loss == "mse":
        target = torch.tensor(np.random.RandomState(1).uniform(
            0.0, 1.0, (px.shape[0], 3)).astype(np.float32))
    cfg = engine.IntegratorConfig(**GRAD_KW)
    fast = (adjoint_supported(tmeta, cfg)
            and engine.use_pathtrace_mega(tmeta, cfg))
    assert fast == (route == "fast")
    loss_1, want = diff.render_value_and_grad(tarr, tmeta, cfg, px, py, sid,
                                              words(), target)
    loss_4, got = diff.render_value_and_grad(
        tarr, tmeta, cfg, px, py, sid, words(), target,
        mesh=make_render_mesh(["cpu"] * 4))
    np.testing.assert_allclose(float(loss_4), float(loss_1), atol=1e-6)
    for f in diff.DiffParams._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.shape == b.shape, f
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   err_msg=f)
    assert max(float(g.abs().max()) for g in got if g.numel()) > 0.0


@pytest.mark.parametrize("route", ["fast", "autograd"])
def test_sharded_gradient_matches_jax(grad_spot, route, monkeypatch):
    """The port's gradient over four shards against JAX's over its
    8-device mesh (jax.grad of the mean radiance with the parameters
    replicated and the lanes sharded, XLA's psum): tests/test_torch_grad.py's
    bar."""
    arrays, meta, tarr, tmeta, res = grad_spot
    px, py, sid = lanes(res, 1)
    key = jax.random.key(3, impl="threefry2x32")
    mesh = jax_mesh(jax.devices()[:8])
    sharded, replicated = NamedSharding(mesh, P("rays")), NamedSharding(
        mesh, P())
    cfg_j = JaxConfig(**GRAD_KW)

    def loss(p, scene, px, py, sid, key):
        return jnp.mean(jax_render_with_params(scene, meta, cfg_j, p, px, py,
                                               sid, key))

    want = jax.grad(loss)(
        jax.device_put(jax_extract(arrays), replicated),
        jax.device_put(arrays, replicated),
        *(jax.device_put(jnp.asarray(x), sharded) for x in (px, py, sid)),
        jax.device_put(key, replicated))
    if route == "autograd":
        monkeypatch.setenv("QARAY_NO_MEGAKERNEL", "1")
    _, got = diff.render_value_and_grad(
        tarr, tmeta, engine.IntegratorConfig(**GRAD_KW),
        *(torch.tensor(x) for x in (px, py, sid)), words(),
        mesh=make_render_mesh(["cpu"] * 4))
    assert_fields(got, want, f"sharded {route}")


def test_new_modules_import_no_jax():
    """parallel/, utils/ and viz/ import neither jax nor qaray_tpu."""
    import os
    import subprocess
    import sys

    code = (
        "import sys\n"
        "import qaray_tpu_torch.parallel.mesh, qaray_tpu_torch.parallel\n"
        "import qaray_tpu_torch.parallel.distributed\n"
        "import qaray_tpu_torch.utils.timing, qaray_tpu_torch.utils\n"
        "import qaray_tpu_torch.viz.serve, qaray_tpu_torch.viz.photon_viz\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'qaray_tpu')]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
