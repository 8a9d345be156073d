"""The gradient's captured forms (utils/compiled.py under autograd,
diff._autograd_step, megakernel._mega_backward) on the CPU, where the
wrapped functions run directly: what they compute, against the taped
engine and the JAX package.

- _autograd_step's function equals the route it replaced (leaves from the
  scene's DiffParams fields, render_with_params, the loss,
  torch.autograd.grad) bit for bit, and render_value_and_grad's autograd
  route is that function;
- a wrapped function under its caller's autograd (Compiled.differentiable:
  a forward with no tape, a backward step that re-runs the function, or
  render_batch's megakernel backward on its route) gives the taped
  engine's gradients bit for bit on spot, mesh (the dense sweep), glass
  and texture, and stays within test_torch_grad's bar, 1e-4 * (1 +
  max|b|), of jax.vjp of the JAX engine, with its scenes, keys and lanes;
- the megakernel's backward step equals the taped engine summed over its
  BWD_BATCH slices bit for bit, and render_batch's megakernel route under
  the Function equals its tape through _MegaRender;
- the wrapper keys a call whose tensors require grad (meta tensors stand
  for a card's) and runs it on the caller's tape on the CPU and under
  eager().
The captures themselves run on a card: tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qaray_tpu_torch import diff
from qaray_tpu_torch.integrators import engine
from qaray_tpu_torch.integrators.engine import IntegratorConfig
from qaray_tpu_torch.ops import megakernel
from qaray_tpu_torch.utils import compiled
from test_torch_engine import lanes
from test_torch_grad import (
    KW,
    assert_fields,
    cotangent,
    grad_scene,
    jax_vjp,
    port_vjp,
    words,
)


def _leaves(tarr, need=None):
    """DiffParams leaves made from the scene's fields (those in need only,
    where given, require grad) and the scene with them spliced in."""
    need = need or (True,) * len(diff.DiffParams._fields)
    params = diff.DiffParams(*(t.detach().requires_grad_(w)
                               for t, w in zip(diff.extract_params(tarr),
                                               need)))
    return params, diff.splice_params(tarr, params)


def _grads(out, params, ct):
    """Gradients of sum(out * ct) for the params that require grad, zeros
    where none reaches one."""
    wrt = [p for p in params if p.requires_grad]
    got = iter(torch.autograd.grad((out * ct).sum(), wrt, allow_unused=True))
    return diff.DiffParams(*(
        (lambda g: torch.zeros_like(p) if g is None else g)(next(got))
        if p.requires_grad else torch.zeros_like(p) for p in params))


def _assert_same_bits(got, want, what):
    for f in diff.DiffParams._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), (what, f)


@pytest.mark.parametrize("loss", ["mean", "mse"])
def test_autograd_step_equals_the_taped_route(loss, monkeypatch):
    """diff._autograd_step's function on spot_scene equals the eager route
    it replaced bit for bit, loss and every field; render_value_and_grad
    under QARAY_NO_MEGAKERNEL gives the same bits."""
    _, _, tarr, tmeta, res = grad_scene("spot")
    px, py, sid = (torch.tensor(a) for a in lanes(res, 1))
    cfg = IntegratorConfig(**KW)
    target = None
    if loss == "mse":
        target = torch.tensor(np.random.RandomState(1).uniform(
            0.0, 1.0, (px.shape[0], 3)).astype(np.float32))
    params, _ = _leaves(tarr)
    with torch.enable_grad():
        rad = diff.render_with_params(tarr, tmeta, cfg, params, px, py, sid,
                                      words())
        want_loss = rad.mean() if target is None else (
            (rad - target) ** 2).mean()
        grads = torch.autograd.grad(want_loss, params, allow_unused=True)
    want = diff.DiffParams(*(torch.zeros_like(p) if g is None else g
                             for p, g in zip(params, grads)))
    got_loss, got = diff._autograd_step.fn(tarr, tmeta, cfg, px, py, sid,
                                           words(), target, None)
    assert torch.equal(got_loss, want_loss.detach())
    _assert_same_bits(got, want, loss)
    monkeypatch.setenv("QARAY_NO_MEGAKERNEL", "1")
    loss_r, got_r = diff.render_value_and_grad(tarr, tmeta, cfg, px, py, sid,
                                               words(), target)
    assert torch.equal(loss_r, got_loss) and not loss_r.requires_grad
    _assert_same_bits(got_r, got, f"{loss} through render_value_and_grad")


@pytest.mark.parametrize("name", ["spot", "mesh", "glass", "texture"])
def test_differentiated_render_matches_tape_and_jax(name, monkeypatch):
    """render_with_params' wavefront engine and render_batch under their
    caller's autograd through the wrapper's Function (its forward without
    a tape; its backward the engine re-run, or the megakernel's backward
    step where render_batch takes that route: spot, mesh, glass) give the
    taped engine's gradients bit for bit, and stay within 1e-4 * (1 +
    max|b|) of jax.vjp of the JAX engine on the lanes whose forwards agree
    (test_render_with_params_grad_matches_jax's lanes, cotangent and
    keys)."""
    import jax

    if name == "mesh":
        monkeypatch.setenv("QARAY_MESH_PATH", "stream")
        jax.clear_caches()
    arrays, meta, tarr, tmeta, res = grad_scene(name)
    cfg = IntegratorConfig(**KW)
    px, py, sid = lanes(res, 1)
    tpx, tpy, tsid = (torch.tensor(a) for a in (px, py, sid))
    ct = cotangent(px.shape[0])
    rad, _ = engine.render_batch_wavefront(tarr, tmeta, cfg, tpx, tpy, tsid,
                                           words())
    want_j, keep = jax_vjp(arrays, meta, KW, jnp.asarray(px),
                           jnp.asarray(py), jnp.asarray(sid), ct,
                           rad.numpy())
    assert (~keep).sum() <= 1, (~keep).sum()
    tct = torch.tensor(ct * keep[:, None])
    rad_t, taped = port_vjp(tarr, tmeta, KW, tpx, tpy, tsid, tct)
    mega = engine.use_pathtrace_mega(tmeta, cfg)
    assert mega == (name != "texture")
    for fn in (engine.render_batch_wavefront, engine.render_batch):
        params, scene = _leaves(tarr)
        out, t0 = fn.differentiable(scene, tmeta, cfg, tpx, tpy, tsid,
                                    words())
        assert out.grad_fn is not None and torch.equal(out.detach(), rad_t)
        got = _grads(out, params, tct)
        _assert_same_bits(got, taped, f"{name} {fn.__name__}")
        err = assert_fields(got, want_j, f"{name} {fn.__name__}")
        print(f"{name} {fn.__name__}: worst field {err:.3g} of 1 + max|b|")
    if name == "mesh":
        jax.clear_caches()


def test_mega_backward_step_equals_sliced_tape():
    """megakernel._mega_backward's function on spot_scene, in batches of
    100 lanes, equals the taped engine's gradients summed over the same
    slices bit for bit, for the fields asked for (None for the others);
    render_batch on the megakernel route under the wrapper's Function
    (mega_vjp) equals render_batch on its own tape (_MegaRender), bit for
    bit, with only some leaves requiring grad; the Function's depth output
    carries no gradient."""
    _, _, tarr, tmeta, res = grad_scene("spot")
    cfg = IntegratorConfig(**KW)
    assert engine.use_pathtrace_mega(tmeta, cfg)
    px, py, sid = (torch.tensor(a) for a in lanes(res, 2))
    ct = torch.tensor(cotangent(px.shape[0], seed=2))
    need = tuple(f not in ("mtl_emission", "environment")
                 for f in diff.DiffParams._fields)
    old = megakernel.BWD_BATCH
    megakernel.BWD_BATCH = 100
    try:
        got = megakernel._mega_backward.fn(tarr, tmeta, cfg, px, py, sid,
                                           words(), None, ct, need)
        want = [torch.zeros_like(t) for t in diff.extract_params(tarr)]
        for lo in range(0, px.shape[0], 100):
            sl = slice(lo, lo + 100)
            params, _ = _leaves(tarr, need)
            rad = diff.render_with_params(tarr, tmeta, cfg, params, px[sl],
                                          py[sl], sid[sl], words())
            g = _grads(rad, params, ct[sl])
            want = [w + x for w, x in zip(want, g)]
        for f, w, g, x in zip(diff.DiffParams._fields, need, got, want):
            if not w:
                assert g is None, f
            else:
                assert torch.equal(g, x), f
        runs = []
        for call in (engine.render_batch, engine.render_batch.differentiable):
            params, scene = _leaves(tarr, need)
            rad, t0 = call(scene, tmeta, cfg, px, py, sid, words())
            assert rad.grad_fn is not None
            if call is engine.render_batch:
                assert not t0.requires_grad
            else:  # a float output of the Function: no gradient reaches it
                assert all(torch.equal(g, torch.zeros_like(g))
                           for g in _grads(t0[:, None], params,
                                           torch.ones(1, 3)))
            runs.append(_grads(rad, params, ct))
    finally:
        megakernel.BWD_BATCH = old
    _assert_same_bits(runs[1], runs[0], "render_batch Function against tape")
    for f, w, g, x in zip(diff.DiffParams._fields, need, runs[0], want):
        assert torch.equal(g, x if w else torch.zeros_like(g)), f


def _toy():
    """A wrapped function of a table, a lane input and a host value, with a
    float, an int and a second float output; its calls logged."""
    calls = []

    def fn(tab, x, scale: float, meta=None):
        calls.append(torch.is_grad_enabled())
        y = (tab[x.long()] * scale).sin()
        return y, x * 2, y.sum() * tab.sum()

    return calls, compiled.jit(fn, static_argnames=("meta",), inputs=("x",))


def test_wrapper_differentiates_by_recompute():
    """A wrapped function under its caller's autograd (Compiled
    .differentiable, the route a call on a card takes): one forward with
    no tape, then in the backward one re-run under autograd; its gradients
    equal the tape's bit for bit, the integer output carries none, and an
    output the loss does not read gets no cotangent. A plain call on the
    CPU and a call under eager() run on the caller's tape."""
    calls, wrapped = _toy()
    tab0 = torch.linspace(0.5, 2.0, 7)
    x = torch.tensor([0, 3, 3, 6, 1], dtype=torch.int32)
    tab = tab0.clone().requires_grad_()
    y, xi, s = wrapped.fn(tab, x, 1.5)
    want = torch.autograd.grad((y * torch.arange(5.0)).sum() + s, tab)[0]
    calls.clear()
    tab = tab0.clone().requires_grad_()
    y, xi, s = wrapped.differentiable(tab, x, 1.5)
    assert calls == [False] and not xi.requires_grad and y.requires_grad
    got = torch.autograd.grad((y * torch.arange(5.0)).sum() + s, tab)[0]
    assert calls == [False, True] and torch.equal(got, want)
    tab = tab0.clone().requires_grad_()
    y, _, _ = wrapped.differentiable(tab, x, 1.5)
    only_y = torch.autograd.grad(y.sum(), tab)[0]
    tab = tab0.clone().requires_grad_()
    assert torch.equal(only_y, torch.autograd.grad(
        wrapped.fn(tab, x, 1.5)[0].sum(), tab)[0])
    for ctx in (torch.enable_grad, compiled.eager):
        calls.clear()
        tab = tab0.clone().requires_grad_()
        with ctx():
            y, _, s = wrapped(tab, x, 1.5)
        assert calls == [True] and y.grad_fn is not None
        assert torch.equal(torch.autograd.grad(
            (y * torch.arange(5.0)).sum() + s, tab)[0], want)


def test_wrapper_takes_a_given_vjp():
    """jit(vjp=...): the backward under a caller's autograd calls it with
    the call's arguments, the (argument, leaf indices) pairs of the tensors
    that require grad and the outputs' cotangents (None where the loss
    reads none), and its gradients reach those tensors."""
    seen = []

    def fn(a, b, c):
        return a * b[0] * b[1], c + 1.0

    def vjp(arguments, wrt, cts):
        seen.append((wrt, cts[0] is not None, cts[1] is None))
        return tuple(torch.full((3,), 7.0) for _, idx in wrt for _ in idx)

    wrapped = compiled.jit(fn, vjp=vjp)
    a = torch.ones(3, requires_grad=True)
    b = (torch.ones(3), torch.ones(3, requires_grad=True))
    out, _ = wrapped.differentiable(a, b, torch.ones(2))
    ga, gb = torch.autograd.grad(out.sum(), (a, b[1]))
    assert seen == [((("a", (0,)), ("b", (1,))), True, True)]
    assert torch.equal(ga, torch.full((3,), 7.0)) and torch.equal(
        gb, torch.full((3,), 7.0))


def test_key_of_a_call_that_requires_grad(monkeypatch):
    """render_batch's key on meta tensors (which stand for a card's): a
    call whose DiffParams leaves require grad gets the key of the same
    call without grad (its forward replays that graph); under eager() and
    on CPU tensors that require grad the call runs directly (no key)."""
    from test_torch_compiled import _meta_scene, _on_meta

    monkeypatch.delenv("QARAY_NO_MEGAKERNEL", raising=False)
    monkeypatch.delenv("QARAY_EAGER", raising=False)
    arr, meta = _meta_scene()
    cfg = IntegratorConfig(integrator="pathtrace")
    scene = _on_meta(arr)
    ids = tuple(torch.zeros(256, dtype=torch.int32, device="meta")
                for _ in range(3))
    key = engine.render_batch.key_of(scene, meta, cfg, *ids, (0, 7))
    params = diff.DiffParams(*(t.detach().requires_grad_()
                               for t in diff.extract_params(scene)))
    with torch.enable_grad():
        got = engine.render_batch.key_of(diff.splice_params(scene, params),
                                         meta, cfg, *ids, (0, 7))
        assert key is not None and got == key
        with compiled.eager():
            assert engine.render_batch.key_of(
                diff.splice_params(scene, params), meta, cfg, *ids,
                (0, 7)) is None
        cpu = diff.DiffParams(*(t.detach().requires_grad_()
                                for t in diff.extract_params(arr)))
        assert engine.render_batch.key_of(
            diff.splice_params(arr, cpu), meta, cfg,
            *(torch.zeros(256, dtype=torch.int32) for _ in range(3)),
            (0, 7)) is None
