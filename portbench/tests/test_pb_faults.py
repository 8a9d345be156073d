"""`correct` comes out false where it should, at a size a test run holds:
the control (the plain reference in bfloat16 put in the program's place)
fails the cells' limits, and a run of each driver with its timed path
broken underneath reads not correct, once for each fault the cell can
have. Sound runs at this size read correct (the CPU path is the
reference's arithmetic, bit for bit)."""

import time

import pytest
import torch

from portbench import bench, check
from portbench import run as RUN

SEED = 2**41 + 5
TINY = dict(width=32, height=24, seeds_per_run=2, profile_min_images=1,
            profile_seconds=0.0)
MAPS = {"photon_map_size": 1000, "caustics_map_size": 100}


def _ctx(cell, params=None):
    par = dict(TINY)
    if cell == "softdof.inverse":
        par = {"width": 24, "height": 18}
    elif cell != "caustics.default":
        par.update(spp_min=4, spp_max=4)
    par.update(params or {})
    ctx = RUN.make_ctx(cell, SEED, 0.5, False, device="cpu", params=par,
                       t_start=time.perf_counter())
    ctx.config["renderer"].update(MAPS if ctx.config["renderer"].get(
        "use_photon_map") else {})
    return ctx


def _correct(ctx):
    rec = RUN.run_cell(ctx)
    ok, compared = check.judge(rec["numbers"], ctx.workload["limits"])
    return ok, compared


@pytest.mark.parametrize("cell", ["softdof.final256", "caustics.default",
                                  "softdof.inverse"])
def test_sound_run_is_correct(cell):
    ok, compared = _correct(_ctx(cell))
    assert ok, compared


@pytest.mark.parametrize("cell", ["softdof.final256", "caustics.default"])
def test_control_image_fails(cell):
    from portbench.reference import precision as PR
    from portbench.traffic import render_loop

    ctx = _ctx(cell)
    seed = bench.derive_seed(SEED, "image", 0)
    want_mean, want_count, _ = render_loop.reference_image(ctx, seed)
    PR.set_dtype(torch.bfloat16)
    try:
        mean, count, _ = render_loop.reference_image(ctx, seed)
    finally:
        PR.set_dtype(torch.float32)
    numbers = check.image_summary([check.image_numbers(
        mean, count, want_mean, want_count)])
    ok, compared = check.judge(numbers, ctx.workload["limits"])
    assert not ok, compared


def test_control_gradients_fail():
    from portbench.reference import precision as PR
    from portbench.traffic import grad_loop

    ctx = _ctx("softdof.inverse")
    par = ctx.params
    rp = {**ctx.config["renderer"], **par["renderer"]}
    lr = {k: float(v) for k, v in par["lr"].items()}
    words = bench.derive_seed(SEED, "grad")
    from portbench.reference import render as R

    arr, _ = R.load(str(bench.ROOT / ctx.config["scene"]), 24, 18, "cpu")
    start = grad_loop.start_params(R.params_of(arr), SEED, par["perturb"])
    target = grad_loop.reference_target(ctx, words, rp)
    want = grad_loop.reference_steps(ctx, start, target, 3, lr, rp, words)
    PR.set_dtype(torch.bfloat16)
    try:
        got = grad_loop.reference_steps(ctx, start, target, 3, lr, rp,
                                        words)
    finally:
        PR.set_dtype(torch.float32)
    numbers, _ = check.grad_numbers(got[0], want[0], got[1], want[1],
                                    got[2], want[2])
    ok, compared = check.judge(numbers, ctx.workload["limits"])
    assert not ok, compared


def _stale_render(monkeypatch):
    """Renderer.render returns its frame buffer as it found it, without
    rendering."""
    from qaray_tpu_torch.renderer import Renderer

    monkeypatch.setattr(Renderer, "render", lambda self: self.fb)


def _half_batch(monkeypatch):
    """Each dispatch's second half of lanes gets the first half's radiance:
    every pixel's mean over half of its samples."""
    from qaray_tpu_torch import renderer

    orig = renderer.render_batch

    def half(*a, **kw):
        out = list(orig(*a, **kw))
        n = out[0].shape[0] // 2
        rad = out[0].clone()
        rad[n:2 * n] = rad[:n]
        out[0] = rad
        return tuple(out)

    monkeypatch.setattr(renderer, "render_batch", half)


def _altered(monkeypatch):
    """One lane in 64 of each dispatch comes back with double radiance."""
    from qaray_tpu_torch import renderer

    orig = renderer.render_batch

    def altered(*a, **kw):
        out = list(orig(*a, **kw))
        rad = out[0].clone()
        rad[::64] = rad[::64] * 2.0
        out[0] = rad
        return tuple(out)

    monkeypatch.setattr(renderer, "render_batch", altered)


@pytest.mark.parametrize("fault", [_stale_render, _half_batch, _altered],
                         ids=["state_unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", ["softdof.final256", "caustics.default"])
def test_render_faults_fail(cell, fault, monkeypatch):
    fault(monkeypatch)
    ok, compared = _correct(_ctx(cell))
    assert not ok, compared


def _grad_unchanged(monkeypatch):
    """The step's gradients come back zero: the parameters never move."""
    from qaray_tpu_torch import diff

    orig = diff.render_value_and_grad

    def none(*a, **kw):
        loss, g = orig(*a, **kw)
        return loss, diff.DiffParams(*(torch.zeros_like(x) for x in g))

    monkeypatch.setattr(diff, "render_value_and_grad", none)


def _grad_half_batch(monkeypatch):
    """The step renders the first half of its lanes, the mean over them."""
    from qaray_tpu_torch import diff

    orig = diff.render_value_and_grad

    def half(scene, meta, cfg, px, py, sid, words, target=None, mesh=None):
        n = px.shape[0] // 2
        return orig(scene, meta, cfg, px[:n], py[:n], sid[:n], words,
                    target=target[:n])

    monkeypatch.setattr(diff, "render_value_and_grad", half)


def _grad_altered(monkeypatch):
    """The step's loss comes back 1 % high."""
    from qaray_tpu_torch import diff

    orig = diff.render_value_and_grad

    def altered(*a, **kw):
        loss, g = orig(*a, **kw)
        return loss * 1.01, g

    monkeypatch.setattr(diff, "render_value_and_grad", altered)


@pytest.mark.parametrize("fault", [_grad_unchanged, _grad_half_batch,
                                   _grad_altered],
                         ids=["state_unchanged", "half_batch", "altered"])
def test_grad_faults_fail(fault, monkeypatch):
    fault(monkeypatch)
    ok, compared = _correct(_ctx("softdof.inverse"))
    assert not ok, compared


@pytest.mark.parametrize("fault", [None, "no_exchange"])
def test_ranks_exchange(fault, monkeypatch):
    """Two ranks on the CPU (gloo): sound, rank 0's image is correct; with
    the other rank's part of every all_gather left out on rank 0 it is
    not."""
    if fault:
        from qaray_tpu_torch.parallel import mesh

        orig = mesh.dist.all_gather

        def no_exchange(parts, mine, group=None):
            orig(parts, mine, group=group)
            for p in parts[1:]:
                p.zero_()

        monkeypatch.setattr(mesh.dist, "all_gather", no_exchange)
    ctx = _ctx("softdof.batch4", {"ranks": 2, "spp_min": 2, "spp_max": 2})
    ok, compared = _correct(ctx)
    assert ok == (fault is None), compared


def test_inverse_setup_leaves_out_the_target(monkeypatch):
    """The reference's target image is the benchmark's input: its seconds
    (here made 2 s longer) are recorded apart and are not in setup_s."""
    from portbench.traffic import grad_loop

    orig = grad_loop.reference_target

    def slow(*a, **kw):
        time.sleep(2.0)
        return orig(*a, **kw)

    monkeypatch.setattr(grad_loop, "reference_target", slow)
    ctx = _ctx("softdof.inverse")
    rec = RUN.run_cell(ctx)
    total = time.perf_counter() - ctx.t_start
    assert rec["target_s"] >= 2.0
    assert 0 < rec["setup_s"]
    assert (rec["setup_s"] + rec["target_s"] + rec["window_s"]
            + rec["reference_s"]) <= total
