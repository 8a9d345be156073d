"""The readers of the program's own spans and counters (progspans.py and
the six metrics that use it) on hand-made traces and counters, their
silence on a program without them, and the placement rule: the program's
spans leave every operation that one of the benchmark's ranges holds
under the same innermost benchmark label."""

import json
import shutil
import time
import types
from collections import Counter

import pytest
import torch

from portbench import bench, devtrace, progspans
from portbench import run as RUN

SEED = 2**41 + 11
# The benchmark's ranges (traffic/render_loop.Loop.wrap_parts).
BENCH_RANGES = {"dispatch", "read", "escalate", "fold", "converge", "sync",
                "finalize", "event_wait"}


def _trace():
    # A stretch of 0-200 us holding two images; the benchmark's `escalate`
    # range 20-40 inside the program's render.escalate 15-45 launched
    # kernels 50-70 and 80-90; a second render.escalate 100-110 launched
    # nothing; render.end ranges 120-160 (a kernel 130-140 inside it, one
    # 150-170 across its end) and 180-200 (idle).
    def ann(name, ts, dur):
        return {"ph": "X", "cat": "user_annotation", "name": name,
                "ts": ts, "dur": dur}

    def launch(corr, ts):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": ts, "dur": 1, "args": {"correlation": corr}}

    def kernel(corr, ts, dur):
        return {"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": ts,
                "dur": dur, "args": {"correlation": corr}}

    events = [ann("stretch", 0, 200), ann("render.escalate", 15, 30),
              ann("escalate", 20, 20), ann("render.escalate", 100, 10),
              ann("render.end", 120, 40), ann("sync", 121, 5),
              ann("finalize", 141, 15), ann("render.end", 180, 20),
              launch(1, 22), launch(2, 30), launch(3, 125), launch(4, 145),
              kernel(1, 50, 20), kernel(2, 80, 10), kernel(3, 130, 10),
              kernel(4, 150, 20)]
    return devtrace.parse(events)


def _rec(trace):
    return {"items": [{"s": 0.1, "samples": 10}],
            "counters": {"capture_s": 0.25},
            "trace": {"trace": trace, "images": 2, "steps": 2,
                      "samples": 20, "counters": {"capture_s": 0.5}}}


def read(name, rec):
    return bench.load_module("metrics", name).read(rec, None)


def test_idle_inside_ranges():
    tr = _trace()
    assert progspans.ranges(tr, "render.end") == [(120.0, 160.0),
                                                  (180.0, 200.0)]
    busy = progspans.merged(tr)
    assert busy == [[50.0, 70.0], [80.0, 90.0], [130.0, 140.0],
                    [150.0, 170.0]]
    assert progspans.busy_within(busy, 60.0, 135.0) == 10 + 10 + 5
    assert progspans.busy_within(busy, 0.0, 10.0) == 0.0
    # 40 us less 10 + 10 busy, and 20 us idle.
    assert progspans.idle_inside_us(tr, "render.end") == 40.0
    assert progspans.idle_inside_us(tr, "render.start") is None


def test_trace_readers():
    tr = _trace()
    rec = _rec(tr)
    # 40 us idle over 2 images.
    assert read("end_of_image_idle_ms", rec) == pytest.approx(0.02)
    # 30 us labelled `escalate` over 2 render.escalate ranges.
    assert read("wavefront_ms_per_call", rec) == pytest.approx(0.015)
    assert read("wavefront_ms_per_image", rec) == pytest.approx(0.015)
    # No idle time is counted beyond the render.end ranges' length.
    total = sum(b - a for a, b in progspans.ranges(tr, "render.end"))
    assert read("end_of_image_idle_ms", rec) * 2 * 1e3 <= total


def test_trace_readers_silent_without_program_spans():
    events = [{"ph": "X", "cat": "user_annotation", "name": "escalate",
               "ts": 0, "dur": 10}]
    rec = _rec(devtrace.parse(events))
    assert read("end_of_image_idle_ms", rec) is None
    assert read("wavefront_ms_per_call", rec) is None


def test_counter_and_span_readers(monkeypatch):
    from qaray_tpu_torch import renderer
    from qaray_tpu_torch.utils import timing

    monkeypatch.setattr(renderer, "stats", {
        "escalated_lanes": 300, "escalated_padded": 1024})
    monkeypatch.setattr(timing, "totals", {"scene.compile": [0.75, 1],
                                           "capture": [2.0, 12],
                                           "grad.fast": [1.0, 1],
                                           "grad.autograd": [9.0, 3]})
    rec = _rec(_trace())
    assert read("escalated_lane_yield", rec) == pytest.approx(
        100 * 300 / 1024)
    assert read("autograd_step_share", rec) == pytest.approx(75.0)
    assert read("scene_compile_s", rec) == pytest.approx(0.75)
    # 2 s of captures less the window's 0.25 and the stretch's 0.5.
    assert read("graph_capture_s", rec) == pytest.approx(1.25)


def test_counter_and_span_readers_silent_on_an_older_program(monkeypatch):
    """A program without the counters and spans (the parent of the change
    that added them) gives no number, and no reader raises."""
    from qaray_tpu_torch import renderer
    from qaray_tpu_torch.utils import timing

    monkeypatch.delattr(renderer, "stats")
    monkeypatch.delattr(timing, "totals")
    rec = _rec(_trace())
    for name in ("escalated_lane_yield", "autograd_step_share",
                 "scene_compile_s", "graph_capture_s"):
        assert read(name, rec) is None, name


def _annotations_and_ops(prof, path):
    """(user_annotation ranges as (name, ts, dur) sorted by start,
    aten:: operators as (name, ts)) of a profiler session."""
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)
    events = events.get("traceEvents", events)
    anns = sorted(((e["name"], float(e["ts"]), float(e["dur"]))
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"),
                  key=lambda a: a[1])
    ops = sorted(((e["name"], float(e["ts"])) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "cpu_op"
                  and e["name"].startswith("aten::")), key=lambda o: o[1])
    return anns, ops


def _labels(anns, ops):
    starts = [a[1] for a in anns]
    return [(name, devtrace.span_at(anns, ts, starts)) for name, ts in ops]


@pytest.mark.skipif(shutil.which("g++") is None,
                    reason="needs g++ for the host build of the kernel "
                    "source")
def test_program_spans_keep_the_benchmark_labels(tmp_path, monkeypatch):
    """A CPU render of the caustics cell's image (16x12, the megakernel's
    source on the host and the global radius blown up so that lanes
    escalate, as tests/test_torch_pipeline.py renders it) under
    torch.profiler with the benchmark's ranges (Loop.wrap_parts): every
    aten:: operator that a benchmark range holds keeps the same innermost
    benchmark label with the program's ranges on as with them off, both
    in one trace (the program's ranges left out of the labelling) and
    against a second render with the program's ranges off."""
    from portbench.traffic import render_loop
    from qaray_tpu_torch.ops import megakernel
    from qaray_tpu_torch.utils import timing

    monkeypatch.setattr(megakernel, "mega_render",
                        megakernel.mega_render_host)
    ctx = RUN.make_ctx("caustics.default", SEED, 0.0, True, device="cpu",
                       params=dict(width=16, height=12, spp_min=2,
                                   spp_max=3, seeds_per_run=1),
                       t_start=time.perf_counter())
    ctx.config["renderer"].update(photon_map_size=400, caustics_map_size=120,
                                  photon_map_bounce=6, caustics_map_bounce=6,
                                  max_bounce=3, shadow_spp=2,
                                  shadow_spp_max=4)
    loop = render_loop.Loop(ctx)
    g, c = loop.r.photon_maps
    loop.r.photon_maps = (g._replace(radius=torch.tensor(50.0)), c)
    loop.render(0)
    spans = ctx.spans
    undo = loop.wrap_parts(spans)
    spans.annotate = True
    runs = {}
    try:
        for mode in ("on", "off"):
            if mode == "off":
                monkeypatch.setattr(timing, "_profiling", lambda: False)
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]) as p:
                loop.render(0)
            runs[mode] = _annotations_and_ops(p, tmp_path / f"{mode}.json")
    finally:
        spans.annotate = False
        undo()
    program = set(timing.totals)
    assert not program & BENCH_RANGES
    anns_on, ops_on = runs["on"]
    names_on = {a[0] for a in anns_on}
    assert {"render", "render.dispatch", "render.fold", "render.retire",
            "render.escalate", "render.end"} <= names_on
    assert "escalate" in names_on
    benchmark_only = [a for a in anns_on if a[0] not in program]
    with_program = _labels(anns_on, ops_on)
    without = _labels(benchmark_only, ops_on)
    held = [(w, o) for w, o in zip(with_program, without)
            if o[1] in BENCH_RANGES]
    assert any(o[1] == "escalate" for _, o in held)
    assert all(w == o for w, o in held), [
        (w, o) for w, o in held if w != o][:5]
    anns_off, ops_off = runs["off"]
    assert not {a[0] for a in anns_off} & program
    held_off = Counter(x for x in _labels(anns_off, ops_off)
                       if x[1] in BENCH_RANGES)
    assert Counter(o for _, o in held) == held_off


def test_result_line_holds_the_new_metrics(monkeypatch):
    """A traced record of each cell reports the six metrics where
    BENCHMARK.json lists them (run.report, the result line)."""
    from qaray_tpu_torch import renderer
    from qaray_tpu_torch.utils import timing

    monkeypatch.setattr(renderer, "stats", {
        "escalated_lanes": 300, "escalated_padded": 1024})
    monkeypatch.setattr(timing, "totals", {"scene.compile": [0.75, 1],
                                           "capture": [2.0, 12],
                                           "grad.autograd": [12.0, 4]})
    spec = bench.benchmark_spec()
    new = {"end_of_image_idle_ms", "wavefront_ms_per_call",
           "escalated_lane_yield", "scene_compile_s", "graph_capture_s",
           "autograd_step_share"}
    for cell in ("softdof.final256", "caustics.default", "softdof.inverse"):
        wl = bench.load_json("workloads", cell)
        ctx = types.SimpleNamespace(
            name=cell, trace=True, device=types.SimpleNamespace(type="cpu"),
            workload=wl, config=bench.load_json("configs", wl["config"]))
        rec = _rec(_trace())
        rec.update(setup_s=1.0, window_s=1.0, memory_peak_bytes=0,
                   attempted=1, failed=0, host={"seconds": {}, "calls": {}},
                   setup_parts={},
                   numbers={k: 0.0 for k in wl["limits"]})
        rec["counters"].update(captures=0, wavefront_lanes=0)
        out = RUN.report(ctx, rec, spec)
        want = {m["name"] for m in bench.cell_metrics(spec, cell,
                                                      "per_layer")} & new
        assert want and want <= set(out["metrics"]), cell
