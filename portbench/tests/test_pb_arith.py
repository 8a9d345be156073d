"""The arithmetic of the metrics on hand-made records and traces: union,
idle share, idle gaps, percentiles, the roofline count at a tiny size by
hand, and the result line's shape."""

import json
import types

import pytest

from portbench import bench, devtrace
from portbench.roofline import ops, softdof


def _trace():
    # Two kernels overlapping (10-30, 20-40), one apart (60-70); a stretch
    # of 0-100 us; host spans "a" 0-50 and "b" 50-100 launched them.
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "stretch", "ts": 0,
         "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "a", "ts": 0,
         "dur": 50},
        {"ph": "X", "cat": "user_annotation", "name": "b", "ts": 50,
         "dur": 50},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 5, "dur": 1, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
         "ts": 55, "dur": 1, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "mega_kernel<false>", "ts": 10,
         "dur": 20, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "fold", "ts": 20, "dur": 20,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 60,
         "dur": 10, "args": {"correlation": 2}},
    ]
    return devtrace.parse(events)


def test_union_and_idle_share():
    tr = _trace()
    assert devtrace.union([(0, 2), (1, 3), (5, 6)]) == 4
    assert devtrace.busy_us(tr) == 40.0
    assert devtrace.window_us(tr) == 100.0
    assert devtrace.idle_share(tr) == pytest.approx(0.6)


def test_labels_gaps_and_ops():
    tr = _trace()
    labels = {name: span for name, _, _, span in tr["kernels"]}
    assert labels == {"mega_kernel<false>": "a", "fold": "a",
                      "Memcpy DtoH": "b"}
    gaps = devtrace.idle_gaps(tr)
    # gaps: 0-10 (middle in a), 40-60 (middle 50: b), 70-100 (b)
    assert [g[0] for g in gaps] == ["b", "b", "a"]
    assert [round(g[1] * 1e6) for g in gaps] == [30, 20, 10]
    top = devtrace.top_ops(tr)
    assert top[0] == ["mega_kernel<false>", 20e-6]
    assert devtrace.kept_launches(tr, "mega_kernel") == 1
    assert devtrace.device_us_where(tr, lambda n, s: s == "b") == 10.0


def test_percentile():
    assert bench.percentile([1, 2, 3, 4, 5], 50) == 3
    assert bench.percentile(list(range(1, 101)), 95) == pytest.approx(95.05)
    assert bench.percentile([7.0], 95) == 7.0


def test_roofline_count_by_hand():
    # One lane: a camera ray, two closest-hit rays, one shading vertex and
    # 16 shadow rays, against 3 spheres and a plane.
    counts = {"lanes": 1, "closest_rays": 2, "vertices": 1,
              "shadow_rays": 16}
    tests = 3 * (33 + 24) + (33 + 5)          # 209
    want = 46 + 2 * (tests + 30) + 150 + 16 * (tests + 33)
    assert want == 4546
    assert ops.path_ops(counts, 3, 1) == want
    flops, nbytes = softdof.megakernel_work(counts, 1000)
    assert flops == 1000 * want and nbytes == 16000
    t, bound = ops.least_seconds(flops, nbytes)
    assert bound == "operations" and t == pytest.approx(want * 1000 / 67e12)


def _rec(trace=None):
    rec = {"setup_s": 12.5, "window_s": 2.0,
           "items": [{"s": 0.1 * (i + 1), "samples": 100, "lanes": 100}
                     for i in range(10)],
           "counters": {"captures": 0, "wavefront_lanes": 10,
                        "all_gather_s": 0.5},
           "host": {"seconds": {"dispatch": 0.01, "fold": 0.01},
                    "calls": {"dispatch": 4}},
           "setup_parts": {"photon_build_s": 1.5},
           "memory_peak_bytes": 123, "numbers": {
               "count_mismatch_share": 0.0, "mean_rel_gap": 0.0,
               "bad_pixel_share": 0.0},
           "attempted": 10, "failed": 0}
    if trace is not None:
        rec["trace"] = {"trace": trace, "images": 2, "steps": 2,
                        "samples": 1000}
        rec["work"] = {"lanes": 1, "closest_rays": 2, "vertices": 1,
                       "shadow_rays": 16}
    return rec


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  bench.benchmark_spec()["workloads"]])
@pytest.mark.parametrize("traced", [False, True])
def test_result_line_shape(traced, cell):
    from portbench import run as RUN

    spec = bench.benchmark_spec()
    wl = bench.load_json("workloads", cell)
    ctx = types.SimpleNamespace(
        name=cell, trace=traced, device=types.SimpleNamespace(type="cpu"),
        workload=wl, config=bench.load_json("configs", wl["config"]))
    rec = _rec(_trace() if traced else None)
    rec["numbers"] = {k: 0.0 for k in wl["limits"]}
    ranks = 4 if wl["traffic"] == "ranks" else 1
    if ranks > 1:
        rec["ranks"] = ranks
    out = RUN.report(ctx, rec, spec)
    line = json.loads(bench.result_line(**out))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "compared"
    kind = "per_layer" if traced else "end_to_end"
    want = {m["name"] for m in bench.cell_metrics(spec, cell, kind)}
    assert set(line["metrics"]) == want
    m = line["metrics"]
    want = {
        "idle_share.render": 60.0, "idle_share.inverse": 60.0,
        "escalated_lane_share": 1.0, "host_ms_per_dispatch": 5.0,
        # megakernel: 1000 samples x 4546 operations over its 20 us.
        "megakernel_roofline": 100 * 4546e3 / ranks / 67e12 / 20e-6,
        "grad_step_busy_ms": 0.02, "allgather_wait_ms_per_image": 50.0,
        "captures.render": 0, "captures.inverse": 0, "photon_build_s": 1.5,
        "wavefront_ms_per_image": 0.0,  # nothing launched in "escalate"
        # the stretch's 1000 samples over its 40 us of device-busy time.
        "mfu.render": 100 * 4546e3 / 40e-6 / 67e12 / ranks,
        "samples_per_s": 500.0, "grad_paths_per_s": 500.0,
        "image_s_p80": 0.82, "setup_s": 12.5}
    for name, value in m.items():
        assert value["value"] == pytest.approx(want[name]), name
    if traced:
        assert line["device"]["busy_s"] == pytest.approx(40e-6)
        assert line["device"]["window_s"] == pytest.approx(100e-6)
        assert len(line["breakdown"]["idle_gaps"]) <= 10
    assert line["correct"] is True


def test_rank_readers():
    """The readers of a multi-card cell (softdof.batch4, kept out of
    BENCHMARK.json for its spread): rank 0's all_gather wait an image, its
    share of the megakernel's samples, and mfu over every card."""
    wl = bench.load_json("workloads", "softdof.batch4")
    ctx = types.SimpleNamespace(config=bench.load_json("configs",
                                                       wl["config"]))
    rec = _rec(_trace())
    rec["ranks"] = 4

    def read(name):
        return bench.load_module("metrics", name).read(rec, ctx)

    assert read("allgather_wait_ms_per_image") == pytest.approx(50.0)
    assert read("megakernel_roofline") == pytest.approx(
        100 * 4546e3 / 4 / 67e12 / 20e-6)
    assert read("mfu.render") == pytest.approx(
        100 * 4546e3 / 40e-6 / 67e12 / 4)
