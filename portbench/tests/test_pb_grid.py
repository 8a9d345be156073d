"""The grid cell's parts on the CPU: its reference (reference_grid) holds
to a brute-force test of every triangle and imports nothing of the
program, its traffic loop (traffic/grid_loop.py) runs correct at a small size
and counts the W1 rays, the control fails its limits, and the five
readers of the cell read hand-made records and stay silent on a program
without the new spans and counters."""

import ast
import time

import pytest
import torch

from portbench import bench, check, devtrace
from portbench import run as RUN
from portbench.scenes import make_grid as G

SEED = 2**41 + 29
SMALL = dict(width=24, height=18, spp_min=2, spp_max=3, seeds_per_run=2,
             check_rows=18, profile_min_images=1, profile_seconds=0.0)


@pytest.fixture(scope="module")
def small_scene(tmp_path_factory):
    """A 3 x 3 patch of the field, of the rock at subdivision 2."""
    out = tmp_path_factory.mktemp("grid")
    v, f = G.rock(2)
    (out / "rock2.obj").write_text(G.obj_text(v, f))
    rocks = [r for k, r in enumerate(G.placements())
             if k // G.GRID in (4, 5, 6) and k % G.GRID in (4, 5, 6)]
    path = out / "grid_small.xml"
    path.write_text(G.scene_xml("rock2.obj", rocks))
    return str(path)


def _ctx(scene, params=None):
    ctx = RUN.make_ctx("grid.instances", SEED, 0.5, False, device="cpu",
                       params={**SMALL, **(params or {})},
                       t_start=time.perf_counter())
    ctx.config["scene"] = scene
    return ctx


def test_reference_imports_nothing_of_the_program():
    for path in sorted((bench.PORTBENCH / "reference_grid").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in {
                    "jax", "jaxlib", "flax", "qaray_tpu", "qaray_tpu_torch",
                    "portbench"}, (path.name, name)


def test_tree_walk_equals_every_triangle():
    """bvh.walk against a test of every triangle, """
    from portbench.reference.intersect import intersect_triangles
    from portbench.reference_grid import bvh

    v, f = G.rock(3)
    tri_v = torch.tensor(v[f], dtype=torch.float32)
    tree = bvh.Tree(*map(torch.as_tensor, bvh.build(tri_v.numpy())))
    g = torch.Generator().manual_seed(7)
    n = 1024
    # From a sphere of radius 3 towards points of the rock's box.
    p = 3.0 * torch.nn.functional.normalize(
        torch.rand((n, 3), generator=g) - 0.5, dim=1)
    aim = 2.6 * (torch.rand((n, 3), generator=g) - 0.5)
    d = torch.nn.functional.normalize(aim - p, dim=1)
    t_max = torch.where(torch.arange(n) % 3 == 0, 1.5, 1e30)
    t, tri = bvh.walk(tree, tri_v, p, d, t_max)
    m = len(f)
    all_t, _, _, hit = intersect_triangles(
        p.repeat_interleave(m, 0), d.repeat_interleave(m, 0),
        tri_v[:, 0].repeat(n, 1), tri_v[:, 1].repeat(n, 1),
        tri_v[:, 2].repeat(n, 1), t_max.repeat_interleave(m))
    all_t = torch.where(hit, all_t, torch.inf).reshape(n, m)
    want_t, want_tri = all_t.min(dim=1)
    found = torch.isfinite(want_t)
    assert 0.1 < found.float().mean() < 0.9
    assert torch.equal(tri >= 0, found)
    assert torch.equal(t[found], want_t[found])
    assert torch.equal(tri[found], want_tri[found])


def test_sound_run_is_correct_and_counts_w1_rays(small_scene, monkeypatch):
    """The patch's 2,880 triangles would be baked to world space: the
    program keeps them per instance, as it keeps the cell's 11.8M, with
    QARAY_NO_WORLD_BVH."""
    from portbench.traffic import grid_loop

    monkeypatch.setenv("QARAY_NO_WORLD_BVH", "1")
    ctx = _ctx(small_scene)
    rec = grid_loop.run(ctx)
    ok, compared = check.judge(rec["numbers"], ctx.workload["limits"])
    assert ok, compared
    assert rec["numbers"]["mean_rel_gap"] < 1e-6
    c = rec["counters"]
    samples = sum(x["samples"] for x in rec["items"])
    # Every camera sample's first closest hit walks the 9 instances.
    assert c["bvh.closest_rays"] >= samples
    assert c["bvh.any_rays"] > 0
    assert c["launches.K1a"] == 0


def test_control_fails(small_scene):
    from portbench.reference import precision as PR
    from portbench.traffic import grid_loop

    ctx = _ctx(small_scene)
    seed = bench.derive_seed(SEED, "image", 0)
    want_mean, want_count, _ = grid_loop.reference_image(ctx, seed)
    PR.set_dtype(torch.bfloat16)
    try:
        mean, count, _ = grid_loop.reference_image(ctx, seed)
    finally:
        PR.set_dtype(torch.float32)
    numbers = check.image_summary([check.image_numbers(
        mean, count, want_mean, want_count)])
    ok, compared = check.judge(numbers, ctx.workload["limits"])
    assert not ok, compared


def test_path_work_counts_the_mesh(small_scene):
    from portbench.roofline import grid
    from portbench.traffic import grid_loop

    ctx = _ctx(small_scene)
    _, _, ref = grid_loop.reference_image(ctx, 5, rows=torch.arange(2))
    counts = grid_loop.path_work(ctx, ref, lanes=256)
    assert counts["lanes"] == 256
    assert 0 < counts["mesh_closest"] <= counts["closest_rays"]
    assert 0 <= counts["mesh_blocked"] <= counts["shadow_rays"]
    flops, nbytes = grid.w1_work(counts, 512)
    assert flops == 2 * 73 * (counts["mesh_closest"]
                              + counts["mesh_blocked"])
    assert nbytes == 2 * (53 * counts["closest_rays"]
                          + 30 * counts["shadow_rays"])


def _trace():
    # A stretch of 0-100 us: W1's kernels 10-30 and 40-50, another 60-90.
    def launch(corr, ts):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": ts, "dur": 1, "args": {"correlation": corr}}

    def kernel(corr, name, ts, dur):
        return {"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                "dur": dur, "args": {"correlation": corr}}

    events = [{"ph": "X", "cat": "user_annotation", "name": "stretch",
               "ts": 0, "dur": 100},
              launch(1, 5), launch(2, 35), launch(3, 55),
              kernel(1, "void bvh_kernel<false>(...)", 10, 20),
              kernel(2, "void bvh_kernel<true>(...)", 40, 10),
              kernel(3, "closest_full_kernel<false>", 60, 30)]
    return devtrace.parse(events)


def _rec(counters=None):
    work = {"lanes": 100, "closest_rays": 200, "mesh_closest": 120,
            "vertices": 150, "shadow_rays": 150, "mesh_blocked": 30}
    return {"items": [{"s": 0.5, "samples": 1000},
                      {"s": 0.5, "samples": 3000}],
            "counters": counters or {}, "work": work,
            "trace": {"trace": _trace(), "images": 2, "samples": 400,
                      "counters": {}}}


def read(name, rec):
    ctx = type("Ctx", (), {"config": {"roofline": "grid"}})()
    return bench.load_module("metrics", name).read(rec, ctx)


def test_trace_readers():
    rec = _rec()
    # 30 us of bvh_kernel records over 2 images.
    assert read("bvh_walk_ms_per_image", rec) == pytest.approx(0.015)
    # 400 samples: 4x the work's 100 lanes. Bytes (53 * 200 + 30 * 150)
    # * 4 = 60,400 B at 3.35e12 B/s; operations 73 * 150 * 4 = 43,800 at
    # 67e12/s: bytes bound, over 30 us.
    want = 100.0 * (60400 / 3.35e12) / 30e-6
    assert read("bvh_walk_roofline", rec) == pytest.approx(want)
    assert 0 < want < 100


def test_counter_and_span_readers(monkeypatch):
    from qaray_tpu_torch.utils import timing

    rec = _rec({"bvh.closest_rays": 6000, "bvh.any_rays": 2000})
    assert read("bvh_rays_per_sample", rec) == pytest.approx(2.0)
    monkeypatch.setattr(timing, "totals", {"scene.obj_load": [0.4, 1],
                                           "scene.bvh_build": [0.9, 2]})
    assert read("obj_load_s", rec) == pytest.approx(0.4)
    assert read("bvh_build_s", rec) == pytest.approx(0.9)


def test_readers_silent_on_an_older_program(monkeypatch):
    """A program without the counters and spans (the parent of the change
    that added them) gives no number, and no reader raises."""
    from qaray_tpu_torch.utils import timing

    monkeypatch.setattr(timing, "totals", {"scene.compile": [0.5, 1]})
    rec = _rec({"launches.W1": 12})
    for name in ("bvh_rays_per_sample", "obj_load_s", "bvh_build_s"):
        assert read(name, rec) is None, name
    rec = _rec()
    rec["trace"]["trace"] = devtrace.parse([])
    rec["trace"]["trace"]["stretch"] = (0.0, 1.0)
    assert read("bvh_walk_roofline", rec) is None
    assert read("bvh_walk_ms_per_image", rec) == 0.0


def test_result_line_holds_the_cell_metrics(monkeypatch):
    """A traced record of the cell reports every per-layer metric that
    BENCHMARK.json lists for it (run.report, the result line)."""
    from qaray_tpu_torch.utils import timing

    monkeypatch.setattr(timing, "totals", {"scene.compile": [0.75, 1],
                                           "capture": [2.0, 12],
                                           "scene.obj_load": [0.4, 1],
                                           "scene.bvh_build": [0.9, 2],
                                           "render.end": [0.1, 2]})
    spec = bench.benchmark_spec()
    wl = bench.load_json("workloads", "grid.instances")
    ctx = RUN.make_ctx("grid.instances", SEED, 1.0, True, device="cpu")
    rec = _rec({"bvh.closest_rays": 6000, "bvh.any_rays": 2000,
                "captures": 0, "capture_s": 0.0})
    rec["trace"]["counters"] = {"capture_s": 0.0}
    rec["trace"]["trace"]["annotations"].append(("render.end", 90.0, 5.0))
    rec.update(setup_s=1.0, window_s=1.0, memory_peak_bytes=0, attempted=2,
               failed=0, host={"seconds": {"dispatch": 0.1}, "calls":
                               {"dispatch": 4}}, setup_parts={},
               numbers={k: 0.0 for k in wl["limits"]})
    out = RUN.report(ctx, rec, spec)
    want = {m["name"] for m in bench.cell_metrics(spec, "grid.instances",
                                                  "per_layer")}
    assert want == set(out["metrics"])
    assert "megakernel_roofline" not in want
