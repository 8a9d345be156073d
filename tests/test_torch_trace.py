"""The program's spans and counters (utils/timing.span, renderer.stats):
totals, the profiler ranges a span opens only while a profiler records,
the Renderer's ranges nested as its code nests them, the escalated lanes'
counter against its spans, one gradient span a step by route, the CLI's
trace of the set-up's spans, and the counters the benchmark reads by
key."""

import json
import os
import shutil

import pytest
import torch

from qaray_tpu_torch import cli, diff
from qaray_tpu_torch import renderer as renderer_mod
from qaray_tpu_torch.core.rng import key_words
from qaray_tpu_torch.integrators.engine import IntegratorConfig
from qaray_tpu_torch.ops import megakernel
from qaray_tpu_torch.parallel import mesh
from qaray_tpu_torch.parallel.mesh import make_render_mesh
from qaray_tpu_torch.renderer import Renderer, RendererParam
from qaray_tpu_torch.scene.compiler import compile_scene
from qaray_tpu_torch.scene.procedural import with_glass
from qaray_tpu_torch.scene.xml_parser import load_scene
from qaray_tpu_torch.utils import compiled, timing

ASSETS = os.path.join(os.path.dirname(__file__), "assets")
RENDER_PARTS = ("render.start", "render.dispatch", "render.fold",
                "render.retire", "render.converge", "render.end")


def softdof(width=32, height=24, glass=False):
    desc = load_scene(os.path.join(ASSETS, "softdof_scene.xml"))
    if glass:
        desc = with_glass(desc, "mid")
    desc.camera.img_width, desc.camera.img_height = width, height
    return desc


def ranges(prof, tmp_path):
    """The record_function ranges of a finished profiler session, as
    (name, start_us, end_us) sorted by start."""
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)
    events = events.get("traceEvents", events)
    return sorted((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in events if e.get("ph") == "X"
                  and e.get("cat") == "user_annotation")


def inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_totals_grow_per_span():
    before = list(timing.totals.get("test.span", [0.0, 0]))
    for _ in range(3):
        with timing.span("test.span") as s:
            sum(range(1000))
        assert s.seconds > 0.0
    row = timing.totals["test.span"]
    assert row[1] == before[1] + 3
    assert row[0] > before[0]
    with pytest.raises(KeyError):
        with timing.span("test.raises"):
            raise KeyError("x")
    assert timing.totals["test.raises"][1] >= 1


def test_ranges_only_while_the_profiler_records(monkeypatch):
    """No record_function range without a profiler; under one, a range of
    the span's name with its id as args."""
    made = []

    class Recorder:
        def __init__(self, name, args=None):
            made.append((name, args))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Recorder)
    assert not torch._C._autograd._profiler_enabled()
    with timing.span("test.off", id=7):
        pass
    assert made == []
    monkeypatch.setattr(timing, "_profiling", lambda: True)
    with timing.span("test.on", id=7):
        with timing.span("test.inner"):
            pass
    assert made == [("test.on", "7"), ("test.inner", None)]


def test_render_ranges_nest_as_the_code(tmp_path, monkeypatch):
    """A CPU render of softdof (32x24, spp 1..2 at a threshold no pixel
    meets: phase 1 and one adaptive round) under torch.profiler: one
    `render` range holds every render.* range, render.start comes before
    the first dispatch, render.end last, a dispatch holds no fold, and the
    last render.retire runs inside render.end."""
    monkeypatch.chdir(tmp_path)
    r = Renderer(RendererParam(spp_min=1, spp_max=2, max_bounce=2,
                               shadow_spp=2, shadow_spp_max=4,
                               threshold=(-1.0, -1.0, -1.0)),
                 device="cpu")
    r.compute_scene(softdof())
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        r.render()
    got = ranges(prof, tmp_path)
    names = [g[0] for g in got]
    assert names.count("render") == 1
    whole = next(g for g in got if g[0] == "render")
    for part in RENDER_PARTS:
        assert part in names, part
    parts = [g for g in got if g[0].startswith("render.")]
    assert all(inside(p, whole) for p in parts)
    by = {n: [g for g in got if g[0] == n] for n in RENDER_PARTS}
    assert len(by["render.start"]) == 1 and len(by["render.end"]) == 1
    start, end = by["render.start"][0], by["render.end"][0]
    assert start[2] <= min(d[1] for d in by["render.dispatch"])
    assert all(p[2] <= end[1] for p in parts
               if p[0] != "render.end" and not inside(p, end))
    assert any(inside(x, end) for x in by["render.retire"])
    for d in by["render.dispatch"]:
        assert not any(inside(f, d) for f in by["render.fold"])
    assert not any(inside(c, x) for c in by["render.converge"]
                   for x in by["render.retire"])


@pytest.mark.skipif(shutil.which("g++") is None,
                    reason="needs g++ for the host build of the kernel "
                    "source")
def test_escalations_counted(tmp_path, monkeypatch):
    """The photon-mapped caustics scene on the megakernel's route (its
    source on the CPU, the global radius blown up so that lanes escalate,
    as tests/test_torch_pipeline.py renders it): a render.escalate range
    for each of the span's calls, each inside a render.retire, and the
    escalated lanes within their padded buckets."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(megakernel, "mega_render",
                        megakernel.mega_render_host)
    r = Renderer(RendererParam(
        spp_min=2, spp_max=4, use_photon_map=True, photon_map_size=400,
        caustics_map_size=120, photon_map_bounce=6, caustics_map_bounce=6,
        max_bounce=3, shadow_spp=2, shadow_spp_max=4), device="cpu")
    r.compute_scene(softdof(40, 30, glass=True))
    g, c = r.photon_maps
    r.photon_maps = (g._replace(radius=torch.tensor(50.0)), c)
    before = dict(renderer_mod.stats)
    spans_before = list(timing.totals.get("render.escalate", [0.0, 0]))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        r.render()
    grown = {k: v - before[k] for k, v in renderer_mod.stats.items()}
    got = ranges(prof, tmp_path)
    escalate = [x for x in got if x[0] == "render.escalate"]
    assert len(escalate) > 0
    assert len(escalate) == (timing.totals["render.escalate"][1]
                             - spans_before[1])
    assert 0 < grown["escalated_lanes"] <= grown["escalated_padded"]
    retires = [x for x in got if x[0] == "render.retire"]
    assert all(any(inside(e, x) for x in retires) for e in escalate)


@pytest.mark.parametrize("scene,route", [("softdof", "autograd_steps"),
                                         ("spot", "fast_steps")])
def test_gradient_steps_counted(scene, route):
    """render_value_and_grad on the CPU: softdof (depth of field) takes
    the autograd route, spot_scene the fast one (the megakernel's and the
    adjoint's plain versions); one step is one call of the route's span
    and none of the other's."""
    desc = load_scene(os.path.join(ASSETS, f"{scene}_scene.xml"))
    desc.camera.img_width, desc.camera.img_height = 8, 6
    arr, meta = compile_scene(desc, device="cpu")
    cfg = IntegratorConfig(integrator="pathtrace", max_bounce=2,
                           shadow_spp=2, shadow_spp_max=4)
    ids = torch.arange(48, dtype=torch.int32)
    name = "grad." + route.split("_")[0]
    before = {k: timing.totals.get(k, [0.0, 0])[1] for k in diff.GRAD_SPANS}
    loss, grads = diff.render_value_and_grad(
        arr, meta, cfg, ids % 8, ids // 8, torch.zeros_like(ids),
        key_words("threefry2x32", 3))
    assert torch.isfinite(loss)
    grown = {k: timing.totals.get(k, [0.0, 0])[1] - before[k]
             for k in diff.GRAD_SPANS}
    assert grown == {k: int(k == name) for k in diff.GRAD_SPANS}


def test_sharded_gradient_step_is_one_span():
    """render_value_and_grad over a mesh of four CPU shards: one
    grad.autograd span for the step, whatever the shard count."""
    desc = load_scene(os.path.join(ASSETS, "softdof_scene.xml"))
    desc.camera.img_width, desc.camera.img_height = 8, 6
    arr, meta = compile_scene(desc, device="cpu")
    cfg = IntegratorConfig(integrator="pathtrace", max_bounce=2,
                           shadow_spp=2, shadow_spp_max=4)
    ids = torch.arange(48, dtype=torch.int32)
    before = {k: timing.totals.get(k, [0.0, 0])[1] for k in diff.GRAD_SPANS}
    loss, _ = diff.render_value_and_grad(
        arr, meta, cfg, ids % 8, ids // 8, torch.zeros_like(ids),
        key_words("threefry2x32", 3), mesh=make_render_mesh(["cpu"] * 4))
    assert torch.isfinite(loss)
    grown = {k: timing.totals.get(k, [0.0, 0])[1] - before[k]
             for k in diff.GRAD_SPANS}
    assert grown == {"grad.fast": 0, "grad.autograd": 1}


def test_cli_profile_holds_the_setup_spans(tmp_path, monkeypatch):
    """The CLI's -profile trace of a photon-mapped render holds the
    set-up's spans (scene.compile, photon.build) before the render's."""
    monkeypatch.chdir(tmp_path)
    assert cli.main([os.path.join(ASSETS, "softdof_scene.xml"), "-device",
                     "cpu", "-res", "16x12", "-spp", "1", "-bounce", "2",
                     "-shadow-spp", "2", "-shadow-spp-max", "4",
                     "-use-photon-map", "-photon-map-size", "200",
                     "-caustics-map-size", "60", "-profile",
                     str(tmp_path / "prof"), "-out",
                     str(tmp_path / "x_")]) == 0
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    first = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            first[e["name"]] = min(first.get(e["name"], e["ts"]), e["ts"])
    assert {"scene.compile", "photon.build", "render"} <= set(first)
    assert first["scene.compile"] < first["photon.build"] < first["render"]


def test_counters_keep_their_keys():
    """The keys the benchmark reads (portbench/bench.program_counters),
    and the new counters' keys."""
    assert set(compiled.stats) == {"captures", "replays", "capture_s"}
    assert set(mesh.stats) == {"all_gathers", "all_gather_s"}
    assert set(renderer_mod.stats) == {"escalated_lanes",
                                       "escalated_padded"}


def test_mesh_setup_spans_once_each():
    """A CPU compile of mesh_scene (one OBJ on the world route) opens
    scene.obj_load once, around the parser's load_obj, and
    scene.bvh_build once, around the tree's build and pack."""
    names = ("scene.obj_load", "scene.bvh_build")
    before = {k: timing.totals.get(k, [0.0, 0])[1] for k in names}
    desc = load_scene(os.path.join(ASSETS, "mesh_scene.xml"))
    compile_scene(desc, device="cpu")
    grown = {k: timing.totals[k][1] - before[k] for k in names}
    assert grown == {"scene.obj_load": 1, "scene.bvh_build": 1}


def test_bvh_ray_counters():
    """ops/bvh_packed.stats on a CPU per-instance walk of grid_scene (25
    instances): the rays handed to the closest and any-hit walks."""
    from qaray_tpu_torch.ops import bvh_packed, trace

    desc = load_scene(os.path.join(ASSETS, "grid_scene.xml"))
    arr, meta = compile_scene(desc, device="cpu", world_bvh=False)
    assert meta.num_mesh_instances == 25
    g = torch.Generator().manual_seed(3)
    p = torch.tensor([0.0, -14.0, 2.0]).expand(300, 3).contiguous()
    d = torch.nn.functional.normalize(
        torch.rand((300, 3), generator=g) * torch.tensor([0.6, 0.0, 0.3])
        + torch.tensor([-0.3, 1.0, -0.2]), dim=1)
    before = dict(bvh_packed.stats)
    hits = trace.trace_closest(arr, meta, p, d)
    assert hits["hit"].any()
    trace.trace_shadow(arr, meta, p[:100], d[:100], torch.full((100,), 5.0))
    grown = {k: bvh_packed.stats[k] - before[k] for k in before}
    assert grown == {"closest_rays": 300, "any_rays": 100}
    # A scene without meshes hands the walks nothing.
    before = dict(bvh_packed.stats)
    r = Renderer(RendererParam(spp_min=1, spp_max=1, max_bounce=1,
                               shadow_spp=1, shadow_spp_max=1), device="cpu")
    r.compute_scene(softdof(8, 6))
    r.render()
    assert bvh_packed.stats == before
