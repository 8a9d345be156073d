"""Captured execution (utils/compiled.py) against the eager one on one GPU:
images bit for bit, the device's idle share in turns, where the host's
time goes, captures, graphs and peak memory.

- Renders (Renderer.render() at 800x600 with a fresh frame buffer a turn,
  the scene compiled once): softdof with the defaults (4a), softdof at 1
  spp on the wavefront route (4b: QARAY_NO_MEGAKERNEL, 65,536-lane
  batches), mesh_scene with ico6 at 1 spp (4e: K4a/K4b), caustics_scene
  with -use-photon-map (4k: K1d, K5, escalated lanes on the wavefront
  engine), grid_scene per instance (4o: W1), texture_scene (4g). In the
  turns eager, captured, captured, eager, each under torch.profiler (CUDA
  activity): the wall, the device's busy time and the idle share; every
  captured turn's planes (mean, std, count, depth, irradiance) equal the
  first eager turn's bit for bit, and the second captured turn captures
  nothing new.
- The host's time of one render of 4a and 4b in each mode: the
  Renderer's program spans (render.start, render.dispatch, render.fold,
  render.retire, render.escalate, render.converge, render.end), and under
  cProfile the functions that hold it (own time).
- The fast gradient route (spot_scene, 262,144 lanes, pathtrace, rbg): 3
  steps with the material and light parameters changed every step, eager
  and captured, equal bit for bit, captured once.
- The autograd route's step (QARAY_NO_MEGAKERNEL; spot_scene 262,144
  lanes, mesh_scene 131,072) in the same turns: wall, busy, idle share,
  peak memory, captures, launches; the loss bit for bit and each field
  within the eager turns' spread; a replay under sync debug "error". Then
  where the device time of one eager step goes (op_split: operators and
  kernels under torch.profiler).
- A photon map build (caustics_scene's default maps): equal bit for bit,
  one capture a batch size.
- render_batch replays under torch.cuda.set_sync_debug_mode("error").

    python -m qaray_tpu_torch.tools.capture_turns [CASE ...]

CASE is any of 4a 4b 4e 4k 4o 4g grad autograd photon sync profile
(default: all).
Prints the card's name and power limit and, last, one JSON line.
"""

import contextlib
import cProfile
import json
import os
import pstats
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ASSETS = os.path.join(HERE, "tests", "assets")
PLANES = ("mean", "color_std", "count", "zbuffer", "irrad")
TURNS = ("eager", "captured", "captured", "eager")
# The autograd route's cases: 4m's lanes.
AUTOGRAD_LANES = (("spot", 1 << 18), ("mesh", 1 << 17))


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def flush_profiler():
    """A torch.profiler session with a few small kernels: in a process that
    has just made or dropped CUDA graphs the profiler loses device records
    of its next session, and this one takes that loss."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        x = torch.zeros(1, device="cuda")
        for _ in range(4):
            x = x + 1
        torch.cuda.synchronize()


def _device_us(evt):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        val = getattr(evt, attr, None)
        if val is not None:
            return val
    return 0


def _mode(mode):
    from qaray_tpu_torch.utils import compiled

    return compiled.eager() if mode == "eager" else _null()


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def cases():
    """{name: (description, scene builder, RendererParam keywords, route
    switches, world_bvh)}."""
    from qaray_tpu_torch.scene.procedural import (
        icosphere,
        with_glass,
        with_mesh,
    )
    from qaray_tpu_torch.scene.xml_parser import load_scene

    def softdof():
        return load_scene(os.path.join(ASSETS, "softdof_scene.xml"))

    def scene(name):
        return lambda: load_scene(os.path.join(ASSETS, name))

    return {
        "4a": ("softdof defaults", softdof, {}, {}, True),
        "4b": ("softdof wavefront 1 spp", softdof,
               dict(spp_min=1, spp_max=1, batch_pixels=1 << 16),
               {"QARAY_NO_MEGAKERNEL": "1"}, True),
        "4e": ("mesh_scene ico6 1 spp (K4a/K4b)",
               lambda: with_mesh(load_scene(os.path.join(
                   ASSETS, "mesh_scene.xml")), *icosphere(6), name="ico6"),
               dict(spp_min=1, spp_max=1), {}, True),
        "4k": ("caustics_scene photon map defaults",
               lambda: with_glass(softdof(), "mid"),
               dict(use_photon_map=True), {}, True),
        "4o": ("grid_scene per instance defaults", scene("grid_scene.xml"),
               {}, {}, False),
        "4g": ("texture_scene defaults", scene("texture_scene.xml"), {}, {},
               True),
    }


class _env:
    def __init__(self, env):
        self.env = env

    def __enter__(self):
        for k, v in self.env.items():
            os.environ[k] = v

    def __exit__(self, *exc):
        for k in self.env:
            os.environ.pop(k, None)


def make_renderer(name):
    """A Renderer of case `name` with its scene (and maps, written into the
    working directory) computed."""
    from qaray_tpu_torch.renderer import Renderer, RendererParam

    what, build, kw, env, world_bvh = cases()[name]
    r = Renderer(RendererParam(**kw), device="cuda")
    with _env(env):
        r.compute_scene(build(), world_bvh=world_bvh)
    return r


def render_once(r, mode, env, profile=True):
    """One render of r in `mode` on a fresh frame buffer: (frame buffer,
    wall ms, device busy ms or None, graphs captured)."""
    from qaray_tpu_torch.fb.framebuffer import FrameBuffer
    from qaray_tpu_torch.utils import compiled

    r.fb = FrameBuffer(r.meta.img_width, r.meta.img_height)
    before = compiled.stats["captures"]
    torch.cuda.synchronize()
    if profile:
        flush_profiler()
    with _env(env), _mode(mode):
        if profile:
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                fb = r.render()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t) * 1e3
            busy = sum(_device_us(e) for e in prof.key_averages()) / 1e3
        else:
            t = time.perf_counter()
            fb = r.render()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
            busy = None
    return fb, wall, busy, compiled.stats["captures"] - before


def planes_equal(a, b):
    return all(np.array_equal(np.asarray(getattr(a, k)),
                              np.asarray(getattr(b, k))) for k in PLANES)


def render_turns(name, r=None, turns=TURNS, profile=True):
    """Case `name` in turns (a first captured render before them captures
    the graphs, untimed). Returns a dict: per turn the mode, wall, busy and
    idle share, the captures of each turn, the planes' equality with the
    first eager turn, graphs held and peak memory."""
    from qaray_tpu_torch.utils import compiled

    what, _, _, env, _ = cases()[name]
    t = time.perf_counter()
    r = r or make_renderer(name)
    setup_s = time.perf_counter() - t
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    first, _, _, caps0 = render_once(r, "captured", env, profile=False)
    first_s = time.perf_counter() - t
    peak_cap = torch.cuda.max_memory_allocated()
    rows, ref, equal = [], None, True
    for mode in turns:
        t = time.perf_counter()
        fb, wall, busy, caps = render_once(r, mode, env, profile)
        if ref is None:
            ref = fb
        equal = equal and planes_equal(fb, ref)
        rows.append(dict(mode=mode, wall_ms=wall, busy_ms=busy,
                         idle_share=None if busy is None
                         else 1.0 - busy / wall, captures=caps,
                         turn_s=time.perf_counter() - t))
    fb_c, _, _, caps_c = render_once(r, "captured", env, profile=False)
    equal = bool(equal and planes_equal(fb_c, ref)
                 and planes_equal(first, ref))
    out = dict(case=name, what=what, turns=rows, setup_s=setup_s,
               first_captured_s=first_s,
               first_captures=caps0, again_captures=caps_c,
               planes_equal=equal, graphs=compiled.graph_count(),
               peak_mib_first_captured=peak_cap / 2**20,
               peak_mib=torch.cuda.max_memory_allocated() / 2**20)
    print(f"  {name} {what}: captured vs eager planes equal {equal}; scene "
          f"set-up {setup_s:.2f} s, first captured render {first_s:.3f} s "
          f"with {caps0} captures, a later one {caps_c}; graphs "
          f"{out['graphs']}, peak {out['peak_mib']:.1f} MiB; a profiled "
          "turn's seconds " + " / ".join(f"{x['turn_s']:.1f}" for x in rows),
          flush=True)
    print("    turns " + " / ".join(
        f"{x['mode']} {x['wall_ms']:.3f} ms busy "
        + ("n/a" if x['busy_ms'] is None else
           f"{x['busy_ms']:.3f} idle {x['idle_share']:.4f}")
        for x in rows), flush=True)
    return out


# The Renderer's spans that cpu_split reads (utils/timing.span): the whole
# render, then its parts in the order of a render. render.escalate and the
# escalated lanes' render.fold run inside render.retire, and the last
# render.retire inside render.end: a nested span counts in its parent too.
RENDER_SPANS = ("render", "render.start", "render.dispatch", "render.fold",
                "render.retire", "render.escalate", "render.converge",
                "render.end")


def cpu_split(name, r=None, top=12):
    """Where the host's time of one render of case `name` goes, in each
    mode (after a captured render that captures its graphs): the wall and
    the Renderer's program spans (utils/timing.totals over the render: the
    whole render, render.start with init_state, render.dispatch,
    render.fold, render.retire with its reads and escalated re-renders and
    folds, render.converge, render.end with the last retire, sync_to_fb
    and finalize), then a second render under cProfile for the functions
    that hold the host (own time; cProfile inflates Python's share)."""
    from qaray_tpu_torch.fb.framebuffer import FrameBuffer
    from qaray_tpu_torch.utils import timing

    what, _, _, env, _ = cases()[name]
    r = r or make_renderer(name)
    render_once(r, "captured", env, profile=False)
    out = {}
    for mode in ("eager", "captured"):
        r.fb = FrameBuffer(r.meta.img_width, r.meta.img_height)
        before = {k: list(v) for k, v in timing.totals.items()}
        torch.cuda.synchronize()
        with _env(env), _mode(mode):
            t = time.perf_counter()
            r.render()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        grown = {k: [v[0] - before.get(k, [0.0, 0])[0],
                     v[1] - before.get(k, [0.0, 0])[1]]
                 for k, v in timing.totals.items()}
        parts = {k: grown[k][0] * 1e3 for k in RENDER_SPANS if k in grown}
        calls = {k: grown[k][1] for k in RENDER_SPANS if k in grown}
        r.fb = FrameBuffer(r.meta.img_width, r.meta.img_height)
        torch.cuda.synchronize()
        prof = cProfile.Profile()
        with _env(env), _mode(mode):
            prof.enable()
            r.render()
            torch.cuda.synchronize()
            prof.disable()
        st = pstats.Stats(prof)
        own = sorted(((tt, f"{os.path.basename(f)}:{fn}")
                      for (f, _, fn), (_, _, tt, _, _) in st.stats.items()),
                     reverse=True)[:top]
        out[mode] = dict(wall_ms=wall, parts_ms=parts, calls=calls,
                         top_own_ms_cprofile=[(k, v * 1e3) for v, k in own])
        print(f"  {name} {what} {mode}: wall {wall:.3f} ms; " + ", ".join(
            f"{k} {v:.3f}" + (f" ({calls[k]} calls)" if k in calls else "")
            for k, v in parts.items()), flush=True)
        print("    own time under cProfile (ms): " + ", ".join(
            f"{k} {v:.2f}" for k, v in out[mode]["top_own_ms_cprofile"]),
            flush=True)
    return out


def grad_turns(steps=3, lanes=1 << 18):
    """The fast route over `steps` steps with parameters that change every
    step, eager then captured: (equal bit for bit, captures of each
    captured step, launch counts of the captured steps)."""
    from qaray_tpu_torch import diff
    from qaray_tpu_torch.integrators.engine import IntegratorConfig
    from qaray_tpu_torch.ops import adjoint, megakernel
    from qaray_tpu_torch.renderer import key_words
    from qaray_tpu_torch.scene.compiler import compile_scene
    from qaray_tpu_torch.scene.xml_parser import load_scene
    from qaray_tpu_torch.utils import compiled

    desc = load_scene(os.path.join(ASSETS, "spot_scene.xml"))
    desc.camera.img_width, desc.camera.img_height = 800, 600
    arr, meta = compile_scene(desc, device="cuda")
    cfg = IntegratorConfig(integrator="pathtrace", max_bounce=5,
                           shadow_spp=16)
    ids = torch.arange(lanes, device="cuda", dtype=torch.int32)
    px, py = ids % 800, (ids // 800) % 600
    words = key_words("rbg", 0)
    base = diff.extract_params(arr)

    def run(mode):
        outs, caps = [], []
        for s in range(steps):
            params = diff.DiffParams(*(t * (1.0 + 0.05 * s) for t in base))
            scene = diff.splice_params(arr, params)
            before = compiled.stats["captures"]
            with _mode(mode):
                loss, g = diff.render_value_and_grad(
                    scene, meta, cfg, px, py, torch.full_like(ids, s), words)
            caps.append(compiled.stats["captures"] - before)
            outs.append((loss.clone(), [x.clone() for x in g]))
        return outs, caps

    eager_out, _ = run("eager")
    k1a, k6 = megakernel.launches["K1a"], adjoint.launches["K6"]
    cap_out, caps = run("captured")
    k1a, k6 = megakernel.launches["K1a"] - k1a, adjoint.launches["K6"] - k6
    again_out, caps_again = run("captured")
    equal = all(torch.equal(a[0], b[0]) and all(
        torch.equal(x, y) for x, y in zip(a[1], b[1]))
        for a, b in zip(eager_out, cap_out)) and all(
        torch.equal(a[0], b[0]) for a, b in zip(eager_out, again_out))
    moved = not torch.equal(eager_out[0][1][0], eager_out[1][1][0])
    print(f"  fast gradient route, {steps} steps, parameters changed every "
          f"step: captured vs eager equal {equal}; captures {caps} then "
          f"{caps_again}; K1a {k1a}, K6 {k6} launches over the captured "
          f"steps; gradients move between steps {moved}", flush=True)
    return dict(equal=equal, captures=caps, captures_again=caps_again,
                k1a=k1a, k6=k6, gradients_move=moved)


def autograd_case(name, lanes):
    """(scene arrays, meta, config, a step function of the sample index) of
    the autograd route (QARAY_NO_MEGAKERNEL) on spot_scene or mesh_scene at
    800x600 on its first `lanes` lanes, pathtrace, max_bounce 5,
    shadow_spp 16, rbg: 4m's gradient path."""
    from qaray_tpu_torch import diff
    from qaray_tpu_torch.integrators.engine import IntegratorConfig
    from qaray_tpu_torch.renderer import key_words
    from qaray_tpu_torch.scene.compiler import compile_scene
    from qaray_tpu_torch.scene.xml_parser import load_scene

    desc = load_scene(os.path.join(ASSETS, f"{name}_scene.xml"))
    desc.camera.img_width, desc.camera.img_height = 800, 600
    arr, meta = compile_scene(desc, device="cuda")
    cfg = IntegratorConfig(integrator="pathtrace", max_bounce=5,
                           shadow_spp=16)
    ids = torch.arange(lanes, device="cuda", dtype=torch.int32)
    px, py = ids % 800, (ids // 800) % 600
    words = key_words("rbg", 0)

    def step(s):
        with _env({"QARAY_NO_MEGAKERNEL": "1"}):
            return diff.render_value_and_grad(
                arr, meta, cfg, px, py, torch.full_like(ids, s), words)

    return step


def _step_once(step, mode, profile=True):
    """One gradient step in `mode`: ((loss, gradients), wall ms, device
    busy ms or None, captures, the step's own peak MiB (above what was
    allocated before it), launch counts)."""
    from qaray_tpu_torch.utils import compiled

    torch.cuda.synchronize()
    if profile:
        flush_profiler()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    before, counts = compiled.stats["captures"], compiled._snapshot()
    with _mode(mode), contextlib.ExitStack() as stack:
        if profile:
            prof = stack.enter_context(torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]))
        t = time.perf_counter()
        out = step(1)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    busy = (sum(_device_us(e) for e in prof.key_averages()) / 1e3
            if profile else None)
    after = compiled._snapshot()
    moved = {f"{k[2] or k[1]}": after[k] - v for k, v in counts.items()
             if after[k] != v}
    return (out, wall, busy, compiled.stats["captures"] - before,
            (torch.cuda.max_memory_allocated() - held) / 2**20, moved)


def autograd_turns(name, lanes, turns=TURNS):
    """The autograd route's step (autograd_case) in turns, one step a
    turn under torch.profiler (CUDA activity), after a first captured step
    that captures its graph (untimed): per turn the wall, busy time, idle
    share, captures, peak MiB and launch counts; the capture's peak and
    what it added to the memory reserved (the graphs' pool). Bits: the loss of every turn equal to the
    first eager turn's, each field of a captured turn no further from it
    than the second eager turn is (max |difference| a field); a captured
    step replayed under sync debug "error"."""
    step = autograd_case(name, lanes)
    reserved = torch.cuda.memory_reserved()
    first = _step_once(step, "captured", profile=False)
    capture_peak = first[4]
    reserved = (torch.cuda.memory_reserved() - reserved) / 2**20
    rows, outs = [], []
    for mode in turns:
        out, wall, busy, caps, peak, counts = _step_once(step, mode)
        outs.append(out)
        rows.append(dict(mode=mode, wall_ms=wall, busy_ms=busy,
                         idle_share=1.0 - busy / wall, captures=caps,
                         peak_mib=peak, launches=counts))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        synced = step(1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    eager = [o for o, r in zip(outs, rows) if r["mode"] == "eager"]
    captured = [o for o, r in zip(outs, rows) if r["mode"] == "captured"]
    captured += [first[0], synced]
    spread = [(a - b).abs().max().item()
              for a, b in zip(eager[0][1], eager[1][1])]
    off = [max((c[1][i] - eager[0][1][i]).abs().max().item()
               for c in captured) for i in range(len(spread))]
    loss_equal = all(torch.equal(o[0], eager[0][0])
                     for o in eager + captured)
    within = all(o <= s for o, s in zip(off, spread))
    launches_equal = all(r["launches"] == rows[0]["launches"] for r in rows)
    out = dict(case=name, lanes=lanes, turns=rows,
               first_captures=first[3], first_captured_ms=first[1],
               capture_peak_mib=capture_peak, reserved_mib=reserved,
               loss_equal=loss_equal, within_eager_spread=within,
               eager_spread=spread, captured_off=off,
               launches_equal=launches_equal)
    print(f"  autograd step, {name} {lanes} lanes: loss equal {loss_equal}; "
          f"fields within the eager turns' spread {within} (spread "
          + ", ".join(f"{s:.3g}" for s in spread) + "; captured off "
          + ", ".join(f"{o:.3g}" for o in off) + f"); launches equal "
          f"{launches_equal} {json.dumps(rows[0]['launches'])}; first "
          f"captured step {first[1]:.1f} ms with {first[3]} captures, its "
          f"peak {capture_peak:.1f} MiB, {reserved:.1f} MiB more reserved",
          flush=True)
    print("    turns " + " / ".join(
        f"{x['mode']} {x['wall_ms']:.3f} ms busy {x['busy_ms']:.3f} idle "
        f"{x['idle_share']:.4f} peak {x['peak_mib']:.1f} MiB captures "
        f"{x['captures']}" for x in rows), flush=True)
    return out


def op_split(name="spot", lanes=1 << 18, top=12):
    """Where the device time of one eager autograd step goes (autograd_case,
    after the turns have warmed it): torch.profiler with CPU and CUDA
    activity, the operators by the device time of the kernels they launch
    themselves and the kernels by name, each with its count and its share
    of the step's device busy time."""
    from qaray_tpu_torch.utils import compiled

    step = autograd_case(name, lanes)
    with compiled.eager():
        step(1)
        torch.cuda.synchronize()
        flush_profiler()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            step(1)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type != torch.autograd
               .DeviceType.CPU]
    busy = sum(_device_us(e) for e in kernels) / 1e3
    ops = sorted(((_device_us(e) / 1e3, e.key, e.count) for e in events
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and _device_us(e) > 0), reverse=True)[:top]
    kern = sorted(((_device_us(e) / 1e3, e.key, e.count) for e in kernels),
                  reverse=True)[:top]
    out = dict(case=name, lanes=lanes, wall_ms=wall, busy_ms=busy,
               ops=[dict(name=k, count=c, device_ms=ms, share=ms / busy)
                    for ms, k, c in ops],
               kernels=[dict(name=k[:120], count=c, device_ms=ms,
                             share=ms / busy) for ms, k, c in kern])
    print(f"  eager autograd step, {name} {lanes} lanes, under the profiler "
          f"(CPU and CUDA): wall {wall:.1f} ms, device busy {busy:.1f} ms",
          flush=True)
    for what in ("ops", "kernels"):
        print(f"    top {what} by device ms (count, share of busy): " + "; ".join(
            f"{x['name']} {x['device_ms']:.1f} ({x['count']}, "
            f"{x['share']:.3f})" for x in out[what]), flush=True)
    return out


def photon_turns():
    """caustics_scene's default maps, eager then captured (twice):
    (equal bit for bit, captures of each captured build)."""
    from qaray_tpu_torch.photon.build import build_photon_maps
    from qaray_tpu_torch.renderer import RendererParam
    from qaray_tpu_torch.scene.compiler import compile_scene
    from qaray_tpu_torch.scene.procedural import with_glass
    from qaray_tpu_torch.scene.xml_parser import load_scene
    from qaray_tpu_torch.utils import compiled

    desc = with_glass(load_scene(os.path.join(ASSETS, "softdof_scene.xml")),
                      "mid")
    arr, meta = compile_scene(desc, device="cuda")
    param = RendererParam(use_photon_map=True)
    with compiled.eager():
        torch.cuda.synchronize()
        t = time.perf_counter()
        want = build_photon_maps(arr, meta, param)
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t
    got, caps, walls = [], [], []
    for _ in range(2):
        before = compiled.stats["captures"]
        torch.cuda.synchronize()
        t = time.perf_counter()
        got.append(build_photon_maps(arr, meta, param))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        caps.append(compiled.stats["captures"] - before)
    equal = all(torch.equal(getattr(a, f), getattr(b, f))
                for m in got for a, b in zip(want, m)
                for f in ("pos", "power", "max_power", "direction", "valid"))
    print(f"  photon maps (caustics_scene, defaults): captured vs eager "
          f"equal {equal}; captures {caps}; build s eager {eager_s:.3f}, "
          f"captured {walls[0]:.3f} (capturing) and {walls[1]:.3f}",
          flush=True)
    return dict(equal=equal, captures=caps, eager_s=eager_s,
                captured_s=walls)


def sync_check():
    """render_batch's replays on both routes and a fold's under sync debug
    mode "error", equal to their eager runs."""
    from qaray_tpu_torch.fb import device_accum
    from qaray_tpu_torch.fb.framebuffer import FrameBuffer
    from qaray_tpu_torch.integrators.engine import (
        IntegratorConfig,
        render_batch,
    )
    from qaray_tpu_torch.utils import compiled

    r = make_renderer("4a")
    ids = torch.arange(1 << 16, device="cuda", dtype=torch.int32)
    px, py, sid = ids % 800, ids // 800, torch.zeros_like(ids)
    cfg = IntegratorConfig(integrator="pathtrace")
    ok = True
    for env in ({}, {"QARAY_NO_MEGAKERNEL": "1"}):
        with _env(env):
            with compiled.eager():
                want = render_batch(r.scene_arrays, r.meta, cfg, px, py, sid,
                                    (0, 7))
            render_batch(r.scene_arrays, r.meta, cfg, px, py, sid, (0, 7))
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = render_batch(r.scene_arrays, r.meta, cfg, px, py, sid,
                                   (0, 7))
            finally:
                torch.cuda.set_sync_debug_mode(0)
        ok = ok and all(torch.equal(a, b) for a, b in zip(want, got))
    state = device_accum.init_state(FrameBuffer(800, 600), "cuda")
    colors = torch.rand((1 << 16, 3), device="cuda")
    device_accum.accumulate_round(state, ids, colors)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        device_accum.accumulate_round(state, ids, colors)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ok = ok and bool((state["count"][:1 << 16] == 2).all())
    print(f"  replays under sync debug mode \"error\": no error, equal to "
          f"eager {ok}", flush=True)
    return dict(equal=ok)


def main(argv):
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    which = argv or ["sync", "4a", "4b", "4e", "4k", "4o", "4g", "grad",
                     "autograd", "photon", "profile"]
    print(card_line(), flush=True)
    out = {}
    here = os.getcwd()
    # Photon-mapped scenes write their maps into the working directory.
    with tempfile.TemporaryDirectory() as work:
        os.chdir(work)
        try:
            for name in which:
                t = time.time()
                if name == "sync":
                    out[name] = sync_check()
                elif name == "grad":
                    out[name] = grad_turns()
                elif name == "autograd":
                    out[name] = {w: autograd_turns(w, n)
                                 for w, n in AUTOGRAD_LANES}
                    out["op_split"] = op_split()
                elif name == "photon":
                    out[name] = photon_turns()
                elif name == "profile":
                    out[name] = {c: cpu_split(c) for c in ("4a", "4b")}
                else:
                    out[name] = render_turns(name)
                print(f"  ({name}: {time.time() - t:.1f} s)", flush=True)
        finally:
            os.chdir(here)
    out["stats"] = dict(compiled_stats(), peak_mib=max(
        [v["peak_mib"] for v in out.values() if "peak_mib" in v] or [0.0]))
    print(f"  captures {out['stats']['captures']} in "
          f"{out['stats']['capture_s']:.2f} s (warm-ups included), replays "
          f"{out['stats']['replays']}, graphs held {out['stats']['graphs']}, "
          f"peak memory of a case's renders {out['stats']['peak_mib']:.1f} "
          "MiB", flush=True)
    print(json.dumps(out))
    return 0


def compiled_stats():
    from qaray_tpu_torch.utils import compiled

    return dict(compiled.stats, graphs=compiled.graph_count())


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
