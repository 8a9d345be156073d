"""Smoke test of the PyTorch/CUDA port (qaray_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build every kernel from csrc/ (one nvcc per source, in parallel);
  2. kernels against their plain versions:
       a. K2a, K2b, K2c on 1M random rays against the primitives of
          tests/assets/softdof_scene.xml (tests/test_pallas.py bars);
       b. K3 (ico5, 20,480 triangles) against stream_closest and
          stream_any_hit, K4a/K4b (ico6, 81,920 triangles) against
          tiled_sweep, and the two-phase K4a march against the single-phase
          one, on 1M random rays and the 480,000 camera rays of
          tests/assets/mesh_scene.xml at 800x600 (and their shadow rays for
          K4b), with the tests/test_pallas_tiles.py bars;
       c. K5 against photon_gather_plain on caustics_scene (softdof with its
          middle sphere made glass, scene.procedural.with_glass) at
          800x600 with the default maps (10,000 global photons at r 0.2,
          1,000 caustics photons at r 1.0; every map build in a temporary
          working directory): the 480,000 global-map records of one
          photon-mapped megakernel dispatch, Morton-sorted as gather_apply
          sorts them, and the same at radius 50 where counts exceed 100
          (sums within 1e-5 relative, 1e-7 absolute; counts exact; the share
          of bit-equal lanes printed);
  3. the megakernel against the wavefront engine, with the
     tests/test_megakernel.py bars:
       a. K1a: softdof_scene.xml at 200x150, 2 samples per pixel,
          max_bounce 4, threefry keys, for pathtrace and photonmap;
       b. K1a at the main path's shapes at 800x600, max_bounce 5, where the
          fold datum rid * 65536 + sid wraps past 2^31: the Renderer's first
          packed photonmap dispatch (960,000 lanes, rbg key words), the
          pathtrace render_batch of phase 4a (480,000 lanes, rbg) and a
          phase-2 photonmap round (480,000 lanes, sample 5, threefry);
       c. K1c: mesh_scene.xml (320 triangles), its ico5 (20,480) and
          mirror_scene.xml (a mirrored icosphere alone) at 200x150 x 2 spp,
          threefry, max_bounce 3, pathtrace and photonmap (the
          test_mega_parity_mesh and test_mega_streamed_mesh_parity bars),
          and the first two at 800x600 with the Renderer's photonmap
          settings and rbg words;
       d. K1b: texture_scene.xml (checkers on the floor and the ball) at
          200x150 x 2 spp, threefry, pathtrace and photonmap, a variant
          with a second live slot (specular) under a rotated and translated
          map, and texture_scene at 800x600 with the Renderer's photonmap
          settings and rbg words (the test_mega_checker_textures_parity
          bars: under 5e-3 of lanes above 1e-3 relative, channel means
          within 2e-3);
       e. K1a+K1d: caustics_scene with the default maps against the
          wavefront engine with its exact gathers, at 200x150 x 2 spp
          (threefry) and at 800x600 (threefry and rbg words), with the
          test_mega_photon_gather_parity bars on lanes that are not
          escalated (its share of lanes off cut from 1 % to 1e-4, and a
          control run with the caustics map emptied that must be off on
          ten times that share), and at 200x150 with both radii at 50 those of
          test_mega_photon_escalation_flags_dense_lanes (over 0.3 of lanes
          flagged, no unflagged lane off); escalated shares printed;
       f. K6 (the fused adjoint) against adjoint_render_plain at 200x150,
          max_bounce 5, threefry, on spot_scene.xml, mesh_scene.xml and the
          glass scene (softdof with its depth of field 0 and its middle
          sphere glass), each field within 3e-2 of its max|b|
          (tests/test_grad.py's bar), the errors printed; and render_batch's
          gradients on the megakernel route (K1a forward, the engine's
          autograd backward) against render_with_params';
  4. the main path at 800x600 with every launch count set to 0 before each
     route and read after it, and every plain version of a kernel made to
     raise if it is called:
       a. Renderer defaults (photonmap, spp 4..8, max_bounce 5, shadows
          16->64, rbg) on softdof writing its PNGs, then render_batch with
          pathtrace on 480,000 lanes: K1a only, no lane on the wavefront
          engine;
       b. the wavefront route render_batch takes for scenes the megakernel
          does not serve (forced with QARAY_NO_MEGAKERNEL, 65,536-pixel
          batches): K2b and K2c;
       c. Renderer defaults on mesh_scene.xml: K1a with K1c's mesh sweep;
       d. the same with the ico5 icosphere: K1a/K1c;
       e. the same with the ico6 icosphere, 1 spp: above 65,536 triangles
          the wavefront route, K4a (two-phase) and K4b with K2b/K2c;
       f. mesh_scene.xml under QARAY_NO_MEGAKERNEL, 1 spp: K3 with K2b/K2c;
       g. Renderer defaults on texture_scene.xml: K1a with K1b's checker
          textures, no lane on the wavefront engine;
       h. texture_scene.xml under QARAY_NO_MEGAKERNEL, 1 spp: the wavefront
          route with the texture stack (K2b's uv, K2c, ops/texture.py);
       i. spot_scene.xml with tests/assets/colorBuffer.png bound in code
          to a material, the background and the environment, 1 spp: the
          wavefront route, and the same scene at 200x150 against the same
          render on the CPU;
       j. the basic, phong and mcgi integrators on spot_scene.xml, 1 spp:
          the wavefront route (K2b/K2c);
       k. Renderer defaults with -use-photon-map on caustics_scene in a
          temporary working directory: K1a+K1d with K5 on the records, the
          escalated lanes (and only those) on the wavefront engine; map
          build times and photon counts, the escalated share;
       l. the same scene at 1 spp under QARAY_NO_MEGAKERNEL: the exact
          gathers on the wavefront route;
       m. the gradient path: diff.render_value_and_grad at bench.py's
          gradient shapes (max_bounce 5, shadow_spp 16, rbg words) on
          spot_scene.xml at 800x600 with 262,144 lanes and mesh_scene.xml
          with 131,072, by the fast route (K1a forward, one K6 launch) and
          by autograd (QARAY_NO_MEGAKERNEL: K2b/K2c, K3 on the mesh, and
          their backward), the two routes' gradients within 3e-2 of each
          field's max|b|; forward+backward paths/s and the device's idle
          share printed;
  5. each kernel's time at the path's shapes beside its bound, its launches
     on the main path and its plain version's time, and the device's idle
     share in one Renderer.render() of 4a, 4c, 4g, 4e and 4k; K6's at the
     gradient path's shape of 4m.
Prints the card's name and power limit, one JSON line of per-kernel
numbers and, last, {"ok": true, "device": {...}}. Exits non-zero without
those lines when there is no CUDA device or no package beside it.
"""

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SCENE = os.path.join(HERE, "tests", "assets", "softdof_scene.xml")
TEXTURE_SCENE = os.path.join(HERE, "tests", "assets", "texture_scene.xml")
SPOT_SCENE = os.path.join(HERE, "tests", "assets", "spot_scene.xml")
IMAGE = os.path.join(HERE, "tests", "assets", "colorBuffer.png")

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 operations/s
# outside the tensor cores (integer operations are counted at the same
# rate, which keeps the bound a lower bound).
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12
# Operations per unit of work, counted from csrc/analytic.cuh and
# csrc/threefry.cuh: a primitive test is at least 45 (object-space transform
# 33, plane solve and bounds 12; a sphere takes more), a threefry cipher
# about 120 (20 rounds of add, rotate, xor; 5 key injections). Shading
# arithmetic between them is not counted, so the bound stays a lower bound.
OPS_PER_TEST = 45
OPS_PER_CIPHER = 120
# A triangle test (csrc/mesh.cuh tri_hit) is at least 40: six 3-term dot
# products (30), t (2), the barycentric weights a, b (6) and c (2).
OPS_PER_TRI = 40
# A checker test (csrc/megakernel.cu textured/checker01) is at least 12: the
# sample position (4 multiplies, 4 adds) and two floors with their
# subtractions; the compares and the sum are not counted.
OPS_PER_CHECKER = 12
# A photon test (csrc/photon.cuh photon_add) is at least 20: the distance
# (3 subtractions, 3 multiplies, 2 adds), the weight (a multiply and a
# subtraction), seven multiply-adds of the sums counted as 7 (the count's
# add included) and the compare. A cluster test (photon_cluster_near) is
# at least 12: six additions or subtractions of the radius, six compares.
OPS_PER_PHOTON = 20
OPS_PER_PCLUSTER = 12
# K1d's bar on the share of unescalated lanes off by more than 1e-3
# relative (the JAX package's test allows 1 %, more than a caustic under
# one glass sphere may touch).
K1D_OFF_BAR = 1e-4
# K6's bar against its plain version: tests/test_grad.py's 3e-2 of each
# field's max|b| (the kernel's atomics sum in another order, and a lane
# whose path differs by a last-bit flip moves a field's sum).
K6_BAR = 3e-2
MESH_SCENE = os.path.join(HERE, "tests", "assets", "mesh_scene.xml")
MIRROR_SCENE = os.path.join(HERE, "tests", "assets", "mirror_scene.xml")
ICO_CENTRE, ICO_RADIUS = (0.0, 50.0, 5.1), 8.0  # mesh_scene's icosphere
BIG = 1e30


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=10):
    """Mean milliseconds of fn() by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_us(evt):
    """Self device time (us) of a profiler event, across torch versions."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        val = getattr(evt, attr, None)
        if val is not None:
            return val
    return 0


def kernel_ms(fn, kernel_name, reps=10):
    """Milliseconds per launch of the CUDA kernel whose name contains
    kernel_name (fn launches it once), from torch.profiler's device times
    over the launches it recorded; CUDA events around the whole call when
    it recorded none. torch.profiler may drop the records of the last
    launches it traced, so the mean is taken over those it kept, and their
    count is printed when it is short.
    Returns (ms, "profiler" | "events")."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    seen = [e for e in prof.key_averages() if kernel_name in e.key]
    total = sum(device_us(e) for e in seen)
    count = sum(e.count for e in seen)
    if count != reps:
        print(f"  the profiler recorded {count} of {reps} {kernel_name} "
              "launches", flush=True)
    if total > 0:
        return total / count / 1e3, "profiler"
    return cuda_ms(fn, reps), "events"


def bound(nbytes, ops):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(cond, what):
    if not cond:
        raise AssertionError(what)
    print(f"  ok: {what}", flush=True)


def t_bars(t_ref, i_ref, t_got, i_got, what):
    """tests/test_pallas.py:41-45 bars; returns the agreeing hit lanes."""
    hits = (t_ref < 1e29) & (t_got < 1e29)
    rel = ((t_got - t_ref).abs() / t_ref.clamp_min(1.0))[hits]
    p99 = torch.quantile(rel[: 1 << 24].double(), 0.99).item()
    flips = ((t_ref < 1e29) ^ (t_got < 1e29)).float().mean().item()
    same = (i_got == i_ref)[hits].float().mean().item()
    check(p99 < 1e-5, f"{what}: p99 relative t error {p99:.3g} < 1e-5")
    check(flips < 0.005, f"{what}: hit/miss flips {flips:.3g} < 0.005")
    check(same > 0.995, f"{what}: same primitive {same:.6f} > 0.995")
    return (hits & (i_got == i_ref)), (t_got - t_ref)[hits].abs().max().item()


def lanes(w, h, spp, device="cuda"):
    ids = torch.arange(w * h * spp, device=device, dtype=torch.int32)
    return ids % w, (ids // w) % h, ids // (w * h)


def compare_render(rad_ref, t0_ref, rad, t0, what):
    """tests/test_megakernel.py:94-110 bars."""
    rad_ref, rad = rad_ref.double(), rad.double()
    t_ok = torch.allclose(t0_ref, t0, rtol=1e-4, atol=1e-3)
    check(t_ok, f"{what}: t0 within rtol 1e-4 atol 1e-3")
    rel = ((rad_ref - rad).abs().amax(-1)
           / (1.0 + rad_ref.abs().amax(-1)))
    frac = (rel > 1e-3).double().mean().item()
    med = rel.median().item()
    mean_err = (rad_ref.mean(0) - rad.mean(0)).abs().max().item()
    check(frac < 2e-3, f"{what}: lanes above 1e-3 relative {frac:.3g} < 2e-3")
    check(med < 1e-6, f"{what}: median relative error {med:.3g} < 1e-6")
    check(mean_err < 2e-3, f"{what}: image-mean error {mean_err:.3g} < 2e-3")
    return (rad_ref - rad).abs().max().item()


def compare_tex_render(rad_ref, t0_ref, rad, t0, what):
    """tests/test_megakernel.py::test_mega_checker_textures_parity's bars,
    and primary depth as compare_render holds it."""
    rad_ref, rad = rad_ref.double(), rad.double()
    check(torch.allclose(t0_ref, t0, rtol=1e-4, atol=1e-3),
          f"{what}: t0 within rtol 1e-4 atol 1e-3")
    rel = ((rad_ref - rad).abs().amax(-1)
           / (1.0 + rad_ref.abs().amax(-1)))
    frac = (rel > 1e-3).double().mean().item()
    mean_err = (rad_ref.mean(0) - rad.mean(0)).abs().max().item()
    check(frac < 5e-3, f"{what}: lanes above 1e-3 relative {frac:.3g} < 5e-3")
    check(mean_err < 2e-3, f"{what}: channel-mean error {mean_err:.3g} < "
          "2e-3")
    return (rad_ref - rad).abs().max().item()


def compare_mesh_render(rad_ref, t0_ref, rad, t0, what, bars):
    """tests/test_megakernel.py's mesh bars (t0 lanes off by > 1e-3,
    radiance lanes above 1e-3 relative, channel means): the engine re-tests
    each sweep winner with the exact reference formula while K1c shades the
    sweep's own t and weights, so near-edge lanes may differ."""
    t_bar, rad_bar, mean_bar = bars
    rad_ref, rad = rad_ref.double(), rad.double()
    t_frac = ((t0_ref - t0).abs() > 1e-3).double().mean().item()
    rel = ((rad_ref - rad).abs().amax(-1)
           / (1.0 + rad_ref.abs().amax(-1)))
    frac = (rel > 1e-3).double().mean().item()
    mean_err = (rad_ref.mean(0) - rad.mean(0)).abs().max().item()
    check(t_frac < t_bar, f"{what}: t0 lanes off by > 1e-3 {t_frac:.3g} < "
          f"{t_bar}")
    check(frac < rad_bar, f"{what}: lanes above 1e-3 relative {frac:.3g} < "
          f"{rad_bar}")
    check(mean_err < mean_bar, f"{what}: channel-mean error {mean_err:.3g} "
          f"< {mean_bar}")
    return (rad_ref - rad).abs().max().item()


def row_bars(want, got, what):
    """tests/test_pallas_tiles.py:43-49 on (t, row, row2): rows equal on >
    99.9 % of rays, t to rtol/atol 1e-5 where they agree on a hit, runner-ups
    equal on > 99 % of the rays where both agree and report one. Returns
    the largest t difference on the agreeing hits."""
    t_x, r_x, r2_x = want[:3]
    t_k, r_k, r2_k = got[:3]
    same = (r_x == r_k).double().mean().item()
    hit = (r_x >= 0) & (r_x == r_k)
    close = torch.allclose(t_k[hit], t_x[hit], rtol=1e-5, atol=1e-5)
    agree = (r_x == r_k) & (r2_x >= 0) & (r2_k >= 0)
    same2 = (r2_x[agree] == r2_k[agree]).double().mean().item()
    check(same > 0.999, f"{what}: rows equal on {same:.6f} > 0.999")
    check(close, f"{what}: t within rtol/atol 1e-5 on agreeing hits")
    check(same2 > 0.99, f"{what}: runner-ups equal on {same2:.6f} > 0.99")
    return (t_k - t_x)[hit].abs().max().item() if hit.any() else 0.0


def mesh_rays(n, seed):
    """Rays around mesh_scene's icosphere: origins uniform in a box three
    radii wide, half the directions aimed at the centre (jittered), half
    uniform; budgets uniform in [1, 41)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    c = torch.tensor(ICO_CENTRE, device="cuda")
    p = c + (torch.rand((n, 3), device="cuda", generator=gen) * 2.0 - 1.0
             ) * (3.0 * ICO_RADIUS)
    d = torch.randn((n, 3), device="cuda", generator=gen)
    d = d / d.norm(dim=1, keepdim=True)
    aim = (c - p) / (c - p).norm(dim=1, keepdim=True)
    d = torch.where((torch.arange(n, device="cuda") % 2 == 0)[:, None],
                    aim + 0.05 * d, d)
    d = d / d.norm(dim=1, keepdim=True)
    t_max = torch.rand(n, device="cuda", generator=gen) * 40.0 + 1.0
    return p.contiguous(), d.contiguous(), t_max


def compare_photon_render(ref, got, esc, what, no_caustics):
    """tests/test_megakernel.py::test_mega_photon_gather_parity's bars on
    the lanes that are not escalated, with its share of lanes above 1e-3
    relative cut from 1 % to K1D_OFF_BAR: channel means within 2e-3, the
    irr0 plane equal on more than 0.999 of lanes; primary depth as
    compare_render holds it. no_caustics, the kernel's radiance on the same
    lanes with its caustics map emptied, must be off on ten times the bar's
    share: the bar sees a kernel that skips the caustics gather. Returns
    the largest difference on those lanes."""
    (rad_ref, t0_ref, irr_ref), (rad, t0, irr) = ref, got
    ok = ~esc
    rad_ref, rad = rad_ref.double(), rad.double()
    check(torch.allclose(t0_ref, t0, rtol=1e-4, atol=1e-3),
          f"{what}: t0 within rtol 1e-4 atol 1e-3")

    def off_share(x):
        rel = ((rad_ref - x.double()).abs().amax(-1)
               / (1.0 + rad_ref.abs().amax(-1)))[ok]
        return (rel > 1e-3).double().mean().item()

    frac, ctl = off_share(rad), off_share(no_caustics)
    mean_err = (rad_ref[ok].mean(0) - rad[ok].mean(0)).abs().max().item()
    same_irr = (irr_ref == irr).double().mean().item()
    print(f"  {what}: escalated share {esc.double().mean().item():.6g}, "
          f"unescalated lanes off without the caustics map {ctl:.6g}",
          flush=True)
    check(frac < K1D_OFF_BAR, f"{what}: unescalated lanes above 1e-3 "
          f"relative {frac:.3g} < {K1D_OFF_BAR:g}")
    check(ctl > 10 * K1D_OFF_BAR, f"{what}: control without the caustics "
          f"map off on {ctl:.3g} > {10 * K1D_OFF_BAR:g}")
    check(mean_err < 2e-3, f"{what}: channel-mean error {mean_err:.3g} < "
          "2e-3")
    check(same_irr > 0.999, f"{what}: irr0 equal on {same_irr:.6f} > 0.999")
    return (rad_ref - rad)[ok].abs().max().item()


def grad_field_errors(got, want):
    """Per DiffParams field: max|a - b| / max|b| (or max|a| where b is 0)."""
    out = {}
    for f in got._fields:
        a, b = getattr(got, f).double(), getattr(want, f).double()
        if a.numel() == 0:
            continue
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        out[f] = err / scale if scale > 0 else a.abs().max().item()
    return out


class ForbidPlain:
    """Within the block, every plain version a kernel wrapper could take
    raises: a main-path run that finishes ran only kernels."""

    def __init__(self, *targets):
        self.targets = targets  # (module, attribute name)
        self.saved = []

    def __enter__(self):
        for mod, name in self.targets:
            self.saved.append((mod, name, getattr(mod, name)))

            def refuse(*_args, _name=f"{mod.__name__}.{name}", **_kw):
                raise AssertionError(f"plain version {_name} ran on the "
                                     "main path")

            setattr(mod, name, refuse)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        self.saved = []
        return False


def main():
    if not torch.cuda.is_available():
        print("no CUDA device: the port's kernels run only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from qaray_tpu_torch.core.constants import BIAS
    from qaray_tpu_torch.integrators import engine
    from qaray_tpu_torch.integrators.engine import (
        IntegratorConfig,
        render_batch,
        render_batch_wavefront,
    )
    from qaray_tpu_torch.fb.framebuffer import FrameBuffer
    from qaray_tpu_torch import diff
    from qaray_tpu_torch.ops import _build, adjoint, analytic, megakernel
    from qaray_tpu_torch.ops import mesh_sweep
    from qaray_tpu_torch.ops import photon
    from qaray_tpu_torch.ops import intersect as I
    from qaray_tpu_torch.ops import tiles
    from qaray_tpu_torch.ops.mesh_stream import (
        StreamTris,
        stream_any_hit,
        stream_closest,
    )
    from qaray_tpu_torch.ops.mesh_tiles import TiledMesh, tiled_sweep
    from qaray_tpu_torch.renderer import Renderer, RendererParam, key_words
    from qaray_tpu_torch.scene import bvh as bvh_mod
    from qaray_tpu_torch.scene.compiler import compile_scene
    from qaray_tpu_torch.photon.build import build_photon_maps
    from qaray_tpu_torch.photon.cluster import cluster_photon_map
    from qaray_tpu_torch.scene.procedural import (
        icosphere,
        with_glass,
        with_mesh,
        with_texture,
    )
    from qaray_tpu_torch.scene.textures import load_image
    from qaray_tpu_torch.scene.xml_parser import load_scene

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    card = card_line()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # -- 1. build ----------------------------------------------------------
    t = time.time()
    reports = _build.build()
    print(f"phase 1: built {sorted(reports) or 'nothing (cached)'} in "
          f"{time.time() - t:.1f} s", flush=True)
    for name, log in reports.items():
        for line in log.splitlines():
            if "Function properties for" in line:
                print(f"  {name}: {line.split('for ', 1)[1].strip()}")
            elif "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    for name in _build.SOURCES:
        _build.load(name)
    numbers = {}

    def ptxas_info(name, symbol_part):
        """Registers and spill bytes (stores, loads) of the kernel whose
        mangled name holds symbol_part, from nvcc's -Xptxas=-v report of
        library `name`, which ops/_build writes beside the library."""
        log = _build._target(name).with_suffix(".log").read_text()
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Function properties for" in line and symbol_part in line:
                spill = dict((k, int(v)) for v, k in re.findall(
                    r"(\d+) bytes spill (stores|loads)", lines[i + 1]))
                regs = re.search(r"Used (\d+) registers", lines[i + 2])
                return dict(registers=int(regs.group(1)),
                            spill_store_bytes=spill["stores"],
                            spill_load_bytes=spill["loads"])
        raise AssertionError(f"no ptxas report for {symbol_part} in {name}")

    # -- 2. kernels against their plain versions -----------------------------
    print("phase 2a: analytic kernels vs plain, 1M random rays", flush=True)
    arr, meta = compile_scene(load_scene(SCENE), device="cuda")
    prims = arr.analytic
    gen = torch.Generator(device="cuda").manual_seed(0)
    n_rays = 1 << 20
    p = torch.rand((n_rays, 3), device="cuda", generator=gen) * 60.0 - 30.0
    d = torch.randn((n_rays, 3), device="cuda", generator=gen)
    d = d / d.norm(dim=1, keepdim=True)
    t_max = torch.rand(n_rays, device="cuda", generator=gen) * 59.0 + 1.0
    t_k, i_k = analytic.closest(p, d, prims)
    t_p, i_p = analytic.closest_plain(p, d, prims)
    _, err = t_bars(t_p, i_p, t_k, i_k, "K2a")
    numbers["K2a"] = {"max_abs_err": err}
    full_k = analytic.closest_full(p, d, prims)
    full_p = analytic.closest_full_plain(p, d, prims)
    agree, err = t_bars(full_p["t"], full_p["prim_idx"], full_k["t"],
                        full_k["prim_idx"], "K2b")
    for k in ("n", "p", "uvw"):
        e = (full_k[k] - full_p[k])[agree].abs().max().item()
        check(e < 1e-4, f"K2b: {k} max error {e:.3g} < 1e-4 on agreeing lanes")
        err = max(err, e)
    for k in ("front", "mtl"):
        check(bool((full_k[k] == full_p[k])[agree].all()),
              f"K2b: {k} equal on agreeing lanes")
    numbers["K2b"] = {"max_abs_err": err}
    occ_k = analytic.shadow(p, d, t_max, prims)
    occ_p = analytic.shadow_plain(p, d, t_max, prims)
    dis = (occ_k != occ_p).float().mean().item()
    check(dis < 0.005, f"K2c: occlusion disagreements {dis:.3g} < 0.005")
    numbers["K2c"] = {"max_abs_err": float(dis > 0), "disagree_frac": dis}
    torch.cuda.synchronize()

    print("phase 2b: mesh kernels vs plain: ico5 (K3) and ico6 (K4a/K4b), "
          "1M random rays and 480,000 camera rays at 800x600", flush=True)
    mesh_base = load_scene(MESH_SCENE)
    mesh_base.camera.img_width, mesh_base.camera.img_height = 800, 600
    ico5 = with_mesh(mesh_base, *icosphere(5), name="ico5")
    ico6 = with_mesh(mesh_base, *icosphere(6), name="ico6")
    t = time.time()
    a5, m5 = compile_scene(ico5, device="cuda")
    t5 = time.time() - t
    t = time.time()
    a6, m6 = compile_scene(ico6, device="cuda")
    t6 = time.time() - t
    # The world BVH is built at compile for tables equal to the JAX
    # package's; no route of the port walks it yet. Its share of compile:
    wv6 = a6.mesh.tri_v.cpu().numpy()
    t = time.time()
    b6 = bvh_mod.build_bvh(wv6, m6.max_leaf)
    bvh_mod.pack_bvh(b6.bounds, b6.left, b6.right, b6.count, b6.elems, wv6)
    tb6 = time.time() - t
    print(f"  compiled ico5 in {t5:.3f} s, ico6 in {t6:.3f} s; ico6's BVH "
          f"build and pack alone {tb6:.3f} s", flush=True)
    check(m5.num_tris == 20480 and m5.mesh_stream and m5.mesh_mega,
          "ico5: dense-sweep (K3) and megakernel (K1c) tables")
    check(m6.num_tris == 81920 and m6.mesh_tiled and not m6.mesh_mega,
          "ico6: tiled (K4a/K4b) tables, above the megakernel's limit")
    c16 = a5.mesh.stream_c16
    plain5 = StreamTris(a5.mesh.stream_coeff, a5.mesh.stream_const)
    m6t = a6.mesh
    tm6 = TiledMesh(m6t.tile_coeff, m6t.tile_const, m6t.tile_gid,
                    m6t.tile_cbounds)
    rp, rd, rt = mesh_rays(1 << 20, 7)
    cpx, cpy, csid = lanes(800, 600, 1)
    cp, cd, *_ = engine.generate_camera_rays(a5, m5, cpx, cpy, csid, None)
    cp, cd = cp.contiguous(), cd.contiguous()
    light = -torch.tensor([1.0, 0.5, -1.0], device="cuda")
    light = light / light.norm()
    mesh_err = {"K3": 0.0, "K4a": 0.0, "K4b": 0.0}
    for what, p_, d_, tmax_ in (("random", rp, rd, rt),
                                ("camera", cp, cd, rt[: cp.shape[0]])):
        t_cur = torch.full_like(tmax_, BIG)
        got = mesh_sweep.sweep_closest(p_, d_, t_cur, c16)
        want = stream_closest(p_, d_, t_cur, plain5)
        mesh_err["K3"] = max(mesh_err["K3"],
                             row_bars(want, got, f"K3 ico5 {what}"))
        occ_k = mesh_sweep.sweep_occluded(p_, d_, tmax_, c16)
        occ_p = stream_any_hit(p_, d_, tmax_, plain5)
        check(torch.equal(occ_k, occ_p), f"K3 any hit ico5 {what}: every "
              "ray equal")
        del got, want
        got = tiles.tiled_sweep_kernel(p_, d_, t_cur, tm6, m6t.tile_c16T)
        want = tiled_sweep(p_, d_, t_cur, tm6)
        mesh_err["K4a"] = max(mesh_err["K4a"],
                              row_bars(want, got, f"K4a ico6 {what}"))
        if what == "camera":
            # Shadow rays toward mesh_scene's direct light from the camera
            # rays' hits; misses get budget 0, as the engine gives them.
            hit = want[1] >= 0
            sp = (p_ + torch.where(hit, want[0], 0.0)[:, None] * d_)
            tmax_ = torch.where(hit, BIG, 0.0)
            d_ = light.expand_as(sp).contiguous()
            p_ = sp.contiguous()
            shadow6 = (p_, d_, tmax_)
        occ_k = tiles.tiled_sweep_kernel(p_, d_, tmax_, tm6, m6t.tile_c16T,
                                         any_hit=True)
        occ_p = tiled_sweep(p_, d_, tmax_, tm6, any_hit=True)
        check(torch.equal(occ_k, occ_p), f"K4b ico6 {what}: every ray equal "
              f"({occ_k.double().mean().item():.4f} occluded)")
        del got, want
    for what, p_, d_ in (("random", rp, rd), ("camera", cp, cd)):
        # Two-phase against single-phase, both on the coherence-sorted rays.
        # Rows may differ only where two triangles tie exactly in t (a ray
        # through an edge both share): the repacked phase-2 packets visit
        # the clusters in another order.
        t_cur = torch.full((p_.shape[0],), BIG, device="cuda")
        t0, r0, _ = tiles.tiled_closest_twophase(p_, d_, t_cur, tm6,
                                                 m6t.tile_c16T, budget=0)
        t1, r1, _ = tiles.tiled_closest_twophase(p_, d_, t_cur, tm6,
                                                 m6t.tile_c16T, budget=12)
        ties = int(((r0 != r1) & (t0 == t1)).sum().item())
        check(bool(((r0 == r1) | (t0 == t1)).all()),
              f"K4a two-phase vs single-phase ico6 {what}: rows identical "
              f"but for {ties} exact ties in t")
    torch.cuda.synchronize()

    print("phase 2c: K5 vs photon_gather_plain, the global-map records of "
          "one photon-mapped dispatch of caustics_scene at 800x600",
          flush=True)
    caus_desc = with_glass(load_scene(SCENE), "mid")
    caus_desc.camera.img_width, caus_desc.camera.img_height = 800, 600
    c_arr, c_meta = compile_scene(caus_desc, device="cuda")
    p_photon = RendererParam(use_photon_map=True)
    with tempfile.TemporaryDirectory() as wd, contextlib.chdir(wd):
        t = time.time()
        gmap, cmap = build_photon_maps(c_arr, c_meta, p_photon)
        torch.cuda.synchronize()
        t_maps = time.time() - t
    pmaps = (cluster_photon_map(gmap), cluster_photon_map(cmap))
    print(f"  maps built in {t_maps:.3f} s: {int(gmap.valid.sum())} global "
          f"photons in {pmaps[0].cbounds.shape[0]} clusters, "
          f"{int(cmap.valid.sum())} caustics photons in "
          f"{pmaps[1].cbounds.shape[0]} clusters", flush=True)
    cfg_photon = Renderer(p_photon, device="cuda").integrator_config()
    rbg = key_words("rbg", RendererParam().seed)
    bpx, bpy, bsid = lanes(800, 600, 1)
    captured = {}
    gather_apply = photon.gather_apply

    def capture(gmap_, rec):
        captured["rec"] = rec.clone()
        return gather_apply(gmap_, rec)

    photon.gather_apply = capture
    try:
        megakernel.mega_render(c_arr, c_meta, cfg_photon, bpx, bpy, bsid, rbg,
                               photon_maps=pmaps)
    finally:
        photon.gather_apply = gather_apply
    packed = torch.stack(list(captured.pop("rec")), dim=-1)
    valid = packed[:, 16] > 0.5
    _, order = torch.sort(photon._morton_keys(packed[:, 0:3], valid),
                          stable=True)
    q5 = packed[order, 0:3].contiguous()
    a5 = packed[order, 16].contiguous()
    print(f"  {q5.shape[0]} queries, {int(valid.sum())} with a record "
          f"({valid.double().mean().item():.4f})", flush=True)
    k5_err = 0.0
    for radius in (pmaps[0].radius, 50.0):
        got = photon.photon_gather(pmaps[0].ctable, pmaps[0].cbounds, radius,
                                   q5, a5)
        want = photon.photon_gather_plain(pmaps[0].ctable, pmaps[0].cbounds,
                                          radius, q5, a5)
        torch.cuda.synchronize()
        r_ = float(radius)
        for k, (w_, g_) in enumerate(zip(want[:2], got[:2])):
            bad = ((g_ - w_).abs() > 1e-7 + 1e-5 * w_.abs()).sum().item()
            check(bad == 0, f"K5 r {r_:g}: {('irradiance', 'direction')[k]} "
                  "sums within 1e-5 relative (1e-7 absolute)")
            k5_err = max(k5_err, (g_ - w_).abs().max().item())
        check(torch.equal(want[2], got[2]), f"K5 r {r_:g}: counts exact")
        same = torch.ones_like(valid)
        for w_, g_ in zip(want, got):
            same &= (w_ == g_).reshape(w_.shape[0], -1).all(-1)
        over = (got[2] > 100).double().mean().item()
        print(f"  K5 r {r_:g}: bit-equal lanes {same.double().mean().item()}"
              f", lanes over 100 photons {over:.6f}", flush=True)
        if r_ > 1.0:
            check(over > 0.01, f"K5 r 50: counts over 100 on {over:.4f} of "
                  "lanes")
        del got, want
    numbers["K5"] = {"max_abs_err": k5_err}
    torch.cuda.synchronize()

    # -- 3. the megakernel against the engine --------------------------------
    print("phase 3a: K1a vs the wavefront engine, softdof 200x150 x 2 spp",
          flush=True)
    small = load_scene(SCENE)
    small.camera.img_width, small.camera.img_height = 200, 150
    s_arr, s_meta = compile_scene(small, device="cuda")
    spx, spy, ssid = lanes(200, 150, 2)
    k1a_err = 0.0
    for integ in ("pathtrace", "photonmap"):
        cfg = IntegratorConfig(integrator=integ, max_bounce=4)
        rad_k, t0_k = megakernel.mega_render(s_arr, s_meta, cfg, spx, spy,
                                             ssid, (0, 3))
        rad_p, t0_p = render_batch_wavefront(s_arr, s_meta, cfg, spx, spy,
                                             ssid, (0, 3))
        k1a_err = max(k1a_err, compare_render(rad_p, t0_p, rad_k, t0_k,
                                              f"K1a {integ}"))
    torch.cuda.synchronize()

    print("phase 3b: K1a vs the wavefront engine at the main path's shapes, "
          "softdof 800x600, max_bounce 5", flush=True)
    scene = load_scene(SCENE)
    scene.camera.img_width, scene.camera.img_height = 800, 600
    m_arr, m_meta = compile_scene(scene, device="cuda")
    cfg_pm = Renderer(RendererParam(), device="cuda").integrator_config()
    cfg_pt = IntegratorConfig(integrator="pathtrace", max_bounce=5)
    rbg = key_words("rbg", RendererParam().seed)
    bpx, bpy, bsid = lanes(800, 600, 1)

    def plain_render(cfg, px, py, sid, words):
        """The engine in 65,536-lane batches; (radiance, t0, ms)."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        outs = [render_batch_wavefront(m_arr, m_meta, cfg, px[lo:lo + 65536],
                                       py[lo:lo + 65536], sid[lo:lo + 65536],
                                       words)
                for lo in range(0, px.shape[0], 65536)]
        end.record()
        end.synchronize()
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]), start.elapsed_time(end))

    plain_ms = None
    for what, cfg, (cpx, cpy, csid), words in (
            ("photonmap 960000 lanes rbg", cfg_pm, lanes(800, 600, 2), rbg),
            ("pathtrace 480000 lanes rbg", cfg_pt, (bpx, bpy, bsid), rbg),
            ("photonmap 480000 lanes sample 5 threefry", cfg_pm,
             (bpx, bpy, bsid + 5), (0, 3))):
        rad_k, t0_k = megakernel.mega_render(m_arr, m_meta, cfg, cpx, cpy,
                                             csid, words)
        rad_p, t0_p, ms_p = plain_render(cfg, cpx, cpy, csid, words)
        if cfg is cfg_pt:
            plain_ms = ms_p
        k1a_err = max(k1a_err, compare_render(rad_p, t0_p, rad_k, t0_k,
                                              f"K1a {what}"))
        del rad_k, t0_k, rad_p, t0_p
    numbers["K1a"] = {"max_abs_err": k1a_err}
    torch.cuda.synchronize()

    print("phase 3c: K1c vs the wavefront engine (which runs on K3), "
          "mesh_scene, its ico5 and mirror_scene", flush=True)
    k1c_err = 0.0
    mesh_bars = {"mesh": (2e-3, 5e-3, 2e-3), "ico5": (5e-3, 1e-2, 2e-3),
                 "mirror": (2e-3, 5e-3, 2e-3)}
    for what in ("mesh", "ico5", "mirror"):
        # mirror_scene: a mirror-instanced icosphere and no analytic
        # primitive at all.
        small = load_scene(MIRROR_SCENE if what == "mirror" else MESH_SCENE)
        if what == "ico5":
            small = with_mesh(small, *icosphere(5), name="ico5")
        small.camera.img_width, small.camera.img_height = 200, 150
        k_arr, k_meta = compile_scene(small, device="cuda")
        check(k_meta.mesh_mega, f"{what}: megakernel mesh tables")
        spx, spy, ssid = lanes(200, 150, 2)
        for integ in ("pathtrace", "photonmap"):
            cfg = IntegratorConfig(integrator=integ, max_bounce=3)
            rad_k, t0_k = megakernel.mega_render(k_arr, k_meta, cfg, spx, spy,
                                                 ssid, (0, 5))
            rad_p, t0_p = render_batch_wavefront(k_arr, k_meta, cfg, spx, spy,
                                                 ssid, (0, 5))
            k1c_err = max(k1c_err, compare_mesh_render(
                rad_p, t0_p, rad_k, t0_k, f"K1c {what} 200x150 {integ}",
                mesh_bars[what]))
    mesh_arr = {}
    for what, desc in (("mesh", mesh_base), ("ico5", ico5)):
        k_arr, k_meta = compile_scene(desc, device="cuda")
        mesh_arr[what] = (k_arr, k_meta)
        rad_k, t0_k = megakernel.mega_render(k_arr, k_meta, cfg_pm, bpx, bpy,
                                             bsid, rbg)
        rad_p, t0_p = render_batch_wavefront(k_arr, k_meta, cfg_pm, bpx, bpy,
                                             bsid, rbg)
        k1c_err = max(k1c_err, compare_mesh_render(
            rad_p, t0_p, rad_k, t0_k,
            f"K1c {what} 800x600 photonmap max_bounce 5 rbg", mesh_bars[what]))
        del rad_k, t0_k, rad_p, t0_p
    numbers["K1c"] = {"max_abs_err": k1c_err}
    torch.cuda.synchronize()

    print("phase 3d: K1b vs the wavefront engine with its texture stack, "
          "texture_scene and a two-slot variant", flush=True)
    tex_desc = load_scene(TEXTURE_SCENE)
    two_slot = with_texture(tex_desc, ("ballmtl", "specular"),
                            checker=((1.0, 0.2, 0.1), (0.1, 0.3, 1.0)),
                            scale=0.07, angle=30.0,
                            offset=(0.013, 0.027, 0.0))
    two_slot = with_texture(two_slot, ("floor", "diffuse"),
                            checker=((0.1,) * 3, (0.9,) * 3), scale=0.05,
                            angle=17.0, offset=(0.4, 0.3, 0.0))
    k1b_err = 0.0
    spx, spy, ssid = lanes(200, 150, 2)
    for what, desc in (("texture_scene", tex_desc), ("two-slot", two_slot)):
        desc.camera.img_width, desc.camera.img_height = 200, 150
        k_arr, k_meta = compile_scene(desc, device="cuda")
        check(k_meta.mega_tex_ok and k_arr.kernel.mtl.shape[1] == 102,
              f"{what}: checker columns in the kernel's material table, "
              f"slots {k_meta.mega_tex_slots}")
        for integ in ("pathtrace", "photonmap"):
            cfg = IntegratorConfig(integrator=integ, max_bounce=4)
            before = megakernel.launches["K1b"]
            rad_k, t0_k = megakernel.mega_render(k_arr, k_meta, cfg, spx, spy,
                                                 ssid, (0, 3))
            check(megakernel.launches["K1b"] == before + 1,
                  "the textured kernel was launched")
            rad_p, t0_p = render_batch_wavefront(k_arr, k_meta, cfg, spx, spy,
                                                 ssid, (0, 3))
            k1b_err = max(k1b_err, compare_tex_render(
                rad_p, t0_p, rad_k, t0_k, f"K1b {what} 200x150 {integ}"))
    tex_desc.camera.img_width, tex_desc.camera.img_height = 800, 600
    t_arr, t_meta = compile_scene(tex_desc, device="cuda")
    rad_k, t0_k = megakernel.mega_render(t_arr, t_meta, cfg_pm, bpx, bpy,
                                         bsid, rbg)
    rad_p, t0_p = render_batch_wavefront(t_arr, t_meta, cfg_pm, bpx, bpy,
                                         bsid, rbg)
    k1b_err = max(k1b_err, compare_tex_render(
        rad_p, t0_p, rad_k, t0_k,
        "K1b texture_scene 800x600 photonmap max_bounce 5 rbg"))
    del rad_k, t0_k, rad_p, t0_p
    numbers["K1b"] = {"max_abs_err": k1b_err}
    torch.cuda.synchronize()

    print("phase 3e: K1a+K1d vs the wavefront engine with its exact gathers, "
          "caustics_scene with the default maps", flush=True)

    def plain_photon(arr, meta_, cfg, px, py, sid, words, maps):
        """The engine with exact gathers in 65,536-lane batches:
        ((radiance, t0, irr0), ms)."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        outs = [render_batch_wavefront(arr, meta_, cfg, px[lo:lo + 65536],
                                       py[lo:lo + 65536], sid[lo:lo + 65536],
                                       words, photon_maps=maps,
                                       want_aux=True)
                for lo in range(0, px.shape[0], 65536)]
        end.record()
        end.synchronize()
        return (tuple(torch.cat([o[k] for o in outs]) for k in range(3)),
                start.elapsed_time(end))

    k1d_err = 0.0
    small = with_glass(load_scene(SCENE), "mid")
    small.camera.img_width, small.camera.img_height = 200, 150
    sc_arr, sc_meta = compile_scene(small, device="cuda")
    spx, spy, ssid = lanes(200, 150, 2)
    cfg_small = IntegratorConfig(integrator="photonmap", max_bounce=4,
                                 use_photon_map=True)
    blown = tuple(m._replace(radius=torch.tensor(50.0)) for m in pmaps)
    # The control of compare_photon_render: the global map with an empty
    # caustics map.
    no_caustics = (pmaps[0], cluster_photon_map(
        cmap._replace(valid=torch.zeros_like(cmap.valid))))
    for what, maps in (("200x150 x 2 threefry", pmaps),
                       ("200x150 x 2 threefry, both radii 50", blown)):
        rad_k, t0_k, irr_k, esc = megakernel.mega_render(
            sc_arr, sc_meta, cfg_small, spx, spy, ssid, (0, 3),
            photon_maps=maps)
        ref, _ = plain_photon(sc_arr, sc_meta, cfg_small, spx, spy, ssid,
                              (0, 3), maps)
        if maps is blown:
            share = esc.double().mean().item()
            rel = ((ref[0] - rad_k).abs().amax(-1)
                   / (1.0 + ref[0].abs().amax(-1)))[~esc]
            check(share > 0.3, f"K1d {what}: escalated share {share:.4f} > "
                  "0.3")
            off = int((rel > 1e-3).sum().item())
            check(off == 0, f"K1d {what}: no unflagged lane off ({off})")
        else:
            ctl = megakernel.mega_render(sc_arr, sc_meta, cfg_small, spx,
                                         spy, ssid, (0, 3),
                                         photon_maps=no_caustics)[0]
            k1d_err = max(k1d_err, compare_photon_render(
                ref, (rad_k, t0_k, irr_k), esc, f"K1d {what}", ctl))
    for what, words in (("threefry", (0, 3)), ("rbg", rbg)):
        out = megakernel.mega_render(c_arr, c_meta, cfg_photon, bpx, bpy,
                                     bsid, words, photon_maps=pmaps)
        ctl = megakernel.mega_render(c_arr, c_meta, cfg_photon, bpx, bpy,
                                     bsid, words, photon_maps=no_caustics)[0]
        ref, photon_plain_ms = plain_photon(c_arr, c_meta, cfg_photon, bpx,
                                            bpy, bsid, words, pmaps)
        k1d_err = max(k1d_err, compare_photon_render(
            ref, out[:3], out[3], f"K1d 800x600 photonmap max_bounce 5 "
            f"{what}", ctl))
        del out, ref, ctl
    numbers["K1d"] = {"max_abs_err": k1d_err}
    torch.cuda.synchronize()

    print("phase 3f: K6 vs adjoint_render_plain at 200x150, max_bounce 5, "
          "threefry: spot_scene, mesh_scene, the glass scene", flush=True)
    cfg_g = IntegratorConfig(integrator="pathtrace", max_bounce=5,
                             shadow_spp=16)

    def grad_desc(what, w, h):
        if what == "glass":
            desc = with_glass(load_scene(SCENE), "mid")
            desc.camera.depth_of_field = 0.0
        else:
            desc = load_scene(SPOT_SCENE if what == "spot" else MESH_SCENE)
        desc.camera.img_width, desc.camera.img_height = w, h
        return desc

    gpx, gpy, gsid = lanes(200, 150, 1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    k6_err = 0.0
    for what in ("spot", "mesh", "glass"):
        g_arr, g_meta = compile_scene(grad_desc(what, 200, 150),
                                      device="cuda")
        check(adjoint.adjoint_supported(g_meta, cfg_g),
              f"{what}: the fused adjoint serves it")
        ct = torch.randn((gpx.shape[0], 3), device="cuda", generator=gen)
        got = adjoint.adjoint_render(g_arr, g_meta, cfg_g, gpx, gpy, gsid,
                                     (0, 3), ct)
        want = adjoint.adjoint_render_plain(g_arr, g_meta, cfg_g, gpx, gpy,
                                            gsid, (0, 3), ct)
        errs = grad_field_errors(diff._unpack_adjoint(got, g_meta, g_arr),
                                 diff._unpack_adjoint(want, g_meta, g_arr))
        print(f"  K6 {what}: " + ", ".join(f"{k} {v:.3g}"
                                          for k, v in errs.items()),
              flush=True)
        check(bool(got.isfinite().all()) and max(errs.values()) < K6_BAR,
              f"K6 {what}: every field within {K6_BAR:g} of its max|b| "
              f"(worst {max(errs.values()):.3g})")
        k6_err = max(k6_err, (got - want).abs().max().item())
    numbers["K6"] = {"max_abs_err": k6_err}

    print("phase 3f: render_batch's gradients on the megakernel route vs "
          "render_with_params', spot_scene 200x150", flush=True)
    g_arr, g_meta = compile_scene(grad_desc("spot", 200, 150), device="cuda")
    params = diff.DiffParams(*(t.detach().requires_grad_()
                               for t in diff.extract_params(g_arr)))
    ct = torch.rand((gpx.shape[0], 3), device="cuda", generator=gen)
    before = megakernel.launches["K1a"]
    rad_g, _ = render_batch(diff.splice_params(g_arr, params), g_meta, cfg_g,
                            gpx, gpy, gsid, (0, 3))
    check(megakernel.launches["K1a"] == before + 1
          and rad_g.grad_fn is not None,
          "render_batch launched K1a and its radiance carries a gradient")
    got = diff.DiffParams(*torch.autograd.grad(
        (rad_g * ct).sum(), params, allow_unused=True))
    rad_w = diff.render_with_params(g_arr, g_meta, cfg_g, params, gpx, gpy,
                                    gsid, (0, 3))
    want = diff.DiffParams(*torch.autograd.grad(
        (rad_w * ct).sum(), params, allow_unused=True))
    zero = diff.DiffParams(*(torch.zeros_like(p) for p in params))
    errs = grad_field_errors(
        diff.DiffParams(*(z if g is None else g for z, g in zip(zero, got))),
        diff.DiffParams(*(z if g is None else g for z, g in zip(zero, want))))
    check(max(errs.values()) < 1e-4, "render_batch gradients equal "
          f"render_with_params' (worst field {max(errs.values()):.3g} < "
          "1e-4 of max|b|)")
    del params, rad_g, rad_w
    torch.cuda.synchronize()

    # -- 4. the main path ----------------------------------------------------
    counters = (analytic.launches, megakernel.launches, mesh_sweep.launches,
                tiles.launches, photon.launches, adjoint.launches)
    forbid = ForbidPlain(
        (analytic, "closest_plain"), (analytic, "closest_full_plain"),
        (analytic, "shadow_plain"), (mesh_sweep, "stream_closest"),
        (mesh_sweep, "stream_any_hit"), (tiles, "march_plain"),
        (photon, "photon_gather_plain"))

    def reset_counts():
        for counts in counters:
            for k in counts:
                counts[k] = 0
        engine.wavefront_lanes = 0

    def read_counts():
        out = {}
        for counts in counters:
            out.update(counts)
        out["wavefront_lanes"] = engine.wavefront_lanes
        return out

    def render_main(what, desc, param, no_mega=False, max_mean=10.0):
        """One Renderer.render() on the main path: counts set to 0 just
        before and read just after, plain versions refused. Returns
        (frame buffer, wall seconds, counts, renderer)."""
        reset_counts()
        if no_mega:
            os.environ["QARAY_NO_MEGAKERNEL"] = "1"
        try:
            with forbid:
                r = Renderer(param, device="cuda")
                r.compute_scene(desc)
                torch.cuda.synchronize()
                t = time.time()
                fb = r.render()
                torch.cuda.synchronize()
                wall = time.time() - t
        finally:
            os.environ.pop("QARAY_NO_MEGAKERNEL", None)
        counts = read_counts()
        rays = int(fb.count.sum())
        print(f"  {what}: Renderer wall {wall:.4f} s, {rays} primary rays, "
              f"{rays / wall:.4e} primary rays/s, spp per pixel "
              f"{fb.count.min()}..{fb.count.max()} "
              f"(mean {fb.count.mean():.3f})", flush=True)
        print(f"  launch counts: {json.dumps(counts)}", flush=True)
        check(fb.img.shape == (800 * 600, 3), "colour buffer is 800x600x3")
        check(bool(np.isfinite(fb.mean).all()), "radiance finite")
        check(0.0 < float(fb.mean.mean()) < max_mean,
              f"mean radiance {float(fb.mean.mean()):.4f} plausible")
        check(param.spp_min <= fb.count.min()
              and fb.count.max() <= param.spp_max,
              f"spp within {param.spp_min}..{param.spp_max}")
        return fb, wall, counts, r

    escalated = [0]
    render_escalated = Renderer._render_escalated

    def count_escalated(self, ids, sids, esc):
        fixed = render_escalated(self, ids, sids, esc)
        escalated[0] += 0 if fixed is None else fixed[0].size
        return fixed

    Renderer._render_escalated = count_escalated

    print("phase 4a: Renderer, softdof 800x600, defaults", flush=True)
    fb, wall, _, renderer = render_main("softdof", scene, RendererParam())
    with tempfile.TemporaryDirectory() as out_dir:
        prefix = os.path.join(out_dir, "smoke_")
        fb.save_image(prefix + "colorBuffer.png")
        fb.save_z_image(prefix + "depthBuffer.png")
        fb.save_sample_count_image(prefix + "sampleBuffer.png")
        sizes = [os.path.getsize(prefix + f) for f in (
            "colorBuffer.png", "depthBuffer.png", "sampleBuffer.png")]
    check(min(sizes) > 100, f"PNGs written ({sizes} bytes)")
    s_arr, s_meta = renderer.scene_arrays, renderer.meta
    torch.cuda.synchronize()
    with forbid:
        t = time.time()
        rad_b, t0_b = render_batch(s_arr, s_meta, cfg_pt, bpx, bpy, bsid,
                                   rbg)
        torch.cuda.synchronize()
        wall_b = time.time() - t
    check(rad_b.shape == (480000, 3) and bool(rad_b.isfinite().all()),
          "render_batch radiance [480000, 3] finite")
    print(f"  render_batch pathtrace 480000 lanes: wall {wall_b:.4f} s, "
          f"{480000 / wall_b:.4e} primary rays/s", flush=True)
    counts_a = read_counts()
    print(f"  launch counts: {json.dumps(counts_a)}", flush=True)
    check(counts_a["K1a"] > 0, f"K1a launched {counts_a['K1a']} times")
    check(counts_a["wavefront_lanes"] == 0, "no lane on the wavefront engine")

    print("phase 4b: wavefront route (QARAY_NO_MEGAKERNEL), 800x600 x 1 spp",
          flush=True)
    fb_wf, _, counts_b, _ = render_main(
        "softdof wavefront", scene,
        RendererParam(spp_min=1, spp_max=1, batch_pixels=1 << 16),
        no_mega=True)
    check(counts_b["K2b"] > 0 and counts_b["K2c"] > 0,
          "K2b and K2c launched on the wavefront route")
    check(counts_b["K1a"] == 0, "no K1a launch on the wavefront route")

    print("phase 4c: Renderer, mesh_scene 800x600 (320 triangles), defaults",
          flush=True)
    _, _, counts_c, _ = render_main("mesh_scene", mesh_base, RendererParam())
    check(counts_c["K1c"] > 0 and counts_c["K1c"] == counts_c["K1a"],
          f"K1a launched {counts_c['K1a']} times, all with the mesh sweep")
    check(counts_c["wavefront_lanes"] == 0, "no lane on the wavefront engine")

    print("phase 4d: Renderer, mesh_scene with ico5 (20,480 triangles) "
          "800x600, defaults", flush=True)
    _, _, counts_d, _ = render_main("ico5", ico5, RendererParam())
    check(counts_d["K1c"] > 0 and counts_d["K1c"] == counts_d["K1a"],
          f"K1a launched {counts_d['K1a']} times, all with the mesh sweep")
    check(counts_d["wavefront_lanes"] == 0, "no lane on the wavefront engine")

    print("phase 4e: Renderer, mesh_scene with ico6 (81,920 triangles) "
          "800x600 x 1 spp: the wavefront route", flush=True)
    _, _, counts_e, _ = render_main("ico6", ico6,
                                    RendererParam(spp_min=1, spp_max=1))
    check(counts_e["K4a"] > 0 and counts_e["K4b"] > 0,
          f"K4a launched {counts_e['K4a']} times, K4b {counts_e['K4b']}")
    check(counts_e["K1a"] == 0 and counts_e["K3"] == 0,
          "no K1a or K3 launch above 65,536 triangles")

    print("phase 4f: Renderer, mesh_scene 800x600 x 1 spp under "
          "QARAY_NO_MEGAKERNEL: the dense sweep", flush=True)
    _, _, counts_f, _ = render_main("mesh_scene wavefront", mesh_base,
                                    RendererParam(spp_min=1, spp_max=1),
                                    no_mega=True)
    check(counts_f["K3"] > 0, f"K3 launched {counts_f['K3']} times")
    check(counts_f["K1a"] == 0 and counts_f["K4a"] == 0,
          "no K1a or K4a launch on the dense route")

    print("phase 4g: Renderer, texture_scene 800x600, defaults: the "
          "megakernel with checker textures", flush=True)
    _, _, counts_g, _ = render_main("texture_scene", tex_desc,
                                    RendererParam())
    check(counts_g["K1b"] > 0 and counts_g["K1b"] == counts_g["K1a"],
          f"K1a launched {counts_g['K1a']} times, all with K1b's textures")
    check(counts_g["wavefront_lanes"] == 0, "no lane on the wavefront engine")

    # One 480,000-lane batch a bounce (the Renderer's default batch size):
    # these scenes' hard lights need none of softdof's 64 shadow samples a
    # lane, which is what phase 4b's smaller batches make room for.
    wave_1spp = RendererParam(spp_min=1, spp_max=1)
    print("phase 4h: texture_scene 800x600 x 1 spp under "
          "QARAY_NO_MEGAKERNEL: the wavefront route with the texture stack",
          flush=True)
    _, _, counts_h, _ = render_main("texture_scene wavefront", tex_desc,
                                    wave_1spp, no_mega=True)
    check(counts_h["K2b"] > 0 and counts_h["K2c"] > 0,
          f"K2b launched {counts_h['K2b']} times, K2c {counts_h['K2c']}")
    check(counts_h["K1a"] == 0 and counts_h["K1b"] == 0,
          "no megakernel launch on the wavefront route")

    print("phase 4i: spot_scene with a file texture on a material, the "
          "background and the environment, 800x600 x 1 spp", flush=True)
    image = load_image(IMAGE)
    file_desc = load_scene(SPOT_SCENE)
    file_desc = with_texture(file_desc,
                             (file_desc.materials[0].name, "diffuse"),
                             image=image, color=(1.0, 1.0, 1.0), scale=0.5)
    file_desc = with_texture(file_desc, "background", image=image,
                             color=(1.0, 0.9, 0.8))
    file_desc = with_texture(file_desc, "environment", image=image,
                             color=(0.8, 0.9, 1.0), scale=0.5, angle=25.0)
    file_desc.camera.img_width, file_desc.camera.img_height = 800, 600
    _, _, counts_i, r_file = render_main("file textures", file_desc,
                                         wave_1spp)
    fm = r_file.meta
    check(fm.has_mtl_textures and fm.has_bg_texture and fm.has_env_texture
          and not fm.mega_tex_ok, "file textures on a material, the "
          "background and the environment")
    check(counts_i["K2b"] > 0 and counts_i["K1a"] == 0,
          f"K2b launched {counts_i['K2b']} times, no megakernel launch")
    file_desc.camera.img_width, file_desc.camera.img_height = 200, 150
    cfg_f = IntegratorConfig(integrator="photonmap", max_bounce=3)
    outs = []
    for dev in ("cuda", "cpu"):
        f_arr, f_meta = compile_scene(file_desc, device=dev)
        fpx, fpy, fsid = lanes(200, 150, 1, device=dev)
        rad_f, t0_f = render_batch_wavefront(f_arr, f_meta, cfg_f, fpx, fpy,
                                             fsid, (0, 3))
        outs.append((rad_f.cpu(), t0_f.cpu()))
    compare_render(*outs[1], *outs[0], "file textures 200x150, card vs CPU")
    miss = outs[0][1] > 1e29
    check(bool(miss.any()) and outs[0][0][miss].std().item() > 0.02,
          "the background shows the image")

    print("phase 4j: basic, phong and mcgi on spot_scene 800x600 x 1 spp: "
          "the wavefront route", flush=True)
    spot_desc = load_scene(SPOT_SCENE)
    spot_desc.camera.img_width, spot_desc.camera.img_height = 800, 600
    counts_j = []
    for integ in ("basic", "phong", "mcgi"):
        # Without falloff (basic, phong) the spot's intensity of 400
        # arrives undimmed: a bright image, as in the reference.
        _, _, c_j, _ = render_main(
            integ, spot_desc, RendererParam(
                integrator=integ, spp_min=1, spp_max=1),
            max_mean=10.0 if integ == "mcgi" else 1e4)
        check(c_j["K2b"] > 0 and c_j["K2c"] > 0 and c_j["K1a"] == 0,
              f"{integ}: K2b launched {c_j['K2b']} times, K2c {c_j['K2c']}, "
              "no megakernel launch")
        counts_j.append(c_j)

    print("phase 4k: Renderer, caustics_scene 800x600, -use-photon-map "
          "defaults", flush=True)
    with tempfile.TemporaryDirectory() as wd, contextlib.chdir(wd):
        escalated[0] = 0
        fb_k, wall_k, counts_k, r_k = render_main(
            "caustics_scene photon map", caus_desc, p_photon)
        files = {n_: os.path.getsize(os.path.join(wd, n_))
                 for n_ in ("photonmap.dat", "caustics.dat")}
        fb_k.save_irradiance_image(os.path.join(wd, "irr.png"))
    rays_k = int(fb_k.count.sum())
    gk, ck = r_k.photon_maps
    print(f"  maps: {int(gk.valid.sum())} global and {int(ck.valid.sum())} "
          f"caustics photons; files {json.dumps(files)}; escalated lanes "
          f"{escalated[0]} of {rays_k} ({escalated[0] / rays_k:.6g}); "
          f"irradiance plane {(fb_k.irrad > 0).mean():.4f} of pixels",
          flush=True)
    check(files == {"photonmap.dat": 26 * int(gk.valid.sum()),
                    "caustics.dat": 26 * int(ck.valid.sum())},
          "photonmap.dat and caustics.dat written in the working directory")
    check(counts_k["K1d"] > 0 and counts_k["K1d"] == counts_k["K1a"]
          and counts_k["K5"] == counts_k["K1d"],
          f"K1a launched {counts_k['K1a']} times, all with K1d, and K5 "
          f"{counts_k['K5']} times")
    check(counts_k["wavefront_lanes"] == escalated[0],
          "only the escalated lanes on the wavefront engine")
    check(0.0 < (fb_k.irrad > 0).mean() < 1.0, "irradiance plane filled")

    print("phase 4l: caustics_scene 800x600 x 1 spp, -use-photon-map, under "
          "QARAY_NO_MEGAKERNEL: the exact gathers on the wavefront route",
          flush=True)
    with tempfile.TemporaryDirectory() as wd, contextlib.chdir(wd):
        _, wall_l, counts_l, _ = render_main(
            "caustics_scene photon map wavefront", caus_desc,
            RendererParam(use_photon_map=True, spp_min=1, spp_max=1,
                          batch_pixels=1 << 16), no_mega=True)
    check(counts_l["K2b"] > 0 and counts_l["K1a"] == 0
          and counts_l["K5"] == 0,
          f"K2b launched {counts_l['K2b']} times, no K1a or K5 launch")
    Renderer._render_escalated = render_escalated

    print("phase 4m: the gradient path, render_value_and_grad at 800x600, "
          "max_bounce 5, shadow_spp 16, rbg", flush=True)
    cfg_gp = IntegratorConfig(integrator="pathtrace", max_bounce=5,
                              shadow_spp=16)
    forbid_grad = ForbidPlain(*forbid.targets,
                              (adjoint, "adjoint_render_plain"))
    grad_cells = {}

    grad_steps = {}

    def grad_path(what, batch, no_mega, rounds):
        """bench.py's _grad_bench: `rounds` steps of render_value_and_grad
        on `batch` lanes, one sample index a step, after a warm-up step;
        counts set to 0 just before and read just after, plain versions
        refused. Keeps the step for phase 5's idle share. Returns (counts,
        (loss, grads) of the step at sample index 1, the first timed one,
        the scene and its lanes)."""
        g_arr, g_meta = compile_scene(grad_desc(what, 800, 600),
                                      device="cuda")
        ids = torch.arange(batch, device="cuda", dtype=torch.int32)
        gx, gy = ids % 800, (ids // 800) % 600

        def step(s):
            return diff.render_value_and_grad(
                g_arr, g_meta, cfg_gp, gx, gy, torch.full_like(ids, s), rbg)

        reset_counts()
        if no_mega:
            os.environ["QARAY_NO_MEGAKERNEL"] = "1"
        try:
            with forbid_grad:
                step(0)
                torch.cuda.synchronize()
                t = time.time()
                outs = [step(s) for s in range(1, rounds + 1)]
                torch.cuda.synchronize()
                wall = time.time() - t
                counts = read_counts()
        finally:
            os.environ.pop("QARAY_NO_MEGAKERNEL", None)
        route = "autograd" if no_mega else "fast"
        rate = rounds * batch / wall
        loss, grads = outs[0]
        print(f"  {what} {route} route, {batch} lanes: {rounds} steps in "
              f"{wall:.4f} s, {rate:.4e} forward+backward paths/s",
              flush=True)
        print(f"  launch counts: {json.dumps(counts)}", flush=True)
        check(bool(torch.isfinite(loss)) and all(
            bool(g.isfinite().all()) for g in grads),
            f"{what} {route}: loss {float(loss):.6g} and gradients finite")
        grad_cells[(what, route)] = dict(paths_per_s=rate, wall_s=wall)
        grad_steps[(what, route)] = (lambda: step(rounds + 1), no_mega)
        del outs
        return counts, (loss, grads), (g_arr, g_meta, gx, gy)

    counts_m = []
    g_path = {}
    for what, batch in (("spot", 1 << 18), ("mesh", 1 << 17)):
        c_fast, out_fast, g_path[what] = grad_path(what, batch, False, 5)
        check(c_fast["K1a"] > 0 and c_fast["K6"] == c_fast["K1a"]
              and c_fast["wavefront_lanes"] == 0,
              f"{what} fast route: K1a and K6 launched {c_fast['K6']} times "
              "each, no lane on the wavefront engine")
        if what == "mesh":
            check(c_fast["K1c"] == c_fast["K1a"], "every K1a launch swept "
                  "the mesh (K1c)")
        c_auto, out_auto, _ = grad_path(what, batch, True, 2)
        check(c_auto["K6"] == 0 and c_auto["K1a"] == 0
              and c_auto["K2b"] > 0 and c_auto["K2c"] > 0
              and (what != "mesh" or c_auto["K3"] > 0),
              f"{what} autograd route: K2b {c_auto['K2b']}, K2c "
              f"{c_auto['K2c']}, K3 {c_auto['K3']} launches, no K1a or K6")
        counts_m += [c_fast, c_auto]
        errs = grad_field_errors(out_fast[1], out_auto[1])
        errs.pop("texture_texels", None)
        print(f"  {what} fast vs autograd route: " + ", ".join(
            f"{k} {v:.3g}" for k, v in errs.items()), flush=True)
        check(max(errs.values()) < K6_BAR, f"{what}: the routes' gradients "
              f"within {K6_BAR:g} of each field's max|b|")
        del out_fast, out_auto
    torch.cuda.synchronize()

    launches = {k: sum(c[k] for c in (counts_a, counts_b, counts_c, counts_d,
                                       counts_e, counts_f, counts_g, counts_h,
                                       counts_i, *counts_j, counts_k,
                                       counts_l, *counts_m))
                for k in ("K1a", "K1b", "K1c", "K1d", "K2a", "K2b", "K2c",
                          "K3", "K4a", "K4b", "K5", "K6")}
    print(f"  launches on the main path (4a-4m): {json.dumps(launches)}",
          flush=True)

    # -- 5. timings at the path's shapes -------------------------------------
    print("phase 5: kernel times at the path's shapes", flush=True)
    ms, src = kernel_ms(lambda: megakernel.mega_render(
        s_arr, s_meta, cfg_pt, bpx, bpy, bsid, rbg), "mega_kernel", 5)

    def mega_work(arr, meta_, cfg=cfg_pt, maps=None):
        """Per-lane work counters of one K1a launch, summed: (primitive
        tests, threefry ciphers, shaded vertices, triangle tests, checker
        tests), with maps also (photon tests, caustics cluster tests)."""
        work = torch.zeros((480000, 7), dtype=torch.int32, device="cuda")
        megakernel.mega_render(arr, meta_, cfg, bpx, bpy, bsid, rbg,
                               work=work, photon_maps=maps)
        return work.sum(0, dtype=torch.int64).tolist()[:5 if maps is None
                                                       else 7]

    def mega_ops(wsum):
        return (wsum[0] * OPS_PER_TEST + wsum[1] * OPS_PER_CIPHER
                + wsum[3] * OPS_PER_TRI + wsum[4] * OPS_PER_CHECKER)

    wsum = mega_work(s_arr, s_meta)
    b_ms, b_by = bound(480000 * (12 + 16), mega_ops(wsum))
    numbers["K1a"].update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=b_by, library_ms=None, timed_by=src,
                          lanes=480000, prim_tests=wsum[0], ciphers=wsum[1],
                          vertices=wsum[2])

    # K1c: the same launch on mesh_scene (320 triangles) and its ico5
    # (20,480); its plain version is the wavefront engine on the same lanes.
    for what in ("mesh", "ico5"):
        k_arr, k_meta = mesh_arr[what]
        ms, src = kernel_ms(lambda: megakernel.mega_render(
            k_arr, k_meta, cfg_pt, bpx, bpy, bsid, rbg), "mega_kernel", 5)
        wsum = mega_work(k_arr, k_meta)
        tab = k_arr.kernel
        nbytes = (480000 * (12 + 16) + 4 * (tab.mesh_rows.numel()
                                            + tab.mesh_attr.numel()
                                            + tab.mesh_cb.numel()))
        b_ms, b_by = bound(nbytes, mega_ops(wsum))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for lo in range(0, 480000, 65536):
            render_batch_wavefront(k_arr, k_meta, cfg_pt, bpx[lo:lo + 65536],
                                   bpy[lo:lo + 65536], bsid[lo:lo + 65536],
                                   rbg)
        end.record()
        end.synchronize()
        row = dict(ms=ms, plain_ms=start.elapsed_time(end), bound_ms=b_ms,
                   bound_by=b_by, timed_by=src, prim_tests=wsum[0],
                   ciphers=wsum[1], vertices=wsum[2], tri_tests=wsum[3])
        if what == "mesh":
            numbers["K1c"].update(library_ms=None, lanes=480000,
                                  triangles=k_meta.num_tris, **row)
        else:
            numbers["K1c"].update({f"ico5_{k}": v for k, v in row.items()})
        print(f"  K1c {what} ({k_meta.num_tris} triangles), pathtrace 480000 "
              f"lanes: {ms:.4f} ms by {src}, bound {b_ms:.5f} ms by {b_by}, "
              f"engine {row['plain_ms']:.3f} ms, {wsum[3]} triangle tests",
              flush=True)

    # K1b: the textured launch on texture_scene, beside K1a's time on
    # softdof above; its plain version is the wavefront engine with the
    # texture stack on the same lanes.
    ms, src = kernel_ms(lambda: megakernel.mega_render(
        t_arr, t_meta, cfg_pt, bpx, bpy, bsid, rbg), "mega_kernel", 5)
    wsum = mega_work(t_arr, t_meta)
    b_ms, b_by = bound(480000 * (12 + 16), mega_ops(wsum))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for lo in range(0, 480000, 65536):
        render_batch_wavefront(t_arr, t_meta, cfg_pt, bpx[lo:lo + 65536],
                               bpy[lo:lo + 65536], bsid[lo:lo + 65536], rbg)
    end.record()
    end.synchronize()
    numbers["K1b"].update(ms=ms, plain_ms=start.elapsed_time(end),
                          bound_ms=b_ms, bound_by=b_by, library_ms=None,
                          timed_by=src, lanes=480000, prim_tests=wsum[0],
                          ciphers=wsum[1], vertices=wsum[2],
                          checker_tests=wsum[4])
    print(f"  K1a+K1b texture_scene, pathtrace 480000 lanes: {ms:.4f} ms by "
          f"{src} (K1a on softdof {numbers['K1a']['ms']:.4f} ms), bound "
          f"{b_ms:.5f} ms by {b_by}, engine {numbers['K1b']['plain_ms']:.3f} "
          f"ms, {wsum[4]} checker tests on {wsum[2]} vertices", flush=True)

    # K1d: the gathering launch on caustics_scene with the default maps
    # (photonmap, max_bounce 5, rbg), beside K1a's time on softdof above;
    # its plain version is the wavefront engine with the exact gathers.
    ms, src = kernel_ms(lambda: megakernel.mega_render(
        c_arr, c_meta, cfg_photon, bpx, bpy, bsid, rbg, photon_maps=pmaps),
        "mega_kernel", 5)
    wsum = mega_work(c_arr, c_meta, cfg_photon, pmaps)
    ctab = pmaps[1]
    b_ms, b_by = bound(
        480000 * (12 + 4 * 4 + 4 * 19)
        + 4 * (ctab.ctable.numel() + ctab.cbounds.numel()),
        mega_ops(wsum) + wsum[5] * OPS_PER_PHOTON + wsum[6] * OPS_PER_PCLUSTER)
    numbers["K1d"].update(ms=ms, plain_ms=photon_plain_ms, bound_ms=b_ms,
                          bound_by=b_by, library_ms=None, timed_by=src,
                          lanes=480000, prim_tests=wsum[0], ciphers=wsum[1],
                          vertices=wsum[2], photon_tests=wsum[5],
                          cluster_tests=wsum[6])
    print(f"  K1a+K1d caustics_scene, photonmap 480000 lanes: {ms:.4f} ms by "
          f"{src} (K1a on softdof {numbers['K1a']['ms']:.4f} ms), bound "
          f"{b_ms:.5f} ms by {b_by}, engine {photon_plain_ms:.3f} ms, "
          f"{wsum[5]} photon tests, {wsum[6]} cluster tests on {wsum[2]} "
          "vertices", flush=True)

    # K5 on the records of phase 2c's dispatch. The bound counts, for each
    # query with a record, the rows of the clusters within r of that query
    # alone (what a per-query cull must sweep). Its bytes: each query's
    # active flag in and 28 bytes out, the 12-byte position of each query
    # with a record, the cluster boxes once, and the 9 columns the sweep
    # reads of the rows of the clusters within r of some such query.
    g5 = pmaps[0]
    r5 = float(g5.radius)
    qa = q5[a5 > 0.5]
    cb = g5.cbounds
    near = ((cb[None, :, 0] <= cb[None, :, 3])
            & (cb[None, :, 0:3] - r5 <= qa[:, None, :]).all(-1)
            & (cb[None, :, 3:6] + r5 >= qa[:, None, :]).all(-1))
    tests5 = int(near.sum().item()) * 128
    near5 = int(near.any(0).sum().item())
    b_ms, b_by = bound(q5.shape[0] * (4 + 28) + qa.shape[0] * 12
                       + 4 * cb.numel() + near5 * 128 * 9 * 4,
                       tests5 * OPS_PER_PHOTON)
    ms, src = kernel_ms(lambda: photon.photon_gather(
        g5.ctable, g5.cbounds, g5.radius, q5, a5), "gather_kernel", 20)
    numbers["K5"].update(
        ms=ms, plain_ms=cuda_ms(lambda: photon.photon_gather_plain(
            g5.ctable, g5.cbounds, g5.radius, q5, a5), 1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, timed_by=src,
        wrapper_ms=cuda_ms(lambda: photon.photon_gather(
            g5.ctable, g5.cbounds, g5.radius, q5, a5), 20),
        queries=q5.shape[0], active=int(qa.shape[0]), photon_tests=tests5,
        clusters_near=near5, photons=int(gmap.valid.sum()))
    print(f"  K5 {q5.shape[0]} queries ({qa.shape[0]} with a record): "
          f"{ms:.5f} ms by {src}, bound {b_ms:.6f} ms by {b_by}, plain "
          f"{numbers['K5']['plain_ms']:.3f} ms, {tests5} photon tests",
          flush=True)

    n2 = 1 << 16  # one wavefront batch of primary rays
    n_sh = 1 << 20  # its first 16 soft-shadow rays per lane
    pk = p[:n2].contiguous()
    dk = d[:n2].contiguous()
    num_p = meta.num_analytic
    for name, kname, fn, plain, n, nbytes in (
        ("K2a", "closest_kernel", lambda: analytic.closest(pk, dk, prims),
         lambda: analytic.closest_plain(pk, dk, prims), n2, n2 * (24 + 8)),
        ("K2b", "closest_full_kernel",
         lambda: analytic.closest_full(pk, dk, prims),
         lambda: analytic.closest_full_plain(pk, dk, prims), n2,
         n2 * (24 + 49)),
        ("K2c", "shadow_kernel", lambda: analytic.shadow(p, d, t_max, prims),
         lambda: analytic.shadow_plain(p, d, t_max, prims), n_sh,
         n_sh * (28 + 1)),
    ):
        if name == "K2c":
            t_all = I.intersect_analytic_t(p, d, prims)
            hit = t_all < t_max[:, None]
            first = torch.where(hit.any(-1), hit.float().argmax(-1) + 1,
                                num_p)
            tests = int(first.sum().item())
        else:
            tests = n * num_p
        b_ms, b_by = bound(nbytes, tests * OPS_PER_TEST)
        k_ms, src = kernel_ms(fn, kname, 20)
        numbers[name].update(ms=k_ms, plain_ms=cuda_ms(plain, 5),
                             bound_ms=b_ms, bound_by=b_by, library_ms=None,
                             timed_by=src, wrapper_ms=cuda_ms(fn, 20),
                             rays=n, prim_tests=tests)
    torch.cuda.synchronize()

    # K3 on ico5 and K4a/K4b on ico6 at the 480,000 camera rays of
    # mesh_scene at 800x600 (and, for K4b, their shadow rays). The tiled
    # route sorts rays by coherence_order before each march, so the kernels
    # are timed on sorted rays; the two-phase K4a is also timed whole.
    n_cam = cp.shape[0]
    t_big = torch.full((n_cam,), BIG, device="cuda")
    fp5 = c16.shape[0]
    tests = n_cam * fp5
    b_ms, b_by = bound(n_cam * (24 + 4 + 12) + fp5 * 64, tests * OPS_PER_TRI)
    k_ms, src = kernel_ms(
        lambda: mesh_sweep.sweep_closest(cp, cd, t_big, c16), "sweep_kernel",
        10)
    numbers["K3"] = dict(
        max_abs_err=mesh_err["K3"], ms=k_ms,
        plain_ms=cuda_ms(lambda: stream_closest(cp, cd, t_big, plain5), 1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, timed_by=src,
        wrapper_ms=cuda_ms(
            lambda: mesh_sweep.sweep_closest(cp, cd, t_big, c16), 10),
        rays=n_cam, triangles=m5.num_tris, tri_tests=tests)

    lo6 = m6t.tile_cbounds[:, :3].amin(0)
    hi6 = m6t.tile_cbounds[:, 3:6].amax(0)
    packet = tiles.PACKET_ROWS * tiles.LANES
    fp6 = m6t.tile_c16T.shape[0] * 8
    n_cl = m6t.tile_cbounds.shape[0]
    for name, (p_, d_, t_) in (("K4a", (cp, cd, t_big)), ("K4b", shadow6)):
        any_hit = name == "K4b"
        perm = tiles.coherence_order(p_, d_, lo6, hi6)
        ps, ds, ts = (x[perm].contiguous() for x in (p_, d_, t_))
        n = ps.shape[0]
        g = (n + packet - 1) // packet
        # The bound counts the triangle tests each ray needed (its own
        # reach against each visited cluster's entry bound), not every lane
        # of every visited cluster.
        steps = torch.zeros(g, dtype=torch.int32, device="cuda")
        work = torch.zeros(n, dtype=torch.int32, device="cuda")
        out = tiles.tiled_sweep_kernel(ps, ds, ts, tm6, m6t.tile_c16T,
                                       any_hit=any_hit, steps=steps,
                                       work=work)
        per_packet = torch.clamp(
            n - packet * torch.arange(g, device="cuda"), max=packet)
        upper = int((steps.long() * per_packet).sum().item()) * 256
        tests = int(work.sum(dtype=torch.int64).item())
        check(bool((work % 256 == 0).all()) and tests <= upper,
              f"{name} per-ray tests {tests} within the packets' {upper}")
        if any_hit:
            check(bool((work[ts <= BIAS] == 0).all()),
                  "K4b: no test counted for a ray without budget")
        else:
            check(bool((work[out[1] >= 0] > 0).all()),
                  "K4a: every ray with a hit needed a test")
        nbytes = n * (24 + 4 + 4 + 13) + fp6 * 64 + g * n_cl * 8
        b_ms, b_by = bound(nbytes, tests * OPS_PER_TRI)
        kname = "march_kernel<true>" if any_hit else "march_kernel<false>"
        k_ms, src = kernel_ms(lambda: tiles.tiled_sweep_kernel(
            ps, ds, ts, tm6, m6t.tile_c16T, any_hit=any_hit), kname, 10)
        numbers[name] = dict(
            max_abs_err=mesh_err[name], ms=k_ms,
            plain_ms=cuda_ms(lambda: tiled_sweep(ps, ds, ts, tm6,
                                                 any_hit=any_hit), 1),
            bound_ms=b_ms, bound_by=b_by, library_ms=None, timed_by=src,
            wrapper_ms=cuda_ms(lambda: tiles.tiled_sweep_kernel(
                ps, ds, ts, tm6, m6t.tile_c16T, any_hit=any_hit), 10),
            rays=n, triangles=m6.num_tris, packets=g,
            clusters_visited=int(steps.sum().item()),
            max_packet_clusters=int(steps.max().item()), tri_tests=tests,
            packet_tri_tests=upper)
    numbers["K4a"]["twophase_wrapper_ms"] = cuda_ms(
        lambda: tiles.tiled_closest_twophase(cp, cd, t_big, tm6,
                                             m6t.tile_c16T), 10)
    torch.cuda.synchronize()

    # K6 at the gradient path's shapes of 4m (spot_scene 262,144 lanes;
    # mesh_scene 131,072), on the mean loss's cotangent. The bound counts
    # the replay's primitive tests, ciphers and triangle tests, and as
    # bytes the lanes' ids and cotangents in and the gradient out (the
    # hooks are the kernel's own scratch).
    for what in ("spot", "mesh"):
        g_arr, g_meta, gx, gy = g_path[what]
        n_l = gx.shape[0]
        gs = torch.zeros_like(gx)
        ct = torch.full((n_l, 3), 1.0 / (3 * n_l), device="cuda")
        ms, src = kernel_ms(lambda: adjoint.adjoint_render(
            g_arr, g_meta, cfg_gp, gx, gy, gs, rbg, ct), "adjoint_kernel", 5)
        work = torch.zeros((n_l, 4), dtype=torch.int32, device="cuda")
        adjoint.adjoint_render(g_arr, g_meta, cfg_gp, gx, gy, gs, rbg, ct,
                               work=work)
        wsum = work.sum(0, dtype=torch.int64).tolist()
        n_par = adjoint.param_layout(g_meta.num_materials,
                                     g_meta.num_lights)
        nbytes = n_l * (12 + 12) + 4 * n_par
        if g_meta.mesh_mega:
            tab = g_arr.kernel
            nbytes += 4 * (tab.mesh_rows.numel() + tab.mesh_attr.numel()
                           + tab.mesh_cb.numel())
        b_ms, b_by = bound(nbytes, wsum[0] * OPS_PER_TEST
                           + wsum[1] * OPS_PER_CIPHER + wsum[3] * OPS_PER_TRI)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        adjoint.adjoint_render_plain(g_arr, g_meta, cfg_gp, gx, gy, gs, rbg,
                                     ct)
        end.record()
        end.synchronize()
        row = dict(ms=ms, plain_ms=start.elapsed_time(end), bound_ms=b_ms,
                   bound_by=b_by, timed_by=src, lanes=n_l,
                   prim_tests=wsum[0], ciphers=wsum[1], vertices=wsum[2],
                   tri_tests=wsum[3])
        if what == "spot":
            numbers["K6"].update(library_ms=None, **row)
        else:
            numbers["K6"].update({f"mesh_{k}": v for k, v in row.items()})
        print(f"  K6 {what}, pathtrace {n_l} lanes: {ms:.4f} ms by {src}, "
              f"bound {b_ms:.5f} ms by {b_by}, plain {row['plain_ms']:.3f} "
              f"ms, {wsum[2]} vertices, {wsum[1]} ciphers", flush=True)
    # The device's idle share over three more steps of each route of 4m,
    # with the count of K1a and K6 records the profiler kept (it may drop
    # the last ones it traced; busy time is then read low).
    for (what, route), (one_step, no_mega) in grad_steps.items():
        if no_mega:
            os.environ["QARAY_NO_MEGAKERNEL"] = "1"
        try:
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t = time.time()
                for _ in range(3):
                    one_step()
                torch.cuda.synchronize()
                wall_p = (time.time() - t) * 1e3
        finally:
            os.environ.pop("QARAY_NO_MEGAKERNEL", None)
        events = prof.key_averages()
        busy = sum(device_us(e) for e in events) / 1e3
        kept = {k: sum(e.count for e in events if n in e.key)
                for k, n in (("K1a", "mega_kernel"),
                             ("K6", "adjoint_kernel"))}
        grad_cells[(what, route)].update(idle_share=1.0 - busy / wall_p)
        print(f"  {what} {route} route, three steps under the profiler: "
              f"wall {wall_p:.3f} ms, device busy {busy:.3f} ms, idle share "
              f"{1.0 - busy / wall_p:.4f}, records kept {json.dumps(kept)}",
              flush=True)
    numbers["K6"]["grad_path"] = {f"{w} {r}": v
                                  for (w, r), v in grad_cells.items()}
    numbers["K6"].update(ptxas_info("adjoint", "adjoint_kernel"))
    numbers["K1a"].update(ptxas_info("megakernel", "mega_kernelILb0ELb0E"))
    print(f"  K6 ptxas: {ptxas_info('adjoint', 'adjoint_kernel')}; K1a "
          f"ptxas: {ptxas_info('megakernel', 'mega_kernelILb0ELb0E')}",
          flush=True)
    torch.cuda.synchronize()

    # Device busy share of one Renderer.render() at the 4a, 4c, 4g, 4e and
    # 4k settings (4k on phase 4k's renderer, whose maps are built).
    def profile_render(what, desc, param, r=None):
        if r is None:
            r = Renderer(param, device="cuda")
            r.compute_scene(desc)
        else:
            r.fb = FrameBuffer(r.meta.img_width, r.meta.img_height)
        torch.cuda.synchronize()
        reset_counts()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t = time.time()
            r.render()
            torch.cuda.synchronize()
            wall_p = (time.time() - t) * 1e3
        busy = {}
        for evt in prof.key_averages():
            dt = device_us(evt)
            if dt > 0:
                busy[evt.key] = dt / 1e3
        total_busy = sum(busy.values())
        top = sorted(busy.items(), key=lambda kv: -kv[1])[:5]
        print(f"  {what} Renderer under the profiler: wall {wall_p:.3f} ms, "
              f"device busy {total_busy:.3f} ms, idle share "
              f"{1.0 - total_busy / wall_p:.4f}, launches "
              f"{json.dumps(read_counts())}", flush=True)
        for key, val in top:
            print(f"    {val:.3f} ms  {key[:90]}")

    profile_render("softdof defaults", scene, RendererParam())
    profile_render("mesh_scene defaults", mesh_base, RendererParam())
    profile_render("texture_scene defaults", tex_desc, RendererParam())
    profile_render("ico6 1 spp", ico6, RendererParam(spp_min=1, spp_max=1))
    profile_render("caustics_scene photon map defaults", caus_desc, p_photon,
                   r_k)

    meta_k = {
        "K1a": ("qaray_tpu_torch/csrc/megakernel.cu",
                "qaray_tpu/ops/pallas_pathtrace.py:1614"),
        "K1b": ("qaray_tpu_torch/csrc/megakernel.cu",
                "qaray_tpu/ops/pallas_pathtrace.py:1614"),
        "K1c": ("qaray_tpu_torch/csrc/megakernel.cu",
                "qaray_tpu/ops/pallas_pathtrace.py:1614"),
        "K1d": ("qaray_tpu_torch/csrc/megakernel.cu",
                "qaray_tpu/ops/pallas_pathtrace.py:1614"),
        "K5": ("qaray_tpu_torch/csrc/photon.cu",
               "qaray_tpu/ops/pallas_photon.py:164"),
        "K3": ("qaray_tpu_torch/csrc/mesh.cu",
               "qaray_tpu/ops/pallas_mesh.py:143"),
        "K4a": ("qaray_tpu_torch/csrc/tiles.cu",
                "qaray_tpu/ops/pallas_tiles.py:385"),
        "K4b": ("qaray_tpu_torch/csrc/tiles.cu",
                "qaray_tpu/ops/pallas_tiles.py:374"),
        "K2a": ("qaray_tpu_torch/csrc/analytic.cu",
                "qaray_tpu/ops/pallas_analytic.py:212"),
        "K2b": ("qaray_tpu_torch/csrc/analytic.cu",
                "qaray_tpu/ops/pallas_analytic.py:405"),
        "K2c": ("qaray_tpu_torch/csrc/analytic.cu",
                "qaray_tpu/ops/pallas_analytic.py:174"),
        "K6": ("qaray_tpu_torch/csrc/adjoint.cu",
               "qaray_tpu/ops/pallas_adjoint.py:639"),
    }
    kernels = []
    for name in ("K1a", "K1b", "K1c", "K1d", "K2a", "K2b", "K2c", "K3", "K4a",
                 "K4b", "K5", "K6"):
        src, rep = meta_k[name]
        row = {"name": name, "route": "cuda", "source": src, "replaces": rep,
               "launches": launches[name]}
        row.update(numbers[name])
        kernels.append(row)
        print(f"  {name}: {row['ms']:.4f} ms by {row['timed_by']} (plain "
              f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms by "
              f"{row['bound_by']})")
    print(f"total {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
