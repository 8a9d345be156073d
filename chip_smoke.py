"""Smoke test of the PyTorch/CUDA port (qaray_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build every kernel from csrc/ (one nvcc per source, in parallel);
  2. K2a, K2b, K2c against their plain versions on 1M random rays against
     the primitives of tests/assets/softdof_scene.xml (tests/test_pallas.py
     bars);
  3. K1a against the wavefront engine (which runs on K2b/K2c), with the
     tests/test_megakernel.py bars:
       a. softdof_scene.xml at 200x150, 2 samples per pixel, max_bounce 4,
          threefry keys, for pathtrace and photonmap;
       b. the main path's shapes at 800x600, max_bounce 5, where the fold
          datum rid * 65536 + sid wraps past 2^31: the Renderer's first
          packed photonmap dispatch (960,000 lanes, rbg key words), the
          pathtrace render_batch of phase 4a (480,000 lanes, rbg) and a
          phase-2 photonmap round (480,000 lanes, sample 5, threefry);
  4. the main path at 800x600 with every launch count set to 0 before each
     route and read after it:
       a. Renderer defaults (photonmap, spp 4..8, max_bounce 5, shadows
          16->64, rbg) writing its PNGs, then render_batch with pathtrace
          on 480,000 lanes: K1a only, no lane on the wavefront engine;
       b. the wavefront route render_batch takes for scenes the megakernel
          does not serve (forced with QARAY_NO_MEGAKERNEL, 65,536-pixel
          batches): K2b and K2c;
  5. each kernel's time at the path's shapes beside its bound and its
     plain version's time.
Prints the card's name and power limit, one JSON line of per-kernel
numbers and, last, {"ok": true, "device": {...}}. Exits non-zero without
those lines when there is no CUDA device or no package beside it.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SCENE = os.path.join(HERE, "tests", "assets", "softdof_scene.xml")

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
    """Milliseconds per call of the CUDA kernel whose name contains
    kernel_name, from torch.profiler's device times; CUDA events around the
    whole call when the profiler reports no device time.
    Returns (ms, "profiler" | "events")."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(device_us(e) for e in prof.key_averages()
                if kernel_name in e.key)
    if total > 0:
        return total / reps / 1e3, "profiler"
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


def main():
    if not torch.cuda.is_available():
        print("no CUDA device: the port's kernels run only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from qaray_tpu_torch.integrators import engine
    from qaray_tpu_torch.integrators.engine import (
        IntegratorConfig,
        render_batch,
        render_batch_wavefront,
    )
    from qaray_tpu_torch.ops import _build, analytic, megakernel
    from qaray_tpu_torch.ops import intersect as I
    from qaray_tpu_torch.renderer import Renderer, RendererParam, key_words
    from qaray_tpu_torch.scene.compiler import compile_scene
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
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    _build.load("analytic")
    _build.load("megakernel")
    numbers = {}

    # -- 2. K2 against the plain versions ------------------------------------
    print("phase 2: analytic kernels vs plain, 1M random rays", flush=True)
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

    # -- 3. K1a against the engine -------------------------------------------
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

    # -- 4. the main path ----------------------------------------------------
    def reset_counts():
        for counts in (analytic.launches, megakernel.launches):
            for k in counts:
                counts[k] = 0
        engine.wavefront_lanes = 0

    def read_counts():
        return {**megakernel.launches, **analytic.launches,
                "wavefront_lanes": engine.wavefront_lanes}

    print("phase 4a: Renderer, softdof 800x600, defaults", flush=True)
    reset_counts()
    renderer = Renderer(RendererParam(), device="cuda")
    renderer.compute_scene(scene)
    torch.cuda.synchronize()
    t = time.time()
    fb = renderer.render()
    torch.cuda.synchronize()
    wall = time.time() - t
    with tempfile.TemporaryDirectory() as out_dir:
        prefix = os.path.join(out_dir, "smoke_")
        fb.save_image(prefix + "colorBuffer.png")
        fb.save_z_image(prefix + "depthBuffer.png")
        fb.save_sample_count_image(prefix + "sampleBuffer.png")
        sizes = [os.path.getsize(prefix + f) for f in (
            "colorBuffer.png", "depthBuffer.png", "sampleBuffer.png")]
    rays = int(fb.count.sum())
    print(f"  Renderer wall {wall:.4f} s, {rays} primary rays, "
          f"{rays / wall:.4e} primary rays/s, spp per pixel "
          f"{fb.count.min()}..{fb.count.max()} (mean {fb.count.mean():.3f})",
          flush=True)
    check(fb.img.shape == (800 * 600, 3), "colour buffer is 800x600x3")
    check(bool(np.isfinite(fb.mean).all()), "radiance finite")
    check(0.0 < float(fb.mean.mean()) < 10.0,
          f"mean radiance {float(fb.mean.mean()):.4f} plausible")
    check(4 <= fb.count.min() and fb.count.max() <= 8, "spp within 4..8")
    check(min(sizes) > 100, f"PNGs written ({sizes} bytes)")

    s_arr, s_meta = renderer.scene_arrays, renderer.meta
    torch.cuda.synchronize()
    t = time.time()
    rad_b, t0_b = render_batch(s_arr, s_meta, cfg_pt, bpx, bpy, bsid, rbg)
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
    reset_counts()
    os.environ["QARAY_NO_MEGAKERNEL"] = "1"
    wf = Renderer(RendererParam(spp_min=1, spp_max=1, batch_pixels=1 << 16),
                  device="cuda")
    wf.compute_scene(scene)
    torch.cuda.synchronize()
    t = time.time()
    fb_wf = wf.render()
    torch.cuda.synchronize()
    wall_wf = time.time() - t
    del os.environ["QARAY_NO_MEGAKERNEL"]
    counts_b = read_counts()
    print(f"  wavefront Renderer wall {wall_wf:.4f} s, "
          f"{480000 / wall_wf:.4e} primary rays/s", flush=True)
    print(f"  launch counts: {json.dumps(counts_b)}", flush=True)
    check(bool(np.isfinite(fb_wf.mean).all()), "wavefront radiance finite")
    check(counts_b["K2b"] > 0 and counts_b["K2c"] > 0,
          "K2b and K2c launched on the wavefront route")
    check(counts_b["K1a"] == 0, "no K1a launch on the wavefront route")
    launches = {k: counts_a[k] + counts_b[k] for k in ("K1a", "K2a", "K2b",
                                                       "K2c")}

    # -- 5. timings at the path's shapes -------------------------------------
    print("phase 5: kernel times at the path's shapes", flush=True)
    ms, src = kernel_ms(lambda: megakernel.mega_render(
        s_arr, s_meta, cfg_pt, bpx, bpy, bsid, rbg), "mega_kernel", 5)
    work = torch.zeros((480000, 3), dtype=torch.int32, device="cuda")
    megakernel.mega_render(s_arr, s_meta, cfg_pt, bpx, bpy, bsid, rbg,
                           work=work)
    wsum = work.sum(0, dtype=torch.int64).tolist()
    ops = wsum[0] * OPS_PER_TEST + wsum[1] * OPS_PER_CIPHER
    b_ms, b_by = bound(480000 * (12 + 16), ops)
    numbers["K1a"].update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=b_by, library_ms=None, timed_by=src,
                          lanes=480000, prim_tests=wsum[0], ciphers=wsum[1],
                          vertices=wsum[2])

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

    # Device busy share of one Renderer.render() at the 4a settings.
    prof_r = Renderer(RendererParam(), device="cuda")
    prof_r.compute_scene(scene)
    torch.cuda.synchronize()
    reset_counts()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t = time.time()
        prof_r.render()
        torch.cuda.synchronize()
        wall_p = (time.time() - t) * 1e3
    busy = {}
    for evt in prof.key_averages():
        dt = device_us(evt)
        if dt > 0:
            busy[evt.key] = dt / 1e3
    total_busy = sum(busy.values())
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:5]
    print(f"  Renderer under the profiler: wall {wall_p:.3f} ms, device busy "
          f"{total_busy:.3f} ms, idle share "
          f"{1.0 - total_busy / wall_p:.4f}, K1a launches "
          f"{megakernel.launches['K1a']}", flush=True)
    for key, val in top:
        print(f"    {val:.3f} ms  {key[:90]}")

    meta_k = {
        "K1a": ("qaray_tpu_torch/csrc/megakernel.cu",
                "qaray_tpu/ops/pallas_pathtrace.py:1614"),
        "K2a": ("qaray_tpu_torch/csrc/analytic.cu",
                "qaray_tpu/ops/pallas_analytic.py:212"),
        "K2b": ("qaray_tpu_torch/csrc/analytic.cu",
                "qaray_tpu/ops/pallas_analytic.py:405"),
        "K2c": ("qaray_tpu_torch/csrc/analytic.cu",
                "qaray_tpu/ops/pallas_analytic.py:174"),
    }
    kernels = []
    for name in ("K1a", "K2a", "K2b", "K2c"):
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
