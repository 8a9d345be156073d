"""grid_loop: render_loop's closed loop of images (traffic/render_loop.py)
on a scene of per-instance meshes.

It is render_loop.run with three changes:

- the image checked and the path work of the roofline come from the grid
  configuration's own reference, portbench/reference_grid (analytic
  primitives and placements of one OBJ mesh, walked per instance);
- the profiled stretch's kept kernel records are the W1 walks'
  (`bvh_kernel` records against the program's launches["W1"]): such a
  scene takes no megakernel;
- the counters snapshot around the window and the stretch holds the
  program's W1 ray counts (ops/bvh_packed.stats, as bvh.<key>; left out
  where the program has none).

Set-up, the window, the pick of the checked image and rows and the seeds
follow render_loop's rules, whose Loop, window, profiled_stretch,
checked_rows and rows_of it uses unchanged. Params: render_loop's.
"""

from __future__ import annotations

import random
import time

from portbench import bench, check
from portbench.traffic.render_loop import (
    REF_BLOCK,
    Loop,
    checked_rows,
    profiled_stretch,
    rows_of,
    window,
)


def counters() -> dict:
    """bench.program_counters and the W1 ray counts (bvh.<key>)."""
    from qaray_tpu_torch.ops import bvh_packed

    out = bench.program_counters()
    for k, v in getattr(bvh_packed, "stats", {}).items():
        out[f"bvh.{k}"] = v
    return out


def reference_image(ctx, seed_words_seed: int, rows=None):
    """The grid reference's image of one seed: (mean, count) on the
    device, from the XML and the seeds alone, and what path_work needs."""
    from portbench.reference_grid import render as R

    par, rp = ctx.params, ctx.config["renderer"]
    if rp["use_photon_map"]:
        raise ValueError("the grid reference builds no photon maps")
    arr, meta = R.load(str(bench.ROOT / ctx.config["scene"]), par["width"],
                       par["height"], ctx.device)
    icfg = R.IntegratorConfig(
        integrator=rp["integrator"], max_bounce=rp["max_bounce"],
        shadow_spp=rp["shadow_spp"], shadow_spp_max=rp["shadow_spp_max"])
    words = R.key_words(rp["rng_impl"], seed_words_seed)
    threshold = par.get("threshold", (0.005, 0.001, 0.005))
    mean, count = R.render_image(arr, meta, icfg, words, par["spp_min"],
                                 par["spp_max"], threshold, rows=rows,
                                 block=REF_BLOCK)
    return mean, count, (arr, meta, icfg, words)


def path_work(ctx, ref, lanes: int = 8192):
    """render_loop.path_work on the grid reference (reference_grid/work.py's
    counts, the mesh's included)."""
    import torch

    from portbench.reference_grid import work
    from portbench.reference_grid.engine import render_lanes

    arr, meta, icfg, words = ref
    n = meta.img_width * meta.img_height
    ids = (torch.arange(lanes, device=ctx.device, dtype=torch.int64)
           * n) // lanes
    sid = (torch.arange(lanes, device=ctx.device)
           % ctx.params["spp_min"]).to(torch.int32)
    w = meta.img_width
    work.reset()
    work.enabled = True
    try:
        with torch.no_grad():
            render_lanes(arr, meta, icfg, (ids % w).to(torch.int32),
                         (ids // w).to(torch.int32), sid, words)
    finally:
        work.enabled = False
        work.alive = None
    return dict(work.counts)


def run(ctx):
    """The cell on one device. Returns the run's record (run.py)."""
    import torch

    loop = Loop(ctx)
    loop.warm_up()
    setup_s = time.perf_counter() - ctx.t_start
    spans = ctx.spans
    undo = loop.wrap_parts(spans)
    pick = random.Random(bench.derive_seed(ctx.seed, "pick"))
    spans.reset()
    before = counters()
    items, window_s, kept = window(loop, ctx.seconds, pick)
    delta = bench.counter_delta(before, counters())
    host = {"seconds": dict(spans.seconds), "calls": dict(spans.calls)}
    rec = {"setup_s": setup_s, "window_s": window_s, "items": items,
           "counters": delta, "host": host,
           "setup_parts": dict(loop.setup_parts)}
    if ctx.trace:
        trace, n_img, n_samples, delta = profiled_stretch(
            loop, spans, counters, len(items),
            ctx.params["profile_min_images"],
            ctx.params["profile_seconds"], "bvh_kernel", "launches.W1")
        rec["trace"] = {"trace": trace, "images": n_img,
                        "samples": n_samples, "counters": delta}
    undo()
    rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                if ctx.device.type == "cuda" else 0)
    # The program's state goes before the reference runs.
    seed_k = loop.seeds[kept["seed"]]
    del loop
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    rows = checked_rows(ctx)
    mean, count, ref = reference_image(ctx, seed_k, rows=rows)
    w = ctx.params["width"]
    parts = [check.image_numbers(rows_of(kept["mean"], rows, w),
                                 rows_of(kept["count"], rows, w), mean,
                                 count)]
    rec["numbers"] = check.image_summary(parts)
    rec["checked"] = {"image": kept["index"], "seed_index": kept["seed"],
                      "rows": len(rows)}
    if ctx.trace:
        rec["work"] = path_work(ctx, ref)
    rec["reference_s"] = time.perf_counter() - t
    rec["attempted"] = len(items)
    rec["failed"] = 0
    return rec


def calibrate(ctx, n_seeds: int, n_control: int, say):
    """portbench/calibrate.py's image readings for this traffic: the timed
    path on n_seeds images against the grid reference (sound), and the
    reference in bfloat16 against it on the first n_control (control).
    say(kind, k, numbers) reports each reading as it comes."""
    import torch

    from portbench.reference import precision as PR

    loop = Loop(ctx)
    planes = []
    for k in range(n_seeds):
        fb, s = loop.render(k)
        planes.append((fb.mean.copy(), fb.count.copy(), s))
    seeds = list(loop.seeds)
    del loop
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    sound, control = [], []
    rows = checked_rows(ctx)
    w = ctx.params["width"]
    for k, (mean, count, s) in enumerate(planes):
        t = time.perf_counter()
        ref_mean, ref_count, _ = reference_image(ctx, seeds[k], rows=rows)
        sound.append(check.image_summary([check.image_numbers(
            rows_of(mean, rows, w), rows_of(count, rows, w), ref_mean,
            ref_count)]))
        sound[-1]["image_s"] = s
        sound[-1]["reference_s"] = time.perf_counter() - t
        say("sound", k, sound[-1])
        if k < n_control:
            PR.set_dtype(torch.bfloat16)
            try:
                low_mean, low_count, _ = reference_image(ctx, seeds[k],
                                                         rows=rows)
            finally:
                PR.set_dtype(torch.float32)
            control.append(check.image_summary([check.image_numbers(
                low_mean, low_count, ref_mean, ref_count)]))
            say("control", k, control[-1])
    return sound, control
