"""render_loop: one offline user rendering images back to back (a closed
loop), through Renderer.render().

Set-up compiles the scene once (Renderer.compute_scene, with the photon
maps where the configuration asks for them, built in a fresh directory
under TMPDIR, where the Renderer writes photonmap.dat and caustics.dat),
then renders each of the cell's `seeds_per_run` images once: every graph
and bucket the window will replay is captured there. The images' key
words and the maps come from the workload's `pool` (pool_seed), so that
every run does the same work; the run's seed sets where in the pool the
window starts, which image is checked and which rows. The program bakes
an image's key words into its graphs, so a run cycles over the images it
warmed up (PERF.md, open questions).

An image is timed from render()'s call to the finalized frame buffer on
the host; the window closes with the first image that ends after
--seconds, and lasts until that image's end: every image of the window is
counted whole.

Params (the workload file): width, height, spp_min, spp_max, threshold
(optional), pool, seeds_per_run, profile_min_images, profile_seconds, and
check_rows, the image rows the reference checks (a sample drawn from the
seed).
"""

from __future__ import annotations

import os
import random
import shutil
import tempfile
import time

from portbench import bench, check, devtrace

# Lanes of one call of the plain reference's image render.
REF_BLOCK = 1 << 20


def pool_seed(ctx) -> int:
    """The seed of the images a run renders and of its photon maps: the
    workload's `pool` (a fixed name), so that every run of a cell renders
    the same images and does the same work, in an order the run's seed
    sets; without a pool, the run's seed."""
    pool = ctx.params.get("pool")
    return ctx.seed if pool is None else bench.derive_seed(0, "pool", pool)


class Loop:
    """The program's Renderer on one device, ready to render images of
    the run's seeds."""

    def __init__(self, ctx, mesh_ranks: bool = False):
        import torch  # noqa: F401  (CUDA set-up is part of set-up)

        from qaray_tpu_torch.renderer import Renderer, RendererParam
        from qaray_tpu_torch.scene.xml_parser import load_scene

        cfg, par = ctx.config, ctx.params
        self.ctx = ctx
        rp = dict(cfg["renderer"])
        rp.update(spp_min=par["spp_min"], spp_max=par["spp_max"],
                  seed=bench.derive_seed(pool_seed(ctx), "maps"))
        if "threshold" in par:
            rp["threshold"] = tuple(par["threshold"])
        param = RendererParam(**rp)
        if mesh_ranks:
            from qaray_tpu_torch.parallel.mesh import default_devices

            param.num_devices = len(default_devices(ctx.device.type))
        self.r = Renderer(param, device=ctx.device)
        desc = load_scene(str(bench.ROOT / cfg["scene"]))
        desc.camera.img_width = par["width"]
        desc.camera.img_height = par["height"]
        self.width, self.height = par["width"], par["height"]
        self.seeds = [bench.derive_seed(pool_seed(ctx), "image", k)
                      for k in range(par["seeds_per_run"])]
        # The run's seed sets where in the pool the window starts.
        self.start = ctx.seed % len(self.seeds)
        self.setup_parts = {}
        self._compute_scene(desc)

    def _compute_scene(self, desc):
        """compute_scene in a fresh directory under TMPDIR, the photon
        build timed to a synchronise."""
        from qaray_tpu_torch.photon import build

        orig = build.build_photon_maps

        def timed(*a, **kw):
            t = time.perf_counter()
            out = orig(*a, **kw)
            self._sync()
            self.setup_parts["photon_build_s"] = time.perf_counter() - t
            return out

        build.build_photon_maps = timed
        cwd = os.getcwd()
        work = tempfile.mkdtemp(prefix="portbench-")
        try:
            os.chdir(work)
            self.r.compute_scene(desc)
        finally:
            os.chdir(cwd)
            build.build_photon_maps = orig
            shutil.rmtree(work, ignore_errors=True)

    def _sync(self):
        import torch

        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize()

    def render(self, k: int):
        """Image of seed k on a fresh frame buffer: (frame buffer,
        seconds from render()'s call to the finalized buffer)."""
        from qaray_tpu_torch.fb.framebuffer import FrameBuffer

        self.r.param.seed = self.seeds[k]
        self.r.fb = FrameBuffer(self.width, self.height)
        t = time.perf_counter()
        fb = self.r.render()
        return fb, time.perf_counter() - t

    def warm_up(self):
        for k in range(len(self.seeds)):
            self.render(k)
        self._sync()

    def wrap_parts(self, spans):
        """Host spans around the Renderer's parts (as tools/capture_turns.py
        splits the host): dispatch, fold, read (with its event wait),
        escalation, sync, finalize. Returns an undo."""
        import torch

        from qaray_tpu_torch.fb import device_accum
        from qaray_tpu_torch.fb.framebuffer import FrameBuffer

        undo = [spans.wrap(self.r, "_dispatch", "dispatch"),
                spans.wrap(self.r, "_read", "read"),
                spans.wrap(self.r, "_render_escalated", "escalate"),
                spans.wrap(device_accum, "accumulate_round", "fold"),
                spans.wrap(device_accum, "accumulate_contig", "fold"),
                spans.wrap(device_accum, "unconverged_ids", "converge"),
                spans.wrap(device_accum, "sync_to_fb", "sync"),
                spans.wrap(FrameBuffer, "finalize", "finalize")]
        if self.ctx.device.type == "cuda":
            undo.append(spans.wrap(torch.cuda.Event, "synchronize",
                                   "event_wait"))
        return lambda: [u() for u in reversed(undo)]


def window(loop: Loop, seconds: float, pick, stop=None):
    """Images back to back until one ends after `seconds`. Returns (items,
    window seconds, the image kept for the check: its index, seed index
    and planes). pick: a seeded random.Random choosing that image among
    all of the window's (a reservoir of one); stop(done): the end test of
    ranks, so that every rank stops at the same image."""
    items, kept = [], {}
    t0 = time.perf_counter()
    i = 0
    while True:
        k = (loop.start + i) % len(loop.seeds)
        fb, s = loop.render(k)
        items.append({"s": s, "samples": int(fb.count.sum()), "seed": k})
        if pick.random() * (i + 1) < 1.0:
            kept = {"index": i, "seed": k, "mean": fb.mean,
                    "count": fb.count}
        i += 1
        done = time.perf_counter() - t0 >= seconds
        if stop is not None:
            done = stop(done)
        if done:
            break
    return items, time.perf_counter() - t0, kept


def profiled_stretch(loop: Loop, spans, counters_fn, first: int,
                     min_images: int, min_seconds: float, kernel_part: str,
                     counter: str):
    """Whole images under the profiler, after the window: at least
    `min_images` and `min_seconds`. The kernel records kept must equal
    the launch counter's growth (one retry after a flush), or it raises.
    Returns (trace, images, samples, counter deltas)."""
    for attempt in range(2):
        before = counters_fn()

        def run():
            out, t0, i = [], time.perf_counter(), first
            while (len(out) < min_images
                   or time.perf_counter() - t0 < min_seconds):
                with spans.span("image"):
                    fb, _ = loop.render((loop.start + i) % len(loop.seeds))
                out.append(int(fb.count.sum()))
                i += 1
            return out

        samples, trace = devtrace.profile(run, spans)
        delta = bench.counter_delta(before, counters_fn())
        kept = devtrace.kept_launches(trace, kernel_part)
        if kept == delta[counter]:
            return trace, len(samples), sum(samples), delta
        print(f"portbench: the profiler kept {kept} {kernel_part} records "
              f"of {delta[counter]} launches (attempt {attempt + 1})",
              flush=True)
    raise RuntimeError("the device trace lost kernel records: no per-layer "
                       "numbers from it")


def checked_rows(ctx):
    """The image rows the reference checks: `check_rows` of them (all
    where the workload gives none) drawn without replacement from the run's
    seed, in ascending order."""
    import torch

    h = ctx.params["height"]
    n = min(ctx.params.get("check_rows", h), h)
    pick = random.Random(bench.derive_seed(ctx.seed, "rows"))
    return torch.tensor(sorted(pick.sample(range(h), n)), dtype=torch.int64)


def rows_of(planes, rows, width: int):
    """The rows' pixels of a row-major [H * W, ...] plane."""
    import torch

    t = torch.as_tensor(planes)
    return t.reshape((-1, width) + t.shape[1:])[rows].reshape(
        (-1,) + t.shape[1:])


def reference_image(ctx, seed_words_seed: int, rows=None):
    """The plain reference's image of one seed: (mean, count) on the
    device, from the XML and the seeds alone."""
    from portbench.reference import render as R

    cfg, par = ctx.config, ctx.params
    arr, meta = R.load(str(bench.ROOT / cfg["scene"]), par["width"],
                       par["height"], ctx.device)
    rp = cfg["renderer"]
    icfg = R.IntegratorConfig(
        integrator=rp["integrator"], max_bounce=rp["max_bounce"],
        shadow_spp=rp["shadow_spp"], shadow_spp_max=rp["shadow_spp_max"],
        use_photon_map=rp["use_photon_map"])
    maps = None
    if rp["use_photon_map"]:
        maps = R.build_maps(arr, meta,
                            bench.derive_seed(pool_seed(ctx), "maps"),
                            **{k: rp[k] for k in _MAP_KEYS if k in rp})
    words = R.key_words(rp["rng_impl"], seed_words_seed)
    threshold = par.get("threshold", (0.005, 0.001, 0.005))
    mean, count = R.render_image(arr, meta, icfg, words, par["spp_min"],
                                 par["spp_max"], threshold, maps=maps,
                                 rows=rows, block=REF_BLOCK)
    return mean, count, (arr, meta, icfg, maps, words)


_MAP_KEYS = ("photon_map_size", "photon_map_bounce", "photon_map_radius",
             "caustics_map_size", "caustics_map_bounce",
             "caustics_map_radius")


def path_work(ctx, ref, lanes: int = 8192):
    """The reference's work counts over a fixed subset of lanes: pixels
    spread evenly over the image, sample indices cycling over the first
    spp_min (reference/work.py)."""
    import torch

    from portbench.reference import work
    from portbench.reference.engine import render_lanes

    arr, meta, icfg, maps, words = ref
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
                         (ids // w).to(torch.int32), sid, words, maps)
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
    before = bench.program_counters()
    items, window_s, kept = window(loop, ctx.seconds, pick)
    counters = bench.counter_delta(before, bench.program_counters())
    host = {"seconds": dict(spans.seconds), "calls": dict(spans.calls)}
    rec = {"setup_s": setup_s, "window_s": window_s, "items": items,
           "counters": counters, "host": host,
           "setup_parts": dict(loop.setup_parts)}
    if ctx.trace:
        trace, n_img, n_samples, delta = profiled_stretch(
            loop, spans, bench.program_counters, len(items),
            ctx.params["profile_min_images"],
            ctx.params["profile_seconds"], "mega_kernel", "launches.K1a")
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
