"""ranks: one process a card, each rendering render_loop's images SPMD
over a mesh of every rank's card (the upstream's MPI batch mode): each
dispatch's lanes are split over the ranks, rendered, and all-gathered to
every rank, which folds the whole dispatch (parallel/mesh.py).

The process the benchmark starts is rank 0. It starts ranks 1..chips-1 as
processes of the same command with --rank (the pattern of
qaray_tpu_torch/tools/multi_card.py), meets them on a free localhost port
(parallel.distributed.init_distributed over env://: gloo, then NCCL for
the collectives, every rank owning a distinct card), times the images and
prints the line; it waits for every rank to end and kills none that has
not. Rank 0 decides when the window closes and tells the others after
each image (a broadcast on the gloo group), so every rank issues the same
collectives. After the window each rank profiles the same stretch (with
--trace 1), and the reference checks the image rank 0 kept: rank 0 sends
its planes to every rank, rank r renders the reference's r-th block of
rows, and the partial sums come back to rank 0.
"""

from __future__ import annotations

import json
import os
import random
import socket
import subprocess
import sys
import time

from portbench import bench, check, devtrace
from portbench.traffic import render_loop


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(ctx, world: int):
    """Ranks 1..world-1 of this run, as processes of the same command."""
    port = _free_port()
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
               WORLD_SIZE=str(world))
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK="0", LOCAL_RANK="0")
    procs = []
    for r in range(1, world):
        e = dict(env, RANK=str(r), LOCAL_RANK=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "portbench.run", "--workload", ctx.name,
             "--seed", str(ctx.seed), "--seconds", str(ctx.seconds),
             "--trace", str(int(ctx.trace)), "--rank", str(r),
             "--device", ctx.device.type, "--params",
             json.dumps(ctx.params)],
            cwd=str(bench.ROOT), env=e))
    return procs


def _reap(procs, timeout=120.0):
    """Wait for every rank; kill and wait for any that outlives timeout.
    Returns the exit codes."""
    codes = []
    end = time.monotonic() + timeout
    for p in procs:
        try:
            p.wait(timeout=max(1.0, end - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        codes.append(p.returncode)
    return codes


def run(ctx):
    world = ctx.params.get("ranks", ctx.workload["chips"])
    procs = _spawn(ctx, world) if not ctx.rank else []
    try:
        rec = _rank(ctx, world)
    except BaseException:
        for p in procs:
            p.kill()
        _reap(procs)
        raise
    codes = _reap(procs)
    if any(codes):
        raise RuntimeError(f"ranks 1..{world - 1} exited {codes}")
    return rec


def _rank(ctx, world: int):
    import torch
    import torch.distributed as dist

    from qaray_tpu_torch.parallel import distributed

    rank, size = distributed.init_distributed(device=ctx.device.type)
    if size != world:
        raise RuntimeError(f"{size} ranks met, the cell needs {world}")
    ctx.device = distributed.local_device()
    try:
        return _body(ctx, rank, world, torch, dist)
    finally:
        distributed.shutdown()


def _body(ctx, rank, world, torch, dist):
    loop = render_loop.Loop(ctx, mesh_ranks=True)
    loop.warm_up()
    dist.barrier()
    setup_s = time.perf_counter() - ctx.t_start
    spans = ctx.spans
    undo = loop.wrap_parts(spans)
    pick = random.Random(bench.derive_seed(ctx.seed, "pick"))

    def stop(done):
        flag = torch.tensor([1 if done else 0], dtype=torch.int32)
        dist.broadcast(flag, 0)
        return bool(flag.item())

    spans.reset()
    before = bench.program_counters()
    items, window_s, kept = render_loop.window(loop, ctx.seconds, pick,
                                               stop=stop)
    counters = bench.counter_delta(before, bench.program_counters())
    rec = {"setup_s": setup_s, "window_s": window_s, "items": items,
           "counters": counters, "ranks": world,
           "host": {"seconds": dict(spans.seconds),
                    "calls": dict(spans.calls)},
           "setup_parts": dict(loop.setup_parts)}
    if ctx.trace:
        trace, n_img, n_samples, delta = render_loop.profiled_stretch(
            loop, spans, bench.program_counters, len(items),
            ctx.params["profile_min_images"], 0.0, "mega_kernel",
            "launches.K1a")
        rec["trace"] = {"trace": trace, "images": n_img,
                        "samples": n_samples, "counters": delta}
        every = [None] * world
        dist.all_gather_object(every, devtrace.summary(trace))
        rec["rank_traces"] = every
    undo()
    peak = (torch.cuda.max_memory_allocated(ctx.device)
            if ctx.device.type == "cuda" else 0)
    peaks = [None] * world
    dist.all_gather_object(peaks, peak)
    rec["memory_peak_bytes"] = max(peaks)

    # The kept image of rank 0, sent to every rank.
    n = loop.width * loop.height
    seed_k = torch.tensor([kept.get("seed", 0) if rank == 0 else 0])
    dist.broadcast(seed_k, 0)
    mean = (torch.as_tensor(kept["mean"]) if rank == 0
            else torch.empty((n, 3), dtype=torch.float32))
    count = (torch.as_tensor(kept["count"]) if rank == 0
             else torch.empty(n, dtype=torch.int32))
    dist.broadcast(mean, 0)
    dist.broadcast(count, 0)
    seed_words = loop.seeds[int(seed_k)]
    h, w = loop.height, loop.width
    del loop
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    rows = render_loop.checked_rows(ctx)[rank::world]
    ref_mean, ref_count, ref = render_loop.reference_image(ctx, seed_words,
                                                           rows=rows)
    part = check.image_numbers(render_loop.rows_of(mean, rows, w),
                               render_loop.rows_of(count, rows, w),
                               ref_mean, ref_count)
    parts = [None] * world
    dist.all_gather_object(parts, part)
    rec["numbers"] = check.image_summary(parts)
    rec["checked"] = {"image": kept.get("index"), "seed_index": int(seed_k),
                      "rows": len(render_loop.checked_rows(ctx))}
    if ctx.trace:
        rec["work"] = render_loop.path_work(ctx, ref)
    rec["reference_s"] = time.perf_counter() - t
    rec["attempted"] = len(items)
    rec["failed"] = 0
    dist.barrier()
    return rec

