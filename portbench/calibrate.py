"""The readings the limits of `correct` are set from (PERF.md, §2), on the
card at the cell's own size, in one process:

    python3 -m portbench.calibrate --workload <cell> --seed <n> \
        --seeds 12 --control 3

- lower readings: the program's timed path (Renderer.render, or the
  optimiser's first steps through diff.render_value_and_grad) on `--seeds`
  seeds derived from --seed, each held to the plain reference as a run
  holds it (the image's checked rows);
- upper readings: the control, the plain reference computed in bfloat16
  (the next precision below the float32 the configuration states) put in
  the program's place, on the first `--control` of those seeds; for the
  inverse-rendering cell also the half-batch fault (the reference's
  steps over the first half of the lanes) on the same seeds.

Prints each reading as a JSON line as it comes, then one JSON line of all
of them with the largest sound one and the smallest control one of each
number. Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from portbench import bench, check
from portbench import run as RUN


def _say(kind, k, numbers):
    """One reading as it comes, so that a cut call keeps those before."""
    print(json.dumps({kind: k, **numbers}), flush=True)


def _images(ctx, n_seeds, n_control):
    import torch

    from portbench.reference import precision as PR
    from portbench.traffic import render_loop

    loop = render_loop.Loop(ctx)
    planes = []
    for k in range(n_seeds):
        fb, s = loop.render(k)
        planes.append((fb.mean.copy(), fb.count.copy(), s))
    seeds = list(loop.seeds)
    del loop
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    sound, control = [], []
    rows = render_loop.checked_rows(ctx)
    w = ctx.params["width"]
    for k, (mean, count, s) in enumerate(planes):
        t = time.perf_counter()
        ref_mean, ref_count, _ = render_loop.reference_image(ctx, seeds[k],
                                                             rows=rows)
        sound.append(check.image_summary([check.image_numbers(
            render_loop.rows_of(mean, rows, w),
            render_loop.rows_of(count, rows, w), ref_mean, ref_count)]))
        sound[-1]["image_s"] = s
        sound[-1]["reference_s"] = time.perf_counter() - t
        _say("sound", k, sound[-1])
        if k < n_control:
            PR.set_dtype(torch.bfloat16)
            try:
                low_mean, low_count, _ = render_loop.reference_image(
                    ctx, seeds[k], rows=rows)
            finally:
                PR.set_dtype(torch.float32)
            control.append(check.image_summary([check.image_numbers(
                low_mean, low_count, ref_mean, ref_count)]))
            _say("control", k, control[-1])
    return sound, control, []


def _grads(ctx, n_seeds, n_control):
    import torch

    from portbench.reference import precision as PR
    from portbench.traffic import grad_loop

    par = ctx.params
    rp = {**ctx.config["renderer"], **par.get("renderer", {})}
    lr = {k: float(v) for k, v in par["lr"].items()}
    sound, control, faults = [], [], []
    opt_lanes = par["width"] * par["height"]
    for k in range(n_seeds):
        ctx.seed = bench.derive_seed(ctx.base_seed, "calibrate", k)
        opt = grad_loop.Optimiser(ctx)
        words_seed = bench.derive_seed(ctx.seed, "grad")
        opt.target = grad_loop.reference_target(ctx, words_seed, rp)
        start = grad_loop.start_params(opt.true, ctx.seed, par["perturb"])
        opt.set_params(start)
        losses, first = [], None
        for _ in range(par["check_steps"]):
            loss, grads = opt.step()
            losses.append(loss)
            if first is None:
                first = {f: v.detach().clone() for f, v in grads.items()}
        change = {f: (opt.params[f] - start[f].to(ctx.device)).detach()
                  for f in grad_loop.FIELDS}
        target = opt.target
        del opt
        ref = grad_loop.reference_steps(ctx, start, target,
                                        par["check_steps"], lr, rp,
                                        words_seed)
        nums, leaves = check.grad_numbers(losses, ref[0], first, ref[1],
                                          change, ref[2])
        sound.append(dict(nums, leaves=leaves))
        _say("sound", k, sound[-1])
        if k < n_control:
            PR.set_dtype(torch.bfloat16)
            try:
                low = grad_loop.reference_steps(ctx, start, target,
                                                par["check_steps"], lr, rp,
                                                words_seed)
            finally:
                PR.set_dtype(torch.float32)
            nums, _ = check.grad_numbers(low[0], ref[0], low[1], ref[1],
                                         low[2], ref[2])
            control.append(nums)
            _say("control", k, nums)
            # The half-batch fault, planted in the reference put in the
            # program's place: the mean over the first half of the lanes.
            half = grad_loop.reference_steps(
                ctx, start, target, par["check_steps"], lr, rp, words_seed,
                lanes=opt_lanes // 2)
            nums, _ = check.grad_numbers(half[0], ref[0], half[1], ref[1],
                                         half[2], ref[2])
            faults.append(nums)
            _say("half_batch", k, nums)
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
    return sound, control, faults


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args(argv)
    wl = bench.load_json("workloads", args.workload)
    try:
        bench.require_cards(1)
    except bench.NoCard as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    t = time.perf_counter()
    # Seeds of their own, not the cell's pool: readings over many images.
    params = ({"seeds_per_run": args.seeds, "pool": None}
              if wl["traffic"] != "grad_loop" else None)
    ctx = RUN.make_ctx(args.workload, args.seed, 0.0, False, params=params)
    ctx.base_seed = args.seed
    if wl["traffic"] == "grad_loop":
        sound, control, faults = _grads(ctx, args.seeds, args.control)
    else:
        sound, control, faults = _images(ctx, args.seeds, args.control)
    names = list(wl["limits"])
    out = {"workload": args.workload, "card": bench.card_line(),
           "sound": sound, "control": control, "half_batch": faults,
           "lower": {n: max(x[n] for x in sound) for n in names},
           "upper": {n: min(x[n] for x in control) for n in names}
           if control else {}, "seconds": time.perf_counter() - t}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
