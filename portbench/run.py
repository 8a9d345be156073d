"""The port's benchmark: one run of one cell.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout that holds qaray_tpu_torch beside
portbench/ and BENCHMARK.json. The cell's files are found by name:
portbench/workloads/<cell>.json names its configuration
(portbench/configs/<config>.json) and its traffic driver
(portbench/traffic/<traffic>.py); every metric BENCHMARK.json gives the
cell has a reader portbench/metrics/<metric>.py. The run loads, warms up
(set-up), measures for --seconds, checks what the timed path produced
against the plain reference (portbench/reference) and prints one JSON
line last: with --trace 0 the cell's end-to-end metrics, with --trace 1
its per-layer metrics, read from host spans, the program's counters and
a profiled stretch after the window. The numbers compared for `correct`
are printed with their limits as the last lines of standard error.

A run needs the cell's CUDA cards: without them it names what is missing
and exits 2, printing no result. It exits 4, printing no result, if JAX,
jaxlib, flax or the JAX package (qaray_tpu) were loaded in its process.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

from portbench import bench, devtrace  # noqa: E402


def make_ctx(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", params=None, t_start=None, rank=None):
    """The run's context: the cell's files, its arguments, host spans.
    params overrides the workload's traffic parameters (tests)."""
    import torch

    wl = bench.load_json("workloads", workload)
    cfg = bench.load_json("configs", wl["config"])
    par = dict(wl["params"])
    par.update(params or {})
    return types.SimpleNamespace(
        workload=wl, name=workload, config=cfg, params=par, seed=int(seed),
        seconds=float(seconds), trace=bool(trace),
        device=torch.device(device), spans=bench.Spans(),
        t_start=T_START if t_start is None else t_start, rank=rank)


def run_cell(ctx):
    """The traffic driver's record of one run."""
    driver = bench.load_module("traffic", ctx.workload["traffic"])
    return driver.run(ctx)


def report(ctx, rec, spec=None):
    """(the result line's fields, the compared numbers) of a run's record:
    the cell's metrics for this kind of run, read by their readers."""
    from portbench import check

    spec = spec or bench.benchmark_spec()
    kind = "per_layer" if ctx.trace else "end_to_end"
    metrics = {}
    for m in bench.cell_metrics(spec, ctx.name, kind):
        reader = bench.load_module("metrics", m["name"])
        value = reader.read(rec, ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
              "kind": _device_name(ctx), "count": ctx.workload["chips"],
              "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    breakdown = None
    if ctx.trace:
        ranks = devtrace.rank_summaries(rec)
        device["busy_s"] = sum(r["busy_us"] for r in ranks) / len(ranks) / 1e6
        device["window_s"] = (sum(r["window_us"] for r in ranks)
                              / len(ranks) / 1e6)
        t0 = rec["trace"]["trace"]
        breakdown = {"device_ops": devtrace.top_ops(t0),
                     "idle_gaps": devtrace.idle_gaps(t0)}
    correct, compared = check.judge(rec["numbers"], ctx.workload["limits"])
    return dict(correct=correct, attempted=rec["attempted"],
                failed=rec["failed"], metrics=metrics, device=device,
                compared=compared, breakdown=breakdown)


def _device_name(ctx) -> str:
    import torch

    if ctx.device.type == "cuda":
        return torch.cuda.get_device_name(ctx.device)
    return "cpu"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # A rank of a multi-card cell, started by the ranks driver: it prints
    # no result. --device cpu and --params serve the drivers' CPU tests.
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--params", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    on_cpu = args.rank and args.device == "cpu"
    try:
        wl = bench.load_json("workloads", args.workload)
        if not on_cpu:
            bench.require_cards(wl["chips"])
    except (bench.NoCard, FileNotFoundError) as e:
        print(f"portbench: {e}", file=sys.stderr, flush=True)
        return 2
    ctx = make_ctx(args.workload, args.seed, args.seconds, args.trace,
                   device="cpu" if on_cpu else "cuda", rank=args.rank,
                   params=json.loads(args.params) if args.params else None)
    if not on_cpu:
        print(f"portbench: {args.workload} seed {args.seed} on "
              f"{bench.card_line()}", file=sys.stderr, flush=True)
    rec = run_cell(ctx)
    if args.rank:
        return 0  # the ranks driver's rank 0 reports
    out = report(ctx, rec)
    found = bench.forbidden_loaded()
    if found:
        print("portbench: the run loaded " + ", ".join(found)
              + ": no result", file=sys.stderr, flush=True)
        return 4
    summary = {k: rec[k] for k in ("setup_s", "target_s", "window_s",
                                   "reference_s", "checked") if k in rec}
    times = [x["s"] for x in rec["items"]]
    summary["item_s_quartiles"] = [bench.percentile(times, q)
                                   for q in (0, 25, 50, 75, 100)]
    n = len(times)
    summary["host_ms_per_item"] = {k: 1e3 * v / n for k, v in
                                   rec["host"]["seconds"].items()}
    print("portbench: " + json.dumps(summary), file=sys.stderr)
    if ctx.device.type == "cuda":
        print("portbench: card after the run: " + bench.card_state(),
              file=sys.stderr)
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(bench.result_line(**out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
