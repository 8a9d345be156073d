"""portbench/calibrate.py for the cells of the grid_loop traffic, whose
reference is portbench/reference_grid (calibrate.py reads render_loop's):

    python3 -m portbench.calibrate_grid --workload grid.instances \
        --seed <n> --seeds 6 --control 3

Prints the same lines as calibrate.py: each reading as a JSON line as it
comes, then one line of all of them with the largest sound reading and
the smallest control reading of each number. Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from portbench import bench
from portbench import run as RUN
from portbench.calibrate import _say


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=6)
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
    ctx = RUN.make_ctx(args.workload, args.seed, 0.0, False,
                       params={"seeds_per_run": args.seeds, "pool": None})
    traffic = bench.load_module("traffic", wl["traffic"])
    sound, control = traffic.calibrate(ctx, args.seeds, args.control, _say)
    names = list(wl["limits"])
    out = {"workload": args.workload, "card": bench.card_line(),
           "sound": sound, "control": control,
           "lower": {n: max(x[n] for x in sound) for n in names},
           "upper": {n: min(x[n] for x in control) for n in names}
           if control else {}, "seconds": time.perf_counter() - t}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
