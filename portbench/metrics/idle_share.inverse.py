"""idle_share.inverse: the device's idle share of the profiled stretch, 1 - (union of the
device operations' intervals) / (the stretch's length), in %; in a
multi-card cell the mean over the ranks."""

from portbench import devtrace

LAYER, SOURCE, MOVES = "device", "device_trace", "grad_paths_per_s"


def read(rec, ctx):
    ranks = devtrace.rank_summaries(rec)
    return 100.0 * sum(1.0 - r["busy_us"] / r["window_us"]
                       for r in ranks) / len(ranks)
