"""mfu.render: the whole render's share of the card's float32 peak while
the card works: the least operations of the samples rendered in the
profiled stretch (portbench/roofline, on the plain reference's paths)
over the stretch's device-busy seconds (the union of its device
operations, from the trace; several ranks: their mean) and the published
67e12 operations/s of every card the cell uses, in %. It reads every
kernel of the render, so work moved off the megakernel still shows here."""

from portbench import bench, devtrace
from portbench.roofline import ops

LAYER, SOURCE, MOVES = "device", "device_trace", "samples_per_s"


def read(rec, ctx):
    if "work" not in rec:
        return None
    ranks = devtrace.rank_summaries(rec)
    busy = sum(r["busy_us"] for r in ranks) / len(ranks) / 1e6
    if busy <= 0:
        return None
    count = bench.load_module("roofline", ctx.config["roofline"])
    flops, _ = count.megakernel_work(rec["work"], rec["trace"]["samples"])
    peak = ops.PEAKS["float32_ops_per_s"] * rec.get("ranks", 1)
    return 100.0 * flops / busy / peak
