"""megakernel_roofline: the least time of the megakernel's work (its
samples in the profiled stretch, at the float32 operations and bytes the
plain reference's paths need, portbench/roofline) over the device time
of its launches (mega_kernel records), in %. The bound is operations on
these cells (roofline/ops.least_seconds says which). With several ranks,
rank 0's trace holds its share of each dispatch's lanes, 1/ranks of the
samples."""

from portbench import bench, devtrace
from portbench.roofline import ops

LAYER, SOURCE, MOVES = "megakernel", "device_trace", "samples_per_s"


def read(rec, ctx):
    tr = rec["trace"]
    busy = devtrace.device_us_where(
        tr["trace"], lambda name, span: "mega_kernel" in name) / 1e6
    if busy <= 0 or "work" not in rec:
        return None
    count = bench.load_module("roofline", ctx.config["roofline"])
    flops, nbytes = count.megakernel_work(
        rec["work"], tr["samples"] / rec.get("ranks", 1))
    least, _ = ops.least_seconds(flops, nbytes)
    return 100.0 * least / busy
