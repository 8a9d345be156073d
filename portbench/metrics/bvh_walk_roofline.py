"""bvh_walk_roofline: the least time of the W1 walks of the profiled
stretch's samples over the device time of its `bvh_kernel` records, in %.
The least time is the larger of two floors (roofline/ops.least_seconds):
the bytes each ray handed to the walk must move, and the operations of
one move into an instance's space and one triangle test for each ray
whose closest hit, or whose blocker, is a mesh (roofline/<config>.w1_work
on the counts of the reference's own replay, rec["work"], scaled to the
stretch's samples). It counts what any walk must do, so it cannot pass
100 %."""

from portbench import bench, devtrace
from portbench.roofline import ops

LAYER, SOURCE, MOVES = "mesh", "device_trace", "samples_per_s"


def read(rec, ctx):
    tr = rec["trace"]
    busy = devtrace.device_us_where(
        tr["trace"], lambda name, span: "bvh_kernel" in name) / 1e6
    if busy <= 0 or "work" not in rec:
        return None
    count = bench.load_module("roofline", ctx.config["roofline"])
    flops, nbytes = count.w1_work(rec["work"], tr["samples"])
    least, _ = ops.least_seconds(flops, nbytes)
    return 100.0 * least / busy
