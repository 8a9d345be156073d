"""bvh_walk_ms_per_image: device milliseconds of the packed BVH walk W1
(the records whose name holds `bvh_kernel`, closest and any hits) per
image of the profiled stretch."""

from portbench import devtrace

LAYER, SOURCE, MOVES = "mesh", "device_trace", "samples_per_s"


def read(rec, ctx):
    tr = rec["trace"]
    us = devtrace.device_us_where(tr["trace"],
                                  lambda name, span: "bvh_kernel" in name)
    return us / 1e3 / tr["images"]
