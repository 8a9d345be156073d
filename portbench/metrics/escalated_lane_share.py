"""escalated_lane_share: lanes the wavefront engine re-rendered in the
window (engine.wavefront_lanes, padded to their buckets) over the
window's samples, in %."""

LAYER, SOURCE, MOVES = "wavefront", "program_counter", "samples_per_s"


def read(rec, ctx):
    samples = sum(x["samples"] for x in rec["items"])
    return 100.0 * rec["counters"]["wavefront_lanes"] / samples
