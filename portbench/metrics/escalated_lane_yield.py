"""escalated_lane_yield: the escalated lanes the wavefront engine
re-rendered over the lanes of the power-of-two buckets it rendered them
in (renderer.stats, escalated_lanes / escalated_padded, over the run), in
%: the share of the re-render's lanes that are not padding."""

from portbench import progspans

LAYER, SOURCE, MOVES = "wavefront", "program_counter", "samples_per_s"


def read(rec, ctx):
    lanes = progspans.counter("renderer", "escalated_lanes")
    padded = progspans.counter("renderer", "escalated_padded")
    if not padded:
        return None
    return 100.0 * lanes / padded
