"""The megakernel's least work on the softdof configuration's scene: three
spheres and a plane (portbench/scenes/softdof_scene.xml)."""

from portbench.roofline import ops

SPHERES = 3
PLANES = 1


def megakernel_work(counts: dict, lanes: float):
    """(operations, bytes) of `lanes` samples whose paths take, on average,
    the work of `counts` (reference/work.py over counts["lanes"] lanes)."""
    per_lane = ops.path_ops(counts, SPHERES, PLANES) / counts["lanes"]
    return per_lane * lanes, ops.LANE_BYTES * lanes
