"""The least work on the grid configuration's scene: a ground plane and
144 placements of one mesh, walked per instance
(portbench/scenes/grid_scene.xml).

The render (megakernel_work, the name the mfu.render reader calls): the
plane's tests and ops.py's camera, shading and shadow terms on the paths
of reference_grid's replay, and the mesh's floor. The mesh's floor: each
ray whose closest hit is a mesh triangle (mesh_closest) and each shadow
ray that a mesh blocks where the plane does not (mesh_blocked) must at
least move into one instance's space and test one triangle; rays that
miss every mesh are left out, so the floor is low, never high.

W1 (w1_work, for bvh_walk_roofline): that floor's operations, and the
bytes each ray handed to the walk must move: a closest-hit ray reads its
origin, direction and bound (28 B) and writes t, instance, triangle,
barycentrics and front (25 B); an any-hit ray reads the same 28 B and its
occluded flag and writes the flag (30 B).
"""

from portbench.roofline import ops

SPHERES = 0
PLANES = 1
TRIANGLE_TEST = 40   # Moller-Trumbore on stored edges: two crosses 18, three
#                      dots 15, the shared divide and three scalings 4,
#                      the origin's offset 3
CLOSEST_RAY_BYTES = 53
ANY_RAY_BYTES = 30


def mesh_ops(counts: dict) -> float:
    """Operations of the mesh's floor in `counts` (reference_grid/work.py's
    keys)."""
    return ((counts["mesh_closest"] + counts["mesh_blocked"])
            * (ops.RAY_TO_OBJECT + TRIANGLE_TEST))


def megakernel_work(counts: dict, lanes: float):
    """(operations, bytes) of the whole render of `lanes` samples whose
    paths take, on average, the work of `counts` (over counts["lanes"]
    lanes)."""
    per_lane = ((ops.path_ops(counts, SPHERES, PLANES) + mesh_ops(counts))
                / counts["lanes"])
    return per_lane * lanes, ops.LANE_BYTES * lanes


def w1_work(counts: dict, lanes: float):
    """(operations, bytes) of the W1 walks of `lanes` samples."""
    scale = lanes / counts["lanes"]
    nbytes = (counts["closest_rays"] * CLOSEST_RAY_BYTES
              + counts["shadow_rays"] * ANY_RAY_BYTES)
    return mesh_ops(counts) * scale, nbytes * scale
