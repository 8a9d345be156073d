"""The least float32 operations and bytes of a path-traced sample, from
the work its path takes, and the H100's published peaks (peaks.json).

Operations are counted as the arithmetic the mathematics needs (add, sub,
mul, div, sqrt; compares, selects and integer work such as the threefry
cipher are not counted), on the paths that the plain reference's own
replay of a fixed subset of lanes takes (reference/work.py): its
closest-hit rays, shading vertices and shadow rays over alive lanes. A
kernel that does less than this count would not compute the image, so
the time it gives is a floor. Bytes: each lane writes its radiance and
depth (16 B); the scene's tables are a few hundred bytes and read once.
Photon gathers are left out of the count (the caustics cell's share is
then lower than its kernel's true share).
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json")
                   .read_text())

# Float32 operations of each piece of work.
RAY_TO_OBJECT = 33   # p' = M (p - t): 3 + 9 + 6; d' = M d: 9 + 6
SPHERE_TEST = 24     # b = o.d 5, c = o.o - 1 6, a = d.d 5, b^2 - ac 3,
#                      sqrt 1, two roots 4
PLANE_TEST = 5       # t = -o.z / d.z 1, hit x and y 4
HIT_ATTRS = 30       # hit point 6, object normal to world and normalised 24
CAMERA_RAY = 46      # screen point 12, lens disc and origin 22,
#                      direction normalised 12
SHADE_VERTEX = 150   # Fresnel 30, lobe lumas 15, one light's Blinn term 50,
#                      continuation sample 40, throughput 15
SHADOW_SAMPLE = 33   # ball sample 10, vector, distance and direction 12,
#                      falloff 6, the soft-shadow recurrence 5
LANE_BYTES = 16      # radiance (3 x float32) and depth written


def prim_test_ops(spheres: int, planes: int) -> int:
    """One ray against every primitive (closest or any hit)."""
    return (spheres * (RAY_TO_OBJECT + SPHERE_TEST)
            + planes * (RAY_TO_OBJECT + PLANE_TEST))


def path_ops(counts: dict, spheres: int, planes: int) -> float:
    """Operations of the work in `counts` (reference/work.py's keys:
    lanes, closest_rays, vertices, shadow_rays)."""
    tests = prim_test_ops(spheres, planes)
    return (counts["lanes"] * CAMERA_RAY
            + counts["closest_rays"] * (tests + HIT_ATTRS)
            + counts["vertices"] * SHADE_VERTEX
            + counts["shadow_rays"] * (tests + SHADOW_SAMPLE))


def least_seconds(ops: float, nbytes: float):
    """(the least seconds of ops and nbytes on the card, which bound sets
    it: 'operations' or 'bytes')."""
    t_ops = ops / PEAKS["float32_ops_per_s"]
    t_bytes = nbytes / PEAKS["hbm_bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
