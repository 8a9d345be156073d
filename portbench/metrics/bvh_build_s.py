"""bvh_build_s: host seconds of building and packing the meshes' BVHs in
set-up (the program's span scene.bvh_build in scene/compiler.py, on the
per-instance and the world route)."""

from portbench import progspans

LAYER, SOURCE, MOVES = "scene", "program_span", "setup_s"


def read(rec, ctx):
    return progspans.span_seconds("scene.bvh_build")
