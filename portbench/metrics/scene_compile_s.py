"""scene_compile_s: host seconds of the program's scene compile in set-up
(the span scene.compile, scene/compiler.compile_scene, which the drivers
call once, in set-up); work it leaves queued on the device is not in it."""

from portbench import progspans

LAYER, SOURCE, MOVES = "scene", "program_span", "setup_s"


def read(rec, ctx):
    return progspans.span_seconds("scene.compile")
