"""obj_load_s: host seconds of loading the scene's OBJ files in set-up
(the program's span scene.obj_load, around load_obj in
scene/xml_parser.py)."""

from portbench import progspans

LAYER, SOURCE, MOVES = "scene", "program_span", "setup_s"


def read(rec, ctx):
    return progspans.span_seconds("scene.obj_load")
