"""captures.inverse: CUDA graphs captured during the window
(utils/compiled.stats["captures"]); 0 where set-up warmed up every shape
the window uses."""

LAYER, SOURCE, MOVES = "capture", "program_counter", "grad_paths_per_s"


def read(rec, ctx):
    return rec["counters"]["captures"]
