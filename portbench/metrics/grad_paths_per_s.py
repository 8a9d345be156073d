"""grad_paths_per_s: lanes (paths traced forward and backward) of every
gradient step completed in the window over the window's seconds (host
clock)."""

LAYER, SOURCE, MOVES = None, "host_clock", None


def read(rec, ctx):
    return sum(x["lanes"] for x in rec["items"]) / rec["window_s"]
