"""samples_per_s: camera samples (the frame buffers' counts) of every image
completed in the window over the window's seconds (host clock)."""

LAYER, SOURCE, MOVES = None, "host_clock", None


def read(rec, ctx):
    return sum(x["samples"] for x in rec["items"]) / rec["window_s"]
