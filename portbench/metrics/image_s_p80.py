"""image_s_p80: the 80th percentile of the image time (render()'s call to
the finalized frame buffer) over every image of the window (host clock):
the highest percentile with some ten images beyond it in a 20 s window of
0.26-0.31 s images."""

from portbench import bench

LAYER, SOURCE, MOVES = None, "host_clock", None


def read(rec, ctx):
    return bench.percentile([x["s"] for x in rec["items"]], 80)
