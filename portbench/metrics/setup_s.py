"""setup_s: seconds from the run's start to its window: imports, the card,
kernel builds (first run of a checkout), the scene compile, photon maps,
and the warm-up that captures every graph the window replays (host
clock)."""

LAYER, SOURCE, MOVES = None, "host_clock", None


def read(rec, ctx):
    return rec["setup_s"]
