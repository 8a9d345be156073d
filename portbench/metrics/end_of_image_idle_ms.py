"""end_of_image_idle_ms: device-idle milliseconds inside the program's
render.end spans (render()'s last retire, the accumulator's copy to the
host and finalize): each span's length less the part of it that device
operations cover, per image of the profiled stretch."""

from portbench import progspans

LAYER, SOURCE, MOVES = "renderer", "device_trace", "samples_per_s"


def read(rec, ctx):
    tr = rec["trace"]
    us = progspans.idle_inside_us(tr["trace"], "render.end")
    return None if us is None else us / 1e3 / tr["images"]
