"""wavefront_ms_per_image: device milliseconds of the operations launched
inside the Renderer's escalated re-render (Renderer._render_escalated, the
wavefront engine's exact gathers) per image of the profiled stretch."""

from portbench import devtrace

LAYER, SOURCE, MOVES = "wavefront", "device_trace", "samples_per_s"


def read(rec, ctx):
    tr = rec["trace"]
    us = devtrace.device_us_where(tr["trace"],
                                  lambda name, span: span == "escalate")
    return us / 1e3 / tr["images"]
