"""wavefront_ms_per_call: device milliseconds of the operations launched
inside the Renderer's escalated re-render (the benchmark's `escalate`
range, as wavefront_ms_per_image selects them) per escalated re-render
of the profiled stretch (the program's render.escalate spans)."""

from portbench import devtrace, progspans

LAYER, SOURCE, MOVES = "wavefront", "device_trace", "samples_per_s"


def read(rec, ctx):
    tr = rec["trace"]["trace"]
    calls = len(progspans.ranges(tr, "render.escalate"))
    if not calls:
        return None
    us = devtrace.device_us_where(tr, lambda name, span: span == "escalate")
    return us / 1e3 / calls
