"""host_ms_per_dispatch: the host's milliseconds to enqueue one dispatch
and its fold (the benchmark's perf_counter spans around Renderer._dispatch
and the device folds, which wait for nothing on the device) over the
window's dispatches; the event waits in Renderer._read, the escalated
re-render and the end-of-image reads are outside these spans."""

LAYER, SOURCE, MOVES = "renderer", "program_span", "samples_per_s"


def read(rec, ctx):
    sec, calls = rec["host"]["seconds"], rec["host"]["calls"]
    n = calls.get("dispatch", 0)
    if not n:
        return None
    return 1e3 * (sec.get("dispatch", 0.0) + sec.get("fold", 0.0)) / n
