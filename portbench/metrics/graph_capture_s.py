"""graph_capture_s: host seconds of the CUDA graphs' warm-ups and captures
in set-up (the program's spans `capture`, utils/compiled.Compiled._capture,
less those of the window and of the profiled stretch, which capture
none where set-up warmed every shape: captures.* read 0)."""

from portbench import progspans

LAYER, SOURCE, MOVES = "capture", "program_span", "setup_s"


def read(rec, ctx):
    total = progspans.span_seconds("capture")
    if total is None:
        return None
    return (total - rec["counters"]["capture_s"]
            - rec["trace"]["counters"]["capture_s"])
