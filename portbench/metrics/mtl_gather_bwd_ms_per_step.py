"""mtl_gather_bwd_ms_per_step: device milliseconds a gradient step of the
profiled stretch in the material gather's backward: the records whose
name holds `mtl_gather_bwd` (the program's kernel G1, both passes) or
`indexing_backward` (PyTorch's sort-based backward of an indexing, which
a program without G1 runs there)."""

from portbench import devtrace

LAYER, SOURCE, MOVES = "gradient", "device_trace", "grad_paths_per_s"


def read(rec, ctx):
    tr = rec["trace"]
    us = devtrace.device_us_where(
        tr["trace"], lambda name, span: "mtl_gather_bwd" in name
        or "indexing_backward" in name)
    return us / 1e3 / tr["steps"]
