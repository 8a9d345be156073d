"""grad_step_busy_ms: device-busy milliseconds (the union of the device
operations' intervals) per gradient step of the profiled stretch."""

from portbench import devtrace

LAYER, SOURCE, MOVES = "gradient", "device_trace", "grad_paths_per_s"


def read(rec, ctx):
    tr = rec["trace"]
    return devtrace.busy_us(tr["trace"]) / 1e3 / tr["steps"]
