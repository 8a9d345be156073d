"""What the readers of the program's own spans and counters share.

The program (qaray_tpu_torch) times its parts with utils/timing.span: host
seconds and calls in `timing.totals`, and, while torch.profiler records,
a record_function range of the span's name, which the device trace holds
beside the benchmark's own ranges (devtrace.parse keeps both as
annotations). Its counters are module dicts, renderer.stats (the escalated
re-renders' lanes), and the calls of each span in `timing.totals`
(grad.fast and grad.autograd: the gradient steps by route).

A program without a span or counter (an older commit) gives None here, and
the metric is left out of the result line.
"""

from __future__ import annotations

import bisect
import importlib


def ranges(trace, name: str):
    """(start_us, end_us) of the trace's ranges named `name`."""
    return [(ts, ts + dur) for n, ts, dur in trace["annotations"]
            if n == name]


def merged(trace):
    """The device operations' intervals merged into sorted disjoint
    (start, end) intervals."""
    out = []
    for _, ts, dur, _ in sorted(trace["kernels"], key=lambda k: k[1]):
        s, e = ts, ts + dur
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_within(busy, a: float, b: float) -> float:
    """Length of [a, b] that the merged intervals `busy` cover."""
    starts = [s for s, _ in busy]
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    total = 0.0
    while i < len(busy) and busy[i][0] < b:
        s, e = busy[i]
        total += max(0.0, min(e, b) - max(s, a))
        i += 1
    return total


def idle_inside_us(trace, name: str):
    """Device-idle microseconds inside the ranges named `name`: each
    range's length less the part of it some device operation covers.
    None where the trace has no such range."""
    spans = ranges(trace, name)
    if not spans:
        return None
    busy = merged(trace)
    return sum((b - a) - busy_within(busy, a, b) for a, b in spans)


def counter(module: str, key: str):
    """The program's counter `key` of the dict `stats` of `module` (a
    module of qaray_tpu_torch), or None where it has none."""
    mod = importlib.import_module(f"qaray_tpu_torch.{module}")
    return getattr(mod, "stats", {}).get(key)


def _span_row(name: str):
    from qaray_tpu_torch.utils import timing

    return getattr(timing, "totals", {}).get(name)


def span_seconds(name: str):
    """Host seconds of the program's span `name` over the process so far
    (utils/timing.totals), or None where the program has no such span or
    never ran it."""
    row = _span_row(name)
    return None if row is None else row[0]


def span_calls(name: str) -> int:
    """Calls of the program's span `name` over the process so far; 0 where
    the program has no such span or never ran it."""
    row = _span_row(name)
    return 0 if row is None else row[1]
