"""The device trace of a profiled stretch, and the arithmetic on it.

A stretch of whole images or steps runs under torch.profiler (CPU and CUDA
activity), with the benchmark's host spans as record_function ranges. The
chrome trace it exports is read back into plain lists:

    kernels      (name, start_us, dur_us, host span at launch)
    annotations  (name, start_us, dur_us) of the host spans

From them: the union of the device intervals (busy), the idle share of the
stretch, device time by operation and by host span, and the longest idle
gaps labelled by the host span open when each began. The idle-share
arithmetic is that of qaray_tpu_torch/tools/capture_turns.py (1 - busy /
wall), with busy the union of the intervals instead of their sum.

The profiler can lose or misplace device records in a process that has
made many CUDA graphs (a short session first takes that loss), so the
caller holds the records kept against the program's launch counters
(kept_launches) and fails rather than reports where they differ.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def flush_profiler():
    """A short profiler session with a few small kernels: in a process
    that has just made CUDA graphs the profiler loses device records of
    its next session, and this one takes that loss."""
    import torch

    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        x = torch.zeros(1, device="cuda")
        for _ in range(4):
            x = x + 1
        torch.cuda.synchronize()


def profile(fn, spans):
    """Run fn() under torch.profiler with spans annotated; returns (fn's
    result, the parsed trace)."""
    import torch

    flush_profiler()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    spans.annotate = True
    try:
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("stretch"):
                out = fn()
                torch.cuda.synchronize()
    finally:
        spans.annotate = False
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return out, parse(events)


def parse(events):
    """Chrome trace events -> {kernels, annotations, stretch}: device
    operations with the host span open when they were launched, the
    record_function ranges, and the 'stretch' range's (start, end)."""
    annotations, launches, device = [], {}, []
    stretch = None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat == "user_annotation":
            if e["name"] == "stretch":
                stretch = (ts, ts + dur)
            else:
                annotations.append((e["name"], ts, dur))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = ts
        elif cat in DEVICE_CATS:
            corr = (e.get("args") or {}).get("correlation")
            device.append((e["name"], ts, dur, corr))
    annotations.sort(key=lambda a: a[1])
    starts = [a[1] for a in annotations]
    label = {}
    kernels = []
    for name, ts, dur, corr in device:
        if corr not in label:
            label[corr] = span_at(annotations, launches.get(corr), starts)
        kernels.append((name, ts, dur, label[corr]))
    kernels.sort(key=lambda k: k[1])
    if stretch is None and kernels:
        stretch = (kernels[0][1], max(k[1] + k[2] for k in kernels))
    return {"kernels": kernels, "annotations": annotations,
            "stretch": stretch}


def span_at(annotations, t, starts=None):
    """The innermost annotation open at host time t ('other' if none):
    of those that hold t, the one that began last. annotations sorted by
    start; starts, their starts."""
    if t is None:
        return "other"
    if starts is None:
        starts = [a[1] for a in annotations]
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        name, ts, dur = annotations[i]
        if t <= ts + dur:
            return name
        i -= 1
    return "other"


def union(intervals):
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def busy_us(trace) -> float:
    """The union of the device intervals, clipped to the stretch."""
    s0, s1 = trace["stretch"]
    return union((max(ts, s0), min(ts + dur, s1))
                 for _, ts, dur, _ in trace["kernels"]
                 if ts + dur > s0 and ts < s1)


def window_us(trace) -> float:
    s, e = trace["stretch"]
    return e - s


def idle_share(trace) -> float:
    """1 - (union of the device intervals) / (the stretch's length)."""
    return 1.0 - busy_us(trace) / window_us(trace)


def summary(trace) -> dict:
    """The busy and window microseconds of a trace (what a rank sends)."""
    return {"busy_us": busy_us(trace), "window_us": window_us(trace)}


def rank_summaries(rec):
    """summary() of every rank's trace of a run's record (one rank: its
    own trace)."""
    return rec.get("rank_traces") or [summary(rec["trace"]["trace"])]


def device_us_where(trace, keep) -> float:
    """Summed device time of the operations keep(name, span) selects."""
    return sum(dur for name, _, dur, span in trace["kernels"]
               if keep(name, span))


def top_ops(trace, n=10):
    """[[name, seconds]] of the n operations that took most device time."""
    by = {}
    for name, _, dur, _ in trace["kernels"]:
        by[name] = by.get(name, 0.0) + dur
    top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:200], us / 1e6] for name, us in top]


def idle_gaps(trace, n=10):
    """[[host span at the gap's middle, seconds]] of the n longest gaps
    between device operations inside the stretch (the stretch's start and
    end count as edges): what the host was doing while the device
    waited."""
    s0, s1 = trace["stretch"]
    ivs = sorted((ts, ts + dur) for _, ts, dur, _ in trace["kernels"])
    gaps, cur = [], s0
    for s, e in ivs:
        if s > cur:
            gaps.append((s - cur, 0.5 * (s + cur)))
        cur = max(cur, e)
    if s1 > cur:
        gaps.append((s1 - cur, 0.5 * (s1 + cur)))
    gaps.sort(key=lambda g: -g[0])
    starts = [a[1] for a in trace["annotations"]]
    return [[span_at(trace["annotations"], t, starts), us / 1e6]
            for us, t in gaps[:n]]


def kept_launches(trace, name_part: str) -> int:
    """Device records whose name holds name_part."""
    return sum(1 for name, *_ in trace["kernels"] if name_part in name)
