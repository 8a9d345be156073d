"""Frame timing with a running average, the program's spans, and the
profiler hook.

Counterpart of qaray_tpu/utils/timing.py: the reference's TimeFrame
START/STOP/KILL state machine (renderers/renderer.cpp:41-63), a per-frame
wall clock, a moving average that skips the first frame (kernel builds
here, cold caches there), and the same printed lines. profile() wraps a
block in a torch.profiler trace, with the card's kernels when the render
runs on one.

span(name, id=None) times a part of the program where it runs: its host
seconds and calls add up in `totals` (name -> [seconds, calls]) for the
life of the process, and while a torch.profiler session records, the span
is also a record_function range of that name, so that a trace shows every
device operation under the program span that launched it, on the
profiler's one clock. A span never synchronises the device and reads no
tensor: what it times is the host's part, waits included. Top-level spans
pass their item's id (an image's render count and seed, a gradient step's
number) as the range's args; nested spans belong to their item by
nesting. The spans and the metrics that read them are listed in PERF.md.

The JAX package's enable_compile_cache has no counterpart: the port's
kernels are built once into build/kernels/ (ops/_build.py), named by a
digest of their source, and loaded from there on every later run.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

# Span name -> [host seconds, calls] over the life of the process.
totals = {}

# Whether a torch.profiler session records in this thread (some 0.1 us).
_profiling = torch._C._autograd._profiler_enabled
_now_ns = time.perf_counter_ns


class FrameTimer:
    def __init__(self):
        self.avg = 0.0
        self.num_frames = -1  # don't count the first frame
        self._start = None

    def start(self):
        self._start = time.time()

    def stop(self) -> float:
        elapsed = time.time() - self._start
        print(f"\nElapsed Time is {elapsed:f} s")
        self.num_frames += 1
        if self.num_frames > 0:
            self.avg += (elapsed - self.avg) / self.num_frames
        return elapsed

    def kill(self):
        print(f"\nProgram Ends, Average Frame Time {self.avg:f} s\n")


class span:
    """with span(name, id=None): the block's host time and one call go to
    totals[name]; while the profiler records, the block is also a
    record_function range `name`, with str(id) as its args. After the
    block, .seconds holds its duration."""

    __slots__ = ("name", "id", "seconds", "_t0", "_range")

    def __init__(self, name: str, id=None):
        self.name = name
        self.id = id
        self.seconds = 0.0
        self._range = None

    def __enter__(self):
        if _profiling():
            self._range = torch.profiler.record_function(
                self.name, None if self.id is None else str(self.id))
            self._range.__enter__()
        self._t0 = _now_ns()
        return self

    def __exit__(self, *exc):
        self.seconds = (_now_ns() - self._t0) * 1e-9
        row = totals.get(self.name)
        if row is None:
            totals[self.name] = [self.seconds, 1]
        else:
            row[0] += self.seconds
            row[1] += 1
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        return False


@contextlib.contextmanager
def profile(log_dir: str | None, device="cuda"):
    """torch.profiler trace around a block when log_dir is set: host
    activity, and the card's (kernels, copies) when device is a card.
    Writes log_dir/trace.json (Chrome trace format; rank{r}_trace.json in
    a multi-process run), with the program's spans as ranges."""
    if not log_dir:
        yield
        return
    from qaray_tpu_torch.parallel import distributed

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    name = "trace.json"
    if distributed.process_count() > 1:
        name = f"rank{distributed.process_index()}_trace.json"
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, name))
