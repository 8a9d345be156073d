"""Frame timing with a running average, and the profiler hook.

Counterpart of qaray_tpu/utils/timing.py: the reference's TimeFrame
START/STOP/KILL state machine (renderers/renderer.cpp:41-63), a per-frame
wall clock, a moving average that skips the first frame (kernel builds
here, cold caches there), and the same printed lines. profile() wraps a
block in a torch.profiler trace, with the card's kernels when the render
runs on one.

The JAX package's enable_compile_cache has no counterpart: the port's
kernels are built once into build/kernels/ (ops/_build.py), named by a
digest of their source, and loaded from there on every later run.
"""

from __future__ import annotations

import contextlib
import os
import time


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


@contextlib.contextmanager
def profile(log_dir: str | None, device="cuda"):
    """torch.profiler trace around a block when log_dir is set: host
    activity, and the card's (kernels, copies) when device is a card.
    Writes log_dir/trace.json (Chrome trace format; rank{r}_trace.json in
    a multi-process run)."""
    if not log_dir:
        yield
        return
    import torch

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
