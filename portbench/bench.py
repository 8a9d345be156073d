"""What every traffic driver of the benchmark shares: the cell's files by
name, the card check, seeds, host spans and counters, the device trace of
a profiled stretch, and the result line.

The benchmark drives the program (qaray_tpu_torch) through its public
entry points and reads only its counters; it never imports the JAX
package or JAX.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

PORTBENCH = Path(__file__).resolve().parent
ROOT = PORTBENCH.parent
# Top-level module names that may not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "qaray_tpu")


class NoCard(RuntimeError):
    """The run needs cards this machine does not have."""


def load_json(kind: str, name: str) -> dict:
    """portbench/<kind>/<name>.json (kind: configs, workloads)."""
    path = PORTBENCH / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is missing")
    return json.loads(path.read_text())


def benchmark_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_metrics(spec: dict, cell: str, kind: str):
    """The entries of spec[kind] ('end_to_end' or 'per_layer') that cell
    reports: those without a workloads list, and those that name it."""
    return [m for m in spec[kind] if cell in m.get("workloads", [cell])]


def load_module(kind: str, name: str):
    """portbench/<kind>/<name>.py as a module (names may hold dots)."""
    path = PORTBENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {name!r}: {path}")
    mod_name = f"portbench_{kind}_{name.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def derive_seed(seed: int, *parts) -> int:
    """A 63-bit seed from the run's seed and more parts (an image index,
    a purpose): the same parts give the same seed."""
    text = ":".join(str(x) for x in (seed,) + parts)
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") >> 1


def require_cards(count: int):
    """Raise NoCard unless torch sees `count` CUDA devices. A run never
    falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard(f"no CUDA card: the cell needs {count} NVIDIA "
                     f"card(s) and torch.cuda.is_available() is false")
    have = torch.cuda.device_count()
    if have < count:
        raise NoCard(f"the cell needs {count} CUDA cards and this machine "
                     f"has {have}")


def forbidden_loaded():
    """Modules of sys.modules whose top-level name is in FORBIDDEN,
    compared whole (qaray_tpu_torch is not qaray_tpu)."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def card_line() -> str:
    """'name, power limit' of the first card, from nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def card_state() -> str:
    """The first card's SM clock, power draw and limit, and temperature."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def percentile(values, q: float) -> float:
    """The q-th percentile (0..100) of values by linear interpolation
    between order statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


class Spans:
    """Host spans by name: seconds and calls, timed by perf_counter. With
    `annotate` each span is also a torch.profiler record_function range,
    so that a device trace can say what the host was doing."""

    def __init__(self):
        self.seconds = {}
        self.calls = {}
        self.annotate = False

    @contextlib.contextmanager
    def span(self, name: str):
        rf = None
        if self.annotate:
            import torch

            rf = torch.profiler.record_function(name)
            rf.__enter__()
        t = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t)
            self.calls[name] = self.calls.get(name, 0) + 1
            if rf is not None:
                rf.__exit__(None, None, None)

    def wrap(self, obj, attr: str, name: str):
        """Time every call of obj.attr as span `name`; returns an undo."""
        fn = getattr(obj, attr)

        def run(*a, **kw):
            with self.span(name):
                return fn(*a, **kw)

        setattr(obj, attr, run)
        return lambda: setattr(obj, attr, fn)

    def reset(self):
        self.seconds.clear()
        self.calls.clear()


def program_counters() -> dict:
    """A flat snapshot of the program's counters: kernel launches of each
    ops module, the wavefront engine's lanes, captures and replays, and the
    mesh's all_gathers (what chip_smoke.py and capture_turns.py read)."""
    from qaray_tpu_torch.integrators import engine
    from qaray_tpu_torch.ops import (
        adjoint,
        analytic,
        bvh_packed,
        megakernel,
        mesh_sweep,
        photon,
        tiles,
    )
    from qaray_tpu_torch.parallel import mesh
    from qaray_tpu_torch.utils import compiled

    out = {}
    for mod in (analytic, megakernel, mesh_sweep, tiles, photon, adjoint,
                bvh_packed):
        for k, v in mod.launches.items():
            out[f"launches.{k}"] = v
    out["wavefront_lanes"] = engine.wavefront_lanes
    out["captures"] = compiled.stats["captures"]
    out["replays"] = compiled.stats["replays"]
    out["capture_s"] = compiled.stats["capture_s"]
    out["all_gathers"] = mesh.stats["all_gathers"]
    out["all_gather_s"] = mesh.stats["all_gather_s"]
    return out


def counter_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, compared: dict, breakdown=None) -> str:
    """The run's last line of standard output: one JSON object with the
    contract's keys, `compared` (each number held against its limit)
    last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = compared
    return json.dumps(out)
