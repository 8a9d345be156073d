"""Build and load the port's CUDA kernels.

Each source in csrc/ is compiled by nvcc into a shared library with a plain
C interface and loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC --fmad=false -Xptxas=-v

on first use, into build/kernels/ at the root of the checkout. A library's
file name carries a digest of its sources and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. All missing libraries are
built together, one nvcc process per source. The libraries are built
without fast math and without FMA contraction: every operation rounds as
the plain PyTorch versions' operations do, which keeps the parity bars
(lanes whose Russian-roulette comparison flips) tight.

Called only by the kernels' wrappers for CUDA tensors; nothing here runs
when the package is imported.

load_host is apart from all that: it compiles a kernel source with g++
against csrc/host/cuda_runtime.h, a stand-in that runs a launch one lane at
a time on the CPU, so that tests without a card can hold the source's
arithmetic to the plain version (ops/megakernel.mega_render_host,
ops/adjoint.adjoint_render_host). No entry point of the port uses it.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
SOURCES = {"adjoint": "adjoint.cu", "analytic": "analytic.cu",
           "megakernel": "megakernel.cu", "mesh": "mesh.cu",
           "photon": "photon.cu", "tiles": "tiles.cu"}
FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas=-v",
]

_libs = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=tuple(SOURCES)) -> dict:
    """Compile every library of `names` not built yet, in parallel.

    Returns {name: nvcc's report} for the libraries built by this call (the
    report holds ptxas's registers, spills and shared memory per kernel)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    if name not in _libs:
        build((name,))
        _libs[name] = ctypes.CDLL(str(_target(name)))
    return _libs[name]


def load_host(name: str) -> ctypes.CDLL:
    """`name`'s source compiled for the CPU by g++ (-O1, no FMA contraction,
    as the card's build has none), loaded; raises RuntimeError without g++
    or for a source that does not go through csrc/host/cuda_runtime.h's
    macros (the megakernel and the adjoint do)."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: no host build of the kernels")
    stub = CSRC / "host"
    h = hashlib.sha256(_target(name).name.encode())
    h.update((stub / "cuda_runtime.h").read_bytes())
    out = BUILD_DIR / f"lib{name}-host-{h.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [gxx, "-x", "c++", "-std=c++17", "-O1", "-ffp-contract=off",
               "-shared", "-fPIC", "-Wno-unknown-pragmas", f"-I{stub}",
               "-o", str(tmp), str(CSRC / SOURCES[name])]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {name}:\n{proc.stderr}")
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))


_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "u": ctypes.c_uint32,
           "f": ctypes.c_float}


def bind(lib: ctypes.CDLL, fname: str, signature: str):
    """Set the C signature of `fname` from a string of argument codes
    (p pointer or stream, i int, u uint32, f float); returns int."""
    fn = getattr(lib, fname)
    fn.argtypes = [_CTYPES[c] for c in signature]
    fn.restype = ctypes.c_int
    return fn


def check(rc: int, what: str):
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
