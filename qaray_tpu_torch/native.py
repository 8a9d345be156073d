"""ctypes bindings for the port's native host library.

Counterpart of qaray_tpu/native.py, over the port's own copy of the C++
source (qaray_tpu_torch/native/qaray_native.cpp): the BVH builders (the
numpy builders' trees, node for node), the OBJ parser and the zlib PNG
encoder. On first use the source is compiled with g++ into build/native/
at the root of the checkout (the file name carries a digest of the
source), and loaded. Every entry point returns None (or False) when the
library cannot be built or loaded, and its caller then takes the Python
path, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "native" / "qaray_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "native"
FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

_lib = None
_tried = False
# Why the library did not load (None while it did, or before the first try).
error: Optional[str] = None


def _target() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libqaray_native-{h.hexdigest()[:16]}.so"


def _build(out: Path):
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *FLAGS, "-o", str(tmp), str(SOURCE), "-lz"],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed:\n{proc.stderr}")
    os.replace(tmp, out)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, error
    if _tried:
        return _lib
    _tried = True
    out = _target()
    try:
        if not out.exists():
            _build(out)
        lib = ctypes.CDLL(str(out))
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        error = str(e)
        return None

    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    ip = ctypes.POINTER(ctypes.c_int)
    lib.qn_bvh_build.argtypes = [f32p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ip, ip]
    lib.qn_bvh_build.restype = ctypes.c_int
    lib.qn_bvh_fetch.argtypes = [f32p, i32p, i32p, i32p, i32p]
    lib.qn_bvh_fetch.restype = ctypes.c_int
    lib.qn_png_write.argtypes = [ctypes.c_char_p, u8p, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int]
    lib.qn_png_write.restype = ctypes.c_int
    lib.qn_obj_load.argtypes = [ctypes.c_char_p, ip, ip, ip, ip]
    lib.qn_obj_load.restype = ctypes.c_int
    lib.qn_obj_fetch.argtypes = [f32p, f32p, f32p, i32p, i32p, i32p]
    lib.qn_obj_fetch.restype = ctypes.c_int
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def bvh_build_native(tri_verts: np.ndarray, max_leaf: int,
                     method: str = "sah"):
    """(bounds, left, right, count, elems) of the native build, or None."""
    lib = _load()
    if lib is None:
        return None
    tv = np.ascontiguousarray(tri_verts.reshape(-1, 9), np.float32)
    n_nodes, n_elems = ctypes.c_int(), ctypes.c_int()
    if lib.qn_bvh_build(tv, tv.shape[0], max_leaf, 1 if method == "sah" else 0,
                        ctypes.byref(n_nodes), ctypes.byref(n_elems)) != 0:
        return None
    bounds = np.empty((n_nodes.value, 6), np.float32)
    left = np.empty(n_nodes.value, np.int32)
    right = np.empty(n_nodes.value, np.int32)
    count = np.empty(n_nodes.value, np.int32)
    elems = np.empty(max(n_elems.value, 1), np.int32)
    if lib.qn_bvh_fetch(bounds, left, right, count, elems) != 0:
        return None
    return bounds, left, right, count, elems[:n_elems.value]


def png_write_native(path: str, array: np.ndarray) -> bool:
    """Write `array` ([H, W] grey or [H, W, 3] RGB uint8) as a PNG; False
    where the library is missing or the write failed."""
    lib = _load()
    if lib is None:
        return False
    arr = np.ascontiguousarray(array, np.uint8)
    h, w = arr.shape[:2]
    comps = 1 if arr.ndim == 2 else arr.shape[2]
    return lib.qn_png_write(path.encode(), arr.reshape(-1), w, h, comps) == 0


def obj_load_native(path: str):
    """(v, vn, vt, f_v, f_vt, f_vn) of a triangle OBJ file, or None."""
    lib = _load()
    if lib is None:
        return None
    nv, nvn, nvt, nf = (ctypes.c_int() for _ in range(4))
    if lib.qn_obj_load(path.encode(), ctypes.byref(nv), ctypes.byref(nvn),
                       ctypes.byref(nvt), ctypes.byref(nf)) != 0:
        return None
    v = np.empty((max(nv.value, 1), 3), np.float32)
    vn = np.empty((max(nvn.value, 1), 3), np.float32)
    vt = np.empty((max(nvt.value, 1), 2), np.float32)
    f_v, f_vt, f_vn = (np.empty((max(nf.value, 1), 3), np.int32)
                       for _ in range(3))
    if lib.qn_obj_fetch(v, vn, vt, f_v, f_vt, f_vn) != 0:
        return None
    return (v[:nv.value], vn[:nvn.value], vt[:nvt.value], f_v[:nf.value],
            f_vt[:nf.value], f_vn[:nf.value])
