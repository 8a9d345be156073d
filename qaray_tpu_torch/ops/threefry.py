"""The wavefront engine's random draws on the card (kernel H1,
csrc/threefry.cu).

core/rng.py calls these for CUDA tensors; on CPU tensors it runs
core/krng.py's int64 cipher, which stays the plain version, and nothing
here falls back to it:

- fold(k0, k1, data) == krng.fold2(k0, k1, data): the folded key's two
  words as int64 tensors, one launch;
- uniform(k0, k1, n) [B, n] float32 with element (b, j) equal to
  krng.draw_at(k0[b], k1[b], j), one launch; B * n < 2^31, so the flat
  index's high word is 0.

Both launch on the current stream without synchronising, so they capture
under utils/compiled.jit. fold_host and uniform_host run the kernels'
source on the CPU under g++ (_build.load_host), for tests. `launches`
counts H1's launches; `stats` the keys folded (folds) and the floats
drawn (draws).
"""

import torch

from qaray_tpu_torch.core.krng import MASK
from qaray_tpu_torch.ops import _build

launches = {"H1": 0}
stats = {"folds": 0, "draws": 0}

# Elements the uniform kernel covers at most (csrc/threefry.cu
# kMaxElements).
MAX_ELEMENTS = 2**31 - 1

_fns = {}


def _kernels(host: bool = False):
    """(qr_threefry_fold, qr_threefry_uniform) of the CUDA library, or with
    host=True of the same source built for the CPU (tests only)."""
    if host not in _fns:
        lib = (_build.load_host if host else _build.load)("threefry")
        _fns[host] = (_build.bind(lib, "qr_threefry_fold", "plu" * 3 + "lppp"),
                      _build.bind(lib, "qr_threefry_uniform", "ppllpp"))
    return _fns[host]


def fold(k0, k1, data):
    """krng.fold2(k0, k1, data) by H1 on the current stream. Each operand is
    an int, or an int64 CUDA tensor: [B] (B the same for all), or one
    element shared by every lane. Returns two int64 tensors shaped as the
    largest operand."""
    return _fold(k0, k1, data, host=False)


def uniform(k0, k1, n: int):
    """[B, n] float32 by H1 on the current stream: element (b, j) is
    krng.draw_at(k0[b], k1[b], j), flat element j of jax.random.uniform
    under key (k0[b], k1[b]). k0, k1: int64 CUDA tensors [B]; B * n <
    2^31."""
    return _uniform(k0, k1, n, host=False)


def fold_host(k0, k1, data):
    """fold by the kernel's source on the CPU, on CPU tensors (tests; counts
    no launch)."""
    return _fold(k0, k1, data, host=True)


def uniform_host(k0, k1, n: int):
    """uniform by the kernel's source on the CPU, on CPU tensors (tests;
    counts no launch)."""
    return _uniform(k0, k1, n, host=True)


def _device(host: bool, operands):
    tensors = [x for x in operands if isinstance(x, torch.Tensor)]
    if not tensors:
        raise ValueError("H1 needs a tensor among its operands")
    dev = tensors[0].device
    if host != (dev.type == "cpu") or dev.type not in ("cpu", "cuda"):
        raise ValueError(f"H1 takes {'CPU' if host else 'CUDA'} tensors, "
                         f"got {dev}")
    for x in tensors:
        if x.device != dev or x.dtype != torch.int64:
            raise ValueError(f"H1's operands must be int64 on {dev}, got "
                             f"{x.dtype} on {x.device}")
        if not x.is_contiguous():
            raise ValueError("H1's operands must be contiguous")
    return dev, tensors


def _fold(k0, k1, data, host: bool):
    dev, tensors = _device(host, (k0, k1, data))
    shape = torch.broadcast_shapes(*(x.shape for x in tensors))
    n = shape.numel()
    args = []
    for x in (k0, k1, data):
        if isinstance(x, torch.Tensor):
            if x.numel() != 1 and x.shape != shape:
                raise ValueError(f"H1 fold operands of shapes {tuple(x.shape)}"
                                 f" and {tuple(shape)}")
            args += [x.data_ptr(), 0 if x.numel() == 1 else 1, 0]
        else:
            args += [None, 0, int(x) & MASK]
    out0 = torch.empty(shape, dtype=torch.int64, device=dev)
    out1 = torch.empty(shape, dtype=torch.int64, device=dev)
    if n == 0:
        return out0, out1
    fn = _kernels(host)[0]
    stream = None if host else torch.cuda.current_stream(dev).cuda_stream
    _build.check(fn(*args, n, out0.data_ptr(), out1.data_ptr(), stream),
                 "H1 threefry fold")
    if not host:
        launches["H1"] += 1
        stats["folds"] += n
    return out0, out1


def _uniform(k0, k1, n: int, host: bool):
    dev, _ = _device(host, (k0, k1))
    if not isinstance(k0, torch.Tensor) or not isinstance(k1, torch.Tensor):
        raise ValueError("H1 uniform takes key tensors")
    if k0.ndim != 1 or k0.shape != k1.shape:
        raise ValueError(f"H1 uniform takes keys [B], got {tuple(k0.shape)} "
                         f"and {tuple(k1.shape)}")
    lanes = k0.shape[0]
    if n < 0 or lanes * n > MAX_ELEMENTS:
        raise ValueError(f"H1 uniform draws 0 to 2^31 - 1 floats, got "
                         f"{lanes} lanes x {n}")
    out = torch.empty((lanes, n), dtype=torch.float32, device=dev)
    if lanes * n == 0:
        return out
    fn = _kernels(host)[1]
    stream = None if host else torch.cuda.current_stream(dev).cuda_stream
    _build.check(fn(k0.data_ptr(), k1.data_ptr(), lanes, n, out.data_ptr(),
                    stream), "H1 threefry uniform")
    if not host:
        launches["H1"] += 1
        stats["draws"] += lanes * n
    return out
