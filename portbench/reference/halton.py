"""Vectorized Halton / radical-inverse sequences.

Counterpart of qaray_tpu/core/halton.py: Halton(s, 11)/Halton(s, 13) give
the sub-pixel jitter (reference scene/scene.cpp:99-102).
"""

import numpy as np
import torch

from . import precision as PR


def halton_np(index, base):
    """NumPy host-side radical inverse; `index` may be an int or array."""
    index = np.asarray(index, dtype=np.int64)
    r = np.zeros(index.shape, dtype=np.float64)
    f = np.full(index.shape, 1.0 / base, dtype=np.float64)
    i = index.copy()
    while np.any(i > 0):
        r = r + f * (i % base)
        f = f / base
        i = i // base
    return r.astype(np.float32)


def halton(index, base: int, num_iters=None):
    """Float32 radical inverse of a non-negative int tensor."""
    i = index.to(torch.int32)
    if num_iters is None:
        # Digits enough for indices up to 2^31 (10 for bases 11 and 13).
        num_iters = int(np.ceil(31 / np.log2(base))) + 1
    r = torch.zeros(i.shape, dtype=PR.dtype(), device=i.device)
    f = torch.full(i.shape, 1.0 / base, dtype=PR.dtype(), device=i.device)
    for _ in range(num_iters):
        r = r + f * (i % base).to(PR.dtype())
        f = f / base
        i = i // base
    return r
