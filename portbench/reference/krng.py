"""Threefry-2x32-20 on uint32 words held in int64 tensors.

Counterpart of qaray_tpu/core/krng.py. PyTorch has no full uint32
arithmetic, so every word lives in an int64 tensor and is masked back to 32
bits after each add or shift. The functions reproduce jax.random bit for
bit under the partitionable threefry path (the JAX default):

  fold2(k0, k1, d)    == key_data(jax.random.fold_in(key, d))
  draw_at(k0, k1, f)  == jax.random.uniform(key, shape) flat element f
                         (bits = w0 ^ w1 of cipher(key, hi(f), lo(f)))

The CUDA kernels carry the same cipher on native uint32 (csrc/threefry.cuh).
"""

import torch

from . import precision as PR

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) & MASK) | (x >> (32 - r))


def cipher2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds. All args int64 tensors (or ints) holding
    uint32 values; broadcasting applies. Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def as_word(data):
    """Any integer tensor -> int64 holding its uint32 bit pattern (an int32
    wraps exactly as jnp.asarray(data, uint32) does in jax's fold_in)."""
    return data.to(torch.int64) & MASK


def fold2(k0, k1, data):
    """jax.random.fold_in for threefry keys, on raw words."""
    data = as_word(data)
    return cipher2x32(k0, k1, torch.zeros_like(data), data)


def u01(bits):
    """uint32 bits -> float32 uniform in [0, 1): the mantissa trick of
    jax.random.uniform, ((bits >> 9) | 0x3F800000) viewed as f32, minus 1."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return (f - 1.0).to(PR.dtype())


def draw_at(k0, k1, f):
    """Flat element(s) `f` of jax.random.uniform(key, shape). `f` is an int
    or an int64 tensor broadcastable against the keys."""
    w0, w1 = cipher2x32(k0, k1, f >> 32, f & MASK)
    return u01(w0 ^ w1)
