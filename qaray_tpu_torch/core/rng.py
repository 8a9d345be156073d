"""Deterministic counter-based RNG for the wavefront engine.

Counterpart of qaray_tpu/core/rng.py. A batch of keys is a pair (k0, k1) of
int64 tensors [B] holding threefry-2x32 key words; every draw is a pure
function of (key, purpose tag, flat element), so a lane's stream does not
depend on the batch it runs in. With threefry key words the draws equal
jax.random's bit for bit (core/krng.py).

ray_keys, fold and uniform run the cipher where their tensors are: on CUDA
tensors as kernel H1 (ops/threefry.py), one launch a fold or a draw; on
CPU tensors as core/krng.py's int64 code, the plain version H1 equals bit
for bit.
"""

import math

import torch

from qaray_tpu_torch.core.krng import MASK, draw_at, fold2
from qaray_tpu_torch.ops import threefry

# Purpose tags (the JAX package's values).
P_LOBE_SELECT = 0
P_LOBE_SAMPLE = 1
P_DOF = 2
P_SHADOW = 3
P_PHOTON_EMIT = 4
P_PIXEL = 5
P_LIGHT_SELECT = 6
P_GLOSSY = 7


def key_words(rng_impl: str, seed: int):
    """Key data of jax.random.key(seed, impl=rng_impl) as words.

    threefry2x32 -> [seed >> 32, seed & 0xFFFFFFFF] (also the words of
    jax.random.PRNGKey(seed)); rbg -> [0, s, 0, s]. The four rbg words
    xor-fold to (0, 0) for every seed on the way into the draws
    (fold_words), so an rbg render does not depend on the seed: this
    matches the reference's megakernel path on purpose."""
    hi, lo = (seed >> 32) & MASK, seed & MASK
    if rng_impl == "threefry2x32":
        return (hi, lo)
    if rng_impl == "rbg":
        return (0, lo, 0, lo)
    raise ValueError(f"unknown rng_impl {rng_impl!r}")


def fold_words(key_words):
    """Base key words -> the two threefry words every draw starts from.

    Two words (a threefry2x32 key) pass through. Four words (the key data
    of a jax 'rbg' key, [0, s, 0, s] for seed s) xor-fold to two, as
    qaray_tpu/ops/pallas_pathtrace.py::_fold_words does: (0^0, s^s) = (0, 0)
    for every seed, so under 'rbg' the seed has no effect on the image.
    This matches the reference's megakernel path on purpose.
    """
    w = [int(x) & MASK for x in key_words]
    if len(w) == 4:
        return w[0] ^ w[2], w[1] ^ w[3]
    if len(w) != 2:
        raise ValueError(f"expected 2 or 4 key words, got {len(w)}")
    return w[0], w[1]


def ray_keys(base_words, ray_ids):
    """Per-ray keys fold_in(base, ray_id) from an integer id tensor [B]; the
    base words are ints or one-element tensors on the ids' device."""
    b0, b1 = base_words
    if ray_ids.is_cuda:
        return threefry.fold(b0, b1, ray_ids.to(torch.int64))
    return fold2(b0, b1, ray_ids)


def fold(keys, tag):
    """Fold an int (or an int tensor [B]) tag into a batch of keys."""
    k0, k1 = keys
    if k0.is_cuda:
        if isinstance(tag, torch.Tensor):
            tag = tag.to(torch.int64)
        return threefry.fold(k0, k1, tag)
    if isinstance(tag, int):
        tag = torch.full(k0.shape, tag, dtype=torch.int64, device=k0.device)
    return fold2(k0, k1, tag)


def uniform(keys, shape_suffix=()):
    """jax.random.uniform(key, shape_suffix) per key: [B] -> [B, *suffix]."""
    k0, k1 = keys
    n = math.prod(shape_suffix)
    if k0.is_cuda:
        return threefry.uniform(k0, k1, n).reshape(k0.shape
                                                   + tuple(shape_suffix))
    if not shape_suffix:
        return draw_at(k0, k1, 0)
    f = torch.arange(n, dtype=torch.int64, device=k0.device)
    u = draw_at(k0[:, None], k1[:, None], f[None, :])
    return u.reshape(k0.shape + tuple(shape_suffix))
