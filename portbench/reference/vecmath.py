"""Batched 3-vector math on the trailing axis of [..., 3] float32 tensors.

Counterpart of qaray_tpu/core/vecmath.py. Sums over the three components
are written out left to right, ((x + y) + z), the order the CUDA kernels use,
so that the plain versions and the kernels round alike.
"""

import torch

from . import constants


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def normalize(a, eps=0.0):
    """a / |a| along the trailing axis (NaN for zero vectors when eps=0,
    like glm::normalize); eps clamps the squared norm from below."""
    n2 = dot(a, a)[..., None]
    if eps:
        n2 = torch.clamp_min(n2, eps)
    return a * (1.0 / torch.sqrt(n2))


def luma(c):
    """Rec.709 luma; reference math/math.h ColorLuma."""
    return (
        constants.LUMA_R * c[..., 0]
        + constants.LUMA_G * c[..., 1]
        + constants.LUMA_B * c[..., 2]
    )


def to_local_frame(n, sample):
    """Map a tangent-space sample (z-up) onto the frame around normal `n`
    (reference math/math.cpp:37-46; the frame must match bit for bit, since
    a different valid frame changes every sampled direction)."""
    zx, zy, zz = n[..., 0], n[..., 1], n[..., 2]
    use_a = (torch.abs(zx) > torch.abs(zy))[..., None]
    zero = torch.zeros_like(zx)
    ya = torch.stack([zz, zero, -zx], dim=-1)
    yb = torch.stack([zero, -zz, zy], dim=-1)
    y = normalize(torch.where(use_a, ya, yb))
    x = normalize(cross(y, n))
    u = normalize(sample)
    return u[..., 0:1] * x + u[..., 1:2] * y + u[..., 2:3] * n


def pow_safe(base, exponent):
    """x^g for cosine-lobe terms with the base clamped to 1e-6."""
    return torch.pow(torch.clamp_min(base, 1e-6), exponent)
