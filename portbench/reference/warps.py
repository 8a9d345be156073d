"""Sampling warps driven by explicit uniforms.

Counterpart of qaray_tpu/core/warps.py (reference core/sampler.cpp:42-167),
including the reference's UniformBall quirk (r2 used for both y and z) and
its rejection loops re-expressed as a fixed number of attempts.
"""

import math

import torch

TWO_PI = 2.0 * math.pi


def _polar(cos_t, sin_t, phi):
    return torch.stack(
        [sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1
    )


def uniform_sphere(u):
    """u: [..., 2] uniforms -> unit vectors [..., 3]. PDF = 1/4pi."""
    r1 = u[..., 0] * 2.0 - 1.0
    sin_t = torch.sqrt(torch.clamp_min(1.0 - r1 * r1, 0.0))
    return _polar(r1, sin_t, TWO_PI * u[..., 1])


def uniform_hemisphere(u):
    """PDF = 1/2pi (z-up)."""
    cos_t = u[..., 0]
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    return _polar(cos_t, sin_t, TWO_PI * u[..., 1])


def cos_weighted_hemisphere(u):
    """PDF = cos(theta)/pi (z-up)."""
    cos_t = torch.sqrt(u[..., 0])
    sin_t = torch.sqrt(torch.clamp_min(1.0 - u[..., 0], 0.0))
    return _polar(cos_t, sin_t, TWO_PI * u[..., 1])


def cos_lobe_weighted_hemisphere(u, n):
    """PDF = (n+1) cos^n(theta) / 2pi."""
    cos_t = torch.pow(u[..., 0], 1.0 / (n + 1.0))
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    return _polar(cos_t, sin_t, TWO_PI * u[..., 1])


def _per_lane(radius, ndim):
    if torch.is_tensor(radius) and radius.ndim:
        return radius.reshape(radius.shape + (1,) * (ndim - radius.ndim))
    return radius


def uniform_ball(u3, radius):
    """Exactly uniform in a ball of `radius` (polar method). u3: [..., 3]."""
    d = uniform_sphere(u3[..., :2])
    r = torch.pow(u3[..., 2], 1.0 / 3.0)
    return d * (r[..., None] * _per_lane(radius, d.ndim))


def uniform_ball_ref(u_attempts, radius):
    """Reference-quirk UniformBall with A attempts: u [..., A, 2] -> [..., 3].

    The first in-ball attempt (x = r1, y = z = r2) wins; if all miss, the
    last attempt is radially clamped into the ball.
    """
    r1 = u_attempts[..., 0] * 2.0 - 1.0
    r2 = u_attempts[..., 1] * 2.0 - 1.0
    p = torch.stack([r1, r2, r2], dim=-1)
    norm = torch.sqrt(p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1]
                      + p[..., 2] * p[..., 2])
    num_a = u_attempts.shape[-2]
    idx = torch.arange(num_a, device=u_attempts.device)
    first = torch.where(norm <= 1.0, idx, num_a - 1).amin(dim=-1)
    index = first[..., None, None].expand(first.shape + (1, 3))
    pick = torch.gather(p, -2, index)[..., 0, :]
    pick_norm = torch.sqrt(
        pick[..., 0:1] * pick[..., 0:1] + pick[..., 1:2] * pick[..., 1:2]
        + pick[..., 2:3] * pick[..., 2:3]
    )
    pick = torch.where(pick_norm > 1.0,
                       pick / torch.clamp_min(pick_norm, 1e-12), pick)
    return pick * _per_lane(radius, pick.ndim)


def concentric_disc(u, radius):
    """DoF lens sample: r = R*sqrt(u1), t = 2pi*u2 (scene/scene.cpp:104-111)."""
    r = radius * torch.sqrt(u[..., 0])
    t = TWO_PI * u[..., 1]
    return torch.stack([r * torch.cos(t), r * torch.sin(t)], dim=-1)
