"""Texture sampling from the flat atlas.

Counterpart of qaray_tpu/ops/texture.py: bilinear tiled file sampling with
v-flip (textures/texture.cpp:97-125), the procedural checker
(texture.cpp:129-137), the uvw TextureMap transform (core/texture.cpp:67-82),
TexturedColor = color * map (core/texture.cpp:95-105), the environment
mapping (core/texture.cpp:107-114) and the reference's 32-sample elliptic
footprint filter (core/texture.cpp:32-52), driven by the primary rays'
differentials (ops/trace.py); secondary hits point-sample.

Plain tensor code, as in the JAX package, on whatever device the tensors
lie. It is also the plain version of the checker sampling that the
megakernel does itself (K1b, csrc/megakernel.cu): the transform and the
footprint positions are written out in the kernel's operation order, since
a checker flips at frac == 0.5 and a last-bit difference changes a whole
colour.
"""

import math

import numpy as np
import torch

from .constants import TEXTURE_SAMPLE_COUNT
from .halton import halton_np
from .arrays import TEX_CHECKER, TextureAtlas


def _tile_clamp(u):
    """Wrap to [0,1) (Texture::TileClamp, core/texture.cpp:53-63)."""
    return u - torch.floor(u)


def _transform(tex_m, x):
    """tex_m [B,3,3] @ x [B,3], each row summed left to right."""
    return torch.stack(
        [tex_m[..., i, 0] * x[..., 0] + tex_m[..., i, 1] * x[..., 1]
         + tex_m[..., i, 2] * x[..., 2] for i in range(3)], dim=-1)


def sample_file_texture(atlas: TextureAtlas, tex_id, uvw):
    """Bilinear tiled sample of file textures. tex_id [B], uvw [B,3] ->
    [B,3]."""
    tid = tex_id.clamp_min(0).long()
    w = atlas.width[tid]
    h = atlas.height[tid]
    off = atlas.offset[tid].long()
    # v-flip then tile (TextureFile::Sample).
    u = _tile_clamp(uvw[..., 0])
    v = _tile_clamp(1.0 - uvw[..., 1])
    x = w.to(torch.float32) * u
    y = h.to(torch.float32) * v
    ix = torch.floor(x).to(torch.int32)
    iy = torch.floor(y).to(torch.int32)
    fx = (x - ix.to(torch.float32))[..., None]
    fy = (y - iy.to(torch.float32))[..., None]
    w_safe = w.clamp_min(1)
    h_safe = h.clamp_min(1)
    ix = torch.minimum(ix.clamp_min(0), w_safe - 1)
    iy = torch.minimum(iy.clamp_min(0), h_safe - 1)
    ixp = torch.where(ix + 1 >= w_safe, 0, ix + 1)
    iyp = torch.where(iy + 1 >= h_safe, 0, iy + 1)

    def texel(yy, xx):
        return atlas.texels[off + (yy * w_safe + xx).long()]

    return (texel(iy, ix) * (1 - fx) * (1 - fy)
            + texel(iy, ixp) * fx * (1 - fy)
            + texel(iyp, ix) * (1 - fx) * fy
            + texel(iyp, ixp) * fx * fy)


def sample_checker(atlas: TextureAtlas, tex_id, uvw):
    """TextureChecker::Sample (textures/texture.cpp:129-137)."""
    tid = tex_id.clamp_min(0).long()
    u = _tile_clamp(uvw[..., 0])
    v = _tile_clamp(uvw[..., 1])
    take1 = (u <= 0.5) == (v <= 0.5)
    return torch.where(take1[..., None], atlas.color1[tid], atlas.color2[tid])


def sample_texture(atlas: TextureAtlas, tex_id, uvw):
    """Dispatch by texture kind; tex_id -1 lanes return 0 (caller masks)."""
    tid = tex_id.clamp_min(0).long()
    is_checker = atlas.kind[tid] == TEX_CHECKER
    if atlas.texels.shape[0] == 1:  # only the pad texel: no file texture
        c = sample_checker(atlas, tex_id, uvw)
    else:
        c = torch.where(is_checker[..., None],
                        sample_checker(atlas, tex_id, uvw),
                        sample_file_texture(atlas, tex_id, uvw))
    return torch.where((tex_id >= 0)[..., None], c, torch.zeros_like(c))


def sample_textured_color(atlas, color, tex_id, tex_m, tex_t, uvw,
                          has_texture):
    """TexturedColor::Sample: color * map.Sample(TransformTo(uvw)).

    color [B,3], tex_id [B], tex_m [B,3,3], tex_t [B,3], uvw [B,3]. Lanes
    without a hit texture coordinate (has_texture False) or without a map
    return the flat color (core/texture.cpp:95-105)."""
    tex = sample_texture(atlas, tex_id, _transform(tex_m, uvw - tex_t))
    use_tex = (tex_id >= 0) & has_texture
    return torch.where(use_tex[..., None], color * tex, color)


def elliptic_offsets_np():
    """The 31 static Halton(2,3) elliptic footprint offsets as float32
    numpy arrays (xs, ys) (core/texture.cpp:38-44, TEXTURE_SAMPLE_COUNT =
    32; sample 0 is the centre, handled apart). K1b reads the same 62
    floats from constant memory."""
    i = np.arange(1, TEXTURE_SAMPLE_COUNT)
    hx = halton_np(i, 2)
    hy = halton_np(i, 3)
    r = np.sqrt(hx) * 0.5
    x = r * np.sin(hy * 2.0 * np.pi)
    y = r * np.cos(hy * 2.0 * np.pi)
    return x.astype(np.float32), y.astype(np.float32)


_offsets = {}


def _elliptic_offsets(device):
    """elliptic_offsets_np on `device`, copied there once: a copy from the
    host would stall the stream and could not be captured."""
    key = str(device)
    if key not in _offsets:
        xs, ys = elliptic_offsets_np()
        _offsets[key] = (torch.as_tensor(xs, device=device),
                         torch.as_tensor(ys, device=device))
    return _offsets[key]


def sample_textured_color_filtered(atlas, color, tex_id, tex_m, tex_t, uvw,
                                   duvw0, duvw1, has_texture):
    """TexturedColor::Sample with the elliptic footprint filter
    (core/texture.cpp:32-52 and the TextureMap duvw transform at :67-82).

    duvw0/duvw1: d(uvw)/d(pixel) in pre-transform uv space, [B, 3]. Lanes
    with a zero footprint reduce to the point sample (the reference's early
    out)."""
    u = _transform(tex_m, uvw - tex_t)
    d0 = _transform(tex_m, duvw0)
    d1 = _transform(tex_m, duvw1)
    xs, ys = _elliptic_offsets(u.device)
    # [B, 31, 3] footprint sample positions.
    pos = (u[:, None, :] + xs[None, :, None] * d0[:, None, :]
           + ys[None, :, None] * d1[:, None, :])
    num = u.shape[0]
    k = TEXTURE_SAMPLE_COUNT - 1
    samples = sample_texture(atlas, tex_id.repeat_interleave(k),
                             pos.reshape(num * k, 3)).reshape(num, k, 3)
    center = sample_texture(atlas, tex_id, u)
    filtered = (center + samples.sum(dim=1)) / float(TEXTURE_SAMPLE_COUNT)
    zero_fp = ((d0 * d0).sum(dim=-1) + (d1 * d1).sum(dim=-1)) == 0.0
    tex = torch.where(zero_fp[:, None], center, filtered)
    use_tex = (tex_id >= 0) & has_texture
    return torch.where(use_tex[:, None], color * tex, color)


def sample_environment(atlas, env, d):
    """TexturedColor::SampleEnvironment (core/texture.cpp:107-114).

    env: EnvColor; d [B,3] (unit ray direction). Returns [B,3]."""
    z = torch.asin(torch.clamp(-d[..., 2], -1.0, 1.0)) / math.pi + 0.5
    denom = torch.abs(d[..., 0]) + torch.abs(d[..., 1])
    denom = torch.where(denom < 1e-20, torch.full_like(denom, 1e-20), denom)
    x = d[..., 0] / denom
    y = d[..., 1] / denom
    u = 0.5 + z * (x * 0.5 - y * 0.5)
    v = 0.5 + z * (x * 0.5 + y * 0.5)
    return _env_sample_at(atlas, env,
                          torch.stack([u, v, torch.zeros_like(u)], dim=-1))


def sample_background(atlas, env, uvw):
    """Background sampled with screen-space uv (renderer.cpp:335-339)."""
    return _env_sample_at(atlas, env, uvw)


def _env_sample_at(atlas, env, uvw):
    num = uvw.shape[0]
    return sample_textured_color(
        atlas, env.color.expand(num, 3), env.tex_id.expand(num),
        env.tex_m.expand(num, 3, 3), env.tex_t.expand(num, 3), uvw,
        torch.ones(num, dtype=torch.bool, device=uvw.device))
