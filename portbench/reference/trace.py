"""Closest-hit and any-hit tracing over a ray batch of analytic primitives
(spheres and planes), in plain torch.

A frozen copy of the program's plain route for scenes without meshes
(reference scene/scene.cpp:35-76): every ray is tested against every
primitive, the winner's attributes are evaluated once.

Hit record (dict of [B]-shaped tensors):
    t         world-space hit distance (BIGFLOAT if miss)
    hit       bool
    p         world hit position (at t = 1 on a miss: stays finite)
    n         world shading normal (unit)
    uvw       texture coordinates
    front     front-face flag
    mtl       material table index
    has_texture
    duvw0, duvw1  texture footprints d(uvw)/d(pixel), only with `diff`
"""

import torch

from . import intersect as I
from .arrays import SceneArrays, SceneMeta
from .constants import BIGFLOAT

_KEYS = ("p", "n", "uvw", "front", "mtl", "has_texture")


def trace_closest(scene: SceneArrays, meta: SceneMeta, p, d, diff=None):
    """Closest-hit trace of B world-space rays; diff: optional (px, dx, py,
    dy) differential rays, which add the winner's texture footprints."""
    if meta.num_mesh_instances:
        raise ValueError("the reference traces analytic primitives only")
    t, idx = I.closest_analytic(p, d, scene.analytic)
    t_attr = torch.where(t < BIGFLOAT, t, torch.ones_like(t))
    full = I.analytic_hit_attrs(p, d, t_attr, idx, scene.analytic)
    attrs = {k: full[k] for k in _KEYS}
    if meta.num_analytic == 0:  # only the compiler's placeholder primitive
        t = torch.full_like(t, BIGFLOAT)
    hit = t < BIGFLOAT
    t_attr = torch.where(hit, t, torch.ones_like(t))
    if diff is not None:
        d0, d1 = I.analytic_diff_uv(p, d, *diff, t_attr, idx, scene.analytic,
                                    attrs["uvw"])
        attrs["duvw0"] = d0
        attrs["duvw1"] = d1
    attrs["t"] = t
    attrs["hit"] = hit
    return attrs


def trace_shadow(scene: SceneArrays, meta: SceneMeta, p, d, t_max):
    """Any-hit occlusion: True where something blocks with BIAS < t < t_max
    (GenLight::Shadow, lights/lights.cpp:39-48; both sides count)."""
    if meta.num_analytic == 0:
        return torch.zeros(p.shape[0], dtype=torch.bool, device=p.device)
    t_all = I.intersect_analytic_t(p, d, scene.analytic)
    return (t_all < t_max[:, None]).any(dim=-1)
