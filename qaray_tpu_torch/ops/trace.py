"""Scene-level closest-hit and any-hit tracing over a ray batch.

Counterpart of the analytic branches of qaray_tpu/ops/trace.py
(trace_closest / trace_shadow, reference scene/scene.cpp:35-76). On CUDA
tensors they run the analytic kernels K2b and K2c (ops/analytic.py); on
the CPU their plain versions. Meshes arrive with the mesh slice.

Hit record (dict of [B]-shaped tensors):
    t         world-space hit distance (BIGFLOAT if miss)
    hit       bool
    p         world hit position (at t = 1 on a miss: stays finite)
    n         world shading normal (unit)
    uvw       texture coordinates
    front     front-face flag
    mtl       material table index
    has_texture
"""

import torch

from qaray_tpu_torch.core.constants import BIGFLOAT
from qaray_tpu_torch.ops import analytic
from qaray_tpu_torch.scene.arrays import SceneArrays, SceneMeta

_KEYS = ("p", "n", "uvw", "front", "mtl", "has_texture")


def _no_meshes(meta: SceneMeta):
    if meta.num_mesh_instances > 0:
        raise NotImplementedError("mesh tracing comes with the mesh slice")


def trace_closest(scene: SceneArrays, meta: SceneMeta, p, d):
    """Closest-hit trace of B world-space rays."""
    _no_meshes(meta)
    full = analytic.closest_full(p, d, scene.analytic)
    attrs = {k: full[k] for k in _KEYS}
    t = full["t"]
    if meta.num_analytic == 0:  # only the compiler's placeholder primitive
        t = torch.full_like(t, BIGFLOAT)
    attrs["t"] = t
    attrs["hit"] = t < BIGFLOAT
    return attrs


def trace_shadow(scene: SceneArrays, meta: SceneMeta, p, d, t_max):
    """Any-hit occlusion: True where something blocks with BIAS < t < t_max
    (GenLight::Shadow, lights/lights.cpp:39-48; both sides count)."""
    _no_meshes(meta)
    if meta.num_analytic == 0:
        return torch.zeros(p.shape[0], dtype=torch.bool, device=p.device)
    return analytic.shadow(p, d, t_max, scene.analytic)
