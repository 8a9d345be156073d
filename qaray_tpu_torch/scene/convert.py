"""Conversion of the JAX package's compiled scene into the port's tables.

The tests compile a scene once with qaray_tpu, turn its SceneArrays into
numpy leaves (jax.tree.map(np.asarray, arrays)) and hand them here, so both
packages compute on identical tables. This module imports neither JAX nor
qaray_tpu: it reads the leaves by field name.
"""

import numpy as np
import torch

from qaray_tpu_torch.scene.arrays import (
    CameraArrays,
    EnvColor,
    LightTable,
    MaterialTable,
    SceneArrays,
    SceneMeta,
    analytic_prims,
    with_kernel_tables,
)


def from_numpy_arrays(tree, meta, device="cuda"):
    """(qaray_tpu SceneArrays with numpy leaves, its SceneMeta) ->
    (the port's SceneArrays on `device`, the port's SceneMeta).

    Raises NotImplementedError for scenes this slice of the port does not
    carry (meshes, textures)."""
    meta = SceneMeta(**meta._asdict())
    if meta.num_mesh_instances:
        raise NotImplementedError("meshes come with the mesh slice")
    if meta.has_mtl_textures or meta.has_bg_texture or meta.has_env_texture:
        raise NotImplementedError("textures come with the texture slice")

    def dev(a):
        return torch.as_tensor(np.array(a), device=device)

    def group(cls, src):
        return cls(**{f: dev(getattr(src, f)) for f in cls._fields})

    arrays = SceneArrays(
        analytic=analytic_prims(**{f: dev(getattr(tree.analytic, f))
                                   for f in ("kind", "mtl", "m_w2o",
                                             "t_o2w")}),
        materials=group(MaterialTable, tree.materials),
        lights=group(LightTable, tree.lights),
        background=EnvColor(dev(tree.background.color)),
        environment=EnvColor(dev(tree.environment.color)),
        camera=group(CameraArrays, tree.camera),
    )
    return with_kernel_tables(arrays, meta), meta
