"""Conversion of the JAX package's compiled scene and photon maps into the
port's tables.

The tests compile a scene once with qaray_tpu, turn its SceneArrays into
numpy leaves (jax.tree.map(np.asarray, arrays)) and hand them here, so both
packages compute on identical tables; photon maps come across the same way
(photon_map_from_numpy), which keeps gather parity apart from build parity.
This module imports neither JAX nor qaray_tpu: it reads the leaves by field
name.
"""

import numpy as np
import torch

from qaray_tpu_torch.scene.arrays import (
    CameraArrays,
    EnvColor,
    LightTable,
    MaterialTable,
    MeshArrays,
    MeshInstances,
    SceneArrays,
    SceneMeta,
    TextureAtlas,
    analytic_prims,
    with_kernel_tables,
)


def from_numpy_arrays(tree, meta, device="cuda"):
    """(qaray_tpu SceneArrays with numpy leaves, its SceneMeta) ->
    (the port's SceneArrays on `device`, the port's SceneMeta).

    Mesh and instance leaves come across field by field (None where the
    JAX compiler left an optional table out); a scene without mesh
    instances gets None for both, as the port's compiler gives it. The
    texture atlas and the texture columns of the materials, the background
    and the environment come across as they are; per-instance scenes
    (world_bvh=False) too, with W1's transform rows packed from the
    instances' (with_kernel_tables)."""
    meta = SceneMeta(**meta._asdict())

    def dev(a):
        return torch.as_tensor(np.array(a), device=device)

    def group(cls, src):
        return cls(**{f: None if getattr(src, f) is None
                      else dev(getattr(src, f)) for f in cls._fields})

    mesh = instances = None
    if meta.num_mesh_instances:
        # The walks' trees (and the dense route's Morton rows) have no JAX
        # counterpart: they are built as the port's compiler builds them
        # (the tiled route's, K3's and K1c's).
        mesh = MeshArrays(**{f: None if getattr(tree.mesh, f, None) is None
                             else dev(getattr(tree.mesh, f))
                             for f in MeshArrays._fields})
        if mesh.tile_cbounds is not None:
            from qaray_tpu_torch.ops.tiles import cluster_tree

            mesh = mesh._replace(tile_tree=cluster_tree(mesh.tile_cbounds))
        if mesh.stream_c16 is not None:
            from qaray_tpu_torch.ops.mesh_sweep import build_walk

            walk = build_walk(np.asarray(tree.mesh.tri_v))
            mesh = mesh._replace(stream_rows=dev(walk.rows),
                                 stream_gid=dev(walk.gid),
                                 stream_tree=dev(walk.tree))
        if mesh.mega_c16 is not None:
            from qaray_tpu_torch.ops.megakernel import build_mega_tree

            mesh = mesh._replace(mega_tree=dev(build_mega_tree(
                np.asarray(tree.mesh.tri_v), mesh.mega_c16.numel() // 16)))
        instances = group(MeshInstances, tree.instances)

    arrays = SceneArrays(
        analytic=analytic_prims(**{f: dev(getattr(tree.analytic, f))
                                   for f in ("kind", "mtl", "m_w2o",
                                             "t_o2w")}),
        materials=group(MaterialTable, tree.materials),
        lights=group(LightTable, tree.lights),
        background=group(EnvColor, tree.background),
        environment=group(EnvColor, tree.environment),
        camera=group(CameraArrays, tree.camera),
        textures=group(TextureAtlas, tree.textures),
        mesh=mesh,
        instances=instances,
    )
    return with_kernel_tables(arrays, meta), meta


def photon_map_from_numpy(pmap, device="cuda"):
    """A qaray_tpu PhotonMapData with numpy leaves -> the port's
    PhotonMapData on `device` (the radius stays a float32 scalar on the
    CPU). ctable and cbounds come across where the map has them."""
    from qaray_tpu_torch.photon.gather import PhotonMapData

    def dev(a):
        return None if a is None else torch.as_tensor(np.array(a),
                                                      device=device)

    return PhotonMapData(
        pos=dev(pmap.pos), power=dev(pmap.power),
        max_power=dev(pmap.max_power), direction=dev(pmap.direction),
        radius=torch.tensor(np.float32(pmap.radius)),
        valid=dev(pmap.valid), ctable=dev(pmap.ctable),
        cbounds=dev(pmap.cbounds))
