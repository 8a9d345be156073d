"""Scene compilation with per-instance meshes: the reference's analytic
compiler (portbench/reference/compiler.py) for spheres and planes, and
for the OBJ nodes one mesh in object space with its own tree (bvh.py) and
every node that places it as an instance.

An instance keeps its world -> object transform as the analytic objects
do (p_obj = M_w2o (p_world - t_o2w), M_w2o = inv(M_o2w), baked once in
numpy), its material row and its world box: the box of its eight
object-box corners moved to world space, with room (bvh.pad_of), which
only picks the instances a ray may enter. All nodes must share one mesh
(the upstream's nodes that name one OBJ file share one TriObj) and take a
plain material.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..reference import desc as D
from ..reference.compiler import SceneCompiler, _to_numpy32
from . import bvh


class MeshField(NamedTuple):
    """One mesh in object space and its instances."""

    tri_v: torch.Tensor  # [F, 3, 3] corner positions
    tri_n: torch.Tensor  # [F, 3, 3] corner normals
    tree: bvh.Tree
    m_w2o: torch.Tensor  # [I, 3, 3]
    t_o2w: torch.Tensor  # [I, 3]
    mtl: torch.Tensor  # [I] int32 material row
    box_lo: torch.Tensor  # [I, 3] world box
    box_hi: torch.Tensor  # [I, 3]


class GridCompiler(SceneCompiler):
    def __init__(self, scene: D.SceneDesc):
        super().__init__(scene, world_bvh=False)
        self.mesh = None
        self.placed = []  # (M_o2w, t_o2w, material row)

    def _flatten(self, node: D.NodeDesc, parent: D.Affine):
        if node.obj_type != "mesh" or node.mesh is None:
            super()._flatten(node, parent)
            return
        world = parent.compose(node.xform)
        if self.mesh is not None and node.mesh is not self.mesh:
            raise ValueError("the reference compiles one shared mesh")
        self.mesh = node.mesh
        mtl = (self.scene.find_material(node.mtl_name)
               if node.mtl_name else None)
        row = self._intern_material(mtl)[0]
        if row < 0:
            raise ValueError("the reference's instances take plain materials")
        self.placed.append((world.m, world.t, row))
        for child in node.children:
            self._flatten(child, world)

    def _field(self, device) -> MeshField:
        mesh = self.mesh
        tri_v = mesh.vertices[mesh.faces]
        tri_n = mesh.normals[mesh.face_normals]
        obj_lo = tri_v.reshape(-1, 3).min(0).astype(np.float64)
        obj_hi = tri_v.reshape(-1, 3).max(0).astype(np.float64)
        corners = np.array([[(obj_lo, obj_hi)[(c >> a) & 1][a]
                             for a in range(3)] for c in range(8)])
        box_lo, box_hi = [], []
        for m, t, _ in self.placed:
            w = corners @ m.T + t
            pad = bvh.pad_of(w)
            box_lo.append(w.min(0) - pad)
            box_hi.append(w.max(0) + pad)
        tree = bvh.build(tri_v)

        def dev(a):
            return torch.as_tensor(_to_numpy32(a), device=device)

        return MeshField(
            tri_v=dev(tri_v), tri_n=dev(tri_n),
            tree=bvh.Tree(*(torch.as_tensor(x, device=device)
                            for x in tree)),
            m_w2o=dev(np.stack([np.linalg.inv(m) for m, _, _ in self.placed])),
            t_o2w=dev(np.stack([t for _, t, _ in self.placed])),
            mtl=dev(np.array([r for _, _, r in self.placed], np.int32)),
            box_lo=dev(np.stack(box_lo)), box_hi=dev(np.stack(box_hi)))

    def compile(self, device):
        arrays, meta = super().compile(device)
        if self.mesh is None:
            return arrays, meta
        field = self._field(device)
        return arrays._replace(mesh=field), meta._replace(
            num_mesh_instances=len(self.placed),
            num_tris=int(self.mesh.faces.shape[0]))


def compile_scene(scene: D.SceneDesc, device="cuda"):
    """(SceneArrays on `device`, whose `mesh` is the MeshField of its
    instances or None, SceneMeta)."""
    return GridCompiler(scene).compile(device)
