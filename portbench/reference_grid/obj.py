"""A plain Wavefront OBJ loader for geometry-only meshes: `v` and `f` lines
(faces of three or more corners, fan-triangulated, negative indices
counted from the end), with the vertex normals computed as the upstream's
TriMesh::ComputeNormals does (mesh/TriMesh.cpp:134-158): each face's
unnormalised normal (v1 - v0) x (v2 - v0), whose length is twice its area,
added to its three corners, then normalised. A file with normals, texture
coordinates or materials raises: the reference reads none of them."""

from __future__ import annotations

import os

import numpy as np

from ..reference import desc as D


def _index(tok: str, n_v: int) -> int:
    v = int(tok.split("/")[0])
    return v - 1 if v > 0 else n_v + v


def load_obj(path: str) -> D.MeshDesc:
    """The mesh of a geometry-only OBJ file: float32 vertices, int32
    faces and the computed normals (one a vertex, face_normals = faces)."""
    verts, faces = [], []
    with open(path, "r") as f:
        for line in f:
            toks = line.split()
            if not toks or toks[0].startswith("#"):
                continue
            if toks[0] == "v":
                verts.append([float(x) for x in toks[1:4]])
            elif toks[0] == "f":
                idx = [_index(t, len(verts)) for t in toks[1:]]
                faces += [[idx[0], idx[k], idx[k + 1]]
                          for k in range(1, len(idx) - 1)]
            elif toks[0] in ("vn", "vt", "usemtl", "mtllib"):
                raise ValueError(f"{path}: the reference reads geometry-only "
                                 f"OBJ files (found {toks[0]!r})")
    v = np.asarray(verts, np.float32).reshape(-1, 3)
    fv = np.asarray(faces, np.int32).reshape(-1, 3)
    return D.MeshDesc(name=os.path.basename(path), vertices=v, faces=fv,
                      normals=vertex_normals(v, fv), face_normals=fv)


def vertex_normals(v: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals, summed in float64, as float32."""
    p = v.astype(np.float64)[faces]
    fn = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    n = np.zeros((v.shape[0], 3))
    for k in range(3):
        np.add.at(n, faces[:, k], fn)
    return (n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-300)
            ).astype(np.float32)
