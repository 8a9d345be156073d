"""Pure-python Wavefront OBJ/MTL loader.

TPU-native replacement for the reference's tinyobjloader path
(mesh/TriMesh.cpp:63-116): triangles only, vertex/normal/uv indices kept
separately, faces sorted by material id (matching TriMesh::LoadFromFileObj's
sort), polygon faces fan-triangulated (tinyobjloader `triangulate=true`).
Area-weighted vertex normals are computed when the file has none
(TriMesh::ComputeNormals, mesh/TriMesh.cpp:134-158).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from qaray_tpu_torch.scene.desc import MeshDesc


def _parse_index(tok: str, n_v: int, n_vt: int, n_vn: int):
    """OBJ index triple 'v/vt/vn' with negative-index support. 0-based out."""
    parts = tok.split("/")
    v = int(parts[0])
    v = v - 1 if v > 0 else n_v + v
    vt = vn = -1
    if len(parts) > 1 and parts[1]:
        vt = int(parts[1])
        vt = vt - 1 if vt > 0 else n_vt + vt
    if len(parts) > 2 and parts[2]:
        vn = int(parts[2])
        vn = vn - 1 if vn > 0 else n_vn + vn
    return v, vt, vn


def load_mtl(path: str) -> List[Dict]:
    """Parse a .mtl file into a list of dicts (tinyobjloader-compatible keys)."""
    materials: List[Dict] = []
    cur: Optional[Dict] = None
    if not os.path.exists(path):
        return materials
    with open(path, "r", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            toks = line.split()
            key = toks[0]
            if key == "newmtl":
                cur = {
                    "name": toks[1] if len(toks) > 1 else "",
                    "diffuse": [0.5, 0.5, 0.5],
                    "specular": [0.0, 0.0, 0.0],
                    "transmittance": [0.0, 0.0, 0.0],
                    "shininess": 1.0,
                    "ior": 1.0,
                    "illum": 2,
                    "diffuse_texname": "",
                    "specular_texname": "",
                }
                materials.append(cur)
            elif cur is None:
                continue
            elif key == "Kd":
                cur["diffuse"] = [float(x) for x in toks[1:4]]
            elif key == "Ks":
                cur["specular"] = [float(x) for x in toks[1:4]]
            elif key == "Tf":
                cur["transmittance"] = [float(x) for x in toks[1:4]]
            elif key == "Ns":
                cur["shininess"] = float(toks[1])
            elif key == "Ni":
                cur["ior"] = float(toks[1])
            elif key == "illum":
                cur["illum"] = int(float(toks[1]))
            elif key == "map_Kd":
                cur["diffuse_texname"] = toks[-1]
            elif key == "map_Ks":
                cur["specular_texname"] = toks[-1]
    return materials


def load_obj(path: str, load_mtl_files: bool = True) -> MeshDesc:
    """Load a triangle mesh. Raises FileNotFoundError if `path` is missing.

    Geometry-only files (no mtllib/usemtl) go through the port's native
    C++ parser (qaray_tpu_torch/native.py) where it loads; files that carry
    materials take the python path, which synthesises the MTL materials.
    """
    try:
        with open(path, "rb") as f:
            head = f.read()
        has_mtl = (b"usemtl" in head) or (b"mtllib" in head)
    except OSError:
        raise FileNotFoundError(path)
    if not has_mtl:
        from qaray_tpu_torch import native

        out = native.obj_load_native(path)
        if out is not None:
            v, vn, vt, f_v, f_vt, f_vn = out
            directory = os.path.dirname(os.path.abspath(path))
            if vn.shape[0] == 0 or np.all(f_vn < 0):
                vn, f_vn = compute_vertex_normals(v, f_v)
            return MeshDesc(
                name=os.path.basename(path),
                vertices=v,
                faces=f_v,
                normals=vn,
                face_normals=f_vn,
                texcoords=vt if vt.shape[0] else None,
                face_texcoords=f_vt if vt.shape[0] else None,
                face_materials=-np.ones((f_v.shape[0],), np.int32),
                obj_materials=[],
                directory=directory + os.sep if directory else "",
            )
    return _load_obj_python(path, load_mtl_files)


def _load_obj_python(path: str, load_mtl_files: bool = True) -> MeshDesc:
    verts: List[List[float]] = []
    norms: List[List[float]] = []
    uvs: List[List[float]] = []
    f_v: List[List[int]] = []
    f_vt: List[List[int]] = []
    f_vn: List[List[int]] = []
    f_mtl: List[int] = []
    materials: List[Dict] = []
    mtl_by_name: Dict[str, int] = {}
    cur_mtl = -1
    directory = os.path.dirname(os.path.abspath(path))

    with open(path, "r", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            toks = line.split()
            key = toks[0]
            if key == "v":
                verts.append([float(x) for x in toks[1:4]])
            elif key == "vn":
                norms.append([float(x) for x in toks[1:4]])
            elif key == "vt":
                uvs.append([float(x) for x in toks[1:3]])
            elif key == "f":
                idx = [
                    _parse_index(t, len(verts), len(uvs), len(norms))
                    for t in toks[1:]
                ]
                # Fan triangulation for polygons (tinyobjloader triangulate).
                for k in range(1, len(idx) - 1):
                    tri = [idx[0], idx[k], idx[k + 1]]
                    f_v.append([t[0] for t in tri])
                    f_vt.append([t[1] for t in tri])
                    f_vn.append([t[2] for t in tri])
                    f_mtl.append(cur_mtl)
            elif key == "usemtl" and len(toks) > 1:
                cur_mtl = mtl_by_name.get(toks[1], -1)
            elif key == "mtllib" and load_mtl_files and len(toks) > 1:
                for mtl_file in toks[1:]:
                    for m in load_mtl(os.path.join(directory, mtl_file)):
                        mtl_by_name[m["name"]] = len(materials)
                        materials.append(m)

    vertices = np.asarray(verts, dtype=np.float32).reshape(-1, 3)
    faces = np.asarray(f_v, dtype=np.int32).reshape(-1, 3)
    face_mtl = np.asarray(f_mtl, dtype=np.int32)

    # Sort faces by material id, keeping unassigned (-1) faces in place at the
    # end of the order — reference TriMesh.cpp:107-114 (stable sort, negative
    # ids compare "not less").
    if len(materials) > 0 and faces.shape[0] > 0:
        order = np.argsort(np.where(face_mtl < 0, np.iinfo(np.int32).max, face_mtl), kind="stable")
        faces = faces[order]
        face_mtl = face_mtl[order]
        f_vt = [f_vt[i] for i in order]
        f_vn = [f_vn[i] for i in order]

    face_vt = np.asarray(f_vt, dtype=np.int32).reshape(-1, 3)
    face_vn = np.asarray(f_vn, dtype=np.int32).reshape(-1, 3)

    normals = (
        np.asarray(norms, dtype=np.float32).reshape(-1, 3) if norms else None
    )
    if normals is None or np.all(face_vn < 0):
        normals, face_vn = compute_vertex_normals(vertices, faces)
    texcoords = np.asarray(uvs, dtype=np.float32).reshape(-1, 2) if uvs else None

    return MeshDesc(
        name=os.path.basename(path),
        vertices=vertices,
        faces=faces,
        normals=normals,
        face_normals=face_vn,
        texcoords=texcoords,
        face_texcoords=face_vt if texcoords is not None else None,
        face_materials=face_mtl,
        obj_materials=materials,
        directory=directory + os.sep if directory else "",
    )


def compute_vertex_normals(vertices: np.ndarray, faces: np.ndarray):
    """Area-weighted vertex normals (reference TriMesh::ComputeNormals)."""
    n = np.zeros_like(vertices)
    if faces.shape[0]:
        a = vertices[faces[:, 0]]
        fn = np.cross(vertices[faces[:, 1]] - a, vertices[faces[:, 2]] - a)
        for k in range(3):
            np.add.at(n, faces[:, k], fn)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = n / np.maximum(norm, 1e-20)
    return n.astype(np.float32), faces.astype(np.int32)
