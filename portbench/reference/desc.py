"""Host-side scene description (pre-compilation).

This is the mutable object model the XML parser populates — the analogue of
the reference's Node/Material/Light graph (core/node.h, parser/xmlload.cpp)
— before `scene.compiler` flattens it into device-resident `SceneArrays`.
Everything here is plain NumPy/python; nothing touches JAX.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


def identity_affine() -> Tuple[np.ndarray, np.ndarray]:
    return np.eye(3, dtype=np.float64), np.zeros(3, dtype=np.float64)


@dataclasses.dataclass
class Affine:
    """Local-to-parent affine: p_parent = m @ p_local + t.

    Mirrors the reference Transformation (core/transform.h:36-79) where
    `tm`/`pos` map local->parent and composition left-multiplies.
    """

    m: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(3))
    t: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))

    def transform(self, mat: np.ndarray):
        """Reference Transformation::Transform: tm = m*tm; pos = m*pos."""
        self.m = mat @ self.m
        self.t = mat @ self.t

    def scale(self, sx, sy, sz):
        self.transform(np.diag([sx, sy, sz]).astype(np.float64))

    def rotate(self, axis, degrees):
        axis = np.asarray(axis, dtype=np.float64)
        axis = axis / np.linalg.norm(axis)
        a = np.deg2rad(degrees)
        x, y, z = axis
        c, s = np.cos(a), np.sin(a)
        omc = 1.0 - c
        rot = np.array(
            [
                [c + x * x * omc, x * y * omc - z * s, x * z * omc + y * s],
                [y * x * omc + z * s, c + y * y * omc, y * z * omc - x * s],
                [z * x * omc - y * s, z * y * omc + x * s, c + z * z * omc],
            ]
        )
        self.transform(rot)

    def translate(self, t):
        self.t = self.t + np.asarray(t, dtype=np.float64)

    def compose(self, child: "Affine") -> "Affine":
        """self ∘ child: child-local -> self-parent."""
        return Affine(self.m @ child.m, self.m @ child.t + self.t)


@dataclasses.dataclass
class TextureDesc:
    """A texture resource: procedural checker or an image file."""

    name: str
    kind: str  # 'checker' | 'file' | 'missing' (failed load: samples black)
    color1: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    color2: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    # For 'file': HxWx3 float image (loaded lazily by the compiler).
    image: Optional[np.ndarray] = None


@dataclasses.dataclass
class TextureMapDesc:
    """Texture + uvw transform (reference core/texture.h TextureMap)."""

    texture: TextureDesc
    xform: Affine = dataclasses.field(default_factory=Affine)


@dataclasses.dataclass
class TexturedColor:
    color: np.ndarray = dataclasses.field(default_factory=lambda: np.ones(3))
    map: Optional[TextureMapDesc] = None


@dataclasses.dataclass
class MaterialDesc:
    """Blinn material parameters (reference MtlBlinn_* family).

    One description serves all integrators; which shading model interprets it
    is a renderer-level config (improving on the reference's compile-time
    `using MtlBlinn = ...` selection at materials/materials.h:57-61).
    """

    name: str
    diffuse: TexturedColor = dataclasses.field(
        default_factory=lambda: TexturedColor(np.array([0.5, 0.5, 0.5]))
    )
    specular: TexturedColor = dataclasses.field(
        default_factory=lambda: TexturedColor(np.array([0.7, 0.7, 0.7]))
    )
    emission: TexturedColor = dataclasses.field(
        default_factory=lambda: TexturedColor(np.zeros(3))
    )
    reflection: TexturedColor = dataclasses.field(
        default_factory=lambda: TexturedColor(np.zeros(3))
    )
    refraction: TexturedColor = dataclasses.field(
        default_factory=lambda: TexturedColor(np.zeros(3))
    )
    absorption: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    glossiness: float = 20.0
    reflection_glossiness: float = 0.0
    refraction_glossiness: float = 0.0
    ior: float = 1.0
    # Sub-materials for per-face OBJ material dispatch (reference MultiMtl).
    sub_materials: Optional[List["MaterialDesc"]] = None


@dataclasses.dataclass
class LightDesc:
    kind: str  # 'ambient' | 'direct' | 'point' | 'spot'
    name: str = ""
    intensity: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    direction: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 0.0, 1.0])
    )
    position: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    size: float = 0.0
    # Spot-light cone (reference lights/lights.cpp:120-127).
    angle: float = 45.0
    blend: float = 1.0

    @property
    def outer(self) -> float:
        s = np.clip(self.angle / 2.0, 1.0, 89.0) / 180.0 * np.pi
        return float(np.tan(s))

    @property
    def inner(self) -> float:
        b = np.clip(self.blend, 0.0, 1.0)
        return float(np.sqrt(self.outer**2 * (1.0 - b)))


@dataclasses.dataclass
class MeshDesc:
    """Host triangle mesh (reference mesh/TriMesh.h)."""

    name: str
    vertices: np.ndarray  # [V, 3] float
    faces: np.ndarray  # [F, 3] int vertex indices
    normals: Optional[np.ndarray] = None  # [VN, 3]
    face_normals: Optional[np.ndarray] = None  # [F, 3] int normal indices
    texcoords: Optional[np.ndarray] = None  # [VT, 2]
    face_texcoords: Optional[np.ndarray] = None  # [F, 3] int uv indices
    face_materials: Optional[np.ndarray] = None  # [F] int sub-material id
    obj_materials: Optional[list] = None  # raw MTL dicts (for MultiMtl synth)
    directory: str = ""


@dataclasses.dataclass
class NodeDesc:
    name: str = ""
    obj_type: Optional[str] = None  # None | 'sphere' | 'plane' | 'mesh'
    mesh: Optional[MeshDesc] = None
    mtl_name: Optional[str] = None
    xform: Affine = dataclasses.field(default_factory=Affine)
    children: List["NodeDesc"] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class CameraDesc:
    """Reference core/camera.cpp:31-41 defaults."""

    pos: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    dir: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 0.0, -1.0])
    )
    up: np.ndarray = dataclasses.field(default_factory=lambda: np.array([0.0, 1.0, 0.0]))
    fovy: float = 40.0
    focal_distance: float = 1.0
    depth_of_field: float = 0.0
    img_width: int = 200
    img_height: int = 150


@dataclasses.dataclass
class SceneDesc:
    root: NodeDesc = dataclasses.field(default_factory=NodeDesc)
    materials: List[MaterialDesc] = dataclasses.field(default_factory=list)
    lights: List[LightDesc] = dataclasses.field(default_factory=list)
    camera: CameraDesc = dataclasses.field(default_factory=CameraDesc)
    background: TexturedColor = dataclasses.field(
        default_factory=lambda: TexturedColor(np.zeros(3))
    )
    environment: TexturedColor = dataclasses.field(
        default_factory=lambda: TexturedColor(np.zeros(3))
    )
    textures: List[TextureDesc] = dataclasses.field(default_factory=list)

    def find_material(self, name: str) -> Optional[MaterialDesc]:
        for m in self.materials:
            if m.name == name:
                return m
        return None
