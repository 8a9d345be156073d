"""Scene compilation: host SceneDesc -> device SceneArrays.

Counterpart of qaray_tpu/scene/compiler.py for the analytic part of a
scene. Each leaf object's composed affine is baked once on the host, in
numpy (p_obj = M_w2o @ (p_world - t_o2w), M_w2o = inv(M_o2w)); the finished
tables then move to the device in one step. Mesh nodes and live textures
raise NotImplementedError: they arrive with the mesh and texture slices of
the port.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from qaray_tpu_torch.scene import desc as D
from qaray_tpu_torch.scene.arrays import (
    KIND_PLANE,
    KIND_SPHERE,
    LIGHT_AMBIENT,
    LIGHT_DIRECT,
    LIGHT_POINT,
    LIGHT_SPOT,
    CameraArrays,
    EnvColor,
    LightTable,
    MaterialTable,
    SceneArrays,
    SceneMeta,
    analytic_prims,
    with_kernel_tables,
)

_LIGHT_KIND = {
    "ambient": LIGHT_AMBIENT,
    "direct": LIGHT_DIRECT,
    "point": LIGHT_POINT,
    "spot": LIGHT_SPOT,
}
_SLOTS = ("diffuse", "specular", "emission", "reflection", "refraction")


def _live_texture(tc: D.TexturedColor) -> bool:
    return tc.map is not None and tc.map.texture.kind != "missing"


def _default_material() -> D.MaterialDesc:
    """MtlBlinn defaults (MtlBlinn_PhotonMap.cpp ctor) for unbound objects."""
    return D.MaterialDesc(name="__default__")


class SceneCompiler:
    def __init__(self, scene: D.SceneDesc):
        self.scene = scene
        self.mtl_index: Dict[int, int] = {}  # id(MaterialDesc) -> table row
        self.materials: List[D.MaterialDesc] = []
        self.kinds: List[int] = []
        self.prim_mtl: List[int] = []
        self.m_w2o: List[np.ndarray] = []
        self.t_o2w: List[np.ndarray] = []

    def _intern_material(self, mtl) -> int:
        if mtl is None:
            mtl = _default_material()
        if mtl.sub_materials is not None:
            raise NotImplementedError(
                "multi-materials bind to mesh faces: mesh slice of the port"
            )
        key = id(mtl)
        if key not in self.mtl_index:
            self.mtl_index[key] = len(self.materials)
            self.materials.append(mtl)
        return self.mtl_index[key]

    def _flatten(self, node: D.NodeDesc, parent: D.Affine):
        world = parent.compose(node.xform)
        if node.obj_type in ("sphere", "plane"):
            mtl = (self.scene.find_material(node.mtl_name)
                   if node.mtl_name else None)
            self.kinds.append(
                KIND_SPHERE if node.obj_type == "sphere" else KIND_PLANE
            )
            self.prim_mtl.append(self._intern_material(mtl))
            self.m_w2o.append(np.linalg.inv(world.m))
            self.t_o2w.append(world.t)
        elif node.obj_type == "mesh" and node.mesh is not None:
            raise NotImplementedError(
                f"mesh node {node.name!r}: meshes come with the mesh slice "
                "of the port"
            )
        for child in node.children:
            self._flatten(child, world)

    def _material_table(self) -> Dict[str, np.ndarray]:
        mats = self.materials or [_default_material()]
        for mat in mats:
            for slot in _SLOTS:
                if _live_texture(getattr(mat, slot)):
                    raise NotImplementedError(
                        f"material {mat.name!r} has a {slot} texture: "
                        "textures come with the texture slice of the port"
                    )

        def col(get, shape=(3,)):
            return np.stack([
                np.broadcast_to(np.asarray(get(x), np.float32), shape)
                for x in mats
            ])

        def colour(slot):
            # A slot whose texture failed to load samples as colour * 0 in
            # the reference (textures/texture.cpp:97-99): fold it to black.
            arr = col(lambda x: getattr(x, slot).color)
            for i, mat in enumerate(mats):
                if getattr(mat, slot).map is not None:
                    arr[i] = 0.0
            return arr

        return dict(
            diffuse=colour("diffuse"),
            specular=colour("specular"),
            emission=colour("emission"),
            reflection=colour("reflection"),
            refraction=colour("refraction"),
            absorption=col(lambda x: x.absorption),
            glossiness=col(lambda x: x.glossiness, ()),
            reflection_glossiness=col(lambda x: x.reflection_glossiness, ()),
            refraction_glossiness=col(lambda x: x.refraction_glossiness, ()),
            ior=col(lambda x: x.ior, ()),
        )

    def _light_table(self) -> Dict[str, np.ndarray]:
        lights = self.scene.lights
        n = max(len(lights), 1)
        out = dict(
            kind=np.zeros(n, np.int32),
            intensity=np.zeros((n, 3), np.float32),
            position=np.zeros((n, 3), np.float32),
            direction=np.tile(np.array([0, 0, 1], np.float32), (n, 1)),
            size=np.zeros(n, np.float32),
            inner=np.zeros(n, np.float32),
            outer=np.zeros(n, np.float32),
        )
        for i, light in enumerate(lights):
            out["kind"][i] = _LIGHT_KIND[light.kind]
            out["intensity"][i] = light.intensity
            out["position"][i] = light.position
            out["direction"][i] = light.direction
            out["size"][i] = light.size
            if light.kind == "spot":
                out["inner"][i] = light.inner
                out["outer"][i] = light.outer
        return out

    def _env_color(self, tc: D.TexturedColor, what: str) -> np.ndarray:
        if _live_texture(tc):
            raise NotImplementedError(
                f"textured {what}: textures come with the texture slice of "
                "the port"
            )
        if tc.map is not None:  # failed texture load samples as black
            return np.zeros(3, np.float32)
        return np.asarray(tc.color, np.float32)

    def _camera(self) -> Dict[str, np.ndarray]:
        """Screen basis; straight from reference renderer.cpp:76-91."""
        cam = self.scene.camera
        focal = cam.focal_distance
        aspect = cam.img_width / float(cam.img_height)
        screen_h = 2.0 * focal * np.tan(cam.fovy * np.pi / 2.0 / 180.0)
        screen_w = aspect * screen_h
        x = np.cross(cam.dir, cam.up)
        x = x / np.linalg.norm(x)
        y = np.cross(x, cam.dir)
        y = y / np.linalg.norm(y)
        z = -cam.dir / np.linalg.norm(cam.dir)
        screen_u = x * (screen_w / cam.img_width)
        screen_v = -y * (screen_h / cam.img_height)
        screen_a = (cam.pos - z * focal + y * screen_h / 2.0
                    - x * screen_w / 2.0)
        f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
        return dict(pos=f32(cam.pos), screen_a=f32(screen_a),
                    screen_u=f32(screen_u), screen_v=f32(screen_v),
                    screen_x=f32(x), screen_y=f32(y),
                    dof=f32(cam.depth_of_field))

    def compile(self, device) -> Tuple[SceneArrays, SceneMeta]:
        for child in self.scene.root.children:
            self._flatten(child, D.Affine())
        background = self._env_color(self.scene.background, "background")
        environment = self._env_color(self.scene.environment, "environment")
        n_analytic = len(self.kinds)
        if n_analytic:
            prims = dict(
                kind=np.array(self.kinds, np.int32),
                mtl=np.array(self.prim_mtl, np.int32),
                m_w2o=np.stack(self.m_w2o).astype(np.float32),
                t_o2w=np.stack(self.t_o2w).astype(np.float32),
            )
        else:
            prims = dict(
                kind=np.zeros(1, np.int32), mtl=np.zeros(1, np.int32),
                m_w2o=np.eye(3, dtype=np.float32)[None],
                t_o2w=np.zeros((1, 3), np.float32),
            )
        mtl_table = self._material_table()

        def dev(a):
            return torch.as_tensor(np.array(a), device=device)

        def group(cls, tables):
            return cls(**{k: dev(v) for k, v in tables.items()})

        arrays = SceneArrays(
            analytic=analytic_prims(**{k: dev(v) for k, v in prims.items()}),
            materials=group(MaterialTable, mtl_table),
            lights=group(LightTable, self._light_table()),
            background=EnvColor(dev(background)),
            environment=EnvColor(dev(environment)),
            camera=group(CameraArrays, self._camera()),
        )
        lights = self.scene.lights
        meta = SceneMeta(
            img_width=self.scene.camera.img_width,
            img_height=self.scene.camera.img_height,
            num_analytic=n_analytic,
            num_mesh_instances=0,
            num_tris=0,
            num_lights=len(lights),
            num_materials=len(self.materials),
            has_dof=self.scene.camera.depth_of_field > 0.1,
            bvh_depth=1,
            has_ambient=any(light.kind == "ambient" for light in lights),
            light_kinds=tuple(_LIGHT_KIND[light.kind] for light in lights),
            light_soft=tuple(bool(light.size > 0.01) for light in lights),
            analytic_kinds=tuple(int(k) for k in self.kinds),
            analytic_mtls=tuple(int(m) for m in self.prim_mtl),
            has_glossy=any(
                m.reflection_glossiness > 0 or m.refraction_glossiness > 0
                for m in self.materials
            ),
            mega_tex_slots=(False,) * 5,
            has_mtl_textures=False,
            has_bg_texture=False,
            has_env_texture=False,
        )
        return with_kernel_tables(arrays, meta), meta


def compile_scene(scene: D.SceneDesc, device="cuda"):
    """Compile a parsed SceneDesc into (SceneArrays on `device`, SceneMeta)."""
    return SceneCompiler(scene).compile(device)
