"""Flattened scene tables as tensors.

Counterpart of qaray_tpu/scene/arrays.py. NamedTuples of tensors stand in
for the JAX pytrees; SceneMeta is the same static, hashable tuple. This
slice of the port carries analytic primitives, untextured materials,
lights, camera and the background/environment colours; the mesh, instance
and texture tables arrive with the mesh and texture slices.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

# Primitive kinds
KIND_SPHERE = 0
KIND_PLANE = 1

# Light kinds
LIGHT_AMBIENT = 0
LIGHT_DIRECT = 1
LIGHT_POINT = 2
LIGHT_SPOT = 3


class AnalyticPrims(NamedTuple):
    """Unit spheres / unit-square planes instanced by affine transforms.

    p_obj = m_w2o @ (p_world - t_o2w);  dir_obj = m_w2o @ dir_world;
    N_world = normalize(m_w2o^T @ N_obj)  (core/transform.h:47-61).
    """

    kind: torch.Tensor  # [P] int32
    mtl: torch.Tensor  # [P] int32
    m_w2o: torch.Tensor  # [P, 3, 3] float32
    t_o2w: torch.Tensor  # [P, 3] float32
    table: torch.Tensor  # [P, 12] float32: m_w2o row-major, t_o2w (kernels)


def analytic_prims(kind, mtl, m_w2o, t_o2w) -> AnalyticPrims:
    """AnalyticPrims with the kernels' [P, 12] table packed once."""
    table = torch.cat([m_w2o.reshape(-1, 9), t_o2w], dim=1)
    return AnalyticPrims(kind, mtl, m_w2o, t_o2w,
                         table.to(torch.float32).contiguous())


class MaterialTable(NamedTuple):
    diffuse: torch.Tensor  # [M, 3]
    specular: torch.Tensor  # [M, 3]
    emission: torch.Tensor  # [M, 3]
    reflection: torch.Tensor  # [M, 3]
    refraction: torch.Tensor  # [M, 3]
    absorption: torch.Tensor  # [M, 3]
    glossiness: torch.Tensor  # [M]
    reflection_glossiness: torch.Tensor  # [M]
    refraction_glossiness: torch.Tensor  # [M]
    ior: torch.Tensor  # [M]


class LightTable(NamedTuple):
    kind: torch.Tensor  # [L] int32
    intensity: torch.Tensor  # [L, 3]
    position: torch.Tensor  # [L, 3]
    direction: torch.Tensor  # [L, 3]
    size: torch.Tensor  # [L]
    inner: torch.Tensor  # [L]
    outer: torch.Tensor  # [L]


class EnvColor(NamedTuple):
    """Untextured background / environment colour."""

    color: torch.Tensor  # [3]


class CameraArrays(NamedTuple):
    """Resolved screen basis (reference renderer.cpp:76-91)."""

    pos: torch.Tensor  # [3]
    screen_a: torch.Tensor  # [3] top-left screen corner
    screen_u: torch.Tensor  # [3] per-pixel step right
    screen_v: torch.Tensor  # [3] per-pixel step down
    screen_x: torch.Tensor  # [3] camera right (DoF basis)
    screen_y: torch.Tensor  # [3] camera up (DoF basis)
    dof: torch.Tensor  # [] depth of field lens radius


class KernelTables(NamedTuple):
    """The scene in the layout of the megakernel K1a (csrc/megakernel.cu),
    packed once per compiled scene (pallas_pathtrace._pack_tables)."""

    mtl: torch.Tensor  # [M, 22] float32
    light: torch.Tensor  # [L, 12] float32
    cam: torch.Tensor  # [25] float32: camera, background, environment
    light_kind: torch.Tensor  # [max(L, 1)] int32
    light_soft: torch.Tensor  # [max(L, 1)] int32


class SceneArrays(NamedTuple):
    analytic: AnalyticPrims
    materials: MaterialTable
    lights: LightTable
    background: EnvColor
    environment: EnvColor
    camera: CameraArrays
    kernel: Optional[KernelTables] = None


class SceneMeta(NamedTuple):
    """Static (hashable) facts about the compiled scene; the same fields as
    qaray_tpu's SceneMeta so either package's meta converts to the other."""

    img_width: int
    img_height: int
    num_analytic: int
    num_mesh_instances: int
    num_tris: int
    num_lights: int
    num_materials: int
    has_dof: bool
    bvh_depth: int
    has_ambient: bool
    light_kinds: tuple = ()
    light_soft: tuple = ()
    analytic_kinds: tuple = ()
    analytic_mtls: tuple = ()
    mesh_mega: bool = False
    mesh_mega_mtls: tuple = ()
    mesh_mega_stream: bool = False
    has_glossy: bool = False
    mega_tex_ok: bool = False
    mega_tex_slots: tuple = (False,) * 5
    has_mtl_textures: bool = True
    has_bg_texture: bool = True
    has_env_texture: bool = True
    world_bvh: bool = False
    mesh_stream: bool = False
    mesh_tiled: bool = False
    force_xla: bool = False
    max_leaf: int = 4



def with_kernel_tables(arrays: SceneArrays, meta: SceneMeta) -> SceneArrays:
    """arrays with `kernel` packed from its tables and meta's static facts."""
    mt, lt, cam = arrays.materials, arrays.lights, arrays.camera
    mtl = torch.cat([
        mt.diffuse, mt.specular, mt.emission, mt.reflection, mt.refraction,
        mt.glossiness[:, None], mt.reflection_glossiness[:, None],
        mt.refraction_glossiness[:, None], mt.ior[:, None], mt.absorption,
    ], dim=1)
    light = torch.cat([
        lt.intensity, lt.position, lt.direction, lt.size[:, None],
        lt.inner[:, None], lt.outer[:, None],
    ], dim=1)
    cam_tab = torch.cat([
        cam.pos, cam.screen_a, cam.screen_u, cam.screen_v, cam.screen_x,
        cam.screen_y, cam.dof.reshape(1), arrays.background.color,
        arrays.environment.color,
    ])

    def f32(t):
        return t.to(torch.float32).contiguous()

    def ints(values):
        return torch.tensor(values or (0,), dtype=torch.int32,
                            device=cam.pos.device)

    return arrays._replace(kernel=KernelTables(
        mtl=f32(mtl), light=f32(light), cam=f32(cam_tab),
        light_kind=ints(meta.light_kinds),
        light_soft=ints(tuple(int(s) for s in meta.light_soft)),
    ))
