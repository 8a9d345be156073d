"""Flattened scene tables as tensors.

Counterpart of qaray_tpu/scene/arrays.py. NamedTuples of tensors stand in
for the JAX pytrees; SceneMeta is the same static, hashable tuple. The port
carries analytic primitives, triangle meshes (world-baked or per
instance), materials with their texture slots, lights, camera, the texture
atlas and the textured background/environment colours. A scene without
meshes has `mesh` and `instances` None.
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

# Texture kinds
TEX_FILE = 0
TEX_CHECKER = 1

# Texture slots on a material
SLOT_DIFFUSE = 0
SLOT_SPECULAR = 1
SLOT_EMISSION = 2
SLOT_REFLECTION = 3
SLOT_REFRACTION = 4
NUM_SLOTS = 5

# Material table columns of the megakernel (KernelTables.mtl): 22 of
# parameters, then, for scenes whose checker textures it samples itself,
# 16 per slot: [has, color1(3), color2(3), tex_m row 0 (3), row 1 (3),
# tex_t (3)].
MTL_COLS = 22
TEX_STRIDE = 16
MTL_TEX_COLS = MTL_COLS + TEX_STRIDE * NUM_SLOTS


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


class MeshArrays(NamedTuple):
    """All meshes concatenated; triangle vertex data pre-gathered per face.
    The optional tables are those of the mesh routes the compiler chose."""

    tri_v: torch.Tensor  # [F, 3, 3] vertex positions
    tri_n: torch.Tensor  # [F, 3, 3] shading normals per corner
    tri_uv: torch.Tensor  # [F, 3, 2] texture coords per corner
    tri_has_uv: torch.Tensor  # [F] bool
    tri_mtl: torch.Tensor  # [F] int32 sub-material id (-1 if none)
    # Flattened BVH over all triangles (scene/bvh.py).
    bvh_bounds: torch.Tensor  # [N, 6]
    bvh_left: torch.Tensor  # [N] (-1 => leaf)
    bvh_right: torch.Tensor  # [N] (child index, or elem offset for leaf)
    bvh_count: torch.Tensor  # [N]
    bvh_elems: torch.Tensor  # [F] triangle ids in leaf order
    # Packed fat-node layout of the BVH (scene/bvh.pack_bvh).
    pnodes: Optional[torch.Tensor] = None  # [Ni, 16] float32
    ltri: Optional[torch.Tensor] = None  # [F, 12] float32
    # Dense sweep route (ops/mesh_stream.py, its plain version reading
    # stream_c16; K3 walks stream_tree over stream_rows, ops/mesh_sweep.py).
    stream_coeff: Optional[torch.Tensor] = None  # [Fp, 3, 3] n, A, B
    stream_const: Optional[torch.Tensor] = None  # [Fp, 4] k, A0, B0, |n|
    stream_c16: Optional[torch.Tensor] = None  # [Fp16, 16] (pack_coeff16)
    stream_rows: Optional[torch.Tensor] = None  # [Fw, 16] Morton order
    stream_gid: Optional[torch.Tensor] = None  # [Fw] world triangle id
    stream_tree: Optional[torch.Tensor] = None  # [2L, 8] (cluster_tree)
    # Tiled cluster route (ops/mesh_tiles.py; K4a/K4b read tile_c16T and
    # walk tile_tree).
    tile_coeff: Optional[torch.Tensor] = None  # [Fp, 3, 3] Morton order
    tile_const: Optional[torch.Tensor] = None  # [Fp, 4]
    tile_gid: Optional[torch.Tensor] = None  # [Fp] original triangle id
    tile_cbounds: Optional[torch.Tensor] = None  # [C, 6] cluster AABBs
    tile_c16T: Optional[torch.Tensor] = None  # [Fp/8, 128] (pack_coeffT)
    tile_tree: Optional[torch.Tensor] = None  # [2L, 8] (cluster_tree)
    # Megakernel mesh tables (K1c; ops/megakernel.build_mega_mesh), Morton
    # order: [Fp, 16] (or the same memory as [Fp/8, 128] above 16,384
    # triangles, the JAX package's streamed layout).
    mega_c16: Optional[torch.Tensor] = None  # pack_coeff16 rows
    mega_attr: Optional[torch.Tensor] = None  # n0/n1/n2 xyz + mtl row
    mega_cbounds: Optional[torch.Tensor] = None  # [C, 8] AABB (6) + pad
    # K1c walks this tree of its rows' leaves (megakernel.build_mega_tree).
    mega_tree: Optional[torch.Tensor] = None  # [2L, 8] (cluster_tree)


class MeshInstances(NamedTuple):
    root: torch.Tensor  # [I] int32 BVH root node per instance
    mtl: torch.Tensor  # [I] int32 single material (-1 => per-face table)
    mtl_base: torch.Tensor  # [I] int32 base offset for per-face materials
    num_sub_mtl: torch.Tensor  # [I] int32 number of sub-materials
    m_w2o: torch.Tensor  # [I, 3, 3]
    t_o2w: torch.Tensor  # [I, 3]
    obj_bbox: torch.Tensor  # [I, 6] object-space bound box
    proot: Optional[torch.Tensor] = None  # [I] int32 packed root ref


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
    tex_id: torch.Tensor  # [M, NUM_SLOTS] int32 (-1 => no texture)
    tex_m: torch.Tensor  # [M, NUM_SLOTS, 3, 3] uvw w2t matrices
    tex_t: torch.Tensor  # [M, NUM_SLOTS, 3] uvw transform origins


class LightTable(NamedTuple):
    kind: torch.Tensor  # [L] int32
    intensity: torch.Tensor  # [L, 3]
    position: torch.Tensor  # [L, 3]
    direction: torch.Tensor  # [L, 3]
    size: torch.Tensor  # [L]
    inner: torch.Tensor  # [L]
    outer: torch.Tensor  # [L]


class TextureAtlas(NamedTuple):
    texels: torch.Tensor  # [T, 3] flat texel pool
    offset: torch.Tensor  # [K] int32
    width: torch.Tensor  # [K] int32
    height: torch.Tensor  # [K] int32
    kind: torch.Tensor  # [K] int32 (TEX_FILE | TEX_CHECKER)
    color1: torch.Tensor  # [K, 3] checker colours
    color2: torch.Tensor  # [K, 3]


class EnvColor(NamedTuple):
    """TexturedColor for background / environment."""

    color: torch.Tensor  # [3]
    tex_id: torch.Tensor  # [] int32 (-1 => none)
    tex_m: torch.Tensor  # [3, 3]
    tex_t: torch.Tensor  # [3]


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

    mtl: torch.Tensor  # [M, 22] float32, or [M, 102] with checker columns
    light: torch.Tensor  # [L, 12] float32
    cam: torch.Tensor  # [25] float32: camera, background, environment
    light_kind: torch.Tensor  # [max(L, 1)] int32
    light_soft: torch.Tensor  # [max(L, 1)] int32
    # K1c's mesh tables as [Fp, 16] rows and the [2L, 8] tree of their
    # leaves of ops.megakernel.MEGA_LEAF rows (views of MeshArrays.mega_*),
    # None without a megakernel mesh.
    mesh_rows: Optional[torch.Tensor] = None
    mesh_attr: Optional[torch.Tensor] = None
    mesh_tree: Optional[torch.Tensor] = None
    # Per-instance object-space meshes: each instance's M_w2o row-major and
    # t_o2w, the rows W1 (ops/bvh_packed.py) moves the rays with.
    inst_xf: Optional[torch.Tensor] = None  # [I, 12] float32


class SceneArrays(NamedTuple):
    analytic: AnalyticPrims
    materials: MaterialTable
    lights: LightTable
    background: EnvColor
    environment: EnvColor
    camera: CameraArrays
    textures: TextureAtlas
    kernel: Optional[KernelTables] = None
    mesh: Optional[MeshArrays] = None
    instances: Optional[MeshInstances] = None


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


def mega_textured(meta: SceneMeta) -> bool:
    """Does the megakernel sample this scene's (checker) textures itself?"""
    return meta.has_mtl_textures and meta.mega_tex_ok


def with_kernel_tables(arrays: SceneArrays, meta: SceneMeta) -> SceneArrays:
    """arrays with `kernel` packed from its tables and meta's static facts."""
    mt, lt, cam = arrays.materials, arrays.lights, arrays.camera
    mtl = torch.cat([
        mt.diffuse, mt.specular, mt.emission, mt.reflection, mt.refraction,
        mt.glossiness[:, None], mt.reflection_glossiness[:, None],
        mt.refraction_glossiness[:, None], mt.ior[:, None], mt.absorption,
    ], dim=1)
    if mega_textured(meta):
        # Checker columns (pallas_pathtrace._pack_tables, want_tex=True).
        atlas = arrays.textures
        cols = [mtl]
        for s in range(NUM_SLOTS):
            tid = mt.tex_id[:, s]
            safe = tid.clamp_min(0).long()
            cols += [(tid >= 0).to(torch.float32)[:, None],
                     atlas.color1[safe], atlas.color2[safe],
                     mt.tex_m[:, s, 0, :], mt.tex_m[:, s, 1, :],
                     mt.tex_t[:, s]]
        mtl = torch.cat(cols, dim=1)
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

    mesh = {}
    if meta.mesh_mega:
        m = arrays.mesh
        mesh = dict(mesh_rows=m.mega_c16.reshape(-1, 16),
                    mesh_attr=m.mega_attr.reshape(-1, 16),
                    mesh_tree=m.mega_tree)
    if meta.num_mesh_instances and not meta.world_bvh:
        inst = arrays.instances
        mesh["inst_xf"] = f32(torch.cat([inst.m_w2o.reshape(-1, 9),
                                         inst.t_o2w], dim=1))
    return arrays._replace(kernel=KernelTables(
        mtl=f32(mtl), light=f32(light), cam=f32(cam_tab),
        light_kind=ints(meta.light_kinds),
        light_soft=ints(tuple(int(s) for s in meta.light_soft)), **mesh,
    ))
