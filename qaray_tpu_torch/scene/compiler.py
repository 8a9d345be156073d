"""Scene compilation: host SceneDesc -> device SceneArrays.

Counterpart of qaray_tpu/scene/compiler.py. Each analytic object's
composed affine is baked once on the host, in numpy (p_obj = M_w2o @
(p_world - t_o2w), M_w2o = inv(M_o2w)); mesh instances are baked to world
space into one merged triangle set (_build_world_mesh_arrays) with the
tables of the mesh route its size selects. The finished tables then move
to the device in one step.

Textures are interned into one flat atlas: the background's and the
environment's first, then the materials' in table order, as the JAX
package does. With world_bvh=False, QARAY_NO_WORLD_BVH or above 8M world
triangles the meshes stay in object space instead (_build_mesh_arrays):
each unique mesh gets its own tree, packed into one pnodes/ltri table, and
each instance its root refs, transform and materials; ops/trace.py walks
them with W1 (ops/bvh_packed.py).
"""

from __future__ import annotations

import os

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from qaray_tpu_torch.scene import bvh as bvh_mod
from qaray_tpu_torch.scene import desc as D
from qaray_tpu_torch.scene.arrays import (
    KIND_PLANE,
    KIND_SPHERE,
    LIGHT_AMBIENT,
    LIGHT_DIRECT,
    LIGHT_POINT,
    LIGHT_SPOT,
    NUM_SLOTS,
    TEX_CHECKER,
    TEX_FILE,
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
from qaray_tpu_torch.utils.timing import span

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


def _stream_max_tris() -> int:
    """Triangle budget of the dense sweep route (K3); above it the compiler
    builds the tiled cluster route (K4a/K4b). QARAY_STREAM_MAX_TRIS
    overrides, as in the JAX package."""
    from qaray_tpu_torch.ops.mesh_sweep import PALLAS_MESH_MAX_TRIS

    return int(os.environ.get("QARAY_STREAM_MAX_TRIS", PALLAS_MESH_MAX_TRIS))


def _mega_stream_max_tris() -> int:
    """Triangle budget of the megakernel mesh sweep (K1c);
    QARAY_MEGA_STREAM_MAX_TRIS overrides."""
    return int(os.environ.get("QARAY_MEGA_STREAM_MAX_TRIS", 65536))


def _mega_mesh_max_tris() -> int:
    """Above this many triangles the JAX package streams the megakernel's
    mesh tables from HBM (meta.mesh_mega_stream, a [Fp/8, 128] layout of the
    same rows); K1c reads either the same way. QARAY_MEGA_MESH_MAX_TRIS
    overrides."""
    return int(os.environ.get("QARAY_MEGA_MESH_MAX_TRIS", 16384))


def _to_numpy32(a) -> np.ndarray:
    """64-bit numbers narrowed to 32 bits, as JAX stores them."""
    a = np.array(a)
    if a.dtype == np.float64:
        return a.astype(np.float32)
    if a.dtype == np.int64:
        return a.astype(np.int32)
    return a


# Triangles per BVH leaf (the JAX compiler's default), and the world
# triangle count above which the JAX package keeps meshes per instance.
MAX_LEAF = 4
WORLD_BVH_MAX_TRIS = 8_000_000


class SceneCompiler:
    def __init__(self, scene: D.SceneDesc, world_bvh: bool = True):
        self.scene = scene
        self.world_bvh = world_bvh and not os.environ.get("QARAY_NO_WORLD_BVH")
        self.mtl_index: Dict[int, int] = {}  # id(MaterialDesc) -> table row
        self.mtl_multi_base: Dict[int, Tuple[int, int]] = {}  # -> base, count
        self.materials: List[D.MaterialDesc] = []
        self.tex_index: Dict[int, int] = {}  # id(TextureDesc) -> atlas index
        self.textures: List[D.TextureDesc] = []
        self.has_mtl_textures = False  # set by _material_table
        self.kinds: List[int] = []
        self.prim_mtl: List[int] = []
        self.m_w2o: List[np.ndarray] = []
        self.t_o2w: List[np.ndarray] = []
        # Mesh instances: (mesh, single, base, num_sub), world (M_o2w, t),
        # M_w2o.
        self.inst_mesh: List[tuple] = []
        self.inst_world: List[tuple] = []
        self.inst_m: List[np.ndarray] = []
        self.mega_mtls: tuple = ()
        self.mega_stream = False

    def _intern_texture(self, tex: Optional[D.TextureDesc]) -> int:
        if tex is None:
            return -1
        key = id(tex)
        if key not in self.tex_index:
            self.tex_index[key] = len(self.textures)
            self.textures.append(tex)
        return self.tex_index[key]

    def _intern_material(self, mtl) -> Tuple[int, int, int]:
        """(single, multi_base, num_sub): single >= 0 for a plain material;
        a multi-material gives single = -1 and its sub-materials at rows
        [multi_base, multi_base + num_sub)."""
        if mtl is None:
            mtl = _default_material()
        key = id(mtl)
        if mtl.sub_materials is not None:
            if key not in self.mtl_multi_base:
                base = len(self.materials)
                self.materials.extend(mtl.sub_materials)
                self.mtl_multi_base[key] = (base, len(mtl.sub_materials))
            base, count = self.mtl_multi_base[key]
            return -1, base, count
        if key not in self.mtl_index:
            self.mtl_index[key] = len(self.materials)
            self.materials.append(mtl)
        return self.mtl_index[key], 0, 0

    def _flatten(self, node: D.NodeDesc, parent: D.Affine):
        world = parent.compose(node.xform)
        if node.obj_type in ("sphere", "plane"):
            mtl = (self.scene.find_material(node.mtl_name)
                   if node.mtl_name else None)
            self.kinds.append(
                KIND_SPHERE if node.obj_type == "sphere" else KIND_PLANE
            )
            self.prim_mtl.append(self._intern_material(mtl)[0])
            self.m_w2o.append(np.linalg.inv(world.m))
            self.t_o2w.append(world.t)
        elif node.obj_type == "mesh" and node.mesh is not None:
            mtl = (self.scene.find_material(node.mtl_name)
                   if node.mtl_name else None)
            self.inst_mesh.append((node.mesh, *self._intern_material(mtl)))
            self.inst_m.append(np.linalg.inv(world.m))
            self.inst_world.append((world.m, world.t))
        for child in node.children:
            self._flatten(child, world)

    # -- meshes --------------------------------------------------------------

    def _build_mesh_arrays(self):
        """Per-instance object-space meshes
        (qaray_tpu/scene/compiler.py::_build_mesh_arrays): the unique
        meshes concatenated, each with its own BVH whose node and element
        indices are offset into the global arrays, packed together
        (pack_bvh), and per instance its root node and packed root ref,
        material (single, or the MultiMtl base and count), object-space
        bound box and transform. Returns (MeshArrays tables as numpy,
        instance tables, bvh depth)."""
        tri_v, tri_n, tri_uv, tri_has_uv, tri_mtl, parts = [], [], [], [], \
            [], []
        records = {}
        tri_off = node_off = 0
        depth = 1
        for mesh, *_ in self.inst_mesh:
            if id(mesh) in records:
                continue
            v, n, uv, has_uv, fm = self._mesh_face_data(mesh)
            with span("scene.bvh_build"):
                bvh = bvh_mod.build_bvh(v, MAX_LEAF)
            depth = max(depth, bvh_mod.bvh_depth(bvh))
            records[id(mesh)] = {
                "root": node_off,
                "bbox": (np.concatenate([v.reshape(-1, 3).min(0),
                                         v.reshape(-1, 3).max(0)])
                         if v.size else np.array([1, 1, 1, 0, 0, 0],
                                                 np.float32)),
            }
            tri_v.append(v.astype(np.float32))
            tri_n.append(n.astype(np.float32))
            tri_uv.append(uv.astype(np.float32))
            tri_has_uv.append(has_uv)
            tri_mtl.append(fm.astype(np.int32))
            leaf = bvh.left < 0
            parts.append((bvh.bounds,
                          np.where(leaf, -1, bvh.left + node_off),
                          np.where(leaf, bvh.right + tri_off,
                                   bvh.right + node_off),
                          bvh.count, bvh.elems + tri_off))
            tri_off += v.shape[0]
            node_off += len(bvh.left)
        all_v = np.concatenate(tri_v)
        g = [np.concatenate([part[k] for part in parts]) for k in range(5)]
        with span("scene.bvh_build"):
            pnodes, ltri, node_ref = bvh_mod.pack_bvh(*g, all_v)
        mesh_tabs = dict(
            tri_v=all_v, tri_n=np.concatenate(tri_n),
            tri_uv=np.concatenate(tri_uv),
            tri_has_uv=np.concatenate(tri_has_uv),
            tri_mtl=np.concatenate(tri_mtl), bvh_bounds=g[0],
            bvh_left=g[1], bvh_right=g[2], bvh_count=g[3], bvh_elems=g[4],
            pnodes=pnodes, ltri=ltri,
        )
        n_inst = len(self.inst_mesh)
        inst = dict(root=np.zeros(n_inst, np.int32),
                    mtl=-np.ones(n_inst, np.int32),
                    mtl_base=np.zeros(n_inst, np.int32),
                    num_sub_mtl=np.zeros(n_inst, np.int32),
                    m_w2o=np.stack(self.inst_m).astype(np.float32),
                    t_o2w=np.stack([t for _, t in self.inst_world])
                    .astype(np.float32),
                    obj_bbox=np.zeros((n_inst, 6), np.float32),
                    proot=np.zeros(n_inst, np.int32))
        for i, (mesh, single, base, nsub) in enumerate(self.inst_mesh):
            rec = records[id(mesh)]
            inst["root"][i] = rec["root"]
            inst["proot"][i] = node_ref[rec["root"]]
            inst["mtl"][i] = single
            inst["mtl_base"][i] = base
            inst["num_sub_mtl"][i] = nsub
            inst["obj_bbox"][i] = rec["bbox"]
        return mesh_tabs, inst, depth

    @staticmethod
    def _mesh_face_data(mesh: D.MeshDesc):
        """Per-face object-space (v [F,3,3], n [F,3,3], uv [F,3,2],
        has_uv [F], face_mtl [F])."""
        v = mesh.vertices[mesh.faces]  # [F,3,3]
        flat = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
        flat = flat / np.maximum(np.linalg.norm(flat, axis=1, keepdims=True),
                                 1e-20)
        if mesh.normals is not None and mesh.face_normals is not None:
            fn = np.where(mesh.face_normals < 0, 0, mesh.face_normals)
            n = mesh.normals[fn]
            missing = (mesh.face_normals < 0).any(axis=1)
            n = np.where(missing[:, None, None], flat[:, None, :], n)
        else:
            n = np.repeat(flat[:, None, :], 3, axis=1)
        if mesh.texcoords is not None and mesh.face_texcoords is not None:
            ft = np.where(mesh.face_texcoords < 0, 0, mesh.face_texcoords)
            uv = mesh.texcoords[ft]
            has_uv = ~(mesh.face_texcoords < 0).any(axis=1)
        else:
            uv = np.zeros((v.shape[0], 3, 2), np.float32)
            has_uv = np.zeros((v.shape[0],), bool)
        fm = (mesh.face_materials if mesh.face_materials is not None
              else -np.ones((v.shape[0],), np.int32))
        return v, n, uv, has_uv, fm

    def _build_world_mesh_arrays(self):
        """World-space instance baking: every instance's triangles move to
        world space on the host and one merged set covers them all, so
        tracing needs no per-instance transforms
        (qaray_tpu/scene/compiler.py::_build_world_mesh_arrays).

        - t: world-space triangles give the reference's node-space t, since
          it intersects with an unnormalized transformed direction.
        - normals: corner normals are pre-multiplied by M_w2o^T,
          unnormalized; interpolation commutes with the linear map.
        - front face: mirror instances (negative determinant) swap corners
          1 and 2, so the geometric normal keeps its orientation.
        - materials: per-face sub-material ids resolve to table rows here.

        Returns (MeshArrays tables as numpy, instance tables, bvh depth)."""
        wv_l, wn_l, uv_l, huv_l, mtl_l = [], [], [], [], []
        for i, (mesh, single, base, nsub) in enumerate(self.inst_mesh):
            v, n, uv, has_uv, fm = self._mesh_face_data(mesh)
            m_o2w, t = self.inst_world[i]
            wv = v @ m_o2w.T + t
            wn = n @ self.inst_m[i]  # row form of M_w2o^T @ n
            if np.linalg.det(m_o2w) < 0.0:
                wv = wv[:, [0, 2, 1]]
                wn = wn[:, [0, 2, 1]]
                uv = uv[:, [0, 2, 1]]
            if single >= 0:
                mtl = np.full((v.shape[0],), single, np.int32)
            else:
                mtl = base + np.clip(fm, 0, max(nsub - 1, 0))
            wv_l.append(wv.astype(np.float32))
            wn_l.append(wn.astype(np.float32))
            uv_l.append(uv.astype(np.float32))
            huv_l.append(has_uv)
            mtl_l.append(mtl.astype(np.int32))

        from qaray_tpu_torch.ops.mesh_stream import build_stream
        from qaray_tpu_torch.ops.mesh_sweep import (
            PALLAS_MESH_MAX_TRIS,
            build_walk,
            pack_coeff16,
        )

        wv = np.concatenate(wv_l)
        wn = np.concatenate(wn_l)
        mtl_all = np.concatenate(mtl_l)
        num = wv.shape[0]
        with span("scene.bvh_build"):
            bvh = bvh_mod.build_bvh(wv, MAX_LEAF)
            pnodes, ltri, node_ref = bvh_mod.pack_bvh(
                bvh.bounds, bvh.left, bvh.right, bvh.count, bvh.elems, wv)
        tables = {}
        # The dense sweep under the stream budget, the tiled clusters above
        # it: only the selected route's tables are built.
        if num <= _stream_max_tris():
            stream = build_stream(wv)
            tables.update(stream_coeff=stream.coeff,
                          stream_const=stream.const)
            if num <= PALLAS_MESH_MAX_TRIS:
                walk = build_walk(wv)
                tables.update(stream_c16=pack_coeff16(stream.coeff,
                                                      stream.const),
                              stream_rows=walk.rows, stream_gid=walk.gid,
                              stream_tree=walk.tree)
        else:
            from qaray_tpu_torch.ops.mesh_tiles import build_tiles
            from qaray_tpu_torch.ops.tiles import cluster_tree, pack_coeffT

            tiles = build_tiles(wv)
            tables.update(tile_coeff=tiles.coeff, tile_const=tiles.const,
                          tile_gid=tiles.gid, tile_cbounds=tiles.cbounds,
                          tile_c16T=pack_coeffT(tiles.coeff, tiles.const),
                          tile_tree=cluster_tree(tiles.cbounds))
        # The megakernel's mesh tables (K1c), beside either route.
        if 0 < num <= _mega_stream_max_tris():
            distinct = tuple(sorted(int(m) for m in np.unique(mtl_all)))
            if len(distinct) <= 8:
                from qaray_tpu_torch.ops.megakernel import (
                    build_mega_mesh,
                    build_mega_tree,
                )

                c16, attr, cb = build_mega_mesh(wv, wn, mtl_all)
                tree = build_mega_tree(wv, c16.shape[0])
                if num > _mega_mesh_max_tris():
                    c16, attr = c16.reshape(-1, 128), attr.reshape(-1, 128)
                    self.mega_stream = True
                tables.update(mega_c16=c16, mega_attr=attr, mega_cbounds=cb,
                              mega_tree=tree)
                self.mega_mtls = distinct
        mesh = dict(
            tri_v=wv, tri_n=wn, tri_uv=np.concatenate(uv_l),
            tri_has_uv=np.concatenate(huv_l), tri_mtl=mtl_all,
            bvh_bounds=bvh.bounds, bvh_left=bvh.left, bvh_right=bvh.right,
            bvh_count=bvh.count, bvh_elems=bvh.elems, pnodes=pnodes,
            ltri=ltri, **tables,
        )
        bbox = np.concatenate([wv.reshape(-1, 3).min(0),
                               wv.reshape(-1, 3).max(0)])
        instances = dict(
            root=np.zeros(1, np.int32),
            mtl=-np.ones(1, np.int32),  # resolve through the face table
            mtl_base=np.zeros(1, np.int32),
            # tri_mtl holds final rows; the clip must keep them all.
            num_sub_mtl=np.full(1, max(len(self.materials), 1), np.int32),
            m_w2o=np.eye(3, dtype=np.float32)[None],
            t_o2w=np.zeros((1, 3), np.float32),
            obj_bbox=bbox.astype(np.float32)[None],
            proot=np.asarray([node_ref[0]], np.int32),
        )
        return mesh, instances, bvh_mod.bvh_depth(bvh)

    def _material_table(self) -> Dict[str, np.ndarray]:
        mats = self.materials or [_default_material()]
        m = len(mats)

        def col(get, shape=(3,)):
            return np.stack([
                np.broadcast_to(np.asarray(get(x), np.float32), shape)
                for x in mats
            ])

        tex_id = -np.ones((m, NUM_SLOTS), np.int32)
        tex_m = np.broadcast_to(np.eye(3, dtype=np.float32),
                                (m, NUM_SLOTS, 3, 3)).copy()
        tex_t = np.zeros((m, NUM_SLOTS, 3), np.float32)
        for i, mat in enumerate(mats):
            for s, slot in enumerate(_SLOTS):
                tc = getattr(mat, slot)
                if _live_texture(tc):
                    tex_id[i, s] = self._intern_texture(tc.map.texture)
                    tex_m[i, s] = np.linalg.inv(tc.map.xform.m).astype(
                        np.float32)
                    tex_t[i, s] = tc.map.xform.t.astype(np.float32)
        self.has_mtl_textures = bool((tex_id >= 0).any())

        def colour(slot):
            # A slot whose texture failed to load samples as colour * 0 in
            # the reference (textures/texture.cpp:97-99): fold it to black
            # with no texture, which is exact for every uv.
            arr = col(lambda x: getattr(x, slot).color)
            for i, mat in enumerate(mats):
                tc = getattr(mat, slot)
                if tc.map is not None and not _live_texture(tc):
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
            tex_id=tex_id, tex_m=tex_m, tex_t=tex_t,
        )

    def _mega_tex_slots(self) -> tuple:
        """Which material slots carry any live texture."""
        return tuple(
            any(_live_texture(getattr(m, s)) for m in self.materials)
            for s in _SLOTS
        )

    def _mega_tex_ok(self) -> bool:
        """May the megakernel texture this scene? Only if every live
        material texture is a procedural checker (K1b computes it; a file
        texture is sampled on the wavefront route) and no megakernel-mesh
        face material is textured (its attribute rows carry no UVs)."""
        if not self.has_mtl_textures:
            return False
        for m in self.materials:
            for s in _SLOTS:
                tc = getattr(m, s)
                if tc.map is not None and tc.map.texture.kind not in (
                        "missing", "checker"):
                    return False
        for row in self.mega_mtls:
            if any(_live_texture(getattr(self.materials[row], s))
                   for s in _SLOTS):
                return False
        return True

    def _texture_atlas(self) -> Dict[str, np.ndarray]:
        texels = [np.zeros((1, 3), np.float32)]
        offset, width, height, kind, c1, c2 = [], [], [], [], [], []
        cursor = 1
        for tex in self.textures:
            if tex.kind == "checker":
                offset.append(0)
                width.append(0)
                height.append(0)
                kind.append(TEX_CHECKER)
                c1.append(tex.color1)
                c2.append(tex.color2)
            else:
                h, w = tex.image.shape[:2]
                texels.append(tex.image.reshape(-1, 3).astype(np.float32))
                offset.append(cursor)
                width.append(w)
                height.append(h)
                kind.append(TEX_FILE)
                c1.append(np.zeros(3))
                c2.append(np.zeros(3))
                cursor += h * w
        pad = max(len(self.textures), 1) - len(self.textures)
        return dict(
            texels=np.concatenate(texels),
            offset=np.array(offset + [0] * pad, np.int32),
            width=np.array(width + [0] * pad, np.int32),
            height=np.array(height + [0] * pad, np.int32),
            kind=np.array(kind + [TEX_FILE] * pad, np.int32),
            color1=np.stack(c1 + [np.zeros(3)] * pad).astype(np.float32),
            color2=np.stack(c2 + [np.zeros(3)] * pad).astype(np.float32),
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

    def _env_color(self, tc: D.TexturedColor) -> Dict[str, np.ndarray]:
        color = np.asarray(tc.color, np.float32)
        tid = -1
        m, t = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
        if _live_texture(tc):
            tid = self._intern_texture(tc.map.texture)
            m = np.linalg.inv(tc.map.xform.m).astype(np.float32)
            t = tc.map.xform.t.astype(np.float32)
        elif tc.map is not None:  # failed texture load samples as black
            color = np.zeros(3, np.float32)
        return dict(color=color, tex_id=np.int32(tid), tex_m=m, tex_t=t)

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
        mesh_tabs = inst_tabs = None
        depth = 1
        world = False
        if self.inst_mesh:
            total = sum(m.faces.shape[0] for m, *_ in self.inst_mesh)
            world = self.world_bvh and total <= WORLD_BVH_MAX_TRIS
            if world:
                mesh_tabs, inst_tabs, depth = self._build_world_mesh_arrays()
            else:
                mesh_tabs, inst_tabs, depth = self._build_mesh_arrays()
            if torch.device(device).type == "cuda":
                # W1 walks any of these trees (per-instance trees always, a
                # world tree on the bvh route) with a stack of depth + 2 refs.
                from qaray_tpu_torch.ops.bvh_packed import check_stack

                check_stack(depth + 2)
        # The background's and the environment's textures are interned
        # before the materials', so the atlas lists them first.
        background = self._env_color(self.scene.background)
        environment = self._env_color(self.scene.environment)
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
            return torch.as_tensor(_to_numpy32(a), device=device)

        def group(cls, tables):
            return cls(**{k: dev(v) for k, v in tables.items()})

        meshes = mesh_tabs is not None
        num_tris = int(mesh_tabs["tri_v"].shape[0]) if meshes else 0

        arrays = SceneArrays(
            analytic=analytic_prims(**{k: dev(v) for k, v in prims.items()}),
            materials=group(MaterialTable, mtl_table),
            lights=group(LightTable, self._light_table()),
            background=group(EnvColor, background),
            environment=group(EnvColor, environment),
            camera=group(CameraArrays, self._camera()),
            textures=group(TextureAtlas, self._texture_atlas()),
            mesh=group(MeshArrays, mesh_tabs) if meshes else None,
            instances=group(MeshInstances, inst_tabs) if meshes else None,
        )
        lights = self.scene.lights
        meta = SceneMeta(
            img_width=self.scene.camera.img_width,
            img_height=self.scene.camera.img_height,
            num_analytic=n_analytic,
            num_mesh_instances=(int(world) if world
                                else len(self.inst_mesh)),
            num_tris=num_tris,
            num_lights=len(lights),
            num_materials=len(self.materials),
            has_dof=self.scene.camera.depth_of_field > 0.1,
            bvh_depth=depth,
            has_ambient=any(light.kind == "ambient" for light in lights),
            light_kinds=tuple(_LIGHT_KIND[light.kind] for light in lights),
            light_soft=tuple(bool(light.size > 0.01) for light in lights),
            analytic_kinds=tuple(int(k) for k in self.kinds),
            analytic_mtls=tuple(int(m) for m in self.prim_mtl),
            has_glossy=any(
                m.reflection_glossiness > 0 or m.refraction_glossiness > 0
                for m in self.materials
            ),
            has_mtl_textures=self.has_mtl_textures,
            has_bg_texture=_live_texture(self.scene.background),
            has_env_texture=_live_texture(self.scene.environment),
            mega_tex_ok=self._mega_tex_ok(),
            mega_tex_slots=self._mega_tex_slots(),
            world_bvh=world,
            mesh_stream=world and "stream_coeff" in mesh_tabs
            and num_tris <= _stream_max_tris(),
            mesh_tiled=world and "tile_coeff" in mesh_tabs,
            mesh_mega=world and "mega_c16" in mesh_tabs,
            mesh_mega_mtls=self.mega_mtls,
            mesh_mega_stream=self.mega_stream,
            max_leaf=MAX_LEAF,
        )
        return with_kernel_tables(arrays, meta), meta


def compile_scene(scene: D.SceneDesc, device="cuda", world_bvh: bool = True):
    """Compile a parsed SceneDesc into (SceneArrays on `device`, SceneMeta).

    Meshes are baked to world space (world_bvh=True, the default) and
    stay per instance in object space with world_bvh=False (or
    QARAY_NO_WORLD_BVH=1, or above WORLD_BVH_MAX_TRIS world triangles).
    Its host time is the span scene.compile."""
    with span("scene.compile"):
        return SceneCompiler(scene, world_bvh=world_bvh).compile(device)
