"""Scene-level closest-hit and any-hit tracing over a ray batch.

Counterpart of qaray_tpu/ops/trace.py (trace_closest / trace_shadow,
reference scene/scene.cpp:35-76). Analytic primitives go through K2b/K2c
(ops/analytic.py). Meshes take one of three routes:

    tiles   world mesh, meta.mesh_tiled: K4a (two-phase) / K4b, the tiled
            cluster walk (ops/tiles.py)
    stream  world mesh, meta.mesh_stream: K3's culled walk, the dense
            sweep's function (ops/mesh_sweep.py)
    bvh     the packed BVH walk W1 (ops/bvh_packed.py) over the world tree,
            or over every instance's object-space tree with the ray moved
            to each instance's space (per-instance scenes: world_bvh=False,
            QARAY_NO_WORLD_BVH, or above 8M world triangles)

A world mesh takes the route its compiled tables select, as the JAX
package does on the TPU; QARAY_MESH_PATH=bvh|stream|tiles asks for a route
as it does there, and QARAY_BVH_WALK=stacked replaces the packed walk by
the stacked walk (ops/bvh_traverse.py, plain PyTorch on every device).
QARAY_NO_PALLAS or meta.force_xla ask for the kernels' plain versions on
the card too. On CUDA tensors the kernels run, on the CPU their plain
versions on the same route. The sweeps pick each ray's winning triangle
(and a runner-up); the winner's attributes come from the exact reference
test, falling back to the runner-up where the exact test rejects the
winner. The walks return the exact test's winner.

Hit record (dict of [B]-shaped tensors):
    t         world-space hit distance (BIGFLOAT if miss)
    hit       bool
    p         world hit position (at t = 1 on a miss: stays finite)
    n         world shading normal (unit)
    uvw       texture coordinates
    front     front-face flag
    mtl       material table index
    has_texture
    duvw0, duvw1  texture footprints d(uvw)/d(pixel), only with `diff`
"""

import os

import torch

from qaray_tpu_torch.core.constants import BIGFLOAT, RCP_DX, RCP_DY
from qaray_tpu_torch.core.vecmath import cross, dot, normalize
from qaray_tpu_torch.ops import analytic, bvh_packed, mesh_sweep, tiles
from qaray_tpu_torch.ops import intersect as I
from qaray_tpu_torch.ops.bvh_traverse import traverse_bvh
from qaray_tpu_torch.ops.mesh_stream import exact_winner
from qaray_tpu_torch.ops.mesh_tiles import (
    TiledMesh,
    coherence_order,
    exact_winner_rows,
)
from qaray_tpu_torch.scene.arrays import SceneArrays, SceneMeta

_KEYS = ("p", "n", "uvw", "front", "mtl", "has_texture")


def _plain(meta: SceneMeta) -> bool:
    """The kernels' plain versions on any device: QARAY_NO_PALLAS or
    meta.force_xla, as the JAX package's switches to its XLA routes."""
    return bool(os.environ.get("QARAY_NO_PALLAS")) or meta.force_xla


def mesh_route(meta: SceneMeta) -> str:
    """"tiles", "stream" or "bvh": the route of a scene's mesh (the JAX
    package's _use_tiles / _use_stream on the TPU, QARAY_MESH_PATH
    included)."""
    mode = os.environ.get("QARAY_MESH_PATH", "auto")
    if not meta.world_bvh or mode == "bvh":
        return "bvh"
    if meta.mesh_tiled:
        return "tiles"
    if mode == "stream" or meta.mesh_stream:
        return "stream"
    return "bvh"


def _check_stream(scene: SceneArrays):
    if scene.mesh.stream_c16 is None:
        raise NotImplementedError(
            f"dense sweep above {mesh_sweep.PALLAS_MESH_MAX_TRIS} triangles "
            "(QARAY_STREAM_MAX_TRIS): K3 reads the packed table built up to "
            "that size; leave the limit so that the tiled route is taken")


def _tiles_of(scene: SceneArrays) -> TiledMesh:
    m = scene.mesh
    return TiledMesh(m.tile_coeff, m.tile_const, m.tile_gid, m.tile_cbounds)


def _tile_perm(p, d, tm: TiledMesh):
    """Coherence sort for the tiled any-hit walk."""
    lo = tm.cbounds[:, :3].amin(dim=0)
    hi = tm.cbounds[:, 3:6].amax(dim=0)
    return coherence_order(p, d, lo, hi)


def _fallback(t_cur, first, second):
    """Merge the exact re-tests of the winner and the runner-up:
    (t, gid, bary, front), gid -1 and t BIGFLOAT where neither holds."""
    t_e, bary, front, valid, gid = first
    t2, bary2, front2, valid2, gid2 = second
    use2 = ~valid & valid2
    gid = torch.where(use2, gid2, gid)
    t_e = torch.where(use2, t2, t_e)
    bary = torch.where(use2[:, None], bary2, bary)
    front = torch.where(use2, front2, front)
    valid = (valid | use2) & (t_e < t_cur)
    return (torch.where(valid, t_e, torch.full_like(t_e, BIGFLOAT)),
            torch.where(valid, gid, torch.full_like(gid, -1)), bary, front)


def _tiled_closest(scene, meta, p, d, t_cur):
    """K4a's walk, then the exact re-test of its rows. Budget 0: one launch
    walks every ray to its end; a per-ray walk gains nothing from the
    two-phase's capped first launch, which ico6 showed slower (PERF.md)."""
    tm = _tiles_of(scene)
    _, rows, rows2 = tiles.tiled_closest_twophase(
        p, d, t_cur, tm, scene.mesh.tile_c16T, tree=scene.mesh.tile_tree,
        budget=0, plain=_plain(meta))
    tri_v = scene.mesh.tri_v
    return _fallback(t_cur, exact_winner_rows(p, d, rows, tm, tri_v),
                     exact_winner_rows(p, d, rows2, tm, tri_v))


def _stream_closest(scene, meta, p, d, t_cur):
    """K3's walk (the dense sweep's function), then the exact re-test of
    its rows. The rays walk in the order they come: on the card a
    coherence sort costs more than the walk gains from it (PERF.md)."""
    m = scene.mesh
    _, gid, gid2 = mesh_sweep.sweep_closest(p, d, t_cur, m.stream_c16,
                                            walk=mesh_sweep.walk_of(m),
                                            plain=_plain(meta))
    tri_v = scene.mesh.tri_v
    first = (*exact_winner(p, d, gid, tri_v), gid)
    second = (*exact_winner(p, d, gid2, tri_v), gid2)
    return _fallback(t_cur, first, second)


def _stacked(scene, meta, p, d, t, occluded=None):
    """The instance loop of bvh_packed.closest_plain / occluded_plain over
    the stacked walk (plain on every device): the closest hit below t (t,
    inst, tri, bary, front), or with `occluded` given the any hit below t
    = t_max, folded into it."""
    stack = meta.bvh_depth + 2

    def walk(po, do, roots, t0, any_hit=False, work=None):
        return traverse_bvh(po, do, roots, t0, scene.mesh, meta.max_leaf,
                            stack, any_hit=any_hit)

    inst = scene.instances
    roots, xf = ((inst.root[:1], None) if meta.world_bvh else
                 (inst.root, scene.kernel.inst_xf))
    if occluded is not None:
        return bvh_packed.occluded_plain(p, d, t, occluded, None, None, roots,
                                         xf, walk=walk)
    return bvh_packed.closest_plain(p, d, t, None, None, roots, xf,
                                    walk=walk)


def _walk_tables(scene, meta):
    """W1's tables: pnodes, ltri, the root refs and the instances'
    transforms (None for the world tree)."""
    m, inst = scene.mesh, scene.instances
    if meta.world_bvh:
        return m.pnodes, m.ltri, inst.proot[:1], None
    return m.pnodes, m.ltri, inst.proot, scene.kernel.inst_xf


def _bvh_closest(scene, meta, p, d, t_cur):
    if os.environ.get("QARAY_BVH_WALK") == "stacked":
        return _stacked(scene, meta, p, d, t_cur)
    return bvh_packed.closest(p, d, t_cur, *_walk_tables(scene, meta),
                              max_leaf=meta.max_leaf,
                              stack_size=meta.bvh_depth + 2,
                              plain=_plain(meta))


def _mesh_closest(scene: SceneArrays, meta: SceneMeta, p, d, t_cur):
    """Closest mesh hit below t_cur: (t, inst, tri, bary, front)."""
    route = mesh_route(meta)
    if route == "bvh":
        return _bvh_closest(scene, meta, p, d, t_cur)
    if route == "tiles":
        t, tri, bary, front = _tiled_closest(scene, meta, p, d, t_cur)
    else:
        _check_stream(scene)
        t, tri, bary, front = _stream_closest(scene, meta, p, d, t_cur)
    inst = torch.where(tri >= 0, 0, -1).to(torch.int32)
    return t, inst, tri, bary, front


def _mesh_hit_attrs(scene: SceneArrays, p, d, t, inst_id, tri_id, bary,
                    front):
    """Shading attributes of mesh hits (TriObj::IntersectTriangle)."""
    inst, mesh = scene.instances, scene.mesh
    si = inst_id.clamp_min(0).long()
    st = tri_id.clamp_min(0).long()
    m = inst.m_w2o[si]  # [B,3,3]
    n_c = mesh.tri_n[st]  # [B,3,3]
    n_obj = (bary[:, 0:1] * n_c[:, 0] + bary[:, 1:2] * n_c[:, 1]
             + bary[:, 2:3] * n_c[:, 2])
    # M_w2o^T n_obj
    n_world = (m[:, 0, :] * n_obj[:, 0:1] + m[:, 1, :] * n_obj[:, 1:2]
               + m[:, 2, :] * n_obj[:, 2:3])
    uv_c = mesh.tri_uv[st]  # [B,3,2]
    uv = (bary[:, 0:1] * uv_c[:, 0] + bary[:, 1:2] * uv_c[:, 1]
          + bary[:, 2:3] * uv_c[:, 2])
    uvw = torch.cat([uv, torch.zeros_like(uv[:, :1])], dim=-1)
    # Material: instance override, or per-face sub-material (MultiMtl).
    face_mtl = mesh.tri_mtl[st]
    sub = inst.mtl_base[si] + torch.minimum(
        face_mtl.clamp_min(0), (inst.num_sub_mtl[si] - 1).clamp_min(0))
    mtl = torch.where(inst.mtl[si] >= 0, inst.mtl[si], sub)
    return {
        "p": p + t[:, None] * d,
        "n": normalize(n_world, eps=1e-30),
        "uvw": uvw,
        "front": front,
        "mtl": mtl.to(torch.int32),
        "has_texture": mesh.tri_has_uv[st],
    }


def _mesh_diff_uv(scene, p, d, px, dx, py, dy, t, inst_id, tri_id, bary,
                  uvw):
    """Triangle diff-hit uv derivatives (TriObj::IntersectTriangle's diff
    block, objects.cpp:264-290): the offset rays hit the triangle's plane
    and the barycentric weights there interpolate the corner uvs."""
    inst, mesh = scene.instances, scene.mesh
    si = inst_id.clamp_min(0).long()
    st = tri_id.clamp_min(0).long()
    m = inst.m_w2o[si]
    t0 = inst.t_o2w[si]
    v = mesh.tri_v[st]  # [B,3,3]
    uvc = mesh.tri_uv[st]  # [B,3,2]
    v0, v1, v2 = v[:, 0], v[:, 1], v[:, 2]
    n = cross(v1 - v0, v2 - v0)
    abs_n = torch.abs(n)
    axis0 = (abs_n[..., 0] > abs_n[..., 1]) & (abs_n[..., 0] > abs_n[..., 2])
    axis1 = ~axis0 & (abs_n[..., 1] > abs_n[..., 2])

    def area(i, j, a, b, c):
        return ((b[..., i] - a[..., i]) * (c[..., j] - a[..., j])
                - (c[..., i] - a[..., i]) * (b[..., j] - a[..., j]))

    def bary_at(hp):
        def for_axes(i, j):
            s = area(i, j, v0, v1, v2)
            s = torch.where(torch.abs(s) < 1e-30, torch.full_like(s, 1e-30),
                            s)
            return area(i, j, hp, v1, v2) / s, area(i, j, hp, v2, v0) / s

        a0, b0 = for_axes(1, 2)
        a1, b1 = for_axes(0, 2)
        a2, b2 = for_axes(0, 1)
        a = torch.where(axis0, a0, torch.where(axis1, a1, a2))
        b = torch.where(axis0, b0, torch.where(axis1, b1, b2))
        return a, b, 1.0 - a - b

    def offset_uv(pw, dw):
        po = I._apply(m, pw - t0)
        do = I._apply(m, dw)
        denom = dot(do, n)
        denom = torch.where(torch.abs(denom) < 1e-20,
                            torch.full_like(denom, 1e-20), denom)
        t_off = -dot(po - v0, n) / denom
        a, b, c = bary_at(po + t_off[:, None] * do)
        uv = (a[:, None] * uvc[:, 0] + b[:, None] * uvc[:, 1]
              + c[:, None] * uvc[:, 2])
        return torch.cat([uv, torch.zeros_like(uv[:, :1])], dim=-1)

    return (RCP_DX * (offset_uv(px, dx) - uvw),
            RCP_DY * (offset_uv(py, dy) - uvw))


def trace_closest(scene: SceneArrays, meta: SceneMeta, p, d, diff=None):
    """Closest-hit trace of B world-space rays.

    diff: optional (px, dx, py, dy) differential rays (DiffRay, core/ray.h);
    the hit record then gains the winner's texture footprints `duvw0` and
    `duvw1`. The reference computes them for primary camera rays only (the
    default material's secondary DiffRays carry hasDiffRay=false,
    MtlBlinn_PhotonMap.cpp:233)."""
    # The kernel computes the uv only where a material texture reads it
    # (the JAX package's Pallas route); the CPU route always does (its XLA
    # route).
    plain = _plain(meta)
    full = analytic.closest_full(
        p, d, scene.analytic,
        want_uv=meta.has_mtl_textures or p.device.type == "cpu" or plain,
        plain=plain)
    attrs = {k: full[k] for k in _KEYS}
    t = full["t"]
    if meta.num_analytic == 0:  # only the compiler's placeholder primitive
        t = torch.full_like(t, BIGFLOAT)
    use_mesh = None
    if meta.num_mesh_instances > 0:
        # The mesh pass is pruned against the analytic t: a mesh hit it
        # returns is the closer one.
        t_m, inst, tri, bary, front = _mesh_closest(scene, meta, p, d, t)
        use_mesh = tri >= 0
        t = torch.where(use_mesh, t_m, t)
    hit = t < BIGFLOAT
    t_attr = torch.where(hit, t, torch.ones_like(t))
    if use_mesh is not None:
        attrs_m = _mesh_hit_attrs(scene, p, d, t_attr, inst, tri, bary,
                                  front)
        for k in _KEYS:
            sel = use_mesh.reshape((-1,) + (1,) * (attrs[k].ndim - 1))
            attrs[k] = torch.where(sel, attrs_m[k], attrs[k])
    if diff is not None:
        d0, d1 = I.analytic_diff_uv(p, d, *diff, t_attr, full["prim_idx"],
                                    scene.analytic, attrs["uvw"])
        if use_mesh is not None:
            d0m, d1m = _mesh_diff_uv(scene, p, d, *diff, t_attr, inst, tri,
                                     bary, attrs["uvw"])
            d0 = torch.where(use_mesh[:, None], d0m, d0)
            d1 = torch.where(use_mesh[:, None], d1m, d1)
        attrs["duvw0"] = d0
        attrs["duvw1"] = d1
    attrs["t"] = t
    attrs["hit"] = hit
    return attrs


def trace_shadow(scene: SceneArrays, meta: SceneMeta, p, d, t_max):
    """Any-hit occlusion: True where something blocks with BIAS < t < t_max
    (GenLight::Shadow, lights/lights.cpp:39-48; both sides count)."""
    plain = _plain(meta)
    if meta.num_analytic == 0:
        occluded = torch.zeros(p.shape[0], dtype=torch.bool, device=p.device)
    else:
        occluded = analytic.shadow(p, d, t_max, scene.analytic, plain=plain)
    if meta.num_mesh_instances == 0:
        return occluded
    route = mesh_route(meta)
    if route == "bvh":
        if os.environ.get("QARAY_BVH_WALK") == "stacked":
            return _stacked(scene, meta, p, d, t_max, occluded)
        return bvh_packed.occluded(p, d, t_max, occluded,
                                   *_walk_tables(scene, meta),
                                   max_leaf=meta.max_leaf,
                                   stack_size=meta.bvh_depth + 2, plain=plain)
    # Lanes already occluded get no budget.
    budget = torch.where(occluded, torch.zeros_like(t_max), t_max)
    if route == "tiles":
        tm = _tiles_of(scene)
        perm = _tile_perm(p, d, tm)
        occ_s = tiles.tiled_sweep_kernel(p[perm], d[perm], budget[perm], tm,
                                         scene.mesh.tile_c16T, any_hit=True,
                                         tree=scene.mesh.tile_tree,
                                         plain=plain)
        return occluded | occ_s[torch.argsort(perm)]
    _check_stream(scene)
    m = scene.mesh
    return occluded | mesh_sweep.sweep_occluded(p, d, budget, m.stream_c16,
                                                walk=mesh_sweep.walk_of(m),
                                                plain=plain)
