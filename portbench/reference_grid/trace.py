"""Closest-hit and any-hit tracing over analytic primitives and a field of
mesh instances, in plain torch.

The analytic part is the reference's (portbench/reference/trace.py):
every ray against every primitive. The meshes follow the upstream's
TriObj::IntersectRay -> TraceBVHNode -> IntersectTriangle
(objects/objects.cpp:212-419): a node moves the ray into its object space,
p_obj = M_w2o (p - t_o2w) and d_obj = M_w2o d (d_obj unnormalised, so t
is the world ray's parameter), and walks its mesh's tree there. Rays are
paired with the instances whose world box they enter below their bound,
and all pairs walk together (bvh.walk), in blocks of PAIR_BLOCK.

Tie rule: a ray takes a mesh hit only below the analytic t; among the
instances the least t wins and, at equal t, the least instance index (as
a walk over the instances in order that takes only a smaller t); within
an instance, the least triangle id at equal t (bvh.py).

Hit record: reference/trace.py's, with `mesh` (the closest hit is a mesh
triangle). A mesh hit's normal is the corners' normals weighted by the
barycentric coordinates and moved to world space (M_w2o^T n), front is
the ray meeting the triangle's winding side (d_obj . n <= 0), and the
material is the instance's.
"""

import torch

from ..reference import intersect as I
from ..reference import trace as analytic
from ..reference.arrays import SceneArrays, SceneMeta
from ..reference.constants import BIGFLOAT
from ..reference.vecmath import normalize
from . import bvh

# Ray-instance pairs of one walk, and rays of one test of the world boxes.
PAIR_BLOCK = 1 << 18
RAY_BLOCK = 1 << 16


def _pairs(field, p, d, t_max):
    """(ray, instance) index pairs whose world box the ray enters below
    t_max, in ray-major order."""
    rays, insts = [], []
    for a in range(0, p.shape[0], RAY_BLOCK):
        sp, sd = p[a:a + RAY_BLOCK], d[a:a + RAY_BLOCK]
        inside = bvh.slab(field.box_lo[None], field.box_hi[None], sp[:, None],
                          bvh.reciprocals(sd)[:, None],
                          t_max[a:a + RAY_BLOCK, None])
        r, i = torch.nonzero(inside, as_tuple=True)
        rays.append(r + a)
        insts.append(i)
    return torch.cat(rays), torch.cat(insts)


def _to_object(field, p, d, inst):
    m = field.m_w2o[inst]
    return I._apply(m, p - field.t_o2w[inst]), I._apply(m, d)


def _walk_pairs(field, p, d, t_max):
    """Every pair's walk: (ray, instance, t, triangle) over the pairs."""
    ray, inst = _pairs(field, p, d, t_max)
    ts, tris = [t_max[:0]], [ray[:0]]
    for a in range(0, ray.shape[0], PAIR_BLOCK):
        r, i = ray[a:a + PAIR_BLOCK], inst[a:a + PAIR_BLOCK]
        po, do = _to_object(field, p[r], d[r], i)
        t, tri = bvh.walk(field.tree, field.tri_v, po, do, t_max[r])
        ts.append(t)
        tris.append(tri)
    return ray, inst, torch.cat(ts), torch.cat(tris)


def mesh_closest(field, p, d, t_cur):
    """The closest mesh hit below t_cur: (t [B], instance [B], triangle
    [B]); -1 and t_cur where none."""
    n = p.shape[0]
    dev = p.device
    ray, inst, t, tri = _walk_pairs(field, p, d, t_cur)
    found = tri >= 0
    ray, inst, t, tri = ray[found], inst[found], t[found], tri[found]
    best_t = t_cur.clone().scatter_reduce(0, ray, t, "amin")
    at_best = t == best_t[ray]
    best_inst = torch.full((n,), -1, dtype=torch.int64, device=dev)
    first = torch.full((n,), 1 << 40, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, ray[at_best], inst[at_best], "amin")
    win = at_best & (inst == first[ray])
    best_inst[ray[win]] = inst[win]
    best_tri = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_tri[ray[win]] = tri[win]
    return best_t, best_inst, best_tri


def mesh_occluded(field, p, d, t_max):
    """Whether some mesh triangle lies at BIAS < t < t_max on each ray."""
    ray, _, _, tri = _walk_pairs(field, p, d, t_max)
    occ = torch.zeros(p.shape[0], dtype=torch.bool, device=p.device)
    occ[ray[tri >= 0]] = True
    return occ


def _mesh_attrs(field, p, d, t, inst, tri):
    """The hit attributes of mesh hits (inst, tri >= 0)."""
    si, st = inst.clamp_min(0), tri.clamp_min(0)
    po, do = _to_object(field, p, d, si)
    v = field.tri_v[st]
    _, bary, front, _ = I.intersect_triangles(
        po, do, v[:, 0], v[:, 1], v[:, 2],
        torch.full_like(t, BIGFLOAT))
    n_c = field.tri_n[st]
    n_obj = (bary[:, 0:1] * n_c[:, 0] + bary[:, 1:2] * n_c[:, 1]
             + bary[:, 2:3] * n_c[:, 2])
    n_world = I._apply_t(field.m_w2o[si], n_obj)
    return {
        "p": p + t[:, None] * d,
        "n": normalize(n_world, eps=1e-30),
        "uvw": torch.zeros_like(p),
        "front": front,
        "mtl": field.mtl[si],
        "has_texture": torch.zeros_like(front),
    }


def trace_closest(scene: SceneArrays, meta: SceneMeta, p, d, diff=None):
    """Closest-hit trace of B world-space rays (reference/trace.py's
    record and `mesh`); texture footprints (diff) on analytic hits only."""
    flat = meta._replace(num_mesh_instances=0)
    if scene.mesh is None:
        attrs = analytic.trace_closest(scene, flat, p, d, diff=diff)
        attrs["mesh"] = torch.zeros_like(attrs["hit"])
        return attrs
    if diff is not None:
        raise ValueError("the reference gives no texture footprints on "
                         "meshes")
    attrs = analytic.trace_closest(scene, flat, p, d)
    t, inst, tri = mesh_closest(scene.mesh, p, d, attrs["t"])
    mesh = tri >= 0
    m_attrs = _mesh_attrs(scene.mesh, p, d, torch.where(mesh, t, 1.0), inst,
                          tri)
    for k, v in m_attrs.items():
        sel = mesh.reshape((-1,) + (1,) * (v.ndim - 1))
        attrs[k] = torch.where(sel, v, attrs[k])
    attrs["t"] = torch.where(mesh, t, attrs["t"])
    attrs["hit"] = attrs["t"] < BIGFLOAT
    attrs["mesh"] = mesh
    return attrs


def trace_shadow(scene: SceneArrays, meta: SceneMeta, p, d, t_max,
                 parts: bool = False):
    """Any-hit occlusion: True where something blocks with BIAS < t <
    t_max (GenLight::Shadow, lights/lights.cpp:39-48; both sides count).
    With parts, also the lanes a mesh blocks and no analytic primitive
    does, which alone walk the meshes."""
    occ = analytic.trace_shadow(scene, meta, p, d, t_max)
    by_mesh = torch.zeros_like(occ)
    if scene.mesh is not None:
        open_ = torch.nonzero(~occ).squeeze(1)
        by_mesh[open_] = mesh_occluded(scene.mesh, p[open_], d[open_],
                                       t_max[open_])
    occ = occ | by_mesh
    return (occ, by_mesh) if parts else occ
