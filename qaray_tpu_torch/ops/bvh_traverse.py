"""The stacked BVH walk: a batch of rays walks per-lane stacks of nodes.

Counterpart of qaray_tpu/ops/bvh_traverse.py (traverse_bvh), the
re-expression of the reference's iterative stack walk
(objects/objects.cpp:324-419) over the flat SoA tree of scene/bvh.py: each
step pops one node per lane and either tests its (<= max_leaf) triangles
or slab-tests both children and pushes the hit ones, near child first.
The numerics are the JAX package's: the reciprocal-direction slab test
with the 1e-7 parallel-axis guard mapped to (-BIGFLOAT, BIGFLOAT), pruning
by entry < t_best and exit > BIAS, and ops/intersect.intersect_triangles.

Plain PyTorch on every device: QARAY_BVH_WALK=stacked selects it (the JAX
package calls it reference-shaped, for debugging); the default walk is the
packed one (ops/bvh_packed.py). Each step works on the lanes whose stacks
are not empty, which changes no lane's arithmetic.
"""

import torch

from qaray_tpu_torch.core.constants import BIAS, BIGFLOAT
from qaray_tpu_torch.ops.intersect import intersect_triangles


def slab_test(bounds, p, rcp_d, d_small, t_best):
    """Entry and exit of boxes bounds [B, 6] (min xyz, max xyz): (hit [B],
    entry [B]), the JAX package's _slab_test."""
    t_lo = (bounds[:, :3] - p) * rcp_d
    t_hi = (bounds[:, 3:6] - p) * rcp_d
    t0 = torch.where(d_small, -BIGFLOAT, torch.minimum(t_lo, t_hi))
    t1 = torch.where(d_small, BIGFLOAT, torch.maximum(t_lo, t_hi))
    entry = t0.amax(dim=-1)
    exit_ = t1.amin(dim=-1)
    return (entry < t_best) & (entry < exit_) & (exit_ > BIAS), entry


def ray_reciprocals(d):
    """(d_small, rcp_d): axes within 1e-7 of parallel, and 1/d (1 there)."""
    d_small = torch.abs(d) < 1e-7
    return d_small, torch.where(d_small, 1.0, 1.0 / d)


def push_near_first(stack, sp, stack_size, push0, push1, entry0, entry1,
                    ref0, ref1):
    """Push the hit children far first, so that the near child pops first
    (objects.cpp:404-416); returns the new stack pointers. Writes past the
    stack's end land in its last slot, as the JAX walk's clamp does."""
    lane = torch.arange(sp.shape[0], device=sp.device)
    both = push0 & push1
    near0 = entry0 < entry1
    first = torch.where(both, torch.where(near0, ref1, ref0),
                        torch.where(push0, ref0, ref1))
    second = torch.where(near0, ref0, ref1)
    idx0 = torch.clamp_max(sp, stack_size - 1).long()
    stack[lane, idx0] = torch.where(push0 | push1, first, stack[lane, idx0])
    sp1 = sp + (push0 | push1).to(torch.int32)
    idx1 = torch.clamp_max(sp1, stack_size - 1).long()
    stack[lane, idx1] = torch.where(both, second, stack[lane, idx1])
    return sp1 + both.to(torch.int32)


def traverse_bvh(p, d, roots, t_init, mesh, max_leaf: int = 4,
                 stack_size: int = 40, any_hit: bool = False):
    """Trace B object-space rays through the flat BVH of `mesh`
    (scene.arrays.MeshArrays: bvh_bounds/left/right/count/elems, tri_v).

    roots: [B] int32 per-lane root node ids; t_init: [B] the t to beat
    (BIGFLOAT, or t_max for shadow rays). Returns (t [B], tri [B] global
    triangle id or -1, bary [B, 3], front [B]). With any_hit a lane stops
    at its first accepted triangle, and only t < t_init means occluded."""
    n = p.shape[0]
    dev = p.device
    d_small, rcp_d = ray_reciprocals(d)
    stack = torch.zeros((n, stack_size), dtype=torch.int32, device=dev)
    stack[:, 0] = roots
    sp = torch.ones(n, dtype=torch.int32, device=dev)
    t_best = t_init.clone()
    tri_best = torch.full((n, ), -1, dtype=torch.int32, device=dev)
    bary_best = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    front_best = torch.zeros(n, dtype=torch.bool, device=dev)
    n_elems = mesh.bvh_elems.shape[0]
    while True:
        live = torch.nonzero(sp > 0).squeeze(1)
        if live.numel() == 0:
            break
        lp, ld, lsm, lrcp = p[live], d[live], d_small[live], rcp_d[live]
        lstack, lsp = stack[live], sp[live] - 1
        lane = torch.arange(live.numel(), device=dev)
        node = lstack[lane, lsp.long()].long()
        left = mesh.bvh_left[node]
        is_leaf = left < 0
        elem_off = mesh.bvh_right[node]
        count = mesh.bvh_count[node]
        t, tri = t_best[live], tri_best[live]
        bary, front = bary_best[live], front_best[live]
        for k in range(max_leaf):
            valid = is_leaf & (k < count)
            tri_id = mesh.bvh_elems[
                torch.clamp(elem_off + k, 0, max(n_elems - 1, 0)).long()]
            v = mesh.tri_v[tri_id.long()]
            t_hit, b, f, hit = intersect_triangles(lp, ld, v[:, 0], v[:, 1],
                                                   v[:, 2], t)
            take = valid & hit & (t_hit < t)
            t = torch.where(take, t_hit, t)
            tri = torch.where(take, tri_id, tri)
            bary = torch.where(take[:, None], b, bary)
            front = torch.where(take, f, front)
        child0 = left
        child1 = mesh.bvh_right[node]
        n_nodes = mesh.bvh_bounds.shape[0]
        c0 = torch.clamp(child0, 0, n_nodes - 1).long()
        c1 = torch.clamp(child1, 0, n_nodes - 1).long()
        hit0, entry0 = slab_test(mesh.bvh_bounds[c0], lp, lrcp, lsm, t)
        hit1, entry1 = slab_test(mesh.bvh_bounds[c1], lp, lrcp, lsm, t)
        hit0 &= ~is_leaf
        hit1 &= ~is_leaf
        new_sp = push_near_first(lstack, lsp, stack_size, hit0, hit1,
                                 entry0, entry1, child0, child1)
        if any_hit:
            new_sp = torch.where(tri >= 0, 0, new_sp)
        stack[live] = lstack
        sp[live] = new_sp
        t_best[live] = t
        tri_best[live] = tri
        bary_best[live] = bary
        front_best[live] = front
    return t_best, tri_best, bary_best, front_best
