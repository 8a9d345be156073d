"""A plain bounding-volume hierarchy over one mesh's triangles and its walk
in plain torch, for the mesh field's reference.

The tree: triangles sorted by the Morton code of their centroids (10 bits
an axis over the mesh's box), cut into leaves of LEAF consecutive
triangles, and a complete binary tree over the leaves in heap order (node
k, counted from 1, has children 2k and 2k + 1; the leaves are nodes L to
2L - 1, L a power of two). Each box holds its triangles' vertices with
room on every side (pad_of), so that a box test never culls a triangle the
exact test would hit; boxes of no triangle are marked empty.

The walk goes breadth first, a level of the tree at a time, over all
rays together (walk), and tests the triangles of every leaf whose box a
ray enters below its bound with the upstream's IntersectTriangle
(objects/objects.cpp:212-248, reference/intersect.intersect_triangles).

Tie rule: a walk returns, of the triangles that the exact test hits below
t_max, the one of least t and, at equal t, of least triangle id; it does
not depend on the tree's shape, and equals a test of every triangle.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..reference.intersect import intersect_triangles

LEAF = 4
MORTON_BITS = 10
# Triangle tests of one batch at the leaves.
LEAF_TESTS = 1 << 22


class Tree(NamedTuple):
    lo: torch.Tensor  # [2L - 1, 3] box corners, heap order
    hi: torch.Tensor  # [2L - 1, 3]
    full: torch.Tensor  # [2L - 1] bool: the box holds a triangle
    order: torch.Tensor  # [L * LEAF] int64 triangle ids in leaf order, -1 pad


def _spread(x):
    """The bits of 10-bit integers spread to every third bit."""
    x = x.astype(np.uint64)
    out = np.zeros_like(x)
    for b in range(MORTON_BITS):
        out |= ((x >> np.uint64(b)) & np.uint64(1)) << np.uint64(3 * b)
    return out


def pad_of(tri_v: np.ndarray) -> float:
    """The room a box keeps around its triangles: 1e-4 of the mesh's
    largest coordinate (at least 1e-4)."""
    return 1e-4 * max(1.0, float(np.abs(tri_v).max()) if tri_v.size else 1.0)


def build(tri_v: np.ndarray) -> Tree:
    """The tree of triangles [F, 3, 3], its tables as numpy arrays."""
    f = tri_v.shape[0]
    p = tri_v.astype(np.float64)
    c = p.mean(axis=1)
    lo_all, hi_all = c.min(axis=0), c.max(axis=0)
    q = ((c - lo_all) / np.maximum(hi_all - lo_all, 1e-300)
         * ((1 << MORTON_BITS) - 1)).round().astype(np.int64)
    code = ((_spread(q[:, 0]) << np.uint64(2))
            | (_spread(q[:, 1]) << np.uint64(1)) | _spread(q[:, 2]))
    order = np.argsort(code, kind="stable")
    n_leaf = 1
    while n_leaf * LEAF < f:
        n_leaf *= 2
    padded = -np.ones(n_leaf * LEAF, np.int64)
    padded[:f] = order
    pad = pad_of(tri_v)
    t_lo = np.full((n_leaf * LEAF, 3), np.inf)
    t_hi = np.full((n_leaf * LEAF, 3), -np.inf)
    t_lo[:f] = p[order].min(axis=1) - pad
    t_hi[:f] = p[order].max(axis=1) + pad
    levels_lo = [t_lo.reshape(n_leaf, LEAF, 3).min(axis=1)]
    levels_hi = [t_hi.reshape(n_leaf, LEAF, 3).max(axis=1)]
    while levels_lo[0].shape[0] > 1:
        levels_lo.insert(0, levels_lo[0].reshape(-1, 2, 3).min(axis=1))
        levels_hi.insert(0, levels_hi[0].reshape(-1, 2, 3).max(axis=1))
    lo = np.concatenate(levels_lo)
    hi = np.concatenate(levels_hi)
    full = (lo <= hi).all(axis=1)
    lo = np.where(full[:, None], lo, 0.0)
    hi = np.where(full[:, None], hi, 0.0)
    return Tree(lo=lo.astype(np.float32), hi=hi.astype(np.float32),
                full=full, order=padded)


def reciprocals(d):
    """1 / d, with components under 1e-30 in size taken as +-1e30, so
    that the slab test stays finite."""
    tiny = torch.full_like(d, 1e-30).copysign(d)
    return 1.0 / torch.where(d.abs() < 1e-30, tiny, d)


def slab(lo, hi, p, rcp, t_max):
    """Whether the rays enter the boxes [lo, hi] at some t in [0, t_max]."""
    t1 = (lo - p) * rcp
    t2 = (hi - p) * rcp
    t_in = torch.minimum(t1, t2).amax(dim=-1).clamp_min(0.0)
    t_out = torch.maximum(t1, t2).amin(dim=-1)
    return t_in <= torch.minimum(t_out, t_max)


def walk(tree: Tree, tri_v, p, d, t_max):
    """The rays (p, d [n, 3] in the tree's space) against its triangles
    below t_max [n]: (t [n], triangle id [n]; t_max and -1 where none is
    hit). Breadth first: every level keeps the (ray, node) pairs whose box
    the ray enters below t_max and splits them into the node's children;
    the pairs left at the leaves test their triangles, LEAF_TESTS at a
    time, and each ray keeps the least (t, triangle id)."""
    n = p.shape[0]
    dev = p.device
    n_leaf = (tree.lo.shape[0] + 1) // 2
    rcp = reciprocals(d)
    ray = torch.arange(n, device=dev)
    node = torch.ones(n, dtype=torch.int64, device=dev)
    while True:
        keep = tree.full[node - 1] & slab(tree.lo[node - 1],
                                          tree.hi[node - 1], p[ray],
                                          rcp[ray], t_max[ray])
        ray, node = ray[keep], node[keep]
        if n_leaf == 1 or node.numel() == 0 or node[0] >= n_leaf:
            break
        ray = ray.repeat_interleave(2)
        node = (2 * node[:, None]
                + torch.arange(2, device=dev)).reshape(-1)
    tri = tree.order[((node - n_leaf) * LEAF)[:, None]
                     + torch.arange(LEAF, device=dev)].reshape(-1)
    ray = ray.repeat_interleave(LEAF)[tri >= 0]
    tri = tri[tri >= 0]
    best_t = t_max.clone()
    t_all = []
    for a in range(0, tri.shape[0], LEAF_TESTS):
        r, v = ray[a:a + LEAF_TESTS], tri_v[tri[a:a + LEAF_TESTS]]
        t, _, _, hit = intersect_triangles(p[r], d[r], v[:, 0], v[:, 1],
                                           v[:, 2], t_max[r])
        t_all.append(torch.where(hit, t, torch.inf))
    t = torch.cat(t_all) if t_all else best_t[:0]
    best_t.scatter_reduce_(0, ray, t, "amin")
    win = t == best_t[ray]
    best_tri = torch.full((n,), 1 << 62, dtype=torch.int64, device=dev)
    best_tri.scatter_reduce_(0, ray[win], tri[win], "amin")
    return best_t, torch.where(best_tri == 1 << 62, -1, best_tri)
