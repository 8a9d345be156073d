"""Host-side BVH build over triangles, flattened for device traversal.

Counterpart of qaray_tpu/scene/bvh.py and of the host part of
qaray_tpu/ops/bvh_packed.py (pack_bvh). The same build policy as the
reference's vendored cyBVH (src/ext/cyBVH.h): binary tree, leaves of up to
`max_leaf` triangles, split by a binned surface-area heuristic (method
"sah", the default) or by the reference's MeanSplit (method "mean"). The
arrays are plain SoA numpy:

    bounds  [N, 6]  (min xyz, max xyz)
    left    [N]     left child index, or -1 for leaf
    right   [N]     right child index, or first-element offset for leaf
    count   [N]     0 for inner, element count for leaf
    elems   [F]     triangle indices in leaf order

build_bvh takes the port's native builder (qaray_tpu_torch/native.py) where
it loads and the numpy builders below where it does not; all give the same
tree, node for node. QARAY_BVH=sah|mean overrides the method, as in the
JAX package. The BVH walks (ops/bvh_traverse.py, ops/bvh_packed.py) read
these arrays and pack_bvh's fat-node tables.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np


class FlatBVH(NamedTuple):
    bounds: np.ndarray  # [N, 6] float32
    left: np.ndarray  # [N] int32 (-1 for leaf)
    right: np.ndarray  # [N] int32 (child or elem offset)
    count: np.ndarray  # [N] int32 (leaf element count; 0 for inner)
    elems: np.ndarray  # [F] int32


_SAH_BINS = 16


def _empty_bvh() -> FlatBVH:
    """One empty leaf."""
    return FlatBVH(
        bounds=np.zeros((1, 6), np.float32),
        left=np.array([-1], np.int32),
        right=np.array([0], np.int32),
        count=np.array([0], np.int32),
        elems=np.zeros((0,), np.int32),
    )


def build_bvh(tri_verts: np.ndarray, max_leaf: int = 4,
              use_native: bool = True, method: str = "sah") -> FlatBVH:
    """tri_verts: [F, 3, 3] triangle vertex positions (object space).

    method "sah": binned surface-area heuristic; "mean": the reference's
    cyBVH MeanSplit (spatial median on the widest axis, 3-axis fallback;
    cyBVH.h:380-420). The walks' results do not depend on the method, only
    the tree's shape does. QARAY_BVH overrides `method`. The native builder
    runs where use_native and the library loads; the numpy builders give
    the same tree otherwise."""
    if os.environ.get("QARAY_BVH"):
        method = os.environ["QARAY_BVH"]
    if method not in ("sah", "mean"):
        raise ValueError(f"unknown BVH build method {method!r}")
    if use_native:
        from qaray_tpu_torch import native

        out = native.bvh_build_native(tri_verts.astype(np.float32),
                                      max_leaf, method=method)
        if out is not None:
            return FlatBVH(*out)
    if method == "sah":
        return _build_bvh_sah_numpy(tri_verts, max_leaf)
    return _build_bvh_numpy(tri_verts, max_leaf)


def _build_bvh_sah_numpy(tri_verts: np.ndarray,
                         max_leaf: int = 4) -> FlatBVH:
    """Binned SAH build: 16 centroid bins on the widest centroid axis;
    split minimizing SA_L*N_L + SA_R*N_R; spatial-median fallback when
    binning degenerates (all centroids in one bin).

    The tree is node-for-node the JAX package's numpy build, which splits
    one node at a time off a stack. Here every node of a level is split at
    once (numpy over all of the level's triangles, with each node's
    arithmetic unchanged), and a last pass numbers the nodes and orders the
    leaves as that stack build does: depth first, right child first, both
    children numbered when their parent is split."""
    num_tris = tri_verts.shape[0]
    if num_tris == 0:
        return _empty_bvh()

    tri_min = tri_verts.min(axis=1)
    tri_max = tri_verts.max(axis=1)
    tri_center = 0.5 * (tri_min + tri_max)
    nbin = _SAH_BINS

    def half_area(bmin, bmax):  # [..., 3] boxes -> [...]
        e = np.maximum(bmax - bmin, 0.0)
        x, y, z = e[..., 0], e[..., 1], e[..., 2]
        return x * y + y * z + z * x

    # Nodes in creation order ("build ids"): bounds, children, leaf ids.
    bounds_l, kids_l, leaf_ids = [], [], {}
    ids = np.arange(num_tris, dtype=np.int64)  # the level's nodes' triangles
    counts = np.array([num_tris], np.int64)  # triangles per node
    first = 0  # build id of the level's first node
    while counts.size:
        k = counts.size
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        bmin = np.minimum.reduceat(tri_min[ids], starts, axis=0)
        bmax = np.maximum.reduceat(tri_max[ids], starts, axis=0)
        bounds_l.append(
            np.concatenate([bmin, bmax], axis=1).astype(np.float32))
        leaf = counts <= max_leaf
        kids = np.full((k, 2), -1, np.int64)
        for j in np.flatnonzero(leaf):
            leaf_ids[first + j] = ids[starts[j]:starts[j] + counts[j]]
        inner = np.flatnonzero(~leaf)
        kids[inner, 0] = first + k + 2 * np.arange(inner.size)
        kids[inner, 1] = kids[inner, 0] + 1
        kids_l.append(kids)
        if not inner.size:
            break
        seg_all = np.repeat(np.arange(k), counts)
        keep = ~leaf[seg_all]
        ids, seg = ids[keep], np.repeat(np.arange(inner.size), counts[inner])
        counts = counts[inner]
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        pos = np.arange(ids.size) - starts[seg]

        centers = tri_center[ids]
        cmin = np.minimum.reduceat(centers, starts, axis=0)
        cmax = np.maximum.reduceat(centers, starts, axis=0)
        axis = np.argmax(cmax - cmin, axis=1)
        node = np.arange(counts.size)
        extent = cmax[node, axis] - cmin[node, axis]
        # Degenerate: identical centroids -- split the list in half.
        right = pos >= (counts // 2)[seg]
        binned = np.flatnonzero(extent > 1e-12)
        if binned.size:
            # The stack build's scalar expression per node, so the scale
            # has its dtype and rounding.
            scale = np.asarray([nbin * (1.0 - 1e-6) / extent[j]
                                for j in binned]).astype(np.float32)
            row = np.full(counts.size, -1, np.int64)
            row[binned] = np.arange(binned.size)
            el = np.flatnonzero(row[seg] >= 0)
            r_el, n_el = row[seg[el]], seg[el]
            bidx = ((centers[el, axis[n_el]] - cmin[n_el, axis[n_el]])
                    * scale[r_el]).astype(np.int64)
            key = r_el * nbin + bidx
            cnt = np.bincount(key, minlength=binned.size * nbin).reshape(
                -1, nbin)
            binmin = np.full((binned.size * nbin, 3), np.inf, np.float64)
            binmax = np.full((binned.size * nbin, 3), -np.inf, np.float64)
            o = np.argsort(key, kind="stable")
            k_sorted, t_sorted = key[o], ids[el][o]
            grp = np.flatnonzero(np.r_[True, k_sorted[1:] != k_sorted[:-1]])
            binmin[k_sorted[grp]] = np.minimum.reduceat(tri_min[t_sorted], grp,
                                                        axis=0)
            binmax[k_sorted[grp]] = np.maximum.reduceat(tri_max[t_sorted], grp,
                                                        axis=0)
            binmin = binmin.reshape(-1, nbin, 3)
            binmax = binmax.reshape(-1, nbin, 3)
            # Left-to-right and right-to-left accumulated bounds/counts.
            lmin = np.minimum.accumulate(binmin, axis=1)
            lmax = np.maximum.accumulate(binmax, axis=1)
            lcnt = np.cumsum(cnt, axis=1)
            rmin = np.minimum.accumulate(binmin[:, ::-1], axis=1)[:, ::-1]
            rmax = np.maximum.accumulate(binmax[:, ::-1], axis=1)[:, ::-1]
            rcnt = np.cumsum(cnt[:, ::-1], axis=1)[:, ::-1]
            # Split after bin b: left = bins[0..b], right = bins[b+1..].
            nl, nr = lcnt[:, :-1], rcnt[:, 1:]
            cost = np.where(
                (nl == 0) | (nr == 0), np.inf,
                nl * half_area(lmin[:, :-1], lmax[:, :-1])
                + nr * half_area(rmin[:, 1:], rmax[:, 1:]))
            best = np.argmin(cost, axis=1)
            split = np.isfinite(cost[np.arange(binned.size), best])
            by_sah = split[r_el]
            right[el[by_sah]] = bidx[by_sah] > best[r_el[by_sah]]
        # Children in order, each keeping its triangles' order.
        order = np.argsort(2 * seg + right, kind="stable")
        ids = ids[order]
        n_right = np.bincount(seg, weights=right, minlength=counts.size)
        n_right = n_right.astype(np.int64)
        counts = np.stack([counts - n_right, n_right], axis=1).reshape(-1)
        first += k

    bounds_b = np.concatenate(bounds_l)
    kids_b = np.concatenate(kids_l)
    n_nodes = bounds_b.shape[0]
    # Number the nodes and order the leaves as the stack build does.
    final = np.zeros(n_nodes, np.int64)
    left = np.full(n_nodes, -1, np.int32)
    right_o = np.zeros(n_nodes, np.int32)
    count = np.zeros(n_nodes, np.int32)
    elems, n_elems, next_id = [], 0, 1
    stack = [0]
    while stack:
        b = stack.pop()
        f = final[b]
        lb, rb = kids_b[b]
        if lb < 0:
            right_o[f] = n_elems
            count[f] = leaf_ids[b].size
            n_elems += leaf_ids[b].size
            elems.append(leaf_ids[b])
            continue
        final[lb], final[rb] = next_id, next_id + 1
        left[f], right_o[f] = next_id, next_id + 1
        next_id += 2
        stack.append(lb)
        stack.append(rb)
    bounds = np.empty_like(bounds_b)
    bounds[final] = bounds_b
    return FlatBVH(
        bounds=bounds,
        left=left,
        right=right_o,
        count=count,
        elems=np.concatenate(elems).astype(np.int32),
    )


def _build_bvh_numpy(tri_verts: np.ndarray, max_leaf: int = 4) -> FlatBVH:
    """MeanSplit build (the JAX package's numpy builder, one node at a time
    off a stack): spatial median on the widest axis, the other two axes on
    failure, then half the element list."""
    num_tris = tri_verts.shape[0]
    if num_tris == 0:
        return _empty_bvh()
    tri_min = tri_verts.min(axis=1)  # [F, 3]
    tri_max = tri_verts.max(axis=1)
    tri_center = 0.5 * (tri_min + tri_max)
    bounds_list, left_list, right_list, count_list = [], [], [], []
    elem_order = []

    def new_node():
        bounds_list.append(np.zeros(6, np.float32))
        left_list.append(-1)
        right_list.append(0)
        count_list.append(0)
        return len(bounds_list) - 1

    root = new_node()
    stack = [(root, np.arange(num_tris, dtype=np.int64))]
    while stack:
        node, ids = stack.pop()
        bmin = tri_min[ids].min(axis=0)
        bmax = tri_max[ids].max(axis=0)
        bounds_list[node] = np.concatenate([bmin, bmax]).astype(np.float32)
        if len(ids) <= max_leaf:
            left_list[node] = -1
            right_list[node] = len(elem_order)
            count_list[node] = len(ids)
            elem_order.extend(ids.tolist())
            continue
        centers = tri_center[ids]
        axes = np.argsort(-(bmax - bmin))
        ids_l = ids_r = None
        for axis in axes:
            mid = 0.5 * (bmin[axis] + bmax[axis])
            mask = centers[:, axis] < mid
            n_l = int(mask.sum())
            if 0 < n_l < len(ids):
                ids_l, ids_r = ids[mask], ids[~mask]
                break
        if ids_l is None:
            half = len(ids) // 2
            ids_l, ids_r = ids[:half], ids[half:]
        lchild, rchild = new_node(), new_node()
        left_list[node] = lchild
        right_list[node] = rchild
        stack.append((lchild, ids_l))
        stack.append((rchild, ids_r))
    return FlatBVH(
        bounds=np.stack(bounds_list).astype(np.float32),
        left=np.asarray(left_list, np.int32),
        right=np.asarray(right_list, np.int32),
        count=np.asarray(count_list, np.int32),
        elems=np.asarray(elem_order, np.int32),
    )


def bvh_depth(bvh: FlatBVH) -> int:
    """Maximum depth (for sizing traversal stacks)."""
    depth = np.zeros(len(bvh.left), np.int32)
    maxd = 1
    for i in range(len(bvh.left)):
        if bvh.left[i] >= 0:
            d = depth[i] + 1
            depth[bvh.left[i]] = d
            depth[bvh.right[i]] = d
            maxd = max(maxd, d + 1)
    return int(maxd)


def pack_bvh(bounds, left, right, count, elems, tri_v):
    """Host-side packing of a flat (possibly concatenated multi-root) BVH.

    bounds [N,6] f32; left/right/count [N] int32 (left < 0 marks a leaf,
    right = child index or elem offset); elems [F] leaf-ordered global
    triangle ids; tri_v [F,3,3] triangle vertices in GLOBAL id order.

    Returns (pnodes f32[Ni,16], ltri f32[F,12], ref int32[N]) where ref[n]
    is the packed reference for original node n (pass ref[root] as a lane's
    traversal root).
    """
    bounds = np.asarray(bounds, np.float32)
    left = np.asarray(left, np.int64)
    right = np.asarray(right, np.int64)
    count = np.asarray(count, np.int64)
    elems = np.asarray(elems, np.int64)
    tri_v = np.asarray(tri_v, np.float32)

    is_leaf = left < 0
    # Leaf refs pack the element count into 3 bits: counts > 7 would bleed
    # into the offset bits and corrupt the encoding. The builder's max_leaf
    # must therefore be <= 7, and the traversal's static max_leaf must be >=
    # the largest actual leaf (validated again in traverse_bvh_packed).
    if is_leaf.any():
        cmax = int(count[is_leaf].max())
        if cmax > 7:
            raise ValueError(
                f"pack_bvh: leaf count {cmax} exceeds the 3-bit encoding "
                "limit (build the BVH with max_leaf <= 7)"
            )
    inner_slot = np.cumsum(~is_leaf) - 1  # slot id for inner nodes
    ref = np.where(is_leaf, -(right * 8 + count + 1), inner_slot).astype(
        np.int32
    )

    n_inner = int((~is_leaf).sum())
    pnodes = np.zeros((max(n_inner, 1), 16), np.float32)
    if n_inner:
        li = left[~is_leaf]
        ri = right[~is_leaf]
        rows = inner_slot[~is_leaf]
        pnodes[rows, 0:6] = bounds[li]
        pnodes[rows, 6:12] = bounds[ri]
        pnodes[rows, 12] = ref[li].view(np.float32)
        pnodes[rows, 13] = ref[ri].view(np.float32)

    num_elems = elems.shape[0]
    ltri = np.zeros((max(num_elems, 1), 12), np.float32)
    if num_elems:
        v = tri_v[elems]  # [F,3,3] leaf order
        ltri[:num_elems, 0:9] = v.reshape(num_elems, 9)
        ltri[:num_elems, 9] = elems.astype(np.int32).view(np.float32)
    return pnodes, ltri, ref
