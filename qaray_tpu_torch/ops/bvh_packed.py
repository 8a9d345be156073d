"""The packed fat-node BVH walk (W1, csrc/bvh.cu) beside its plain version.

Counterpart of qaray_tpu/ops/bvh_packed.py (traverse_bvh_packed) and of
the per-instance loops of qaray_tpu/ops/trace.py (_mesh_closest,
trace_shadow). The tables are scene/bvh.pack_bvh's: pnodes [Ni, 16] holds
each inner node's two child boxes and their packed refs (bit-cast in
columns 12-13; a ref >= 0 is an inner row, a leaf is -(off * 8 + count +
1)), ltri [F, 12] the triangles in leaf order with the bit-cast world
triangle id in column 9. A step pops a ref, slab-tests both children of an
inner node against the t at the step's start, tests the triangles of a
hit leaf child inline, and pushes the hit inner children whose entry lies
below the t the leaves left, far child first; a popped leaf ref (the root
of a one-leaf tree) is tested as the step's first leaf.

traverse_bvh_packed is the JAX package's walk in plain PyTorch, one step
for the lanes whose stacks are not empty. closest and occluded walk a
batch of world rays over mesh instances: each instance moves the ray to
its object space (xf rows: M_w2o row-major, then t_o2w; p_obj = M_w2o (p
- t_o2w), summed left to right as ops/intersect._apply sums), walks its
root with the best t so far and takes a hit where tri >= 0 and t < best
t; xf None is one world-space tree walked as it is. For CPU tensors (or where the caller
asks for the plain versions) they run that loop in PyTorch; for CUDA
tensors they launch W1, one launch for all instances, bit for bit the
plain loop's results. `launches` counts W1's launches; `stats` the rays
handed to closest (closest_rays) and to occluded (any_rays), counted from
the shapes on every device (replays of a captured call add them too,
utils/compiled._COUNTERS).
"""

import torch

from qaray_tpu_torch.ops.bvh_traverse import (
    push_near_first,
    ray_reciprocals,
    slab_test,
)
from qaray_tpu_torch.ops.intersect import _apply, intersect_triangles

launches = {"W1": 0}
stats = {"closest_rays": 0, "any_rays": 0}

_fns = {}


def _lib(host: bool = False):
    """qr_bvh_walk and qr_bvh_stack_cap of the CUDA library, or with
    host=True of the same source built for the CPU (tests only)."""
    if host not in _fns:
        from qaray_tpu_torch.ops import _build

        lib = (_build.load_host if host else _build.load)("bvh")
        walk = _build.bind(lib, "qr_bvh_walk", "ppppppppiiiiipppppppp")
        cap = _build.bind(lib, "qr_bvh_stack_cap", "")
        _fns[host] = (walk, cap())
        if host:
            _fns["block"] = _build.bind(lib, "qr_host_set_block", "i")
    return _fns[host]


# The kernel's stack holds this many refs (QR_BVH_STACK in csrc/bvh.cu): a
# tree deeper than STACK_CAP - 2 is refused, not walked.
STACK_CAP = 64
# W1's block (kThreads), the instances a block stages in shared memory at
# once (kChunk) and the floats of one staged instance (kRec), as in
# csrc/bvh.cu.
THREADS, CHUNK, REC_FLOATS = 128, 64, 28


def block_smem_bytes(n_inst: int) -> int:
    """Dynamic shared memory of a W1 block (qr_bvh_walk's launch): the
    staged chunk of instances."""
    return 4 * REC_FLOATS * min(n_inst, CHUNK)


def check_stack(stack_size: int):
    if not 1 <= stack_size <= STACK_CAP:
        raise ValueError(
            f"a BVH walk stack of {stack_size} refs (tree depth + 2) exceeds "
            f"W1's {STACK_CAP} (QR_BVH_STACK in csrc/bvh.cu)")


def _decode(ref):
    e = -ref - 1
    return e >> 3, e & 7


def traverse_bvh_packed(p, d, roots_ref, t_init, pnodes, ltri,
                        max_leaf: int = 4, stack_size: int = 40,
                        any_hit: bool = False, work=None):
    """B rays from per-lane packed root refs below t_init. Returns (t [B],
    tri [B] world id or -1, bary [B, 3], front [B]). work: optional int32
    [B, 2], incremented by the inner nodes each ray popped and the
    triangles it tested."""
    n = p.shape[0]
    dev = p.device
    n_inner, n_ltri = pnodes.shape[0], ltri.shape[0]
    d_small, rcp_d = ray_reciprocals(d)
    stack = torch.zeros((n, stack_size), dtype=torch.int32, device=dev)
    stack[:, 0] = roots_ref
    sp = torch.ones(n, dtype=torch.int32, device=dev)
    t_best = t_init.clone()
    tri_best = torch.full((n, ), -1, dtype=torch.int32, device=dev)
    bary_best = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    front_best = torch.zeros(n, dtype=torch.bool, device=dev)
    while True:
        live = torch.nonzero(sp > 0).squeeze(1)
        if live.numel() == 0:
            break
        lp, ld, lsm, lrcp = p[live], d[live], d_small[live], rcp_d[live]
        lstack, lsp = stack[live], sp[live] - 1
        lane = torch.arange(live.numel(), device=dev)
        ref = lstack[lane, lsp.long()]
        popped_leaf = ref < 0
        row = pnodes[torch.clamp(ref, 0, n_inner - 1).long()]
        ref0 = row[:, 12].contiguous().view(torch.int32)
        ref1 = row[:, 13].contiguous().view(torch.int32)
        t = t_best[live]
        hit0, entry0 = slab_test(row[:, 0:6], lp, lrcp, lsm, t)
        hit1, entry1 = slab_test(row[:, 6:12], lp, lrcp, lsm, t)
        hit0 &= ~popped_leaf
        hit1 &= ~popped_leaf
        off_p, cnt_p = _decode(ref)
        off_0, cnt_0 = _decode(ref0)
        off_1, cnt_1 = _decode(ref1)
        zero = torch.zeros_like(cnt_0)
        s0_off = torch.where(popped_leaf, off_p, off_0)
        s0_cnt = torch.where(popped_leaf, cnt_p,
                             torch.where(hit0 & (ref0 < 0), cnt_0, zero))
        s1_cnt = torch.where(hit1 & (ref1 < 0), cnt_1, zero)
        tri, bary, front = tri_best[live], bary_best[live], front_best[live]
        tested = torch.zeros_like(cnt_0)
        for s_off, s_cnt in ((s0_off, s0_cnt), (off_1, s1_cnt)):
            for k in range(max_leaf):
                valid = k < s_cnt
                trow = ltri[torch.clamp(s_off + k, 0, n_ltri - 1).long()]
                t_hit, b, f, hit = intersect_triangles(
                    lp, ld, trow[:, 0:3], trow[:, 3:6], trow[:, 6:9], t)
                take = valid & hit & (t_hit < t)
                gid = trow[:, 9].contiguous().view(torch.int32)
                t = torch.where(take, t_hit, t)
                tri = torch.where(take, gid, tri)
                bary = torch.where(take[:, None], b, bary)
                front = torch.where(take, f, front)
                tested += valid.to(torch.int32)
        push0 = hit0 & (ref0 >= 0) & (entry0 < t)
        push1 = hit1 & (ref1 >= 0) & (entry1 < t)
        new_sp = push_near_first(lstack, lsp, stack_size, push0, push1,
                                 entry0, entry1, ref0, ref1)
        if any_hit:
            new_sp = torch.where(tri >= 0, 0, new_sp)
        if work is not None:
            work[live, 0] += (~popped_leaf).to(torch.int32)
            work[live, 1] += tested
        stack[live] = lstack
        sp[live] = new_sp
        t_best[live] = t
        tri_best[live] = tri
        bary_best[live] = bary
        front_best[live] = front
    return t_best, tri_best, bary_best, front_best


def _to_object(p, d, xf_row):
    """The rays in an instance's object space: M_w2o (p - t_o2w), M_w2o d."""
    m = xf_row[:9].reshape(3, 3)
    return _apply(m, p - xf_row[9:12]), _apply(m, d)


# Lanes of one plain walk when closest_plain and occluded_plain walk several
# instances at once.
PLAIN_LANES = 1 << 18


def _instance_groups(n, n_inst):
    """Consecutive instance ranges whose rays together fill about
    PLAIN_LANES lanes of one walk."""
    g = max(1, min(n_inst, PLAIN_LANES // max(n, 1)))
    return [(i, min(i + g, n_inst)) for i in range(0, n_inst, g)]


def _group_rays(p, d, t, proot, xf, lo, hi):
    """The rays of instances [lo, hi) stacked instance-major: (p, d, t,
    roots) of (hi - lo) * B lanes."""
    n = p.shape[0]
    if xf is None:
        po, do = p.repeat(hi - lo, 1), d.repeat(hi - lo, 1)
    else:
        pairs = [_to_object(p, d, xf[i]) for i in range(lo, hi)]
        po = torch.cat([q for q, _ in pairs])
        do = torch.cat([r for _, r in pairs])
    return (po, do, t.repeat(hi - lo),
            proot[lo:hi].repeat_interleave(n))


def _packed(pnodes, ltri, max_leaf, stack_size):
    """traverse_bvh_packed over these tables, as the instance loops call a
    walk: walk(p, d, roots, t, any_hit=False, work=None)."""
    def walk(p, d, roots, t, any_hit=False, work=None):
        return traverse_bvh_packed(p, d, roots, t, pnodes, ltri, max_leaf,
                                   stack_size, any_hit=any_hit, work=work)
    return walk


def closest_plain(p, d, t_cur, pnodes, ltri, proot, xf, max_leaf: int = 4,
                  stack_size: int = 40, work=None, walk=None):
    """The closest hit over instances, plain: (t [B], inst [B], tri [B],
    bary [B, 3], front [B]); t stays t_cur and inst, tri -1 where no
    triangle lies below it. proot: [n_inst] int32 root refs; xf: [n_inst,
    12] float32, or None for one world-space tree. walk: the walk of one
    batch of rays from per-lane roots (the packed walk over pnodes, ltri
    by default; ops/trace passes the stacked walk, whose roots are node
    ids, for QARAY_BVH_WALK=stacked).

    With `work`, the instances are walked one after another, each from the
    best t so far, as W1 walks them, and work counts W1's steps. Without
    it, groups of instances are walked together from t_cur and their
    results taken in instance order by the same rule, which gives the same
    hits: a walk from a larger t visits more nodes, but the triangles it
    shares with the walk from the best t come in the same order, and only
    a t below the best is taken."""
    walk = walk or _packed(pnodes, ltri, max_leaf, stack_size)
    n = p.shape[0]
    dev = p.device
    best_t = t_cur
    best_inst = torch.full((n, ), -1, dtype=torch.int32, device=dev)
    best_tri = torch.full((n, ), -1, dtype=torch.int32, device=dev)
    best_bary = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    best_front = torch.zeros(n, dtype=torch.bool, device=dev)
    n_inst = proot.shape[0]
    groups = ([(i, i + 1) for i in range(n_inst)] if work is not None
              else _instance_groups(n, n_inst))
    for lo, hi in groups:
        if work is not None:
            po, do = (p, d) if xf is None else _to_object(p, d, xf[lo])
            out = walk(po, do, proot[lo].expand(n), best_t, work=work)
        else:
            po, do, t0, roots = _group_rays(p, d, t_cur, proot, xf, lo, hi)
            out = walk(po, do, roots, t0)
        for j in range(hi - lo):
            t, tri, bary, front = (x[j * n:(j + 1) * n] for x in out)
            take = (tri >= 0) & (t < best_t)
            best_t = torch.where(take, t, best_t)
            best_inst = torch.where(take, lo + j, best_inst)
            best_tri = torch.where(take, tri, best_tri)
            best_bary = torch.where(take[:, None], bary, best_bary)
            best_front = torch.where(take, front, best_front)
    return best_t, best_inst, best_tri, best_bary, best_front


def occluded_plain(p, d, t_max, occluded, pnodes, ltri, proot, xf,
                   max_leaf: int = 4, stack_size: int = 40, work=None,
                   walk=None):
    """Occlusion over instances, plain: `occluded` (or no lane, if None) or
    any triangle with BIAS < t < t_max. With `work`, each instance walks
    only the lanes still open, as W1 does (an occluded lane's budget of 0,
    as the JAX loop gives it, finds nothing), and work counts W1's steps;
    without it, groups of instances walk the lanes open before the group.
    walk: as closest_plain's."""
    walk = walk or _packed(pnodes, ltri, max_leaf, stack_size)
    occ = (torch.zeros(p.shape[0], dtype=torch.bool, device=p.device)
           if occluded is None else occluded.clone())
    n_inst = proot.shape[0]
    groups = ([(i, i + 1) for i in range(n_inst)] if work is not None
              else _instance_groups(p.shape[0], n_inst))
    for lo, hi in groups:
        live = torch.nonzero(~occ).squeeze(1)
        m = live.numel()
        if m == 0:
            break
        lp, ld, lt = p[live], d[live], t_max[live]
        po, do, t0, roots = _group_rays(lp, ld, lt, proot, xf, lo, hi)
        lwork = None if work is None else work[live]
        t, tri, _, _ = walk(po, do, roots, t0, any_hit=True, work=lwork)
        if work is not None:
            work[live] = lwork
        hit = ((tri >= 0) & (t < t0)).reshape(hi - lo, m).any(dim=0)
        occ[live] = hit
    return occ


def _check(p, d, t, pnodes, ltri, proot, xf, stack_size):
    dev = p.device
    for x in (d, t, pnodes, ltri, proot) + (() if xf is None else (xf, )):
        if x.device != dev:
            raise ValueError(f"tensors on {x.device} and {dev}")
    for x in (p, d):
        if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] != 3:
            raise ValueError(f"rays must be float32 [B, 3], got {x.dtype} "
                             f"{tuple(x.shape)}")
    if (d.shape != p.shape or t.dtype != torch.float32
            or t.shape != p.shape[:1]):
        raise ValueError("p, d [B, 3] and t [B] float32 must agree")
    if (pnodes.dtype != torch.float32 or pnodes.ndim != 2
            or pnodes.shape[1] != 16 or ltri.dtype != torch.float32
            or ltri.ndim != 2 or ltri.shape[1] != 12
            or not pnodes.is_contiguous() or not ltri.is_contiguous()):
        raise ValueError("pnodes must be contiguous float32 [Ni, 16] and "
                         "ltri [F, 12] (scene.bvh.pack_bvh)")
    if proot.dtype != torch.int32 or proot.ndim != 1 or not proot.numel():
        raise ValueError("proot must be int32 [n_inst], n_inst > 0")
    if xf is not None and (xf.dtype != torch.float32
                           or xf.shape != (proot.shape[0], 12)
                           or not xf.is_contiguous()):
        raise ValueError("xf must be contiguous float32 [n_inst, 12]")
    check_stack(stack_size)


def _launch(host, p, d, t, occ_in, pnodes, ltri, proot, xf, max_leaf,
            stack_size, any_hit, work, stream):
    n = p.shape[0]
    dev = p.device
    out_t = torch.empty(n, dtype=torch.float32, device=dev)
    tri = torch.empty(n, dtype=torch.int32, device=dev)
    inst = torch.empty(n, dtype=torch.int32, device=dev)
    bary = torch.empty((n, 3), dtype=torch.float32, device=dev)
    front = torch.empty(n, dtype=torch.bool, device=dev)
    occ = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        from qaray_tpu_torch.ops import _build

        fn, cap = _lib(host)
        if cap != STACK_CAP:
            raise RuntimeError(f"csrc/bvh.cu's stack holds {cap} refs, the "
                               f"wrapper expects {STACK_CAP}")
        for x in (pnodes, ltri) + (() if xf is None else (xf, )):
            if x.data_ptr() % 16:
                raise ValueError("W1 reads pnodes, ltri and xf as float4: "
                                 "they must be 16-byte aligned")
        p, d, t = p.contiguous(), d.contiguous(), t.contiguous()
        occ_in = None if occ_in is None else occ_in.contiguous()
        rc = fn(p.data_ptr(), d.data_ptr(), t.data_ptr(),
                None if occ_in is None else occ_in.data_ptr(),
                pnodes.data_ptr(), ltri.data_ptr(), proot.data_ptr(),
                None if xf is None else xf.data_ptr(), n, proot.shape[0],
                stack_size, max_leaf, int(any_hit), out_t.data_ptr(),
                tri.data_ptr(), inst.data_ptr(), bary.data_ptr(),
                front.data_ptr(), occ.data_ptr(),
                None if work is None else work.data_ptr(), stream)
        _build.check(rc, "W1 BVH walk")
        if not host:
            launches["W1"] += 1
    return occ if any_hit else (out_t, inst, tri, bary, front)


def _check_work(work, p):
    if work is not None and (work.device != p.device
                             or work.dtype != torch.int32
                             or work.shape != (p.shape[0], 2)
                             or not work.is_contiguous()):
        raise ValueError("work must be contiguous int32 [B, 2] on the rays' "
                         "device")


def _stream():
    return torch.cuda.current_stream().cuda_stream


def closest(p, d, t_cur, pnodes, ltri, proot, xf=None, max_leaf: int = 4,
            stack_size: int = 40, work=None, plain: bool = False):
    """closest_plain's function: W1 on CUDA tensors (unless `plain`), the
    plain loop on CPU tensors. work: optional int32 [B, 2], set to each
    ray's inner nodes popped and triangles tested."""
    _check(p, d, t_cur, pnodes, ltri, proot, xf, stack_size)
    _check_work(work, p)
    stats["closest_rays"] += p.shape[0]
    if p.device.type == "cpu" or plain:
        if work is not None:
            work.zero_()
        return closest_plain(p, d, t_cur, pnodes, ltri, proot, xf, max_leaf,
                             stack_size, work)
    return _launch(False, p, d, t_cur, None, pnodes, ltri, proot, xf,
                   max_leaf, stack_size, False, work, _stream())


def occluded(p, d, t_max, occ_in, pnodes, ltri, proot, xf=None,
             max_leaf: int = 4, stack_size: int = 40, work=None,
             plain: bool = False):
    """occluded_plain's function: W1 on CUDA tensors (unless `plain`), the
    plain loop on CPU tensors."""
    _check(p, d, t_max, pnodes, ltri, proot, xf, stack_size)
    _check_work(work, p)
    if occ_in is not None and (occ_in.dtype != torch.bool
                               or occ_in.shape != t_max.shape):
        raise ValueError("occ_in must be bool [B]")
    stats["any_rays"] += p.shape[0]
    if p.device.type == "cpu" or plain:
        if work is not None:
            work.zero_()
        return occluded_plain(p, d, t_max, occ_in, pnodes, ltri, proot, xf,
                              max_leaf, stack_size, work)
    return _launch(False, p, d, t_max, occ_in, pnodes, ltri, proot, xf,
                   max_leaf, stack_size, True, work, _stream())


def walk_host(p, d, t, pnodes, ltri, proot, xf=None, any_hit=False,
              occ_in=None, max_leaf: int = 4, stack_size: int = 40,
              block: int = 1):
    """csrc/bvh.cu built for the CPU by g++ (_build.load_host) and run on
    CPU tensors in host blocks of `block` threads (fibers sharing the
    block's shared memory and barriers; 128 is a card block): closest's or
    occluded's outputs, and the work counts [B, 2]. For tests that hold
    the source to the plain version where there is no card; counts no
    launch."""
    from qaray_tpu_torch.ops import _build

    for x in (p, d, t):
        if x.device.type != "cpu":
            raise ValueError("walk_host takes CPU tensors")
    _check(p, d, t, pnodes, ltri, proot, xf, stack_size)
    work = torch.zeros((p.shape[0], 2), dtype=torch.int32)
    _lib(True)
    _build.check(_fns["block"](block), "host block size")
    try:
        return _launch(True, p, d, t, occ_in, pnodes, ltri, proot, xf,
                       max_leaf, stack_size, any_hit, work, None), work
    finally:
        _fns["block"](1)
