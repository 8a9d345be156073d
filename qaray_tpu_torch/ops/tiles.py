"""Tiled cluster walk kernels (K4a closest, K4b any hit, csrc/tiles.cu).

Counterpart of qaray_tpu/ops/pallas_tiles.py (pallas_tiled_sweep ->
_closest_kernel / _anyhit_kernel, and tiled_closest_twophase). The JAX
package marches packets of 2048 rays through the clusters a packet-wide
interval cull kept; here each ray walks on its own, one CUDA thread a ray,
over a binary tree of the Morton-ordered cluster boxes (cluster_tree):

- closest (K4a): the exact top-2 below t_cur. The walk goes on until no
  unvisited cluster can hold a hit below the ray's runner-up t, so `row2`
  is the exact second-closest hit below t_cur, where the Pallas march may
  miss it; `resolved` is False where max_steps cut the walk short.
- any hit (K4b): occluded iff some triangle has BIAS < t < budget; a ray
  stops at its first occluder.

Winners equal ops/mesh_tiles.tiled_sweep's and runner-ups its runner-up
below t_cur; where two triangles tie exactly in t, either may win.

walk_plain is the kernels' plain version: each ray's clusters, culled with
the kernel's one-ray slab test, swept front to back in lock step until the
same stopping rule holds. Its visiting order is sorted, the kernel's the
tree's, so only exact ties can differ. tiled_sweep_kernel runs it for
tensors on the CPU and launches K4a/K4b for CUDA tensors, never falling
back from one to the other. `launches` counts kernel launches. The same
source walks the dense route's clusters for K3 (ops/mesh_sweep.py).
"""

import numpy as np
import torch

from qaray_tpu_torch.core.constants import BIAS, BIGFLOAT
from qaray_tpu_torch.ops.mesh_stream import _chunk_test, merge_top2, top2
from qaray_tpu_torch.ops.mesh_sweep import pack_coeff16, unpack_coeff16
from qaray_tpu_torch.ops.mesh_tiles import CLUSTER, TiledMesh, coherence_order

# The most leaves a kernel's tree walk takes (csrc/walk.cuh, tiles.cu).
MAX_LEAVES = 1 << 16
# Ray-cluster pairs a pass of walk_plain: bounds its [rays, clusters]
# tables (a pass holds a few [rays, clusters, 3] float32 tensors).
PLAIN_PAIRS = 1 << 22

launches = {"K4a": 0, "K4b": 0}

_fns = {}


def _lib(host: bool = False):
    """qr_tiles_walk of the CUDA library, or with host=True of the same
    source built for the CPU (_build.load_host; tests only)."""
    if host not in _fns:
        from qaray_tpu_torch.ops import _build

        lib = (_build.load_host if host else _build.load)("tiles")
        _fns[host] = _build.bind(lib, "qr_tiles_walk", "pppppiiiippppppp")
    return _fns[host]


def pack_coeffT(tile_coeff, tile_const) -> np.ndarray:
    """Tiled coefficients -> [Fp/8, 128]: the [Fp, 16] pack_coeff16 rows, 8
    to a 128-wide row (the JAX package's table; the kernels read it as
    [Fp, 16] rows, the same memory)."""
    c16 = pack_coeff16(tile_coeff, tile_const)
    c16 = c16[: np.asarray(tile_coeff).shape[0]]
    if c16.shape[0] % 8:
        raise ValueError("tiled rows must be a multiple of 8")
    return c16.reshape(-1, 128)


def cluster_tree(cbounds):
    """Binary tree over the Morton-ordered cluster boxes cbounds [C, 6]:
    [2L, 8] float32 rows (min xyz, max xyz, 0, 0) with L the power of two
    at or above C, in heap order: node 1 the root, node k's children 2k and
    2k+1, leaf L + c cluster c. A node's box is the union of its
    children's; row 0, the padding leaves and nodes over padding alone get
    the inverted box (1, 1, 1, -1, -1, -1) that no ray test accepts, as
    build_tiles gives clusters of padding."""
    n = cbounds.shape[0]
    leaves = 1 << max(0, (n - 1).bit_length())
    if leaves > MAX_LEAVES:
        raise ValueError(f"{n} clusters: the walk takes at most "
                         f"{MAX_LEAVES}")
    inf = torch.full((leaves, 3), float("inf"), device=cbounds.device)
    empty = (cbounds[:, :3] > cbounds[:, 3:6]).any(dim=1, keepdim=True)
    lo, hi = inf.clone(), -inf
    lo[:n] = torch.where(empty, inf[:n], cbounds[:, :3])
    hi[:n] = torch.where(empty, -inf[:n], cbounds[:, 3:6])
    los, his = [lo], [hi]
    while lo.shape[0] > 1:
        lo = lo.reshape(-1, 2, 3).amin(dim=1)
        hi = hi.reshape(-1, 2, 3).amax(dim=1)
        los.append(lo)
        his.append(hi)
    lo = torch.cat([inf[:1]] + los[::-1])
    hi = torch.cat([-inf[:1]] + his[::-1])
    bad = (lo > hi).any(dim=1, keepdim=True)
    lo = torch.where(bad, torch.ones_like(lo), lo)
    hi = torch.where(bad, -torch.ones_like(hi), hi)
    return torch.cat([lo, hi, torch.zeros_like(lo[:, :2])],
                     dim=1).contiguous()


def ray_cluster_entry(p, d, cbounds):
    """csrc/mesh.cuh::box_entry of every ray against every cluster box:
    (lo [B, C], ok [B, C]). ok where the ray may hit the box at t > BIAS;
    lo, the widened entry distance, bounds the t of any such hit from
    below."""
    small = torch.abs(d) < 1e-7
    r = (1.0 / torch.where(small, torch.full_like(d, 1e-7), d))[:, None]
    t1 = (cbounds[None, :, :3] - p[:, None]) * r
    t2 = (cbounds[None, :, 3:6] - p[:, None]) * r
    skip = small[:, None, :]
    near = torch.where(skip, -BIGFLOAT, torch.minimum(t1, t2)).amax(dim=-1)
    far = torch.where(skip, BIGFLOAT, torch.maximum(t1, t2)).amin(dim=-1)
    nonempty = (cbounds[:, :3] <= cbounds[:, 3:6]).all(dim=-1)[None, :]
    lo = near - (1e-5 * torch.abs(near) + 1e-6)
    hi = far + (1e-5 * torch.abs(far) + 1e-6)
    return lo, nonempty & (lo <= hi) & (hi > BIAS)


def _walk_rays(p, d, t_in, tab, cbounds, any_hit, max_steps):
    """walk_plain on one pass of rays: (t, row, row2, flag, steps, work)."""
    n = p.shape[0]
    dev = p.device
    lo, ok = ray_cluster_entry(p, d, cbounds)
    key = torch.where(ok, lo, torch.full_like(lo, BIGFLOAT))
    order = torch.argsort(key, dim=1, stable=True)
    entry = torch.gather(key, 1, order)
    count = ok.sum(dim=1)
    rows = torch.arange(CLUSTER, device=dev)
    t_b, t2_b = t_in.clone(), t_in.clone()
    r_b = torch.full((n,), -1, dtype=torch.int32, device=dev)
    r2_b = r_b.clone()
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    capped = torch.zeros_like(occ)
    steps = torch.zeros(n, dtype=torch.int32, device=dev)
    work = torch.zeros_like(steps)
    live = t_in > BIAS
    for j in range(cbounds.shape[0]):
        reach = t_in if any_hit else t2_b
        go = live & ~occ & (j < count) & (entry[:, j] < reach)
        if max_steps and j == max_steps and not any_hit:
            capped = go
            break
        idx = go.nonzero()[:, 0]
        if idx.numel() == 0:
            break
        cid = order[idx, j]
        ridx = cid[:, None] * CLUSTER + rows
        t = _chunk_test(p[idx, None], d[idx, None], tab.coeff[ridx],
                        tab.const[ridx])[:, 0]
        steps[idx] += 1
        if any_hit:
            occ[idx] = (t < t_in[idx, None]).any(dim=1)
            work[idx] += CLUSTER
            continue
        work[idx] += torch.where(entry[idx, j] < t_b[idx], CLUSTER,
                                 0).to(torch.int32)
        t = torch.where(t < t_in[idx, None], t, torch.full_like(t, BIGFLOAT))
        t1, i1, t2, i2 = top2(t)
        base = (cid * CLUSTER).to(torch.int32)
        t_b[idx], r_b[idx], t2_b[idx], r2_b[idx] = merge_top2(
            t_b[idx], r_b[idx], t2_b[idx], r2_b[idx], t1, base + i1, t2,
            base + i2)
    return t_b, r_b, r2_b, occ if any_hit else ~capped, steps, work


def walk_plain(p, d, t_cur, coeffT, cbounds, any_hit=False, max_steps=0):
    """The kernels' plain version: (t [B], row [B], row2 [B], resolved
    [B], steps [B], work [B]), with occluded in place of resolved for the
    any hit."""
    tab = unpack_coeff16(coeffT.reshape(-1, 16))
    rays = max(1, PLAIN_PAIRS // cbounds.shape[0])
    outs = [_walk_rays(p[k:k + rays], d[k:k + rays], t_cur[k:k + rays], tab,
                       cbounds, any_hit, max_steps)
            for k in range(0, max(p.shape[0], 1), rays)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _check(p, d, t_cur, coeffT, tiles: TiledMesh):
    dev = p.device
    for t in (d, t_cur, coeffT):
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
    for t in (p, d):
        if t.dtype != torch.float32 or t.ndim != 2 or t.shape[1] != 3:
            raise ValueError(f"rays must be float32 [B, 3], got {t.dtype} "
                             f"{tuple(t.shape)}")
    if d.shape != p.shape:
        raise ValueError("p and d differ in shape")
    if t_cur.dtype != torch.float32 or t_cur.shape != p.shape[:1]:
        raise ValueError("t_cur must be float32 [B]")
    if (coeffT.dtype != torch.float32 or coeffT.ndim != 2
            or coeffT.shape[1] != 128
            or coeffT.shape[0] * 8 != tiles.cbounds.shape[0] * CLUSTER
            or not coeffT.is_contiguous()):
        raise ValueError("coeffT must be contiguous float32 [Fp/8, 128] with "
                         "256 rows a cluster (pack_coeffT)")


def _launch(fn, p, d, t_cur, coeffT, tree, any_hit, max_steps, steps, work,
            stream):
    n = p.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=p.device)
    row = torch.empty(n, dtype=torch.int32, device=p.device)
    row2 = torch.empty(n, dtype=torch.int32, device=p.device)
    flag = torch.empty(n, dtype=torch.bool, device=p.device)
    if n:
        from qaray_tpu_torch.ops import _build

        p, d, t_cur = p.contiguous(), d.contiguous(), t_cur.contiguous()
        rc = fn(p.data_ptr(), d.data_ptr(), t_cur.data_ptr(),
                coeffT.data_ptr(), tree.data_ptr(), n, tree.shape[0] // 2,
                int(any_hit), max_steps, t.data_ptr(), row.data_ptr(),
                row2.data_ptr(), flag.data_ptr(),
                steps.data_ptr() if steps is not None else None,
                work.data_ptr() if work is not None else None, stream)
        _build.check(rc, "K4b tiled any hit" if any_hit else
                     "K4a tiled closest")
    return t, row, row2, flag


def _check_tree(tiles: TiledMesh, tree, device):
    leaves = tree.shape[0] // 2
    if (tree.device != device or tree.dtype != torch.float32
            or tree.shape != (2 * leaves, 8)
            or leaves < tiles.cbounds.shape[0] or leaves & (leaves - 1)
            or not tree.is_contiguous()):
        raise ValueError("tree must be cluster_tree(tiles.cbounds) on the "
                         "rays' device")


def tiled_sweep_kernel(p, d, t_cur, tiles: TiledMesh, coeffT, *, tree,
                       any_hit=False, max_steps=0, steps=None, work=None,
                       plain=False):
    """Counterpart of pallas_tiled_sweep, one ray at a time.

    closest: (t [B], row [B], row2 [B], resolved [B] bool), sorted-row ids
    (-1 = none): the closest hit below t_cur and the runner-up below t_cur;
    max_steps > 0 caps the clusters each ray visits, and resolved is False
    where the cap cut its walk (phase 1 of tiled_closest_twophase). any_hit:
    occluded [B] bool (t_cur is each ray's budget). coeffT: [Fp/8, 128] from
    pack_coeffT; tree: cluster_tree(tiles.cbounds), the compiled scene's
    tile_tree (the walk on the card reads it). steps, work: optional int32 [B]
    tensors filled with the clusters each ray visited and 256 for each of
    those whose entry bound was below the ray's best t when it was visited
    (any hit: every visited cluster), for roofline bounds. plain: the
    plain version on any device (QARAY_NO_PALLAS, meta.force_xla)."""
    _check(p, d, t_cur, coeffT, tiles)
    _check_tree(tiles, tree, p.device)
    for name, out in (("steps", steps), ("work", work)):
        if out is not None and (out.device != p.device
                                or out.dtype != torch.int32
                                or out.shape != t_cur.shape
                                or not out.is_contiguous()):
            raise ValueError(f"{name} must be contiguous int32 "
                             f"{list(t_cur.shape)} on the rays' device")
    if p.device.type == "cpu" or plain:
        out = walk_plain(p, d, t_cur, coeffT, tiles.cbounds, any_hit,
                         max_steps)
        for dst, src in ((steps, out[4]), (work, out[5])):
            if dst is not None:
                dst.copy_(src)
        return out[3] if any_hit else out[:4]
    out = _launch(_lib(), p, d, t_cur, coeffT, tree, any_hit, max_steps,
                  steps, work, torch.cuda.current_stream().cuda_stream)
    if p.shape[0]:
        launches["K4b" if any_hit else "K4a"] += 1
    return out[3] if any_hit else out


def tiled_sweep_host(p, d, t_cur, tiles: TiledMesh, coeffT, *, tree,
                     any_hit=False, max_steps=0):
    """csrc/tiles.cu built for the CPU by g++ (_build.load_host) and run one
    ray at a time on CPU tensors, with tiled_sweep_kernel's outputs plus
    steps and work. For tests that hold the kernel source to walk_plain
    where there is no card."""
    _check(p, d, t_cur, coeffT, tiles)
    _check_tree(tiles, tree, p.device)
    if p.device.type != "cpu":
        raise ValueError("tiled_sweep_host takes CPU tensors")
    steps = torch.zeros(p.shape[0], dtype=torch.int32)
    work = torch.zeros_like(steps)
    out = _launch(_lib(host=True), p, d, t_cur, coeffT, tree, any_hit,
                  max_steps, steps, work, None)
    return (out[3] if any_hit else out), steps, work


def tiled_closest_twophase(p, d, t_cur, tiles: TiledMesh, coeffT, *, tree,
                           budget: int = 12, plain=False):
    """Divergence-compacted closest hit: a walk of at most `budget`
    clusters per ray on coherence-sorted rays; the rays it leaves
    unresolved are packed together (stable sort by the resolved flag) and
    walked again without a cap, while resolved rays ride along with t = -1,
    which does no work. A ray's walk visits its clusters in the same order
    in both phases, so the result equals budget 0's on every ray, and
    phase 1 only adds a launch: ops/trace.py walks with budget 0. Returns
    (t, row, row2) in the caller's ray order."""
    lo = tiles.cbounds[:, :3].amin(dim=0)
    hi = tiles.cbounds[:, 3:6].amax(dim=0)
    perm = coherence_order(p, d, lo, hi)
    inv = torch.argsort(perm)
    ps, ds, ts = p[perm], d[perm], t_cur[perm]
    if budget <= 0:
        t, r, r2, _ = tiled_sweep_kernel(ps, ds, ts, tiles, coeffT,
                                         tree=tree, plain=plain)
        return t[inv], r[inv], r2[inv]
    t1, r1, r21, res = tiled_sweep_kernel(ps, ds, ts, tiles, coeffT,
                                          max_steps=budget, tree=tree,
                                          plain=plain)
    iota = torch.arange(ps.shape[0], dtype=torch.int64, device=p.device)
    perm2 = torch.argsort(torch.where(res, iota + (1 << 30), iota))
    inv2 = torch.argsort(perm2)
    t_seed = torch.where(res, torch.full_like(ts, -1.0), ts)
    t2, r2b, r22, _ = tiled_sweep_kernel(ps[perm2], ds[perm2], t_seed[perm2],
                                         tiles, coeffT, tree=tree,
                                         plain=plain)
    t_f = torch.where(res, t1, t2[inv2])
    r_f = torch.where(res, r1, r2b[inv2])
    r2_f = torch.where(res, r21, r22[inv2])
    return t_f[inv], r_f[inv], r2_f[inv]
