"""Path-trace megakernel dispatch (kernels K1a, K1b, K1c and K1d,
csrc/megakernel.cu).

Counterpart of qaray_tpu/ops/pallas_pathtrace.py: _fold_words
(core.rng.fold_words here), build_mega_mesh, _mega_raw and mega_render
with its custom_vjp (_MegaRender). _pack_tables is
scene.arrays.with_kernel_tables, run once when a scene is compiled. One
launch renders one pathtrace or photonmap sample per lane: camera ray,
every bounce's closest hit, shading, next-event shadow rays and all
threefry draws. With a world mesh (meta.mesh_mega) the same launch traces
its triangles in-kernel (K1c), each lane walking a tree of the
Morton-ordered rows in leaves of MEGA_LEAF (build_mega_tree):
`launches["K1c"]` counts those launches. On a scene whose live material textures are all checkers
(scene.arrays.mega_textured) the launch is of the textured kernel, which
computes the winner's uv, the primary hit's footprint and the checker
samples itself (K1b): `launches["K1b"]` counts those. With photon maps
(photonmap and cfg.use_photon_map) the launch is of the gathering kernel
(K1d), which gathers the caustics map itself and writes the irr0 and
escalation planes and one global-map record per lane; the wrapper gathers
the records with K5 (ops/photon.gather_apply), adds their contribution
and ORs their escalation flags: `launches["K1d"]` counts those launches.

K1c's own device functions also run on given rays through the probe
mesh_probe (mesh_probe_host: the source under g++), whose plain version
mesh_probe_plain is the in-order sweep over every row that K1c's walk must
equal bit for bit; no path calls it.

The plain version of K1a, K1b and K1c is the wavefront engine
(integrators/engine.render_batch_wavefront) with its texture stack
(ops/texture.py), which draws the same random numbers; for K1d it is the
engine with the exact gather (photon/gather.py), equal to K1d on every
lane that is not escalated. mega_render runs it for tensors on the CPU
and launches the kernel for CUDA tensors, never falling back from one to
the other. `launches` counts kernel launches.

Gradients: where a differentiable scene leaf (diff.DiffParams's fields of
the scene) requires grad, mega_render is a torch.autograd.Function: the
kernel forward as above, and a backward that re-runs the wavefront engine
under autograd on the same lanes and key words, in batches of BWD_BATCH
lanes, and takes the radiance cotangent back to those leaves: a step
captured on a card (_mega_backward), which engine.render_batch's backward
on this route replays too (mega_vjp). Under
threefry words both compute the same function draw for draw, so this is
the gradient of the forward's estimator. (The JAX package's backward
samples XLA's rbg stream under an rbg key, an independent estimator; here
both draw from the folded threefry words.) The primary depth, the photon
maps and the photonmap flags carry no gradient.
"""

import numpy as np
import torch
from torch.utils import _pytree as pytree

from qaray_tpu_torch.core.constants import BIAS
from qaray_tpu_torch.core.rng import fold_words
from qaray_tpu_torch.diff import DiffParams, extract_params, splice_params
from qaray_tpu_torch.photon.gather import radius2
from qaray_tpu_torch.scene.arrays import (
    LIGHT_AMBIENT,
    LIGHT_DIRECT,
    MTL_COLS,
    MTL_TEX_COLS,
    SceneArrays,
    SceneMeta,
    mega_textured,
)
from qaray_tpu_torch.utils.compiled import jit

launches = {"K1a": 0, "K1b": 0, "K1c": 0, "K1d": 0}

NUM_REC = 17  # fields of a global-map gather record

MEGA_CLUSTER = 256  # rows a cluster of the JAX package's mesh tables
# Rows a leaf of K1c's tree (build_mega_tree): mesh_scene's 320 triangles
# make 5 such leaves and no padding row is tested.
MEGA_LEAF = 64

# Lanes a batch of the backward's engine run (bounds its saved tensors).
BWD_BATCH = 65536

_fns = {}


def _kernel(host: bool = False):
    """qr_mega_render of the CUDA library, or with host=True of the same
    source built for the CPU (_build.load_host; tests only)."""
    if host not in _fns:
        from qaray_tpu_torch.ops import _build
        from qaray_tpu_torch.ops.texture import elliptic_offsets_np

        lib = (_build.load_host if host else _build.load)("megakernel")
        # K1b reads the footprint offsets the plain version uses.
        xs, ys = (np.ascontiguousarray(a) for a in elliptic_offsets_np())
        set_offsets = _build.bind(lib, "qr_mega_set_tex_offsets", "pp")
        _build.check(set_offsets(xs.ctypes.data, ys.ctypes.data),
                     "K1b footprint offsets")
        _fns[host] = _build.bind(
            lib, "qr_mega_render",
            "pppipppipiiipppifpuuiiiiiiipppiipppppippifpp")
        if host:
            _fns["host_block"] = _build.bind(lib, "qr_host_set_block", "i")
    return _fns[host]


def _morton_order(tri_v):
    """The order of build_mega_mesh's rows: by the Morton code of each
    triangle's centroid, stable."""
    from qaray_tpu_torch.ops.mesh_tiles import _morton3

    return np.argsort(_morton3(tri_v.mean(axis=1)), kind="stable")


def build_mega_mesh(tri_v, tri_n, tri_mtl, cluster: int = MEGA_CLUSTER):
    """World-baked triangles -> (coeff16 [Fp,16], attr16 [Fp,16],
    cbounds [C,8]): the JAX package's megakernel mesh tables.

    Rows are Morton-ordered by centroid (tight cluster boxes); coeff16 is
    the pack_coeff16 layout; attr16 cols 0-8 hold the three (unnormalized,
    world) corner normals and col 9 the material table row. Padding rows
    never hit (all-zero coefficients). K1c walks build_mega_tree's boxes
    of the same rows; cbounds, the 256-row clusters' boxes, are the JAX
    package's cull."""
    from qaray_tpu_torch.ops.mesh_stream import build_stream
    from qaray_tpu_torch.ops.mesh_sweep import pack_coeff16

    tri_v = np.asarray(tri_v, np.float32)
    num = tri_v.shape[0]
    order = _morton_order(tri_v)
    sv = tri_v[order]
    sn = np.asarray(tri_n, np.float32)[order]
    sm = np.asarray(tri_mtl, np.int32)[order]
    stream = build_stream(sv, chunk=cluster)
    c16 = pack_coeff16(stream.coeff, stream.const)[: stream.coeff.shape[0]]
    fp = c16.shape[0]
    attr = np.zeros((fp, 16), np.float32)
    attr[:num, 0:9] = sn.reshape(num, 9)
    attr[:num, 9] = sm.astype(np.float32)
    return c16, attr, _leaf_boxes(sv, fp, cluster)


def _leaf_boxes(sv, rows: int, leaf: int):
    """[rows / leaf, 8] boxes (min xyz, max xyz, 0, 0) of the sorted
    triangles sv in runs of `leaf` rows; a run of padding rows alone gets
    the inverted box that no ray test accepts."""
    nc = rows // leaf
    cb = np.zeros((nc, 8), np.float32)
    for c in range(nc):
        run = sv[c * leaf:(c + 1) * leaf]
        if run.size == 0:
            cb[c, 0:3] = 1.0
            cb[c, 3:6] = -1.0  # empty box: never hit
        else:
            cb[c, 0:3] = run.reshape(-1, 3).min(axis=0)
            cb[c, 3:6] = run.reshape(-1, 3).max(axis=0)
    return cb


def mega_tree_leaves(rows: int, leaf: int) -> int:
    """Leaves of the K1c tree over `rows` rows in leaves of `leaf`: the
    power of two at or above rows / leaf."""
    return 1 << max(0, (rows // leaf - 1).bit_length())


def build_mega_tree(tri_v, rows: int, leaf: int = MEGA_LEAF):
    """The tree K1c walks: tiles.cluster_tree over the boxes of
    build_mega_mesh's rows (`rows` of them, padding included) in leaves of
    `leaf` consecutive rows, a CPU float32 [2L, 8] tensor with L =
    mega_tree_leaves(rows, leaf). The rows keep their order, so a leaf c
    holds rows c * leaf .. (c + 1) * leaf - 1."""
    from qaray_tpu_torch.ops.tiles import cluster_tree

    tri_v = np.asarray(tri_v, np.float32)
    if rows % leaf or leaf % 8:
        raise ValueError(f"{rows} rows in leaves of {leaf}: a leaf is a "
                         "multiple of 8 rows that divides the table")
    sv = tri_v[_morton_order(tri_v)]
    return cluster_tree(torch.from_numpy(_leaf_boxes(sv, rows, leaf)))


def mesh_args(tabs, meta: SceneMeta, device):
    """K1c's arguments of the kernels' C entries (rows, attributes, tree,
    leaves, leaf rows), after checking the tables against what the kernels
    read; (None, None, None, 0, 0) without a megakernel mesh."""
    if meta.mesh_mega != (tabs.mesh_rows is not None):
        raise ValueError("the kernel tables do not match meta.mesh_mega "
                         "(scene.arrays.with_kernel_tables)")
    if not meta.mesh_mega:
        return None, None, None, 0, 0
    rows, leaf = tabs.mesh_rows.shape[0], MEGA_LEAF
    n_leaves = mega_tree_leaves(rows, leaf)
    for t, shape in ((tabs.mesh_rows, (rows, 16)),
                     (tabs.mesh_attr, (rows, 16)),
                     (tabs.mesh_tree, (2 * n_leaves, 8))):
        if (t.device != device or t.dtype != torch.float32
                or t.shape != shape or not t.is_contiguous()):
            raise ValueError(f"mesh table {tuple(t.shape)} on {t.device}: "
                             f"the kernel needs contiguous float32 {shape} "
                             f"on {device}")
    return (tabs.mesh_rows.data_ptr(), tabs.mesh_attr.data_ptr(),
            tabs.mesh_tree.data_ptr(), n_leaves, leaf)


def _check_lanes(px, py, sample_ids):
    n = px.shape[0]
    for t in (px, py, sample_ids):
        if t.device != px.device:
            raise ValueError(f"lanes on {t.device} and {px.device}")
        if t.ndim != 1 or t.shape[0] != n:
            raise ValueError("px, py and sample_ids must be [B] each")


def gathers(cfg, photon_maps) -> bool:
    """Does a photonmap launch gather photons (K1d)? As in the JAX package:
    photonmap with cfg.use_photon_map and a pair of maps."""
    return (cfg.use_photon_map and cfg.integrator == "photonmap"
            and photon_maps is not None)


def mega_render(scene: SceneArrays, meta: SceneMeta, cfg, px, py, sample_ids,
                key_words, work=None, photon_maps=None):
    """One sample per (px, py) lane: (radiance [B,3], primary depth [B]);
    with photon gathering (gathers(cfg, photon_maps)) also the irradiance
    debug flag [B] and the escalation flag [B], both bool: lanes whose
    gather saw more than GATHER_K photons in the radius, which need the
    exact estimate (on CPU tensors, the exact engine, all False).

    key_words: 2 threefry words, or the 4 words of a jax 'rbg' key, which
    fold to (0, 0) as in the reference (core.rng.fold_words). photon_maps:
    the clustered (global, caustics) PhotonMapData. work: optional int32
    [B, 8] tensor the kernel fills with each lane's primitive tests,
    threefry ciphers, shaded vertices, triangle tests and checker tests,
    when it gathers its photon tests and caustics cluster tests (columns 5
    and 6 are left as they were otherwise), and in column 7 its
    soft-shadow estimates that went on past shadow_spp samples
    (CUDA only; for roofline bounds). A soft-shadow sample's work counts
    to its lane, whichever thread of the block ran it.
    """
    _check_lanes(px, py, sample_ids)
    gather = gathers(cfg, photon_maps)
    leaves = extract_params(scene)
    if torch.is_grad_enabled() and any(t.requires_grad for t in leaves):
        return _MegaRender.apply(
            (scene, meta, cfg, px, py, sample_ids, key_words, work,
             photon_maps if gather else None), *leaves)
    return _forward(scene, meta, cfg, px, py, sample_ids, key_words, work,
                    photon_maps if gather else None)


def _forward(scene, meta, cfg, px, py, sample_ids, key_words, work,
             photon_maps):
    """mega_render without gradients; photon_maps only when it gathers."""
    gather = photon_maps is not None
    if px.device.type == "cpu":
        from qaray_tpu_torch.integrators.engine import render_batch_wavefront

        if not gather:
            return render_batch_wavefront(scene, meta, cfg, px, py,
                                          sample_ids, key_words)
        radiance, t0, irr0 = render_batch_wavefront(
            scene, meta, cfg, px, py, sample_ids, key_words,
            photon_maps=photon_maps, want_aux=True)
        return radiance, t0, irr0, torch.zeros_like(irr0)
    out = _launch(_kernel(), torch.cuda.current_stream().cuda_stream, scene,
                  meta, cfg, px, py, sample_ids, key_words, work, photon_maps)
    if px.shape[0]:
        launches["K1a"] += 1
        if mega_textured(meta):
            launches["K1b"] += 1
        if meta.mesh_mega:
            launches["K1c"] += 1
        if gather:
            launches["K1d"] += 1
    return out


class _MegaRender(torch.autograd.Function):
    """pallas_pathtrace.mega_render's custom_vjp: the kernel forward (its
    plain version on the CPU), the wavefront engine's autograd backward
    with respect to the DiffParams leaves (_mega_backward)."""

    @staticmethod
    def forward(ctx, args, *leaves):
        ctx.args = args
        out = _forward(*args)
        ctx.mark_non_differentiable(*out[1:])
        return out

    @staticmethod
    def backward(ctx, g_rad, *_rest):
        need = ctx.needs_input_grad[1:]
        if g_rad is None or not any(need):
            return (None,) * (1 + len(need))
        scene, meta, cfg, px, py, sid, key_words, _, photon_maps = ctx.args
        return (None, *_mega_backward(scene, meta, cfg, px, py, sid,
                                      key_words, photon_maps, g_rad, need))


def _mega_backward_step(scene, meta, cfg, px, py, sample_ids, key_words,
                        photon_maps, g_rad, need):
    """_MegaRender's backward (the counterpart of pallas_pathtrace's
    _mega_bwd): the wavefront engine re-run under autograd on the lanes in
    batches of BWD_BATCH, on leaves made from the scene's DiffParams
    fields, and the gradients of those `need` names (a bool a field) for
    the radiance cotangent g_rad; None for the others."""
    from qaray_tpu_torch.integrators.engine import render_batch_wavefront

    params = DiffParams(*(t.detach().requires_grad_(w)
                          for t, w in zip(extract_params(scene), need)))
    wrt = [t for t, w in zip(params, need) if w]
    total = [torch.zeros_like(t) for t in wrt]
    spliced = splice_params(scene, params)
    with torch.enable_grad():
        for lo in range(0, px.shape[0], BWD_BATCH):
            sl = slice(lo, lo + BWD_BATCH)
            rad = render_batch_wavefront(
                spliced, meta, cfg, px[sl], py[sl], sample_ids[sl],
                key_words, photon_maps=photon_maps)[0]
            if not rad.requires_grad:
                continue
            for acc, g in zip(total, torch.autograd.grad(
                    rad, wrt, g_rad[sl], allow_unused=True)):
                if g is not None:
                    acc += g
    got = iter(total)
    return tuple(next(got) if w else None for w in need)


# The megakernel's backward under capture (utils/compiled.py): the scene's
# fields, the leaves among them, are tables; one batch's tape bounds the
# graph's pool.
_mega_backward = jit(_mega_backward_step,
                     static_argnames=("meta", "cfg", "need"),
                     inputs=("px", "py", "sample_ids", "g_rad"))


def mega_vjp(arguments, wrt, cts):
    """engine.render_batch's backward on the megakernel route under a
    caller's autograd (its jit's vjp, utils/compiled.py): _mega_backward at
    the radiance's cotangent cts[0], for the wrt leaves of the call's
    arguments that are DiffParams fields of its scene; zeros for the
    others, which the megakernel's forward does not read through autograd
    either."""
    a = arguments
    scene = a["scene"]
    field = {id(t): k for k, t in enumerate(extract_params(scene))}
    leaves, fields = [], []
    for n, idx in wrt:
        flat = pytree.tree_leaves(a[n])
        for i in idx:
            leaves.append(flat[i])
            fields.append(field.get(id(flat[i])) if n == "scene" else None)
    need = tuple(k in fields for k in range(len(DiffParams._fields)))
    grads = (None,) * len(need)
    if cts[0] is not None and any(need):
        maps = a["photon_maps"] if gathers(a["cfg"], a["photon_maps"]) \
            else None
        grads = _mega_backward(scene, a["meta"], a["cfg"], a["px"], a["py"],
                               a["sample_ids"], a["key_words"], maps, cts[0],
                               need)
    return tuple(torch.zeros_like(x) if k is None or grads[k] is None
                 else grads[k] for x, k in zip(leaves, fields))


def mega_render_host(scene: SceneArrays, meta: SceneMeta, cfg, px, py,
                     sample_ids, key_words, work=None, photon_maps=None,
                     block: int = 1):
    """mega_render's kernel source run on the CPU on CPU tensors
    (_build.load_host), in blocks of `block` threads (one std::thread each,
    sharing the block's shared memory and barriers; 1: one lane at a time),
    with its records gathered by the plain version of K5. For tests without
    a card: it holds the source's arithmetic to the plain version and its
    blocks' pooled work to one thread's; no entry point calls it and it
    counts no launch."""
    _check_lanes(px, py, sample_ids)
    if px.device.type != "cpu":
        raise ValueError("mega_render_host takes CPU tensors")
    fn = _kernel(host=True)
    from qaray_tpu_torch.ops import _build

    _build.check(_fns["host_block"](block), "host block size")
    try:
        return _launch(fn, None, scene, meta, cfg, px, py, sample_ids,
                       key_words, work,
                       photon_maps if gathers(cfg, photon_maps) else None)
    finally:
        _fns["host_block"](1)


# ---------------------------------------------------------------------------
# K1c's world-mesh hit on given rays: the probe of the kernel's own device
# functions, beside their plain version
# ---------------------------------------------------------------------------


def _probe_fn(host: bool = False):
    """qr_mega_mesh_probe of the CUDA library, or with host=True of the
    same source built for the CPU (_build.load_host; tests only)."""
    key = ("probe", host)
    if key not in _fns:
        from qaray_tpu_torch.ops import _build

        lib = (_build.load_host if host else _build.load)("megakernel")
        _fns[key] = _build.bind(lib, "qr_mega_mesh_probe",
                                "ppppipppiipppppp")
    return _fns[key]


def _tri_terms(p, d, rows):
    """csrc/mesh.cuh tri_hit of rays (p, d) [..., 3] against coefficient
    rows [..., 16] (broadcast): (hit, t, a, b, dn), with its operations in
    its order."""
    def dot(r, c):
        return (r[..., 0] * rows[..., c] + r[..., 1] * rows[..., c + 1]
                + r[..., 2] * rows[..., c + 2])

    pn, dn = dot(p, 0), dot(d, 0)
    pa, da = dot(p, 3), dot(d, 3)
    pb, db = dot(p, 6), dot(d, 6)
    safe = torch.where(torch.abs(dn) < 1e-30, torch.full_like(dn, 1e-30), dn)
    t = (rows[..., 9] - pn) / safe
    parallel = torch.abs(dn) < 1e-7 * rows[..., 12]
    a = pa + t * da + rows[..., 10]
    b = pb + t * db + rows[..., 11]
    c = 1.0 - a - b
    hit = ~parallel & (t > BIAS) & (a >= 0.0) & (b >= 0.0) & (c >= 0.0)
    return hit, t, a, b, dn


def mesh_fold_plain(rows, p, d, t_a, t_max, chunk: int = 256,
                    rays: int = 1 << 16):
    """The in-order sweep of mesh_probe_plain over coefficient rows [Fp,
    16]: (t, the winning row [B] int64 (-1 where the analytic winner
    stands), occluded [B]), `rays` rays against `chunk` rows at a time."""
    tb = t_a.clone()
    rb = torch.full(tb.shape, -1, dtype=torch.int64, device=p.device)
    occ = torch.zeros(tb.shape, dtype=torch.bool, device=p.device)
    for r0 in range(0, p.shape[0], rays):
        s = slice(r0, r0 + rays)
        ps, ds, tm = p[s, None], d[s, None], t_max[s, None]
        for lo in range(0, rows.shape[0], chunk):
            hit, t, *_ = _tri_terms(ps, ds, rows[None, lo:lo + chunk])
            t_hit = torch.where(hit, t, torch.full_like(t, float("inf")))
            t1, i1 = torch.min(t_hit, dim=1)  # the first row at the minimum
            take = t1 < tb[s]
            tb[s] = torch.where(take, t1, tb[s])
            rb[s] = torch.where(take, lo + i1, rb[s])
            occ[s] |= (hit & (t < tm)).any(dim=1)
    return tb, rb, occ


def mesh_probe_plain(rows, attr, p, d, t_a, t_max, chunk: int = 256):
    """The plain version of K1c's world-mesh hit (csrc/mega_common.cuh
    mesh_closest, mesh_occluded): the in-order sweep over every row of
    build_mega_mesh's tables rows, attr [Fp, 16] for rays p, d [B, 3].

    The closest hit folds each row into the analytic winner t_a [B] where
    its t is strictly smaller, so the analytic winner (row -1) wins ties
    and, of mesh rows at equal t, the lower. Returns (t [B], the winner's
    unnormalized smooth normal [B, 3] (0, 0, 1 where no row wins), its
    front flag [B], its material row [B] int32 (-1 where no row wins), and
    occluded [B]: some row hits with BIAS < t < t_max)."""
    _, rb, occ = mesh_fold_plain(rows, p, d, t_a, t_max, chunk)
    won = rb >= 0
    row = rb.clamp_min(0)
    _, t, a, bb, dn = _tri_terms(p, d, rows[row])
    at = attr[row]
    cc = 1.0 - a - bb
    nrm = torch.stack([a * at[:, k] + bb * at[:, k + 3] + cc * at[:, k + 6]
                       for k in range(3)], dim=1)
    up = torch.tensor([0.0, 0.0, 1.0], device=p.device)
    return (torch.where(won, t, t_a), torch.where(won[:, None], nrm, up),
            torch.where(won, dn <= 0.0, True),
            torch.where(won, at[:, 9].to(torch.int32), -1), occ)


def _probe_call(fn, stream, tabs, p, d, t_a, t_max, work):
    n = p.shape[0]
    dev = p.device
    leaf = MEGA_LEAF
    n_leaves = mega_tree_leaves(tabs.mesh_rows.shape[0], leaf)
    if tabs.mesh_tree.shape != (2 * n_leaves, 8):
        raise ValueError("mesh_tree does not match the rows and MEGA_LEAF")
    for t in (p, d, t_a, t_max, tabs.mesh_rows, tabs.mesh_attr,
              tabs.mesh_tree):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"float32 tensors on {dev} only")
    if work is not None and (work.shape != (n, 2) or work.device != dev
                             or work.dtype != torch.int32
                             or not work.is_contiguous()):
        raise ValueError("work must be a contiguous int32 [B, 2] tensor")
    p, d, t_a, t_max = (x.contiguous() for x in (p, d, t_a, t_max))
    t = torch.empty(n, dtype=torch.float32, device=dev)
    nrm = torch.empty((n, 3), dtype=torch.float32, device=dev)
    front, mrow, occ = (torch.empty(n, dtype=torch.int32, device=dev)
                        for _ in range(3))
    if n:
        from qaray_tpu_torch.ops import _build

        _build.check(fn(p.data_ptr(), d.data_ptr(), t_a.data_ptr(),
                        t_max.data_ptr(), n, tabs.mesh_rows.data_ptr(),
                        tabs.mesh_attr.data_ptr(), tabs.mesh_tree.data_ptr(),
                        n_leaves, leaf, t.data_ptr(), nrm.data_ptr(),
                        front.data_ptr(), mrow.data_ptr(), occ.data_ptr(),
                        work.data_ptr() if work is not None else None,
                        stream), "K1c mesh probe")
    return t, nrm, front > 0, mrow, occ > 0


def mesh_probe(tabs, p, d, t_a, t_max, work=None):
    """K1c's world-mesh hit on given rays p, d [B, 3]: the megakernel's own
    mesh_closest and mesh_occluded (qr_mega_mesh_probe) over the scene's
    kernel tables tabs (scene.arrays.KernelTables) on a card, from the
    analytic winner's t t_a [B] and the any hit's budget t_max [B]; its
    plain version, mesh_probe_plain, for tensors on the CPU. Returns what
    mesh_probe_plain returns. work: optional int32 [B, 2], the kernel's
    triangle tests of the closest hit and of the any hit (CUDA only). For
    tests and measurements: no path calls it, and it counts no launch."""
    if p.device.type == "cpu":
        return mesh_probe_plain(tabs.mesh_rows, tabs.mesh_attr, p, d, t_a,
                                t_max)
    return _probe_call(_probe_fn(), torch.cuda.current_stream().cuda_stream,
                       tabs, p, d, t_a, t_max, work)


def mesh_probe_host(tabs, p, d, t_a, t_max, work=None):
    """mesh_probe's kernel source run on the CPU on CPU tensors
    (_build.load_host), one ray at a time. For tests without a card."""
    if p.device.type != "cpu":
        raise ValueError("mesh_probe_host takes CPU tensors")
    return _probe_call(_probe_fn(host=True), None, tabs, p, d, t_a, t_max,
                       work)


def _launch(fn, stream, scene, meta, cfg, px, py, sample_ids, key_words,
            work, photon_maps):
    """Check the tables against what the kernel reads and call
    qr_mega_render `fn` on `stream`; with photon_maps, gather the records
    the kernel wrote (gather_apply)."""
    if cfg.integrator not in ("pathtrace", "photonmap"):
        raise NotImplementedError(
            "the megakernel renders pathtrace and photonmap")
    if not cfg.inverse_square_falloff:
        raise NotImplementedError("the megakernel always applies falloff")
    k0, k1 = fold_words(key_words)
    dev = px.device
    tabs = scene.kernel
    if tabs is None:
        raise ValueError("scene has no kernel tables "
                         "(scene.arrays.with_kernel_tables)")
    prims = scene.analytic
    for t, dtype in ((prims.table, torch.float32), (prims.kind, torch.int32),
                     (prims.mtl, torch.int32), (tabs.mtl, torch.float32),
                     (tabs.light, torch.float32), (tabs.cam, torch.float32),
                     (tabs.light_kind, torch.int32),
                     (tabs.light_soft, torch.int32)):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"scene table on {t.device} as {t.dtype}: the "
                             f"kernel needs contiguous {dtype} on {dev}")
    n = px.shape[0]
    px, py, sid = (t.to(torch.int32).contiguous()
                   for t in (px, py, sample_ids))
    r, g, b, t0 = (torch.empty(n, dtype=torch.float32, device=dev)
                   for _ in range(4))
    if work is not None and (work.device != dev or work.dtype != torch.int32
                             or work.shape != (n, 8)
                             or not work.is_contiguous()):
        raise ValueError("work must be a contiguous int32 [B, 8] tensor on "
                         "the lanes' device")
    mesh = mesh_args(tabs, meta, dev)
    # K1b: one bit per material slot with a live checker somewhere.
    tex_mask = 0
    if mega_textured(meta):
        tex_mask = sum(1 << s for s, live in enumerate(meta.mega_tex_slots)
                       if live)
    elif meta.has_mtl_textures:
        raise NotImplementedError(
            "the megakernel samples checker textures only, and none on its "
            "meshes (meta.mega_tex_ok)")
    if tabs.mtl.shape[1] != (MTL_TEX_COLS if tex_mask else MTL_COLS):
        raise ValueError("the kernel tables do not match the scene's "
                         "textures (scene.arrays.with_kernel_tables)")
    if photon_maps is not None:
        from qaray_tpu_torch.ops.photon import check_tables

        for pmap in photon_maps:
            check_tables(pmap.ctable, pmap.cbounds, dev)
        cmap = photon_maps[1]
        pout = torch.zeros((2 + NUM_REC, n), dtype=torch.float32, device=dev)
    if n:
        norm_power = 2 if cfg.integrator == "pathtrace" else 1
        light_norm = ((1.0 / meta.num_lights) ** norm_power
                      if meta.num_lights else 0.0)
        from qaray_tpu_torch.ops import _build

        rc = fn(
            px.data_ptr(), py.data_ptr(), sid.data_ptr(), n,
            prims.table.data_ptr(), prims.kind.data_ptr(),
            prims.mtl.data_ptr(), meta.num_analytic,
            tabs.mtl.data_ptr(), tabs.mtl.shape[0], tabs.mtl.shape[1],
            tex_mask, tabs.light.data_ptr(), tabs.light_kind.data_ptr(),
            tabs.light_soft.data_ptr(), meta.num_lights, light_norm,
            tabs.cam.data_ptr(), k0, k1, meta.img_width,
            int(cfg.integrator == "photonmap"), cfg.max_bounce,
            cfg.shadow_spp, cfg.shadow_spp_max, int(meta.has_dof),
            int(meta.has_glossy),
            *mesh,
            r.data_ptr(), g.data_ptr(), b.data_ptr(),
            t0.data_ptr(), work.data_ptr() if work is not None else None,
            int(any(k not in (LIGHT_AMBIENT, LIGHT_DIRECT) and soft
                    for k, soft in zip(meta.light_kinds, meta.light_soft))),
            *((cmap.ctable.data_ptr(), cmap.cbounds.data_ptr(),
               cmap.cbounds.shape[0], radius2(cmap.radius), pout.data_ptr())
              if photon_maps is not None else (None, None, 0, 0.0, None)),
            stream,
        )
        _build.check(rc, "K1a megakernel")
    radiance = torch.stack([r, g, b], dim=-1)
    if photon_maps is None:
        return radiance, t0
    from qaray_tpu_torch.ops.photon import gather_apply

    # Global-map gathers: the records, Morton-sorted, through K5.
    contrib, esc = gather_apply(photon_maps[0], pout[2:])
    return (radiance + contrib, t0, pout[0] > 0.5, (pout[1] > 0.5) | esc)
