"""Path-trace megakernel dispatch (kernels K1a, K1b, K1c and K1d,
csrc/megakernel.cu).

Counterpart of qaray_tpu/ops/pallas_pathtrace.py: _fold_words
(core.rng.fold_words here), build_mega_mesh, _mega_raw and mega_render
with its custom_vjp (_MegaRender). _pack_tables is
scene.arrays.with_kernel_tables, run once when a scene is compiled. One
launch renders one pathtrace or photonmap sample per lane: camera ray,
every bounce's closest hit, shading, next-event shadow rays and all
threefry draws. With a world mesh (meta.mesh_mega) the same launch sweeps
its triangles in-kernel (K1c): `launches["K1c"]` counts those launches.
On a scene whose live material textures are all checkers
(scene.arrays.mega_textured) the launch is of the textured kernel, which
computes the winner's uv, the primary hit's footprint and the checker
samples itself (K1b): `launches["K1b"]` counts those. With photon maps
(photonmap and cfg.use_photon_map) the launch is of the gathering kernel
(K1d), which gathers the caustics map itself and writes the irr0 and
escalation planes and one global-map record per lane; the wrapper gathers
the records with K5 (ops/photon.gather_apply), adds their contribution
and ORs their escalation flags: `launches["K1d"]` counts those launches.

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
lanes, and takes the radiance cotangent back to those leaves. Under
threefry words both compute the same function draw for draw, so this is
the gradient of the forward's estimator. (The JAX package's backward
samples XLA's rbg stream under an rbg key, an independent estimator; here
both draw from the folded threefry words.) The primary depth, the photon
maps and the photonmap flags carry no gradient.
"""

import numpy as np
import torch

from qaray_tpu_torch.core.rng import fold_words
from qaray_tpu_torch.diff import DiffParams, extract_params, splice_params
from qaray_tpu_torch.photon.gather import radius2
from qaray_tpu_torch.scene.arrays import (
    MTL_COLS,
    MTL_TEX_COLS,
    SceneArrays,
    SceneMeta,
    mega_textured,
)

launches = {"K1a": 0, "K1b": 0, "K1c": 0, "K1d": 0}

NUM_REC = 17  # fields of a global-map gather record

MEGA_CLUSTER = 256  # triangles per cull cluster

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
            "pppipppipiiipppifpuuiiiiiiipppipppppppifpp")
    return _fns[host]


def build_mega_mesh(tri_v, tri_n, tri_mtl, cluster: int = MEGA_CLUSTER):
    """World-baked triangles -> (coeff16 [Fp,16], attr16 [Fp,16],
    cbounds [C,8]) for the megakernel's mesh sweep (K1c).

    Rows are Morton-ordered by centroid (tight cluster boxes); coeff16 is
    the pack_coeff16 layout; attr16 cols 0-8 hold the three (unnormalized,
    world) corner normals and col 9 the material table row. Padding rows
    never hit (all-zero coefficients)."""
    from qaray_tpu_torch.ops.mesh_stream import build_stream
    from qaray_tpu_torch.ops.mesh_sweep import pack_coeff16
    from qaray_tpu_torch.ops.mesh_tiles import _morton3

    tri_v = np.asarray(tri_v, np.float32)
    num = tri_v.shape[0]
    order = np.argsort(_morton3(tri_v.mean(axis=1)), kind="stable")
    sv = tri_v[order]
    sn = np.asarray(tri_n, np.float32)[order]
    sm = np.asarray(tri_mtl, np.int32)[order]
    stream = build_stream(sv, chunk=cluster)
    c16 = pack_coeff16(stream.coeff, stream.const)[: stream.coeff.shape[0]]
    fp = c16.shape[0]
    attr = np.zeros((fp, 16), np.float32)
    attr[:num, 0:9] = sn.reshape(num, 9)
    attr[:num, 9] = sm.astype(np.float32)
    nc = fp // cluster
    cb = np.zeros((nc, 8), np.float32)
    for c in range(nc):
        rows = sv[c * cluster:(c + 1) * cluster]
        if rows.size == 0:
            cb[c, 0:3] = 1.0
            cb[c, 3:6] = -1.0  # empty box: never hit
        else:
            cb[c, 0:3] = rows.reshape(-1, 3).min(axis=0)
            cb[c, 3:6] = rows.reshape(-1, 3).max(axis=0)
    return c16, attr, cb


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
    [B, 7] tensor the kernel fills with each lane's primitive tests,
    threefry ciphers, shaded vertices, triangle tests and checker tests,
    and when it gathers its photon tests and caustics cluster tests (the
    last two columns are left as they were otherwise; CUDA only; for
    roofline bounds).
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
    with respect to the DiffParams leaves."""

    @staticmethod
    def forward(ctx, args, *leaves):
        ctx.args = args
        ctx.save_for_backward(*leaves)
        out = _forward(*args)
        ctx.mark_non_differentiable(*out[1:])
        return out

    @staticmethod
    def backward(ctx, g_rad, *_rest):
        from qaray_tpu_torch.integrators.engine import render_batch_wavefront

        scene, meta, cfg, px, py, sid, key_words, _, photon_maps = ctx.args
        leaves = ctx.saved_tensors
        need = ctx.needs_input_grad[1:]
        if g_rad is None or not any(need):
            return (None,) * (1 + len(leaves))
        params = DiffParams(*(t.detach().requires_grad_(w)
                              for t, w in zip(leaves, need)))
        wrt = [t for t, w in zip(params, need) if w]
        total = [torch.zeros_like(t) for t in wrt]
        spliced = splice_params(scene, params)
        with torch.enable_grad():
            for lo in range(0, px.shape[0], BWD_BATCH):
                sl = slice(lo, lo + BWD_BATCH)
                rad = render_batch_wavefront(
                    spliced, meta, cfg, px[sl], py[sl], sid[sl], key_words,
                    photon_maps=photon_maps)[0]
                if not rad.requires_grad:
                    continue
                for acc, g in zip(total, torch.autograd.grad(
                        rad, wrt, g_rad[sl], allow_unused=True)):
                    if g is not None:
                        acc += g
        got = iter(total)
        return (None, *(next(got) if w else None for w in need))


def mega_render_host(scene: SceneArrays, meta: SceneMeta, cfg, px, py,
                     sample_ids, key_words, work=None, photon_maps=None):
    """mega_render's kernel source run on the CPU, one lane at a time, on CPU
    tensors (_build.load_host), with its records gathered by the plain
    version of K5. For tests without a card: it holds the source's
    arithmetic to the plain version; no entry point calls it and it counts
    no launch."""
    _check_lanes(px, py, sample_ids)
    if px.device.type != "cpu":
        raise ValueError("mega_render_host takes CPU tensors")
    return _launch(_kernel(host=True), None, scene, meta, cfg, px, py,
                   sample_ids, key_words, work,
                   photon_maps if gathers(cfg, photon_maps) else None)


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
                             or work.shape != (n, 7)
                             or not work.is_contiguous()):
        raise ValueError("work must be a contiguous int32 [B, 7] tensor on "
                         "the lanes' device")
    mesh = (tabs.mesh_rows, tabs.mesh_attr, tabs.mesh_cb)
    if meta.mesh_mega != (tabs.mesh_rows is not None):
        raise ValueError("the kernel tables do not match meta.mesh_mega "
                         "(scene.arrays.with_kernel_tables)")
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
    n_clusters = 0
    if meta.mesh_mega:
        n_clusters = tabs.mesh_rows.shape[0] // MEGA_CLUSTER
        for t, shape in zip(mesh, ((n_clusters * MEGA_CLUSTER, 16),
                                   (n_clusters * MEGA_CLUSTER, 16),
                                   (n_clusters, 8))):
            if (t.device != dev or t.dtype != torch.float32
                    or t.shape != shape or not t.is_contiguous()):
                raise ValueError(f"mesh table {tuple(t.shape)} on {t.device}"
                                 f": the kernel needs contiguous float32 "
                                 f"{shape} on {dev}")
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
            *(t.data_ptr() if n_clusters else None for t in mesh), n_clusters,
            r.data_ptr(), g.data_ptr(), b.data_ptr(),
            t0.data_ptr(), work.data_ptr() if work is not None else None,
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
