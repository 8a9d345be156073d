"""Fused adjoint dispatch (kernel K6, csrc/adjoint.cu).

Counterpart of qaray_tpu/ops/pallas_adjoint.py: param_layout,
adjoint_supported and adjoint_render. One launch gives the gradient of
sum(radiance * ct) with respect to the parameters diff.DiffParams carries
(without the texels, which the gate leaves out), summed over lanes, as one
flat vector in param_layout's order. The kernel replays the megakernel's
forward draw for draw and runs the reverse beta-chain (the source says
how).

adjoint_render launches the kernel for CUDA tensors and runs its plain
version, adjoint_render_plain, for tensors on the CPU; it never falls back
from one to the other. The plain version is autograd through the
wavefront engine (diff.render_with_params), packed in the same order.
adjoint_render_host runs the kernel's source on the CPU under g++, for
tests. `launches` counts kernel launches.
"""

import torch

from qaray_tpu_torch.core.rng import fold_words
from qaray_tpu_torch.ops.megakernel import MEGA_CLUSTER, _check_lanes

launches = {"K6": 0}

THREADS = 128  # lanes a block (csrc/adjoint.cu kThreads)
NUM_HOOKS = 13  # floats a lane a bounce of the reverse sweep's scratch
# Lanes a batch of the plain version's autograd.
PLAIN_BATCH = 65536

_fns = {}


def param_layout(num_materials: int, num_lights: int) -> int:
    """Length of the flat gradient: per material row r (16 at r * 16)
    diffuse (3), specular (3), emission (3), reflection (3), refraction
    (3), glossiness (1); then per light l (3 at M * 16 + l * 3); then the
    background (3) and the environment (3)."""
    return num_materials * 16 + num_lights * 3 + 6


def adjoint_supported(meta, cfg) -> bool:
    """pallas_adjoint.adjoint_supported: pathtrace without photon maps on
    analytic scenes, with at most a megakernel mesh in the per-cluster
    layout, untextured, without a depth of field, with at most 8 material
    rows and 8 lights."""
    return (
        cfg.integrator == "pathtrace"
        and not cfg.use_photon_map
        and (meta.num_mesh_instances == 0
             or (meta.mesh_mega and not meta.mesh_mega_stream))
        and meta.num_analytic > 0
        and len(meta.analytic_kinds) == meta.num_analytic
        and not meta.has_mtl_textures
        and not meta.has_bg_texture
        and not meta.has_env_texture
        and not meta.has_dof
        and meta.num_materials <= 8
        and meta.num_lights <= 8
    )


def _kernel(host: bool = False):
    """qr_adjoint_render of the CUDA library, or with host=True of the same
    source built for the CPU (_build.load_host; tests only)."""
    if host not in _fns:
        from qaray_tpu_torch.ops import _build

        lib = (_build.load_host if host else _build.load)("adjoint")
        _fns[host] = _build.bind(lib, "qr_adjoint_render",
                                 "pppipppipipppifpuuiiiipppipppiipp")
    return _fns[host]


def pack_grads(grads, meta):
    """A DiffParams of gradients -> the flat [param_layout] vector."""
    m, ll = meta.num_materials, meta.num_lights
    mt = torch.cat([grads.mtl_diffuse, grads.mtl_specular,
                    grads.mtl_emission, grads.mtl_reflection,
                    grads.mtl_refraction, grads.mtl_glossiness[:, None]],
                   dim=1)
    return torch.cat([mt.reshape(m * 16), grads.light_intensity.reshape(
        ll * 3), grads.background, grads.environment])


def adjoint_render_plain(scene, meta, cfg, px, py, sample_ids, key_words,
                         ct):
    """K6's plain version: autograd of sum(radiance * ct) through
    diff.render_with_params with respect to the DiffParams leaves, in
    batches of PLAIN_BATCH lanes, packed in param_layout's order."""
    from qaray_tpu_torch.diff import (
        DiffParams,
        extract_params,
        render_with_params,
    )

    params = DiffParams(*(t.detach().requires_grad_()
                          for t in extract_params(scene)))
    total = [torch.zeros_like(p) for p in params]
    with torch.enable_grad():
        for lo in range(0, px.shape[0], PLAIN_BATCH):
            sl = slice(lo, lo + PLAIN_BATCH)
            rad = render_with_params(scene, meta, cfg, params, px[sl],
                                     py[sl], sample_ids[sl], key_words)
            grads = torch.autograd.grad((rad * ct[sl]).sum(), params,
                                        allow_unused=True)
            for acc, g in zip(total, grads):
                if g is not None:
                    acc += g
    return pack_grads(DiffParams(*total), meta)


def adjoint_render(scene, meta, cfg, px, py, sample_ids, key_words, ct,
                   work=None):
    """Fused parameter gradient: ct [B, 3] is the per-lane radiance
    cotangent; returns the flat [param_layout] float32 gradient, summed
    over all lanes. key_words: 2 threefry words, or the 4 of an rbg key
    (core.rng.fold_words). work: optional int32 [B, 4] the kernel fills
    with each lane's primitive tests, threefry ciphers, shaded vertices and
    triangle tests (CUDA only; for roofline bounds)."""
    _check_lanes(px, py, sample_ids)
    if px.device.type == "cpu":
        return adjoint_render_plain(scene, meta, cfg, px, py, sample_ids,
                                    key_words, ct)
    out = _launch(_kernel(), torch.cuda.current_stream().cuda_stream, scene,
                  meta, cfg, px, py, sample_ids, key_words, ct, work)
    if px.shape[0]:
        launches["K6"] += 1
    return out


def adjoint_render_host(scene, meta, cfg, px, py, sample_ids, key_words, ct,
                        work=None):
    """adjoint_render's kernel source run on the CPU, one lane at a time,
    on CPU tensors (_build.load_host). For tests without a card: it holds
    the source's arithmetic to the plain version; no entry point calls it
    and it counts no launch."""
    _check_lanes(px, py, sample_ids)
    if px.device.type != "cpu":
        raise ValueError("adjoint_render_host takes CPU tensors")
    return _launch(_kernel(host=True), None, scene, meta, cfg, px, py,
                   sample_ids, key_words, ct, work)


def _launch(fn, stream, scene, meta, cfg, px, py, sample_ids, key_words, ct,
            work):
    """Check what the kernel reads and call qr_adjoint_render `fn` on
    `stream`; returns the summed flat gradient."""
    if not adjoint_supported(meta, cfg):
        raise NotImplementedError(
            "the fused adjoint serves pathtrace on untextured analytic "
            "scenes without a depth of field, with at most 8 materials and "
            "8 lights (adjoint_supported)")
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
    if ct.shape != (n, 3) or ct.device != dev:
        raise ValueError("ct must be [B, 3] on the lanes' device")
    if work is not None and (work.device != dev or work.dtype != torch.int32
                             or work.shape != (n, 4)
                             or not work.is_contiguous()):
        raise ValueError("work must be a contiguous int32 [B, 4] tensor on "
                         "the lanes' device")
    n_params = param_layout(meta.num_materials, meta.num_lights)
    if tabs.mtl.shape != (meta.num_materials, 22):
        raise ValueError("the kernel tables do not match the meta "
                         "(scene.arrays.with_kernel_tables)")
    n_clusters = 0
    mesh = (tabs.mesh_rows, tabs.mesh_attr, tabs.mesh_cb)
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
    n_rows = (n + THREADS - 1) // THREADS
    out = torch.zeros((n_rows, n_params), dtype=torch.float32, device=dev)
    if n == 0:
        return out.sum(0)
    px, py, sid = (t.to(torch.int32).contiguous()
                   for t in (px, py, sample_ids))
    ct = ct.detach().to(torch.float32).contiguous()
    hooks = torch.empty((NUM_HOOKS, cfg.max_bounce + 1, n),
                        dtype=torch.float32, device=dev)
    k0, k1 = fold_words(key_words)
    light_norm = (1.0 / meta.num_lights) ** 2 if meta.num_lights else 0.0
    from qaray_tpu_torch.ops import _build

    rc = fn(
        px.data_ptr(), py.data_ptr(), sid.data_ptr(), n,
        prims.table.data_ptr(), prims.kind.data_ptr(), prims.mtl.data_ptr(),
        meta.num_analytic, tabs.mtl.data_ptr(), tabs.mtl.shape[0],
        tabs.light.data_ptr(), tabs.light_kind.data_ptr(),
        tabs.light_soft.data_ptr(), meta.num_lights, light_norm,
        tabs.cam.data_ptr(), k0, k1, meta.img_width, cfg.max_bounce,
        cfg.shadow_spp, cfg.shadow_spp_max,
        *(t.data_ptr() if n_clusters else None for t in mesh), n_clusters,
        ct.data_ptr(), hooks.data_ptr(), out.data_ptr(), n_rows, n_params,
        work.data_ptr() if work is not None else None, stream,
    )
    _build.check(rc, "K6 adjoint")
    return out.sum(0)
