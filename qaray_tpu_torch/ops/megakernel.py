"""Path-trace megakernel dispatch (kernel K1a, csrc/megakernel.cu).

Counterpart of qaray_tpu/ops/pallas_pathtrace.py: _fold_words
(core.rng.fold_words here), _mega_raw and mega_render, forward only (the
backward comes with the gradient slice). _pack_tables is
scene.arrays.with_kernel_tables, run once when a scene is compiled. One launch renders one
pathtrace or photonmap sample per lane: camera ray, every bounce's closest
hit, shading, next-event shadow rays and all threefry draws.

The plain version of K1a is the wavefront engine
(integrators/engine.render_batch_wavefront), which draws the same random
numbers; mega_render runs it for tensors on the CPU and launches the kernel
for CUDA tensors, never falling back from one to the other. `launches`
counts kernel launches.
"""

import torch

from qaray_tpu_torch.core.rng import fold_words
from qaray_tpu_torch.scene.arrays import SceneArrays, SceneMeta

launches = {"K1a": 0}

_fn = []


def _kernel():
    if not _fn:
        from qaray_tpu_torch.ops import _build

        lib = _build.load("megakernel")
        _fn.append(_build.bind(lib, "qr_mega_render",
                               "pppipppipipppifpuuiiiiiiipppppp"))
    return _fn[0]


def _check_lanes(px, py, sample_ids):
    n = px.shape[0]
    for t in (px, py, sample_ids):
        if t.device != px.device:
            raise ValueError(f"lanes on {t.device} and {px.device}")
        if t.ndim != 1 or t.shape[0] != n:
            raise ValueError("px, py and sample_ids must be [B] each")


def mega_render(scene: SceneArrays, meta: SceneMeta, cfg, px, py, sample_ids,
                key_words, work=None):
    """One sample per (px, py) lane: (radiance [B,3], primary depth [B]).

    key_words: 2 threefry words, or the 4 words of a jax 'rbg' key, which
    fold to (0, 0) as in the reference (core.rng.fold_words). work: optional
    int32 [B, 3] tensor the kernel fills with each lane's primitive tests,
    threefry ciphers and shaded vertices (CUDA only; for roofline bounds).
    """
    _check_lanes(px, py, sample_ids)
    if px.device.type == "cpu":
        from qaray_tpu_torch.integrators.engine import render_batch_wavefront

        return render_batch_wavefront(scene, meta, cfg, px, py, sample_ids,
                                      key_words)
    if cfg.integrator not in ("pathtrace", "photonmap") or cfg.use_photon_map:
        raise NotImplementedError(
            "the megakernel renders pathtrace and photonmap without photon "
            "gathering")
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
                             or work.shape != (n, 3)
                             or not work.is_contiguous()):
        raise ValueError("work must be a contiguous int32 [B, 3] tensor on "
                         "the lanes' device")
    if n:
        norm_power = 2 if cfg.integrator == "pathtrace" else 1
        light_norm = ((1.0 / meta.num_lights) ** norm_power
                      if meta.num_lights else 0.0)
        from qaray_tpu_torch.ops import _build

        rc = _kernel()(
            px.data_ptr(), py.data_ptr(), sid.data_ptr(), n,
            prims.table.data_ptr(), prims.kind.data_ptr(),
            prims.mtl.data_ptr(), meta.num_analytic,
            tabs.mtl.data_ptr(), tabs.mtl.shape[0],
            tabs.light.data_ptr(), tabs.light_kind.data_ptr(),
            tabs.light_soft.data_ptr(), meta.num_lights, light_norm,
            tabs.cam.data_ptr(), k0, k1, meta.img_width,
            int(cfg.integrator == "photonmap"), cfg.max_bounce,
            cfg.shadow_spp, cfg.shadow_spp_max, int(meta.has_dof),
            int(meta.has_glossy), r.data_ptr(), g.data_ptr(), b.data_ptr(),
            t0.data_ptr(), work.data_ptr() if work is not None else None,
            torch.cuda.current_stream().cuda_stream,
        )
        _build.check(rc, "K1a megakernel")
        launches["K1a"] += 1
    return torch.stack([r, g, b], dim=-1), t0
