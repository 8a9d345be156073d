"""Renderer: the adaptive-supersampling loop over sample rounds.

Counterpart of qaray_tpu/renderer.py on one device. All active pixels
advance one sample per dispatch; adaptive sampling is host-side
active-pixel compaction between rounds, with SuperSamplerHalton's stopping
rule (scene/scene.cpp:92-98: stop when s >= sppMin and every channel's std
is under its threshold, hard stop at sppMax). Phase 1 packs several sample
indices into one dispatch when the image underfills the batch; phase 2
renders only the unconverged pixels. The accumulation planes stay on the
device (fb/device_accum.py). All six integrators, textured scenes and
photon maps render (integrators/engine.render_batch picks the megakernel
or the wavefront engine).

With use_photon_map, compute_scene builds the global and caustics maps
(photon/build.py), clusters them for the gather kernels and writes
photonmap.dat and caustics.dat into the working directory, as the
reference and the JAX package do. On the megakernel route the kernels'
gathers are exact up to GATHER_K photons in the radius; lanes over it are
flagged, skipped by the fold and rendered again on the wavefront engine
with the exact estimate (same key words, same paths), folded in sample
order so that per-pixel counts stay exact.

Multi-device rendering, checkpoints and rank-debug planes arrive with their
slices of the port and raise NotImplementedError here.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from qaray_tpu_torch.core.constants import SPP_THRESHOLD
from qaray_tpu_torch.core.rng import key_words
from qaray_tpu_torch.fb import device_accum
from qaray_tpu_torch.fb.framebuffer import FrameBuffer
from qaray_tpu_torch.integrators.engine import IntegratorConfig, render_batch
from qaray_tpu_torch.scene.compiler import compile_scene


@dataclasses.dataclass
class RendererParam:
    """The reference RendererParam defaults (renderer.h:47-68)."""

    use_srgb: bool = True
    spp_max: int = 8
    spp_min: int = 4
    max_bounce: int = 5
    integrator: str = "photonmap"
    use_photon_map: bool = False
    photon_map_size: int = 10000
    photon_map_bounce: int = 20
    photon_map_radius: float = 0.2
    caustics_map_size: int = 1000
    caustics_map_bounce: int = 20
    caustics_map_radius: float = 1.0
    shadow_spp: int = 16  # GenLight::shadow_spp_min (lights.cpp:16)
    shadow_spp_max: int = 64  # GenLight::shadow_spp_max (lights.cpp:17)
    mc_samples: int = 10  # MtlBlinn_MonteCarloGI maxMCSample (mcgi only)
    threshold: tuple = SPP_THRESHOLD
    seed: int = 0
    # Key kind, as in qaray_tpu: 'rbg' (the default) or 'threefry2x32'.
    rng_impl: str = "rbg"
    round_spp: int = 1  # samples per adaptive round after spp_min
    batch_pixels: int = 1 << 20  # max pixel lanes per dispatch
    num_devices: int = 0
    progressive_every: int = 0  # save colorBuffer every N spp (0 = off)
    progressive_prefix: str = ""
    rank_debug: bool = False
    checkpoint_every: int = 0
    checkpoint_path: str = "render_checkpoint.npz"


class Renderer:
    def __init__(self, param: Optional[RendererParam] = None,
                 device="cuda"):
        self.param = param or RendererParam()
        p = self.param
        for flag, what in ((p.num_devices > 1, "multi-device rendering"),
                           (p.rank_debug, "rank-debug planes"),
                           (p.checkpoint_every, "checkpoints")):
            if flag:
                raise NotImplementedError(
                    f"{what} come with a later slice of the port")
        self.device = torch.device(device)
        self.stop_flag = False
        self.scene_arrays = None
        self.meta = None
        self.fb: Optional[FrameBuffer] = None
        self.photon_maps = None
        self._progress_cb: Optional[Callable] = None
        self._accum = None

    def compute_scene(self, scene_desc):
        self.scene_arrays, self.meta = compile_scene(scene_desc,
                                                     device=self.device)
        self.fb = FrameBuffer(self.meta.img_width, self.meta.img_height)
        if self.param.use_photon_map:
            from qaray_tpu_torch.photon.build import (
                build_photon_maps,
                save_photon_map,
            )
            from qaray_tpu_torch.photon.cluster import cluster_photon_map

            gmap, cmap = build_photon_maps(self.scene_arrays, self.meta,
                                           self.param)
            # Morton-clustered tables for the gather kernels (K1d, K5); the
            # exact gathers of the wavefront engine ignore them.
            self.photon_maps = (cluster_photon_map(gmap),
                                cluster_photon_map(cmap))
            # The reference dumps both maps for its viewer
            # (renderer.cpp:204-209, 284-289): same files, same records.
            save_photon_map(self.photon_maps[0], "photonmap.dat")
            save_photon_map(self.photon_maps[1], "caustics.dat")
        return self.scene_arrays, self.meta

    def _effective_batch(self) -> int:
        """Pixel lanes per dispatch: the MC-GI expansion widens the
        wavefront mc_samples-fold after the first bounce, so its dispatches
        start that much smaller (qaray_tpu/renderer.py:137-145)."""
        p = self.param
        if p.integrator == "mcgi" and p.mc_samples > 1:
            return max(1, p.batch_pixels // p.mc_samples)
        return p.batch_pixels

    def _want_aux(self) -> bool:
        """Ask the engine for the irradiance debug plane (photonmap with
        photon maps only)."""
        return (self.param.integrator == "photonmap"
                and self.param.use_photon_map)

    def signal_stop(self):
        self.stop_flag = True

    def set_progress_callback(self, cb):
        self._progress_cb = cb

    def integrator_config(self) -> IntegratorConfig:
        p = self.param
        return IntegratorConfig(
            integrator=p.integrator,
            max_bounce=p.max_bounce,
            shadow_spp=p.shadow_spp,
            shadow_spp_max=p.shadow_spp_max,
            mc_samples=p.mc_samples,
            inverse_square_falloff=p.integrator in ("photonmap", "pathtrace",
                                                    "mcgi"),
            use_photon_map=p.use_photon_map,
        )

    # -- render loop -----------------------------------------------------

    def render(self) -> FrameBuffer:
        assert self.scene_arrays is not None, "call compute_scene() first"
        p = self.param
        cfg = self.integrator_config()
        fb = self.fb
        num_pixels = self.meta.img_width * self.meta.img_height
        words = key_words(p.rng_impl, p.seed)
        self._words = words
        # Megakernel dispatches with photon gathering return a last
        # escalation flag per lane (the gather saw > GATHER_K photons in
        # the radius): those lanes are rendered again on the exact engine.
        from qaray_tpu_torch.integrators.engine import use_pathtrace_mega

        self._mega_photon = bool(cfg.use_photon_map and use_pathtrace_mega(
            self.meta, cfg, self.photon_maps))
        self._accum = device_accum.init_state(fb, self.device,
                                              want_irr=self._want_aux())
        all_ids = np.arange(num_pixels, dtype=np.int32)
        start = time.time()

        # Phase 1: spp_min samples for every pixel, several sample indices
        # per dispatch when the image alone underfills the batch.
        s = int(fb.count.min())
        batch = self._effective_batch()
        pack = max(1, batch // max(num_pixels, 1))
        while s < p.spp_min:
            if self.stop_flag:
                return self.sync_fb()
            if num_pixels <= batch:
                k = min(pack, p.spp_min - s)
                self._render_packed(cfg, all_ids, list(range(s, s + k)),
                                    words, record_depth=(s == 0))
            else:
                k = 1
                self._render_round(cfg, all_ids, s, words,
                                   record_depth=(s == 0))
            s += k
            self._report(s)

        # Phase 2: adaptive refinement of the unconverged pixels.
        s = p.spp_min
        while s < p.spp_max:
            active = device_accum.unconverged_ids(self._accum, p.threshold, s)
            if active.size == 0 or self.stop_flag:
                break
            for _ in range(min(p.round_spp, p.spp_max - s)):
                self._render_round(cfg, active, s, words, record_depth=False)
                s += 1
            self._report(s)

        self.sync_fb()
        self._last_elapsed = time.time() - start
        fb.finalize(p.use_srgb, p.spp_max)
        return fb

    def sync_fb(self):
        """Mirror the device accumulator into the host FrameBuffer."""
        if self._accum is not None:
            device_accum.sync_to_fb(self._accum, self.fb)
        return self.fb

    def _lanes(self, pixel_ids: np.ndarray, sample_ids: np.ndarray):
        w = self.meta.img_width
        ids = torch.as_tensor(pixel_ids, device=self.device)
        return (ids % w, ids // w,
                torch.as_tensor(sample_ids, device=self.device))

    def _dispatch(self, cfg, px, py, sid, words):
        """render_batch with this render's maps: (radiance, depth, irr or
        None, esc or None)."""
        out = render_batch(self.scene_arrays, self.meta, cfg, px, py, sid,
                           words, self.photon_maps,
                           want_aux=self._want_aux())
        irr = out[2] if self._want_aux() else None
        esc = out[-1] if self._mega_photon else None
        return out[0], out[1], irr, esc

    def _render_packed(self, cfg, pixel_ids, sample_indices, words,
                       record_depth: bool):
        """len(sample_indices) samples per pixel in one dispatch, folded
        into the accumulator in sample order (the recurrence is
        order-sensitive; the order matches the reference loop)."""
        n = pixel_ids.size
        ids = np.tile(pixel_ids, len(sample_indices))
        sids = np.repeat(np.asarray(sample_indices, np.int32), n)
        px, py, sid = self._lanes(ids, sids)
        radiance, depth, irr, esc = self._dispatch(cfg, px, py, sid, words)
        fixed = self._render_escalated(ids, sids, esc)
        for k in range(len(sample_indices)):
            self._fold(pixel_ids, k * n, radiance, esc, irr, fixed)
        if record_depth:
            self.fb.set_depth(pixel_ids, depth[:n].cpu().numpy())

    def _render_round(self, cfg, pixel_ids, sample_idx: int, words,
                      record_depth: bool):
        """One sample for each pixel id, chunked to the batch size."""
        chunk = self._effective_batch()
        for lo in range(0, pixel_ids.size, chunk):
            ids = pixel_ids[lo:lo + chunk]
            sids = np.full(ids.size, sample_idx, np.int32)
            px, py, sid = self._lanes(ids, sids)
            radiance, depth, irr, esc = self._dispatch(cfg, px, py, sid,
                                                       words)
            fixed = self._render_escalated(ids, sids, esc)
            self._fold(ids, 0, radiance, esc, irr, fixed)
            if record_depth:
                self.fb.set_depth(ids, depth.cpu().numpy())

    def _fold(self, pixel_ids: np.ndarray, lo: int, radiance, esc=None,
              irr=None, fixed=None):
        """Fold lanes [lo, lo + len(pixel_ids)) of a dispatch, one sample
        of each pixel id. Escalated lanes are skipped, then folded with
        their exact radiance from `fixed` (_render_escalated)."""
        sl = slice(lo, lo + pixel_ids.size)
        esc = None if esc is None else esc[sl]
        irr = None if irr is None else irr[sl]
        if pixel_ids.size and np.all(np.diff(pixel_ids) == 1):
            device_accum.accumulate_contig(self._accum, int(pixel_ids[0]),
                                           radiance[sl], skip=esc, irr=irr)
        else:
            device_accum.accumulate_round(
                self._accum, torch.as_tensor(pixel_ids, device=self.device),
                radiance[sl], skip=esc, irr=irr)
        if fixed is not None:
            self._accumulate_escalated(pixel_ids, lo, fixed)

    def _render_escalated(self, ids, sids, esc):
        """Render a dispatch's gather-escalated lanes again, all in one call,
        on the wavefront engine, whose gather applies the reference's
        radius cap exactly (EstimateIrradiance<100>); the same key words
        give the same paths. Returns (lane indices, their radiance), or
        None where no lane escalated."""
        if esc is None:
            return None
        lanes = np.nonzero(esc.cpu().numpy())[0]
        if lanes.size == 0:
            return None
        from qaray_tpu_torch.integrators.engine import render_batch_wavefront

        px, py, sid = self._lanes(ids[lanes], sids[lanes])
        radiance, _ = render_batch_wavefront(
            self.scene_arrays, self.meta, self.integrator_config(), px, py,
            sid, self._words, self.photon_maps)
        return lanes, radiance

    def _accumulate_escalated(self, pixel_ids, lo: int, fixed):
        """Fold the exact radiance of the escalated lanes among [lo, lo +
        len(pixel_ids)): the main fold skipped them, so each pixel still
        gets exactly one sample, in sample order."""
        lanes, radiance = fixed
        sel = np.nonzero((lanes >= lo) & (lanes < lo + pixel_ids.size))[0]
        if sel.size:
            device_accum.accumulate_round(
                self._accum,
                torch.as_tensor(pixel_ids[lanes[sel] - lo],
                                device=self.device),
                radiance[torch.as_tensor(sel, device=self.device)])

    def _report(self, spp_done: int):
        if self._progress_cb is not None:
            self._progress_cb(spp_done, self.param.spp_max)
        pe = self.param.progressive_every
        if pe and spp_done % pe == 0 and spp_done < self.param.spp_max:
            snapshot = copy.deepcopy(self.sync_fb())
            snapshot.finalize(self.param.use_srgb, self.param.spp_max)
            snapshot.save_image(f"{self.param.progressive_prefix}"
                                f"colorBuffer_{spp_done:04d}spp.png")
