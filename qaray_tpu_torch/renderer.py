"""Renderer: the adaptive-supersampling loop over sample rounds.

Counterpart of qaray_tpu/renderer.py. All active pixels
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

Dispatches run one deep, as in the JAX package (_render_round,
_retire_inflight): a dispatch and its fold are enqueued before the
previous one is retired, and the fold reads nothing on the host. Retiring
reads the dispatch's skipped-lane counts (copied to pinned memory behind
an event when it was enqueued), and, only where lanes escalated, their
plane; the first round's depth plane comes the same way. Lane ids are
built on the device. Escalated lanes fold where the JAX Renderer folds
them: after the next chunk's main fold, and in a packed dispatch after all
of its samples' main folds.

As in the JAX Renderer every dispatch, the escalated lanes' one included,
is padded to a power-of-two bucket of at least 256 lanes (_pad_to_bucket),
the extra lanes rendering the dump row W * H of the accumulator, which no
image reads: render_batch and the folds replay one captured graph a bucket
(utils/compiled.py) instead of one a lane count.

checkpoint_every saves the framebuffer state every so many samples of
phase 1 (FrameBuffer.save_state, the JAX package's npz fields), and
load_checkpoint resumes from its smallest count.

With num_devices > 1 (or a mesh given) each dispatch is sharded over a
device mesh (parallel/mesh.py): the scene and the maps are replicated
once at compute_scene, every shard renders on its device and the outputs
come back in lane order to every process, which folds the whole dispatch
as one device does; the escalated lanes render again on each process's
own device, unsharded. Across processes (parallel/distributed.py) every
rank issues the same dispatches, and so the same collectives, in the same
order. rank_debug counts the lanes this process's devices rendered, for
save_rank_debug's planes.

The Renderer's parts are program spans (utils/timing.span): `render`
(the whole image, its id the render count and the seed) holds
render.start (key words, the accumulator, the id tensors), render.dispatch
and render.fold at each call of _dispatch and of the folds, render.retire
(_retire_inflight: the reads, render.escalate around the escalated lanes'
re-render, their folds), render.converge (the convergence read) and
render.end (the last retire, the accumulator's copy to the host and
finalize). The spans open at the call sites, around the functions they
name; render.escalate's calls count the escalated re-renders. `stats`
counts their lanes and the lanes their buckets padded them to.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from qaray_tpu_torch.core.constants import SPP_THRESHOLD
from qaray_tpu_torch.core.rng import key_words
from qaray_tpu_torch.fb import device_accum
from qaray_tpu_torch.fb.framebuffer import FrameBuffer
from qaray_tpu_torch.integrators.engine import IntegratorConfig, render_batch
from qaray_tpu_torch.scene.compiler import compile_scene
from qaray_tpu_torch.utils.timing import span

# Escalated re-renders (_render_escalated) in this process: the escalated
# lanes and the lanes of their power-of-two buckets.
stats = {"escalated_lanes": 0, "escalated_padded": 0}


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
    num_devices: int = 0  # 0/1 = single device; >1 = shard over a mesh
    progressive_every: int = 0  # save colorBuffer every N spp (0 = off)
    progressive_prefix: str = ""
    # -rank-debug: count the lanes this process's shards render (the
    # per-rank debug PNGs of Renderer_MPI.cpp:134-138).
    rank_debug: bool = False
    checkpoint_every: int = 0
    checkpoint_path: str = "render_checkpoint.npz"


def _pad_to_bucket(n: int, minimum: int = 256) -> int:
    """n rounded up to a power of two of at least `minimum` (the JAX
    Renderer's bucket, qaray_tpu/renderer.py:71)."""
    b = minimum
    while b < n:
        b <<= 1
    return b


class Renderer:
    def __init__(self, param: Optional[RendererParam] = None,
                 device="cuda", mesh=None):
        """device: where the accumulator lives and the unsharded work runs.
        mesh: a parallel.mesh.RenderMesh to shard over; without one,
        num_devices > 1 takes the first num_devices of the devices of
        device's kind (parallel.mesh.default_devices: on one card a mesh of
        that card, as jax.devices()[:n] gives one chip)."""
        self.param = param or RendererParam()
        self.device = torch.device(device)
        self._mesh = mesh
        self._render_fn = render_batch
        if mesh is None and self.param.num_devices > 1:
            from qaray_tpu_torch.parallel.mesh import (
                default_devices,
                make_render_mesh,
            )

            self._mesh = make_render_mesh(
                default_devices(self.device.type)[:self.param.num_devices])
        if self._mesh is not None:
            from qaray_tpu_torch.parallel.mesh import shard_render_batch

            self._render_fn = shard_render_batch(self._mesh)
        self._rank_mask = None
        self._replicas = {}
        self.stop_flag = False
        self.scene_arrays = None
        self.meta = None
        self.fb: Optional[FrameBuffer] = None
        self.photon_maps = None
        self._progress_cb: Optional[Callable] = None
        self._accum = None
        self._inflight = None
        self._renders = 0
        # The one-deep pipeline; False keeps the synchronous loop, which
        # reads each dispatch before the next is enqueued (tests and
        # chip_smoke.py compare the two).
        self._pipelined = True

    def compute_scene(self, scene_desc, world_bvh: bool = True):
        """Compile the scene (world_bvh=False keeps meshes per instance in
        object space) and build its photon maps where asked."""
        self.scene_arrays, self.meta = compile_scene(
            scene_desc, device=self.device, world_bvh=world_bvh)
        self.fb = FrameBuffer(self.meta.img_width, self.meta.img_height)
        if self.param.use_photon_map:
            from qaray_tpu_torch.photon.build import (
                build_photon_maps,
                save_photon_map,
            )
            from qaray_tpu_torch.photon.cluster import cluster_photon_map

            with span("photon.build"):
                gmap, cmap = build_photon_maps(self.scene_arrays, self.meta,
                                               self.param)
                # Morton-clustered tables for the gather kernels (K1d, K5);
                # the exact gathers of the wavefront engine ignore them.
                self.photon_maps = (cluster_photon_map(gmap),
                                    cluster_photon_map(cmap))
            # The reference dumps both maps for its viewer
            # (renderer.cpp:204-209, 284-289): same files, same records.
            # Across processes the primary writes them.
            from qaray_tpu_torch.parallel.distributed import is_primary

            if is_primary():
                save_photon_map(self.photon_maps[0], "photonmap.dat")
                save_photon_map(self.photon_maps[1], "caustics.dat")
        # Replicate the scene and the maps over the mesh once (every MPI
        # rank loads the whole scene, Renderer_MPI.cpp:54); the escalated
        # lanes keep using this device's copy.
        self._on_mesh("scene", self.scene_arrays)
        self._on_mesh("maps", self.photon_maps)
        return self.scene_arrays, self.meta

    def _on_mesh(self, name, tree):
        """tree, or with a mesh its replicas over the mesh, made once for
        each tree assigned (parallel.mesh.device_put_replicated)."""
        if self._mesh is None or tree is None:
            return tree
        src, rep = self._replicas.get(name, (None, None))
        if src is not tree:
            from qaray_tpu_torch.parallel.mesh import device_put_replicated

            rep = device_put_replicated(tree, self._mesh)
            self._replicas[name] = (tree, rep)
        return rep

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
        self._renders += 1
        with span("render", id=f"render {self._renders} seed "
                  f"{self.param.seed}"):
            return self._render()

    def _render(self) -> FrameBuffer:
        p = self.param
        cfg = self.integrator_config()
        fb = self.fb
        num_pixels = self.meta.img_width * self.meta.img_height
        with span("render.start"):
            words = key_words(p.rng_impl, p.seed)
            self._words = words
            # Megakernel dispatches with photon gathering return a last
            # escalation flag per lane (the gather saw > GATHER_K photons
            # in the radius): those lanes are rendered again on the exact
            # engine.
            from qaray_tpu_torch.integrators.engine import use_pathtrace_mega

            self._mega_photon = bool(cfg.use_photon_map and use_pathtrace_mega(
                self.meta, cfg, self.photon_maps))
            self._accum = device_accum.init_state(fb, self.device,
                                                  want_irr=self._want_aux(),
                                                  into=self._accum)
            self._rank_mask = (
                torch.zeros(num_pixels, dtype=torch.int32, device=self.device)
                if p.rank_debug and self._mesh is not None else None)
            self._inflight = None
            all_ids = np.arange(num_pixels, dtype=np.int32)
            all_dev = torch.arange(num_pixels, dtype=torch.int32,
                                   device=self.device)

        # Phase 1: spp_min samples for every pixel, several sample indices
        # per dispatch when the image alone underfills the batch. A resumed
        # render (load_checkpoint) continues from the smallest count.
        s = int(fb.count.min())
        batch = self._effective_batch()
        pack = max(1, batch // max(num_pixels, 1))
        while s < p.spp_min:
            if self.stop_flag:
                return self.sync_fb()
            if num_pixels <= batch:
                k = min(pack, p.spp_min - s)
                self._render_packed(cfg, all_ids, all_dev,
                                    list(range(s, s + k)), words,
                                    record_depth=(s == 0))
            else:
                k = 1
                self._render_round(cfg, all_ids, all_dev, s, words,
                                   record_depth=(s == 0))
            s += k
            self._report(s)
            self._maybe_checkpoint(s)

        # Phase 2: adaptive refinement of the unconverged pixels. The
        # convergence mask needs the pipeline retired.
        s = p.spp_min
        while s < p.spp_max:
            self._flush()
            with span("render.converge"):
                active, active_dev = device_accum.unconverged_ids(
                    self._accum, p.threshold, s, on_device=True)
            if active.size == 0 or self.stop_flag:
                break
            for _ in range(min(p.round_spp, p.spp_max - s)):
                self._render_round(cfg, active, active_dev, s, words,
                                   record_depth=False)
                s += 1
            self._report(s)

        with span("render.end"):
            self.sync_fb()
            fb.finalize(p.use_srgb, p.spp_max)
        return fb

    def sync_fb(self):
        """Retire the in-flight dispatch and mirror the device accumulator
        into the host FrameBuffer."""
        self._flush()
        if self._accum is not None:
            device_accum.sync_to_fb(self._accum, self.fb)
        return self.fb

    def load_checkpoint(self, path: str):
        """Resume a render from a saved framebuffer state (FrameBuffer.
        save_state's npz; the JAX package's checkpoints load too)."""
        self.fb = FrameBuffer.load_state(path)
        assert (self.fb.width, self.fb.height) == (
            self.meta.img_width, self.meta.img_height,
        ), "checkpoint resolution mismatch"

    def _maybe_checkpoint(self, spp_done: int):
        ce = self.param.checkpoint_every
        if ce and spp_done % ce == 0:
            self.sync_fb()
            self.fb.save_state(self.param.checkpoint_path)

    def _padded(self, lanes, sid):
        """Device pixel and sample ids padded to their bucket with dump
        lanes (pixel W * H), as the JAX Renderer pads them: sid a tensor
        gets sample 0 on the dump lanes, an int is every lane's sample."""
        n = lanes.shape[0]
        pad = _pad_to_bucket(n) - n
        if pad:
            dump = self.meta.img_width * self.meta.img_height
            lanes = torch.cat([lanes, lanes.new_full((pad,), dump)])
        if isinstance(sid, int):
            return lanes, torch.full(lanes.shape, sid, dtype=torch.int32,
                                     device=lanes.device)
        return lanes, (torch.cat([sid, sid.new_zeros(pad)]) if pad else sid)

    def _dispatch(self, cfg, lanes, sid, words):
        """render_batch (sharded over the mesh, where there is one) with
        this render's maps on the lanes padded to their bucket (_padded):
        (radiance, depth, irr or None, esc or None, the padded lanes and
        sample ids), every output padded."""
        lanes, sid = self._padded(lanes, sid)
        if self._rank_mask is not None:
            self._mark_ownership(lanes)
        w = self.meta.img_width
        out = self._render_fn(self._on_mesh("scene", self.scene_arrays),
                              self.meta, cfg, lanes % w, lanes // w, sid,
                              words, self._on_mesh("maps", self.photon_maps),
                              want_aux=self._want_aux())
        irr = out[2] if self._want_aux() else None
        esc = out[-1] if self._mega_photon else None
        return out[0], out[1], irr, esc, lanes, sid

    def _mark_ownership(self, lanes):
        """-rank-debug: count, per pixel, the lanes of this dispatch that
        this process's devices render (the per-rank ownership of
        Renderer_MPI's static round-robin, Renderer_MPI.cpp:134-138). A
        dump lane (pixel W * H) adds 0 to the last pixel: no host read
        picks them out."""
        from qaray_tpu_torch.parallel.mesh import shard_bounds

        cuts = shard_bounds(lanes.shape[0], self._mesh.size)
        last = self._rank_mask.shape[0] - 1
        for i in self._mesh.local:
            mine = lanes[cuts[i]:cuts[i + 1]].long()
            self._rank_mask.index_add_(0, mine.clamp_max(last),
                                       (mine <= last).to(torch.int32))

    def save_rank_debug(self, prefix: str, rank: int):
        """Write this process's ownership and spp planes
        (Renderer_MPI.cpp:134-138's per-rank PNGs): rank{r}_maskBuffer.png
        holds the samples of each pixel that this process rendered (the
        ranks' planes sum to the pixel's spp), rank{r}_sampleBuffer.png
        the sample-count plane where it rendered any."""
        if self._rank_mask is None:
            return
        fb = self.fb
        mask = self._rank_mask.cpu().numpy()
        fb.save_png(f"{prefix}rank{rank}_maskBuffer.png",
                    np.clip(mask, 0, 255).astype(np.uint8))
        spp = getattr(fb, "sample_count_u8", None)
        if spp is None:
            fb.finalize(self.param.use_srgb, self.param.spp_max)
            spp = fb.sample_count_u8
        fb.save_png(f"{prefix}rank{rank}_sampleBuffer.png",
                    np.where(mask > 0, spp, 0).astype(np.uint8))

    def _fold_main(self, pixel_ids, dev_ids, lo, radiance, esc, irr):
        """Fold lanes [lo, lo + len(pixel_ids)) of a dispatch, one sample
        of each pixel id, skipping the escalated lanes; returns their count
        as a device tensor (None without escalation flags). Contiguous ids
        take the slice update, as in the JAX package."""
        sl = slice(lo, lo + pixel_ids.size)
        esc = None if esc is None else esc[sl]
        irr = None if irr is None else irr[sl]
        with span("render.fold"):
            if _is_contig(pixel_ids):
                return device_accum.accumulate_contig(
                    self._accum, int(pixel_ids[0]), radiance[sl], skip=esc,
                    irr=irr)
            return device_accum.accumulate_round(
                self._accum, dev_ids, radiance[sl], skip=esc, irr=irr)

    def _render_packed(self, cfg, pixel_ids, dev_ids, sample_indices, words,
                       record_depth: bool):
        """len(sample_indices) samples per pixel in one dispatch, folded in
        sample order (the recurrence is order-sensitive; the order matches
        the reference loop), then their escalated lanes in sample order, as
        the JAX package's _render_packed folds them: the previous dispatch
        is retired after this one is enqueued and before its folds."""
        n = pixel_ids.size
        k = len(sample_indices)
        sid = (torch.arange(k, dtype=torch.int32, device=self.device)
               .repeat_interleave(n) + sample_indices[0])
        lanes = dev_ids.repeat(k)
        with span("render.dispatch"):
            radiance, depth, irr, esc, _, _ = self._dispatch(cfg, lanes, sid,
                                                             words)
        self._retire_inflight()
        job = _Dispatch(pixel_ids, lanes, sid,
                        None if esc is None else esc[:n * k], n)
        job.skips = [self._fold_main(pixel_ids, dev_ids, j * n, radiance,
                                     esc, irr) for j in range(k)]
        self._stage(job, depth if record_depth else None)

    def _render_round(self, cfg, pixel_ids, dev_ids, sample_idx: int, words,
                      record_depth: bool):
        """One sample for each pixel id, chunked to the batch size. Each
        chunk is dispatched and folded before the previous one is retired,
        as the JAX package's _render_round pipelines them: a chunk's
        escalated lanes fold after the next chunk's main fold."""
        chunk = self._effective_batch()
        for lo in range(0, pixel_ids.size, chunk):
            ids = pixel_ids[lo:lo + chunk]
            n = ids.size
            lanes = dev_ids[lo:lo + chunk]
            with span("render.dispatch"):
                radiance, depth, irr, esc, padded, sid = self._dispatch(
                    cfg, lanes, sample_idx, words)
            job = _Dispatch(ids, lanes, sid[:n],
                            None if esc is None else esc[:n], n)
            if _is_contig(ids):
                skip = self._fold_main(ids, lanes, 0, radiance, esc, irr)
            else:
                # The padded dispatch folds whole, its dump lanes into the
                # dump row, as the JAX Renderer folds phase 2.
                with span("render.fold"):
                    skip = device_accum.accumulate_round(
                        self._accum, padded, radiance, skip=esc, irr=irr)
            job.skips = [skip]
            self._retire_inflight()
            self._stage(job, depth if record_depth else None)

    def _stage(self, job, depth):
        """Make `job` the dispatch in flight (the previous one retired),
        with what its retire reads (the skipped-lane counts, the first
        round's depth) already on its way to the host: on the card, copies
        into pinned memory behind an event, so that the read waits for this
        dispatch and not for the next one. The synchronous loop (_pipelined
        False) reads it at once, before the next dispatch."""
        if job.esc is not None:
            job.counts = torch.stack(job.skips)
        if depth is not None:
            job.depth = depth[:job.n]
        if self.device.type == "cuda":
            for name in ("counts", "depth"):
                src = getattr(job, name)
                if src is not None:
                    dst = torch.empty(src.shape, dtype=src.dtype,
                                      pin_memory=True)
                    setattr(job, name, dst.copy_(src, non_blocking=True))
            job.event = torch.cuda.Event()
            job.event.record()
        self._inflight = job
        if not self._pipelined:
            self._read(job)

    def _read(self, job):
        """The host reads of a dispatch: its skipped-lane counts, and where
        any lane escalated the escalated lanes' exact radiance, rendered on
        the wavefront engine, whose gather applies the reference's radius
        cap (EstimateIrradiance<100>; the same key words give the same
        paths)."""
        if job.done_reading:
            return
        job.done_reading = True
        if job.event is not None:
            job.event.synchronize()
        if job.counts is not None and int(job.counts.sum()):
            with span("render.escalate"):
                job.fixed = self._render_escalated(job.lanes, job.sid,
                                                   job.esc)

    def _render_escalated(self, lanes, sid, esc):
        """Render a dispatch's escalated lanes again, all in one call, on
        the wavefront engine (lanes, sid: the dispatch's device pixel and
        sample ids). Returns (escalated lane indices as numpy, their
        radiance, the same indices on the device), or None where no lane
        escalated."""
        idx = torch.nonzero(esc).squeeze(1)
        if idx.numel() == 0:
            return None
        from qaray_tpu_torch.integrators.engine import render_batch_wavefront

        w = self.meta.img_width
        ids, esid = self._padded(lanes[idx], sid[idx])
        stats["escalated_lanes"] += idx.numel()
        stats["escalated_padded"] += ids.shape[0]
        radiance, _ = render_batch_wavefront(
            self.scene_arrays, self.meta, self.integrator_config(), ids % w,
            ids // w, esid, self._words, self.photon_maps)
        return idx.cpu().numpy(), radiance, idx, ids

    def _retire_inflight(self):
        """Retire the in-flight dispatch: its reads (_read), then the fold
        of its escalated lanes with their exact radiance, segment by
        segment in sample order (the main fold skipped them, so each pixel
        still gets exactly one sample), and the depth plane on the first
        round."""
        job, self._inflight = self._inflight, None
        if job is None:
            return
        with span("render.retire"):
            self._retire(job)

    def _retire(self, job):
        self._read(job)
        if job.depth is not None:
            self.fb.set_depth(job.pixel_ids, job.depth.cpu().numpy())
        if job.fixed is None:
            return
        lanes, radiance, idx, padded = job.fixed
        cuts = np.searchsorted(lanes, np.arange(0, job.lanes.shape[0] + 1,
                                                job.n))
        segments = [(a, b) for a, b in zip(cuts[:-1], cuts[1:]) if b > a]
        if len(segments) == 1:
            # One segment: the padded render folds whole.
            with span("render.fold"):
                device_accum.accumulate_round(self._accum, padded, radiance)
            return
        ids = job.lanes[idx]
        dump = self.meta.img_width * self.meta.img_height
        for a, b in segments:
            pad = _pad_to_bucket(b - a) - (b - a)
            with span("render.fold"):
                device_accum.accumulate_round(
                    self._accum,
                    torch.cat([ids[a:b], ids.new_full((pad,), dump)]),
                    torch.cat([radiance[a:b], radiance.new_zeros((pad, 3))]))

    _flush = _retire_inflight

    def _report(self, spp_done: int):
        if self._progress_cb is not None:
            # The accumulator at a round boundary: observers that read
            # pixels call sync_fb.
            self._flush()
            self._progress_cb(spp_done, self.param.spp_max)
        pe = self.param.progressive_every
        if pe and spp_done % pe == 0 and spp_done < self.param.spp_max:
            snapshot = copy.deepcopy(self.sync_fb())
            snapshot.finalize(self.param.use_srgb, self.param.spp_max)
            snapshot.save_image(f"{self.param.progressive_prefix}"
                                f"colorBuffer_{spp_done:04d}spp.png")


def _is_contig(ids) -> bool:
    """Consecutive ascending pixel ids (phase-1 chunks)."""
    return ids.size > 0 and bool(np.all(np.diff(ids) == 1))


class _Dispatch:
    """A dispatch in flight: its host pixel ids (one segment of n lanes per
    sample), its device lane ids, sample ids and escalation flags, the
    device counts of skipped lanes of each segment's main fold (and their
    host copy), the first round's depth, the event behind those copies,
    and, once read, the escalated lanes' exact radiance."""

    def __init__(self, pixel_ids, lanes, sid, esc, n):
        self.pixel_ids = pixel_ids
        self.lanes = lanes
        self.sid = sid
        self.esc = esc
        self.n = n
        self.skips = None
        self.counts = None
        self.depth = None
        self.event = None
        self.done_reading = False
        self.fixed = None
