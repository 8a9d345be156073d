"""Smoke test of the PyTorch/CUDA port (qaray_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build every kernel from csrc/ (one nvcc per source, in parallel), and
     the native host library (qaray_tpu_torch/native.py: g++);
  2. kernels against their plain versions:
       a. K2a, K2b, K2c on 1M random rays against the primitives of
          tests/assets/softdof_scene.xml (tests/test_pallas.py bars); K2b
          without the uv equal to K2b with it but for uvw, which is 0; and
          K2a, K2b (with and without the uv) and K2c on the same rays as
          views at a 4-byte offset and on their first 1, 31, 65,537 and
          1,000,001 (aligned and offset) equal to each on all of them, bit
          for bit;
       b. K3's walk (ico5, 20,480 triangles) equal to stream_closest in
          (t, row, row2) on every ray of 1M random rays, of the same rays
          with t_cur a tenth of their budget (runner-ups beyond t_cur), of
          262,144 rays aimed exactly at ico5's vertices (exact ties in t)
          and of the 480,000 camera rays of tests/assets/mesh_scene.xml at
          800x600, and its any hit equal to stream_any_hit; K4a/K4b (ico6,
          81,920 triangles) against tiled_sweep, and the two-phase K4a walk
          against the single-phase one, on the random and camera rays (and
          the camera rays' shadow rays for K4b), with the
          tests/test_pallas_tiles.py bars and K4a's
          runner-up, exact below t_cur, equal to tiled_sweep's on > 99 % of
          the rays where that has one; K4a under a cap of 12 clusters a ray
          against the uncapped walk on the rays it marks resolved; and
          262,144 rays aimed at ico4's vertices through K4a and
          ops/trace._fallback against tiled_sweep and the same fallback:
          equal (t, gid) but for exact ties in t, no hole; ico6's native
          BVH equal to the numpy build node for node, and ico6's compile
          seconds with each builder;
       c. K5 against photon_gather_plain on caustics_scene (softdof with its
          middle sphere made glass, scene.procedural.with_glass) at
          800x600 with the default maps (10,000 global photons at r 0.2,
          1,000 caustics photons at r 1.0; every map build in a temporary
          working directory): the 480,000 global-map records of one
          photon-mapped megakernel dispatch, Morton-sorted as gather_apply
          sorts them, and the same at radius 50 where counts exceed 100
          (sums within 1e-5 relative, 1e-7 absolute; counts exact; the share
          of bit-equal lanes printed), and K5 launched as gather_apply
          launches it (a warp to each of the leading queries with a
          record, their count in device memory) equal to the launch that
          reads every query's flag, bit for bit;
       d. K1c's own mesh functions (the megakernel's tree walk, run on
          given rays by qr_mega_mesh_probe) against the in-order fold over
          the same rows (megakernel.mesh_probe_plain) on ico5: 2^20 rays,
          half random around the icosphere, half aimed exactly at its
          vertices, a third with an analytic t equal to their mesh hit's
          and a third with a budget equal to it: (t, normal, front,
          material row, occluded) equal on every ray;
       e. W1 (csrc/bvh.cu, the packed BVH walk) against its plain walk,
          closest hit (t, instance, triangle, bary, front) and any hit
          (a seventh of the rays already occluded), bit for bit: on
          mesh_scene's icosphere and on ico5 as world trees (1M random
          rays, ico5's 262,144 vertex-aimed rays, 480,000 camera rays),
          with the lanes where W1 and the dense sweep resolve an exact tie
          in t to different triangles counted, on grid_scene's 25
          transformed instances (its 480,000 camera rays and 1M random
          rays) and on 300 transformed instances of mesh_scene's
          icosphere, one mirrored (scene.procedural.scatter_instances:
          more than one of the chunks of instances a block of W1 stages;
          16,384 rays around them, as the plain loop walks 300 instances
          in groups); under QARAY_MESH_PATH=bvh, ops/trace's
          world-mesh closest hit is one W1 launch;
  3. the megakernel against the wavefront engine, with the
     tests/test_megakernel.py bars:
       a. K1a: softdof_scene.xml at 200x150, 2 samples per pixel,
          max_bounce 4, threefry keys, for pathtrace and photonmap;
       b. K1a at the main path's shapes at 800x600, max_bounce 5, where the
          fold datum rid * 65536 + sid wraps past 2^31: the Renderer's first
          packed photonmap dispatch (960,000 lanes, rbg key words), the
          pathtrace render_batch of phase 4a (480,000 lanes, rbg) and a
          phase-2 photonmap round (480,000 lanes, sample 5, threefry);
       c. K1c: mesh_scene.xml (320 triangles), its ico5 (20,480) and
          mirror_scene.xml (a mirrored icosphere alone) at 200x150 x 2 spp,
          threefry, max_bounce 3, pathtrace and photonmap (the
          test_mega_parity_mesh and test_mega_streamed_mesh_parity bars),
          and the first two at 800x600 with the Renderer's photonmap
          settings and rbg words;
       d. K1b: texture_scene.xml (checkers on the floor and the ball) at
          200x150 x 2 spp, threefry, pathtrace and photonmap, a variant
          with a second live slot (specular) under a rotated and translated
          map, and texture_scene at 800x600 with the Renderer's photonmap
          settings and rbg words (the test_mega_checker_textures_parity
          bars: under 5e-3 of lanes above 1e-3 relative, channel means
          within 2e-3);
       e. K1a+K1d: caustics_scene with the default maps against the
          wavefront engine with its exact gathers, at 200x150 x 2 spp
          (threefry) and at 800x600 (threefry and rbg words), with the
          test_mega_photon_gather_parity bars on lanes that are not
          escalated (its share of lanes off cut from 1 % to 1e-4, and a
          control run with the caustics map emptied that must be off on
          ten times that share), and at 200x150 with both radii at 50 those of
          test_mega_photon_escalation_flags_dense_lanes (over 0.3 of lanes
          flagged, no unflagged lane off); escalated shares printed;
       f. K6 (the fused adjoint) against adjoint_render_plain at 200x150,
          max_bounce 5, threefry, on spot_scene.xml, mesh_scene.xml and the
          glass scene (softdof with its depth of field 0 and its middle
          sphere glass), each field within 3e-2 of its max|b|
          (tests/test_grad.py's bar), the errors printed, and a second
          launch equal to the first, bit for bit; and render_batch's
          gradients on the megakernel route (K1a forward, the engine's
          autograd backward) against render_with_params';
       g. G1 (the material gather's backward, csrc/mtl_gather.cu) on the
          inputs of every backward call of the inverse benchmark cell's
          step (softdof 800x600 x 1 spp, 480,000 lanes, pathtrace,
          max_bounce 5): within 1e-6 of each row's sum of |g| of a
          float64 sum, and of index_put_ within index_put_'s own gap to
          that sum plus 1e-6; twice the same bits; the step
          captured equal to eager bit for bit (loss and every field), one
          G1 launch for each gather on the tape; G1's ms at those shapes,
          its bound, the plain version's and the autograd backward's it
          replaces. Alone: python3 -c "import chip_smoke as c;
          c.g1_phase({})";
       h. H1 (the wavefront engine's threefry cipher, csrc/threefry.cu) at
          the inverse cell's soft-shadow draws, 480,000 lanes x 256, and a
          fold of 480,000 keys: equal to core/krng.py's int64 cipher bit
          for bit (max_abs_err), one launch each; its ms, the bound by
          integer operations and by bytes, the int64 cipher's ms, the
          kernels' SASS instructions, funnel shifts and opcodes; H1's
          launches, folds and draws in one eager step of the inverse cell
          with the int64 cipher refused on CUDA tensors. Alone:
          python3 -c "import chip_smoke as c; c.h1_phase({})";
  4. the main path at 800x600 with every launch count set to 0 before each
     route and read after it, and every plain version of a kernel made to
     raise if it is called (core/krng.py's int64 cipher where it is handed
     a CUDA tensor); H1 launched on every route with lanes on the
     wavefront engine, by the photon tracing of k and on the autograd
     routes of m and t, and its launches a timed step of m printed;
     K2b's and K2c's launches recorded by size, and
     the rays of K2b's first two launches (a batch's bounces 0 and 1) at
     its largest size and at 65,536 kept for phase 5:
       a. Renderer defaults (photonmap, spp 4..8, max_bounce 5, shadows
          16->64, rbg) on softdof writing its PNGs, then render_batch with
          pathtrace on 480,000 lanes: K1a only, no lane on the wavefront
          engine;
       b. the wavefront route render_batch takes for scenes the megakernel
          does not serve (forced with QARAY_NO_MEGAKERNEL, 65,536-pixel
          batches): K2b and K2c;
       c. Renderer defaults on mesh_scene.xml: K1a with K1c's mesh sweep;
       d. the same with the ico5 icosphere: K1a/K1c;
       e. the same with the ico6 icosphere, 1 spp: above 65,536 triangles
          the wavefront route, K4a (two-phase walk) and K4b with K2b/K2c;
       f. mesh_scene.xml under QARAY_NO_MEGAKERNEL, 1 spp: K3's walk with
          K2b/K2c;
       g. Renderer defaults on texture_scene.xml: K1a with K1b's checker
          textures, no lane on the wavefront engine;
       h. texture_scene.xml under QARAY_NO_MEGAKERNEL, 1 spp: the wavefront
          route with the texture stack (K2b's uv, K2c, ops/texture.py);
       i. spot_scene.xml with tests/assets/colorBuffer.png bound in code
          to a material, the background and the environment, 1 spp: the
          wavefront route, and the same scene at 200x150 against the same
          render on the CPU;
       j. the basic, phong and mcgi integrators on spot_scene.xml, 1 spp:
          the wavefront route (K2b/K2c);
       k. Renderer defaults with -use-photon-map on caustics_scene in a
          temporary working directory: K1a+K1d with K5 on the records, the
          escalated lanes (and only those) on the wavefront engine; map
          build times and photon counts, the escalated share;
       l. the same scene at 1 spp under QARAY_NO_MEGAKERNEL: the exact
          gathers on the wavefront route;
       m. the gradient path: diff.render_value_and_grad at bench.py's
          gradient shapes (max_bounce 5, shadow_spp 16, rbg words) on
          spot_scene.xml at 800x600 with 262,144 lanes and mesh_scene.xml
          with 131,072, by the fast route (K1a forward, one K6 launch) and
          by autograd (QARAY_NO_MEGAKERNEL: K2b/K2c, K3 on the mesh, and
          their backward), both routes' steps captured on their first
          step and replayed after it, the two routes' gradients within
          3e-2 of each field's max|b|; forward+backward paths/s and the
          device's idle share printed;
       n. mesh_scene and ico5 at 1 spp under QARAY_NO_MEGAKERNEL and
          QARAY_MESH_PATH=bvh: the world tree on W1, no K3;
       o. grid_scene (25 instances of a 320-triangle mesh) with the
          defaults, world route (K1a/K1c) against world_bvh=False (the
          wavefront engine with W1): under 0.5 % of pixels differing by
          more than 2/255; W1's launches by kind and rays;
       p. a 5x5 grid of ico5 instances (procedural.with_shared_mesh) at
          1 spp: 20,480 triangles kept once (W1) against 512,000 baked
          (K4a/K4b): compile seconds, wall, device busy, idle share and
          peak memory of each;
       q. checkpoints: softdof with the defaults under threefry keys and
          checkpoint_every 2, stopped after its checkpoint at 2 samples
          and resumed from the file by a new Renderer, equal to the
          uninterrupted render bit for bit;
       r. sharded rendering on one card (parallel/mesh.py):
          Renderer(num_devices=2), a one-device mesh as in JAX, on softdof
          with the defaults, its planes equal to 4a's bit for bit;
          render_batch over the mesh [cuda:0, cuda:0] on 4a's 480,000
          lanes under rbg and threefry words, every output equal to one
          render_batch's; 4k's photon-mapped caustics_scene over that mesh,
          counts equal to 4k's and mean within 1e-5; the Renderer and
          render_batch unsharded and sharded in turns, and the gather's
          share of a sharded dispatch;
       s. two processes of the CLI (-multihost -coordinator localhost:P,2,r
          -rank-debug; gloo, both on cuda:0) on softdof 800x600 x 2 spp,
          with the kernels phase 1 built: the primary's colorBuffer.png
          equal to a one-process render's bit for bit, no colour buffer
          from rank 1, the ranks' mask planes summing to the spp, each
          rank's output naming the card; render and process walls and the
          host seconds blocked in all_gather;
       t. the sharded gradient: render_value_and_grad over [cuda:0, cuda:0]
          on 4m's spot_scene lanes (262,144), fast route (K1a and K6 once a
          shard) and autograd, every field within 1e-5 of 1 + max|b| of
          the unsharded gradient;
       u. the CLI with -profile on softdof 200x150: the trace names K1a's
          kernel (mega_kernel), and the CLI prints "Elapsed Time is";
       v. the preview server (viz/serve.py) on spot_scene 200x150 x 2 spp,
          port 0: /status reaches spp 2, /image.png and /depth.png are
          PNGs, /orbit?dyaw=30 renders a different image, and three
          /orbit frames (each a new scene compile) capture no graph;
       w. captured execution (utils/compiled.py, render_batch, the folds,
          both gradient routes' steps and the photon batch under CUDA
          graphs, which every phase from 4a on runs) against the eager one
          (compiled.eager()), bit for bit, in a process of its own
          (tools/capture_turns.py, whose profiler has seen no graphs of
          the phases before): the Renderer on 4a, 4b, 4e, 4k and 4o in
          turns (eager, captured, captured, eager) under the profiler,
          later renders capturing nothing; render_batch on both routes and
          a fold replayed under torch.cuda.set_sync_debug_mode("error");
          4m's fast route over 3 steps with changing parameters, captured
          on the first only; 4m's autograd step on spot_scene (262,144
          lanes) and mesh_scene (131,072) in turns, its loss bit for bit,
          every gradient field within the eager turns' spread, its
          launches those of eager, a replay under sync debug "error", its
          peak memory, and the operators and kernels that take the eager
          step's device time; a photon map build; captures, their seconds,
          graphs and peak memory. A first render of a scene in 4a-4v
          includes its captures; phases 2 and 3 run the plain versions
          eagerly (QARAY_EAGER);
  5. each kernel's time at the path's shapes beside its bound, its launches
     on the main path and its plain version's time, and the device's idle
     share in one Renderer.render() of 4a, 4c, 4d, 4g and 4e (4k's and
     4o's come from 4w); K6's at the gradient path's shape of 4m. W1 at
     4o's largest closest-hit and any-hit launches, 4p's largest
     closest-hit launch (ico5's deep tree an instance) and on ico5's
     camera rays (its world tree), each with its bound from its work
     counters (inner nodes, triangle tests, the rays' moves into instance
     space), those counters a ray and a warp's slowest lane against the
     mean, and both instantiations' registers, spills, stack frame, shared
     memory and blocks an SM. The device's idle share eager against
     captured in 4w's turns, and the host's time of one render of 4a and
     4b in each mode (4w's process: the Renderer's program spans, the
     functions that hold it under cProfile). Every profiled session
     follows a short one that takes the device records the profiler loses
     after CUDA graphs are made (flush_profiler); kernels whose records it
     lost all the same are timed by CUDA events, and say so. The
     Renderer's synchronous loop against its
     one-deep pipeline in turns (sync, pipe, pipe, sync) on softdof,
     mesh_scene, ico5, texture_scene and the photon-mapped
     caustics_scene: wall, device busy and idle share, the four renders'
     planes equal bit for bit; the synchronizing operations a dispatch
     of each under torch.cuda.set_sync_debug_mode("warn"), and, since that
     mode does not see torch.cuda.Event.synchronize, the event waits in
     Renderer._read and the host's time blocked in them, in turns. The
     bounds of the kernels that run
     threefry (K1a-K1d, K6) count the ciphers' integer operations at the
     card's integer rate beside the float32 operations at the float32 rate
     (and print the float32-rate figure of earlier PRs); K1a-K1d also give
     the bound with each lane's counters raised to its warp's maximum, a
     warp's maximum against a lane's mean of the counters, the share of
     soft-shadow estimates that went past shadow_spp, and each
     instantiation's registers, spills, shared memory and blocks an SM.
     K1c's bound counts the triangle tests the exact function needs
     (k1c_need: the leaves of its tree at or below each closest hit's final
     t, one leaf an occluded shadow ray, those within budget of an open
     one, on the plain version's rays), and its rows print the leaves a
     lane visits and for a warp's slowest lane; K6's mesh bound is counted
     the same way. K5 is timed as gather_apply launches it, with the warps
     launched and the clusters a query visits.
     K2a and K2b at the largest of K2b's launch sizes in phase 4 and at
     65,536 rays, on random rays and on the rays phase 4 launched them on,
     K2b with and without the uv, with the registers, spills and blocks an
     SM of K2a and both K2b instantiations; K2c at 1,048,576 and 65,536
     rays with the sizes of its launches in phase 4 and both
     instantiations' (pairs, one ray a thread) registers, spills, shared
     memory and blocks an SM.
     K6 also on spot_scene's full frame and the glass scene (480,000
     lanes), with a warp's maximum against a lane's mean of its ciphers and
     vertices, and both instantiations' registers, spills, shared memory
     and blocks an SM (at the gate's largest tables too).
     K3 on ico5 and on mesh_scene (the shape of its launches), on rays in
     the order they come as the dense route walks them: clusters a ray and
     for the warp's slowest ray, and its bound from the clusters within
     each ray's final reach. K4a's and K4b's with two bounds, the
     clusters within reach of the winner (the bound of a walk that keeps
     the winner alone) and within reach of the runner-up (what the exact
     top-2 needs), their registers and spills, and the two-phase K4a whole
     at budgets 12 and 0.
Prints the card's name and power limit, one JSON line of per-kernel
numbers and, last, {"ok": true, "device": {...}}. Exits non-zero without
those lines when there is no CUDA device or no package beside it.
"""

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SCENE = os.path.join(HERE, "tests", "assets", "softdof_scene.xml")
TEXTURE_SCENE = os.path.join(HERE, "tests", "assets", "texture_scene.xml")
SPOT_SCENE = os.path.join(HERE, "tests", "assets", "spot_scene.xml")
IMAGE = os.path.join(HERE, "tests", "assets", "colorBuffer.png")

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 operations/s
# outside the tensor cores. The threefry ciphers' 32-bit integer operations
# run at their own rate: 64 results a clock an SM for compute capability
# 9.0 (the CUDA C++ Programming Guide's throughput table) on 132 SMs at the
# card's maximum SM clock, which main() reads from nvidia-smi (about
# 16.7e12/s at 1,980 MHz). The pipes issue side by side, so a bound is the
# largest of the three times.
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12
PEAK_INT_OPS = None  # set by main(): 64 * 132 * clocks.max.sm
# Operations per unit of work, counted from csrc/analytic.cuh and
# csrc/threefry.cuh: a primitive test is at least 45 (object-space transform
# 33, plane solve and bounds 12; a sphere takes more), a threefry cipher
# about 120 (20 rounds of add, rotate, xor; 5 key injections). Shading
# arithmetic between them is not counted, so the bound stays a lower bound.
OPS_PER_TEST = 45
OPS_PER_CIPHER = 120
# A triangle test (csrc/mesh.cuh tri_hit) is at least 40: six 3-term dot
# products (30), t (2), the barycentric weights a, b (6) and c (2).
OPS_PER_TRI = 40
# W1 (csrc/bvh.cu): an inner node is two slab tests of at least 18 each (6
# subtractions, 6 multiplies, 6 min/max), and a ray's move into an
# instance's space 33 (3 subtractions, two 3x3 products of 9 multiplies
# and 6 adds).
OPS_PER_NODE = 36
OPS_PER_XFORM = 33
# A checker test (csrc/megakernel.cu textured/checker01) is at least 12: the
# sample position (4 multiplies, 4 adds) and two floors with their
# subtractions; the compares and the sum are not counted.
OPS_PER_CHECKER = 12
# A photon test (csrc/photon.cuh photon_add) is at least 20: the distance
# (3 subtractions, 3 multiplies, 2 adds), the weight (a multiply and a
# subtraction), seven multiply-adds of the sums counted as 7 (the count's
# add included) and the compare. A cluster test (photon_cluster_near) is
# at least 12: six additions or subtractions of the radius, six compares.
OPS_PER_PHOTON = 20
OPS_PER_PCLUSTER = 12
# K1d's bar on the share of unescalated lanes off by more than 1e-3
# relative (the JAX package's test allows 1 %, more than a caustic under
# one glass sphere may touch).
K1D_OFF_BAR = 1e-4
# K6's bar against its plain version: tests/test_grad.py's 3e-2 of each
# field's max|b| (the kernel sums in another order than autograd, and a
# lane whose path differs by a last-bit flip moves a field's sum).
K6_BAR = 3e-2
MESH_SCENE = os.path.join(HERE, "tests", "assets", "mesh_scene.xml")
GRID_SCENE = os.path.join(HERE, "tests", "assets", "grid_scene.xml")
MIRROR_SCENE = os.path.join(HERE, "tests", "assets", "mirror_scene.xml")
ICO_CENTRE, ICO_RADIUS = (0.0, 50.0, 5.1), 8.0  # mesh_scene's icosphere
BIG = 1e30


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=10):
    """Mean milliseconds of fn() by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_us(evt):
    """Self device time (us) of a profiler event, across torch versions."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        val = getattr(evt, attr, None)
        if val is not None:
            return val
    return 0


def flush_profiler():
    """A torch.profiler session with a few small kernels: in a process that
    has just made or dropped CUDA graphs the profiler loses device records
    of its next session, and this one takes that loss."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        x = torch.zeros(1, device="cuda")
        for _ in range(4):
            x = x + 1
        torch.cuda.synchronize()


def kernel_ms(fn, kernel_name, reps=10):
    """Milliseconds per launch of the CUDA kernel whose name contains
    kernel_name (fn launches it once), from torch.profiler's device times
    over the launches it recorded; CUDA events around the whole call when
    it recorded none. torch.profiler may drop the records of the last
    launches it traced, so the mean is taken over those it kept, and their
    count is printed when it is short.
    Returns (ms, "profiler" | "events")."""
    fn()
    flush_profiler()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    seen = [e for e in prof.key_averages() if kernel_name in e.key]
    total = sum(device_us(e) for e in seen)
    count = sum(e.count for e in seen)
    if count != reps:
        print(f"  the profiler recorded {count} of {reps} {kernel_name} "
              "launches", flush=True)
    if total > 0:
        return total / count / 1e3, "profiler"
    return cuda_ms(fn, reps), "events"


def bound(nbytes, ops, int_ops=0):
    """The least time (ms) of nbytes moved, ops float32 operations and
    int_ops 32-bit integer operations, and what sets it."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = max(ops / PEAK_OPS, int_ops / PEAK_INT_OPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_sm_clock_hz():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return float(out.stdout.strip().splitlines()[0].split()[0]) * 1e6


def blocks_per_sm(registers, threads, smem):
    """Blocks of `threads` threads an H100 SM holds by their registers
    (allocated 256 a warp, 65,536 an SM) and their shared memory (228 KB an
    SM less 1 KB a block), at most 32 blocks and 2,048 threads."""
    warp_regs = -(-registers * 32 // 256) * 256
    by_regs = 65536 // (warp_regs * (threads // 32))
    return min(by_regs, 233472 // (smem + 1024), 32, 2048 // threads)


def check(cond, what):
    if not cond:
        raise AssertionError(what)
    print(f"  ok: {what}", flush=True)


def t_bars(t_ref, i_ref, t_got, i_got, what):
    """tests/test_pallas.py:41-45 bars; returns the agreeing hit lanes."""
    hits = (t_ref < 1e29) & (t_got < 1e29)
    rel = ((t_got - t_ref).abs() / t_ref.clamp_min(1.0))[hits]
    p99 = torch.quantile(rel[: 1 << 24].double(), 0.99).item()
    flips = ((t_ref < 1e29) ^ (t_got < 1e29)).float().mean().item()
    same = (i_got == i_ref)[hits].float().mean().item()
    check(p99 < 1e-5, f"{what}: p99 relative t error {p99:.3g} < 1e-5")
    check(flips < 0.005, f"{what}: hit/miss flips {flips:.3g} < 0.005")
    check(same > 0.995, f"{what}: same primitive {same:.6f} > 0.995")
    return (hits & (i_got == i_ref)), (t_got - t_ref)[hits].abs().max().item()


def lanes(w, h, spp, device="cuda"):
    ids = torch.arange(w * h * spp, device=device, dtype=torch.int32)
    return ids % w, (ids // w) % h, ids // (w * h)


def compare_render(rad_ref, t0_ref, rad, t0, what):
    """tests/test_megakernel.py:94-110 bars."""
    rad_ref, rad = rad_ref.double(), rad.double()
    t_ok = torch.allclose(t0_ref, t0, rtol=1e-4, atol=1e-3)
    check(t_ok, f"{what}: t0 within rtol 1e-4 atol 1e-3")
    rel = ((rad_ref - rad).abs().amax(-1)
           / (1.0 + rad_ref.abs().amax(-1)))
    frac = (rel > 1e-3).double().mean().item()
    med = rel.median().item()
    mean_err = (rad_ref.mean(0) - rad.mean(0)).abs().max().item()
    check(frac < 2e-3, f"{what}: lanes above 1e-3 relative {frac:.3g} < 2e-3")
    check(med < 1e-6, f"{what}: median relative error {med:.3g} < 1e-6")
    check(mean_err < 2e-3, f"{what}: image-mean error {mean_err:.3g} < 2e-3")
    return (rad_ref - rad).abs().max().item()


def compare_tex_render(rad_ref, t0_ref, rad, t0, what):
    """tests/test_megakernel.py::test_mega_checker_textures_parity's bars,
    and primary depth as compare_render holds it."""
    rad_ref, rad = rad_ref.double(), rad.double()
    check(torch.allclose(t0_ref, t0, rtol=1e-4, atol=1e-3),
          f"{what}: t0 within rtol 1e-4 atol 1e-3")
    rel = ((rad_ref - rad).abs().amax(-1)
           / (1.0 + rad_ref.abs().amax(-1)))
    frac = (rel > 1e-3).double().mean().item()
    mean_err = (rad_ref.mean(0) - rad.mean(0)).abs().max().item()
    check(frac < 5e-3, f"{what}: lanes above 1e-3 relative {frac:.3g} < 5e-3")
    check(mean_err < 2e-3, f"{what}: channel-mean error {mean_err:.3g} < "
          "2e-3")
    return (rad_ref - rad).abs().max().item()


def compare_mesh_render(rad_ref, t0_ref, rad, t0, what, bars):
    """tests/test_megakernel.py's mesh bars (t0 lanes off by > 1e-3,
    radiance lanes above 1e-3 relative, channel means): the engine re-tests
    each sweep winner with the exact reference formula while K1c shades the
    sweep's own t and weights, so near-edge lanes may differ."""
    t_bar, rad_bar, mean_bar = bars
    rad_ref, rad = rad_ref.double(), rad.double()
    t_frac = ((t0_ref - t0).abs() > 1e-3).double().mean().item()
    rel = ((rad_ref - rad).abs().amax(-1)
           / (1.0 + rad_ref.abs().amax(-1)))
    frac = (rel > 1e-3).double().mean().item()
    mean_err = (rad_ref.mean(0) - rad.mean(0)).abs().max().item()
    check(t_frac < t_bar, f"{what}: t0 lanes off by > 1e-3 {t_frac:.3g} < "
          f"{t_bar}")
    check(frac < rad_bar, f"{what}: lanes above 1e-3 relative {frac:.3g} < "
          f"{rad_bar}")
    check(mean_err < mean_bar, f"{what}: channel-mean error {mean_err:.3g} "
          f"< {mean_bar}")
    return (rad_ref - rad).abs().max().item()


def row_bars(want, got, what):
    """tests/test_pallas_tiles.py:43-49 on (t, row, row2): rows equal on >
    99.9 % of rays, t to rtol/atol 1e-5 where they agree on a hit, runner-ups
    equal on > 99 % of the rays where both agree and report one. Returns
    the largest t difference on the agreeing hits."""
    t_x, r_x, r2_x = want[:3]
    t_k, r_k, r2_k = got[:3]
    same = (r_x == r_k).double().mean().item()
    hit = (r_x >= 0) & (r_x == r_k)
    close = torch.allclose(t_k[hit], t_x[hit], rtol=1e-5, atol=1e-5)
    agree = (r_x == r_k) & (r2_x >= 0) & (r2_k >= 0)
    same2 = (r2_x[agree] == r2_k[agree]).double().mean().item()
    check(same > 0.999, f"{what}: rows equal on {same:.6f} > 0.999")
    check(close, f"{what}: t within rtol/atol 1e-5 on agreeing hits")
    check(same2 > 0.99, f"{what}: runner-ups equal on {same2:.6f} > 0.99")
    return (t_k - t_x)[hit].abs().max().item() if hit.any() else 0.0


def row2_bar(want, got, what):
    """K4a's runner-up is exact below t_cur: on the rays where the
    reference reports a winner and a runner-up, the same runner-up on more
    than 99 % (tiled_sweep's runner-up is exact; the Pallas march's is
    not)."""
    has = (want[1] >= 0) & (want[2] >= 0)
    same = (got[2][has] == want[2][has]).double().mean().item()
    check(same > 0.99, f"{what}: runner-ups equal on {same:.6f} > 0.99 of "
          f"the {has.double().mean().item():.4f} of rays with one")


def vertex_rays_no_hole():
    """262,144 rays from a sphere of three radii around mesh_scene's
    icosphere at ico4, aimed at its vertices jittered by 1e-4 (where the
    exact re-test rejects sweep winners), through K4a's two-phase walk and
    ops/trace._fallback, against tiled_sweep and the same fallback: equal
    (t, gid) on every ray but exact ties of the sweep's t, and no ray
    without a hit where the reference has one."""
    from qaray_tpu_torch.ops import tiles
    from qaray_tpu_torch.ops.mesh_stream import _chunk_test
    from qaray_tpu_torch.ops.mesh_tiles import (
        TiledMesh,
        exact_winner_rows,
        tiled_sweep,
    )
    from qaray_tpu_torch.ops.trace import _fallback
    from qaray_tpu_torch.scene.compiler import compile_scene
    from qaray_tpu_torch.scene.procedural import icosphere, with_mesh
    from qaray_tpu_torch.scene.xml_parser import load_scene

    v, f = icosphere(4)
    old = os.environ.get("QARAY_STREAM_MAX_TRIS")
    os.environ["QARAY_STREAM_MAX_TRIS"] = "1"
    try:
        arr, meta = compile_scene(with_mesh(load_scene(MESH_SCENE), v, f),
                                  device="cuda")
    finally:
        if old is None:
            os.environ.pop("QARAY_STREAM_MAX_TRIS")
        else:
            os.environ["QARAY_STREAM_MAX_TRIS"] = old
    check(meta.mesh_tiled, "ico4 compiled for the tiled route")
    m = arr.mesh
    tm = TiledMesh(m.tile_coeff, m.tile_const, m.tile_gid, m.tile_cbounds)
    gen = torch.Generator(device="cuda").manual_seed(4)
    n = 1 << 18
    c = torch.tensor(ICO_CENTRE, device="cuda")
    u = torch.randn((n, 3), device="cuda", generator=gen)
    p = c + 3.0 * ICO_RADIUS * u / u.norm(dim=1, keepdim=True)
    corners = m.tri_v.reshape(-1, 3)  # world-space vertices
    pick = torch.randint(0, corners.shape[0], (n,), device="cuda",
                         generator=gen)
    aim = corners[pick] + 1e-4 * torch.randn((n, 3), device="cuda",
                                             generator=gen)
    d = (aim - p) / (aim - p).norm(dim=1, keepdim=True)
    p, d = p.contiguous(), d.contiguous()
    t_cur = torch.full((n,), BIG, device="cuda")

    def fallback(rows, rows2):
        return _fallback(t_cur, exact_winner_rows(p, d, rows, tm, m.tri_v),
                         exact_winner_rows(p, d, rows2, tm, m.tri_v))[:2]

    def sweep_t(rows):
        r = rows.clamp_min(0).long()
        t = _chunk_test(p[:, None], d[:, None], tm.coeff[r][:, None],
                        tm.const[r][:, None])[:, 0, 0]
        return torch.where(rows >= 0, t, -1.0)

    got = tiles.tiled_closest_twophase(p, d, t_cur, tm, m.tile_c16T,
                                       tree=m.tile_tree)
    ref = tiled_sweep(p, d, t_cur, tm)
    (t_g, gid_g), (t_r, gid_r) = fallback(*got[1:]), fallback(*ref[1:])
    tie = ((sweep_t(got[1]) == sweep_t(ref[1]))
           & (sweep_t(got[2]) == sweep_t(ref[2])))
    off = ~(((gid_g == gid_r) & (t_g == t_r)) | tie)
    holes = (gid_g < 0) & (gid_r >= 0) & ~tie
    fell = (fallback(got[1], torch.full_like(got[1], -1))[1] != gid_g)
    moved = tie & ((got[1] != ref[1]) | (got[2] != ref[2]))
    print(f"  vertex-aimed ico4 rays: {int(fell.sum())} took the runner-up, "
          f"{int(moved.sum())} have other rows at exactly tied t",
          flush=True)
    check(not bool(off.any()), f"K4a + fallback, {n} vertex-aimed ico4 "
          f"rays: (t, gid) of tiled_sweep but for ties ({int(off.sum())} "
          "off)")
    check(not bool(holes.any()) and bool(fell.any()),
          f"K4a + fallback: no hole ({int(holes.sum())}) where the "
          "runner-up was taken")


def vertex_rays(tri_v, n, seed):
    """n rays from a sphere of three radii around mesh_scene's icosphere,
    aimed exactly at the world vertices of tri_v [F, 3, 3]."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    c = torch.tensor(ICO_CENTRE, device="cuda")
    u = torch.randn((n, 3), device="cuda", generator=gen)
    p = c + 3.0 * ICO_RADIUS * u / u.norm(dim=1, keepdim=True)
    corners = tri_v.reshape(-1, 3)
    aim = corners[torch.randint(0, corners.shape[0], (n,), device="cuda",
                                generator=gen)]
    d = (aim - p) / (aim - p).norm(dim=1, keepdim=True)
    return p.contiguous(), d.contiguous()


def mesh_rays(n, seed):
    """Rays around mesh_scene's icosphere: origins uniform in a box three
    radii wide, half the directions aimed at the centre (jittered), half
    uniform; budgets uniform in [1, 41)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    c = torch.tensor(ICO_CENTRE, device="cuda")
    p = c + (torch.rand((n, 3), device="cuda", generator=gen) * 2.0 - 1.0
             ) * (3.0 * ICO_RADIUS)
    d = torch.randn((n, 3), device="cuda", generator=gen)
    d = d / d.norm(dim=1, keepdim=True)
    aim = (c - p) / (c - p).norm(dim=1, keepdim=True)
    d = torch.where((torch.arange(n, device="cuda") % 2 == 0)[:, None],
                    aim + 0.05 * d, d)
    d = d / d.norm(dim=1, keepdim=True)
    t_max = torch.rand(n, device="cuda", generator=gen) * 40.0 + 1.0
    return p.contiguous(), d.contiguous(), t_max


def compare_photon_render(ref, got, esc, what, no_caustics):
    """tests/test_megakernel.py::test_mega_photon_gather_parity's bars on
    the lanes that are not escalated, with its share of lanes above 1e-3
    relative cut from 1 % to K1D_OFF_BAR: channel means within 2e-3, the
    irr0 plane equal on more than 0.999 of lanes; primary depth as
    compare_render holds it. no_caustics, the kernel's radiance on the same
    lanes with its caustics map emptied, must be off on ten times the bar's
    share: the bar sees a kernel that skips the caustics gather. Returns
    the largest difference on those lanes."""
    (rad_ref, t0_ref, irr_ref), (rad, t0, irr) = ref, got
    ok = ~esc
    rad_ref, rad = rad_ref.double(), rad.double()
    check(torch.allclose(t0_ref, t0, rtol=1e-4, atol=1e-3),
          f"{what}: t0 within rtol 1e-4 atol 1e-3")

    def off_share(x):
        rel = ((rad_ref - x.double()).abs().amax(-1)
               / (1.0 + rad_ref.abs().amax(-1)))[ok]
        return (rel > 1e-3).double().mean().item()

    frac, ctl = off_share(rad), off_share(no_caustics)
    mean_err = (rad_ref[ok].mean(0) - rad[ok].mean(0)).abs().max().item()
    same_irr = (irr_ref == irr).double().mean().item()
    print(f"  {what}: escalated share {esc.double().mean().item():.6g}, "
          f"unescalated lanes off without the caustics map {ctl:.6g}",
          flush=True)
    check(frac < K1D_OFF_BAR, f"{what}: unescalated lanes above 1e-3 "
          f"relative {frac:.3g} < {K1D_OFF_BAR:g}")
    check(ctl > 10 * K1D_OFF_BAR, f"{what}: control without the caustics "
          f"map off on {ctl:.3g} > {10 * K1D_OFF_BAR:g}")
    check(mean_err < 2e-3, f"{what}: channel-mean error {mean_err:.3g} < "
          "2e-3")
    check(same_irr > 0.999, f"{what}: irr0 equal on {same_irr:.6f} > 0.999")
    return (rad_ref - rad)[ok].abs().max().item()


def grad_field_errors(got, want):
    """Per DiffParams field: max|a - b| / max|b| (or max|a| where b is 0)."""
    out = {}
    for f in got._fields:
        a, b = getattr(got, f).double(), getattr(want, f).double()
        if a.numel() == 0:
            continue
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        out[f] = err / scale if scale > 0 else a.abs().max().item()
    return out


def on_cuda(*args, **kw):
    """Whether any argument is a CUDA tensor."""
    return any(isinstance(a, torch.Tensor) and a.is_cuda
               for a in (*args, *kw.values()))


class ForbidPlain:
    """Within the block, every plain version a kernel wrapper could take
    raises: a main-path run that finishes ran only kernels. A target is
    (module, attribute name), or (module, attribute name, when) for a plain
    version that stays the CPU's path: it raises only where when(*args,
    **kw) holds, and runs otherwise."""

    def __init__(self, *targets):
        self.targets = targets
        self.saved = []

    def __enter__(self):
        for mod, name, *when in self.targets:
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))

            def refuse(*args, _name=f"{mod.__name__}.{name}", _fn=fn,
                       _when=when[0] if when else None, **kw):
                if _when is not None and not _when(*args, **kw):
                    return _fn(*args, **kw)
                raise AssertionError(f"plain version {_name} ran on the "
                                     "main path")

            setattr(mod, name, refuse)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        self.saved = []
        return False


def clusters_within(p_, d_, cb, reach, ties=False):
    """Per ray, the clusters of boxes cb whose widened entry bound is below
    reach (at or below it with ties): those any exact walk must sweep
    (tiles.ray_cluster_entry, the kernels' own box test)."""
    from qaray_tpu_torch.ops import tiles

    out = []
    for k in range(0, p_.shape[0], 1 << 13):
        lo, ok = tiles.ray_cluster_entry(p_[k:k + (1 << 13)],
                                         d_[k:k + (1 << 13)], cb)
        r = reach[k:k + (1 << 13), None]
        out.append((ok & ((lo <= r) if ties else (lo < r))).sum(1))
    return torch.cat(out)


def k1c_need(arr, meta, cfg, px, py, sid, words):
    """The triangle tests the exact K1c function needs on these lanes,
    whatever walks it. The plain version (the wavefront engine, in
    65,536-lane batches) runs the lanes' paths; it traces every lane at
    every bounce and masks the dead ones later, so the count follows each
    lane's alive flag as the megakernel's loop does (from the closest hits
    and the vertex function's continuation flags) and takes a lane's mesh
    queries while it is alive: for a closest hit the rows of the K1c
    tree's leaves whose entry bound lies at or below its final t (ties may
    win on their row), for a shadow ray (one a lane and light) one leaf
    where it is occluded and the leaves within its budget where it is not.
    Returns (closest-hit rows, any-hit rows)."""
    from qaray_tpu_torch.core.constants import BIAS
    from qaray_tpu_torch.integrators import engine
    from qaray_tpu_torch.ops import megakernel, mesh_sweep

    tabs = arr.kernel
    leaf = megakernel.MEGA_LEAF
    n_leaves = tabs.mesh_tree.shape[0] // 2
    cb = tabs.mesh_tree[n_leaves:n_leaves + tabs.mesh_rows.shape[0] // leaf,
                        :6]
    total = [0, 0]
    state = {}
    closest, occluded = mesh_sweep.sweep_closest, mesh_sweep.sweep_occluded
    vertex_fn = engine._VERTEX_FNS[cfg.integrator]

    def count_closest(p, d, t_cur, c16, **kw):
        out = closest(p, d, t_cur, c16, **kw)
        need = clusters_within(p, d, cb, out[0], ties=True)
        total[0] += int(need[state["alive"]].sum(dtype=torch.int64)) * leaf
        return out

    def count_occluded(p, d, budget, c16, **kw):
        occ = occluded(p, d, budget, c16, **kw)
        if budget.shape != state["lit"].shape:
            raise AssertionError("k1c_need counts one shadow ray a lane")
        need = torch.where(occ, 1, clusters_within(p, d, cb, budget))
        need = torch.where((budget > BIAS) & state["lit"], need, 0)
        total[1] += int(need.sum(dtype=torch.int64)) * leaf
        return occ

    def vertex(scene, meta_, cfg_, hits, *args, **kw):
        state["lit"] = state["alive"] & hits["hit"]
        out = vertex_fn(scene, meta_, cfg_, hits, *args, **kw)
        state["alive"] = state["lit"] & out[3]
        return out

    mesh_sweep.sweep_closest = count_closest
    mesh_sweep.sweep_occluded = count_occluded
    engine._VERTEX_FNS[cfg.integrator] = vertex
    from qaray_tpu_torch.utils import compiled

    # The counting reads each batch on the host: eager, not captured.
    try:
        for lo in range(0, px.shape[0], 65536):
            s_ = slice(lo, lo + 65536)
            state["alive"] = torch.ones(px[s_].shape[0], dtype=torch.bool,
                                        device=px.device)
            with compiled.eager():
                engine.render_batch_wavefront(arr, meta, cfg, px[s_],
                                              py[s_], sid[s_], words)
    finally:
        mesh_sweep.sweep_closest, mesh_sweep.sweep_occluded = (closest,
                                                                occluded)
        engine._VERTEX_FNS[cfg.integrator] = vertex_fn
    return total


# G1's bar against a float64 sum, of each row's sum of |g|: its longest
# chain of float32 adds is some 128 terms (a thread's lanes, the block's 16
# slices, a fold slice's blocks, the 16 fold slices), typically
# sqrt(128) * 2^-24 = 6.7e-7 (tests/test_torch_gpu.py). index_put_ (the
# plain version, and autograd's backward it replaces) adds a row's lanes
# one after another, 460,000 of them on the inverse cell's step, and on
# its cotangents drifts from the float64 sum by far more: G1 is held to
# index_put_ within index_put_'s own gap to the float64 sum plus this bar.
G1_EXACT_TOL = 1e-6


def inverse_step(words):
    """The inverse cell's step under key words `words`: softdof 800x600 x
    1 spp, pathtrace, max_bounce 5, shadow_spp 16..64, an mse loss against
    a grey image, on the autograd route (depth of field)."""
    sys.path.insert(0, HERE)
    from qaray_tpu_torch import diff
    from qaray_tpu_torch.integrators.engine import IntegratorConfig
    from qaray_tpu_torch.scene.compiler import compile_scene
    from qaray_tpu_torch.scene.xml_parser import load_scene

    desc = load_scene(SCENE)
    desc.camera.img_width, desc.camera.img_height = 800, 600
    arr, meta = compile_scene(desc, device="cuda")
    cfg = IntegratorConfig(integrator="pathtrace", max_bounce=5,
                           shadow_spp=16, shadow_spp_max=64)
    check(not diff._fast_route(meta, cfg), "depth of field takes the "
          "autograd route")
    px, py, sid = lanes(800, 600, 1)
    target = torch.full((px.shape[0], 3), 0.25, device="cuda")

    def step():
        return diff.render_value_and_grad(arr, meta, cfg, px, py, sid,
                                          words, target=target)

    return step


def g1_phase(numbers):
    """Phase 3g (see the module's docstring); G1's figures in
    numbers["G1"]."""
    sys.path.insert(0, HERE)
    from qaray_tpu_torch.ops import mtl_gather
    from qaray_tpu_torch.utils import compiled

    print("phase 3g: G1 (the material gather's backward) on the inverse "
          "cell's step, softdof 800x600 x 1 spp, pathtrace, max_bounce 5",
          flush=True)
    step = inverse_step((0, 11))
    calls = []
    launch = mtl_gather.gather_bwd

    def recording(mid, grads, rows):
        calls.append((mid.clone(), [None if g is None else g.clone()
                                    for g in grads], rows))
        return launch(mid, grads, rows)

    mtl_gather.gather_bwd = recording
    try:
        with compiled.eager():
            before = mtl_gather.launches["G1"]
            want = step()
            torch.cuda.synchronize()
            launched = mtl_gather.launches["G1"] - before
    finally:
        mtl_gather.gather_bwd = launch
    check(len(calls) > 0 and launched == len(calls),
          f"the eager step launched G1 once for each of its {len(calls)} "
          "material gathers on the tape")
    worst_plain = worst_exact = worst_lib = 0.0
    for mid, grads, rows in calls:
        got = mtl_gather.gather_bwd(mid, grads, rows)
        again = mtl_gather.gather_bwd(mid, grads, rows)
        plain = mtl_gather.gather_bwd_plain(mid, grads, rows)
        exact = mtl_gather.gather_bwd_plain(
            mid, [None if g is None else g.double() for g in grads], rows)
        for a, b, c, e, g in zip(got, again, plain, exact, grads):
            if g is None:
                continue
            if not torch.equal(a, b):
                raise AssertionError("G1: two launches differ")
            scale = mtl_gather.gather_bwd_plain(
                mid, [g.abs().double()], rows)[0].clamp_min(1e-30)
            off_exact = ((a.double() - e).abs() / scale).max().item()
            off_lib = ((c.double() - e).abs() / scale).max().item()
            off_plain = ((a.double() - c.double()).abs() / scale).max().item()
            if off_plain > off_lib + G1_EXACT_TOL:
                raise AssertionError(f"G1 {off_plain:.3g} from index_put_, "
                                     f"index_put_ {off_lib:.3g} from exact")
            worst_plain = max(worst_plain, off_plain)
            worst_exact = max(worst_exact, off_exact)
            worst_lib = max(worst_lib, off_lib)
    check(worst_exact <= G1_EXACT_TOL,
          f"G1 on the step's {len(calls)} calls: within {G1_EXACT_TOL:g} "
          f"of each row's sum of |g| of a float64 sum ({worst_exact:.3g}); "
          f"index_put_ {worst_lib:.3g} from it, G1 {worst_plain:.3g} from "
          "index_put_ (within index_put_'s own gap plus the bar); two "
          "launches the same bits")
    with compiled.eager():
        again = step()
    eager_env = os.environ.pop("QARAY_EAGER", None)  # phases 2-3 set it
    try:
        caps = compiled.stats["captures"]
        before = mtl_gather.launches["G1"]
        first = step()
        launched_first = mtl_gather.launches["G1"] - before
        caps_first = compiled.stats["captures"] - caps
        before = mtl_gather.launches["G1"]
        replay = step()
        launched_replay = mtl_gather.launches["G1"] - before
        caps_replay = compiled.stats["captures"] - caps - caps_first
        torch.cuda.synchronize()
    finally:
        if eager_env is not None:
            os.environ["QARAY_EAGER"] = eager_env
    same = all(torch.equal(got[0], want[0]) and all(
        torch.equal(a, b) for a, b in zip(got[1], want[1]))
        for got in (again, first, replay))
    check(same and launched_first == launched_replay == len(calls)
          and caps_first > 0 and caps_replay == 0,
          "the step eager twice, captured and replayed: loss and every "
          f"field bit for bit; {launched_replay} G1 launches a replay "
          f"({caps_first} graphs captured, none at the replay)")

    # Times at the step's largest call (the first bounce, every lane).
    mid, grads, rows = max(calls, key=lambda c: c[0].shape[0])
    n = mid.shape[0]
    nbytes = n * (8 + 4 * sum(g[0].numel() for g in grads if g is not None))
    bound_ms = nbytes / PEAK_BYTES * 1e3

    def g1():
        mtl_gather.gather_bwd(mid, grads, rows)

    reps = 20
    g1()
    flush_profiler()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            g1()
        torch.cuda.synchronize()
    seen = [e for e in prof.key_averages() if "mtl_gather_bwd" in e.key]
    by_kernel = {e.key[:60]: device_us(e) / max(e.count, 1) / 1e3
                 for e in seen}
    kernel_ms_ = sum(device_us(e) for e in seen) / reps / 1e3
    call_ms = cuda_ms(g1, reps)
    tables = [torch.zeros((rows, 3) if g.ndim > 1 else (rows,),
                          device="cuda", requires_grad=True)
              for g in grads if g is not None]
    cts = [g for g in grads if g is not None]
    plain_ms = cuda_ms(lambda: mtl_gather.gather_bwd_plain(mid, grads, rows),
                       reps)

    def library():
        outs = [t[mid] for t in tables]
        torch.autograd.grad(outs, tables, cts)

    library_ms = cuda_ms(library, reps)
    step_ms = sum(cuda_ms(lambda c=c: mtl_gather.gather_bwd(*c), 5)
                  for c in calls)
    print(f"  G1 at {n} lanes, {rows} rows, {len(cts)} cotangents: kernels "
          f"{kernel_ms_:.5f} ms a call (by kernel {by_kernel}), the call by "
          f"events {call_ms:.5f} ms; bound {bound_ms:.5f} ms (bytes, "
          f"{nbytes / n:.0f} B a lane); plain (index_put_ a table) "
          f"{plain_ms:.4f} ms; autograd's backward of table[mid] (library) "
          f"{library_ms:.4f} ms; the step's {len(calls)} calls "
          f"{step_ms:.4f} ms by events", flush=True)
    numbers["G1"] = dict(lanes=n, rows=rows, calls_a_step=len(calls),
                         kernel_ms=kernel_ms_, call_ms=call_ms,
                         bound_ms=bound_ms, plain_ms=plain_ms,
                         library_ms=library_ms, step_calls_ms=step_ms,
                         max_gap_plain=worst_plain,
                         max_gap_exact=worst_exact,
                         max_gap_plain_exact=worst_lib)
    del calls, want, again, first, replay
    torch.cuda.synchronize()


# The least integer instructions of one cipher of H1 (csrc/threefry.cu) on
# sm_90, three-input adds (IADD3) and logic (LOP3) fused where the data
# flow allows: the third key word k0 ^ k1 ^ C (1 LOP3), x1 + k1 (1; x0
# starts at 0, so x0 + k0 is k0), 20 rounds of add, funnel shift and xor
# (60), the 5 key injections' x1 += ks + (i + 1) (5 IADD3) and their x0 +=
# ks, of which the first four fold into the next round's add (IADD3) and
# the last stands (1): 68, a fold. A draw adds u01's xor, shift and or (3;
# its float subtract runs on the float pipe): 71.
H1_INT_OPS_A_FOLD = 68
H1_INT_OPS_A_DRAW = 71


def h1_phase(numbers):
    """Phase 3h (see the module's docstring); H1's figures in
    numbers["H1"]."""
    sys.path.insert(0, HERE)
    from qaray_tpu_torch.core import krng
    from qaray_tpu_torch.ops import _build, threefry
    from qaray_tpu_torch.tools.parity_dump import _functions
    from qaray_tpu_torch.utils import compiled

    global PEAK_INT_OPS
    if PEAK_INT_OPS is None:
        PEAK_INT_OPS = 64 * 132 * max_sm_clock_hz()
    lanes, n, chunk = 480_000, 256, 65_536
    print(f"phase 3h: H1 (the wavefront engine's threefry cipher) at the "
          f"inverse cell's soft-shadow draws, {lanes} lanes x {n}",
          flush=True)
    g = torch.Generator(device="cuda").manual_seed(21)
    k0, k1 = (torch.randint(0, 2**32, (lanes,), device="cuda",
                            dtype=torch.int64, generator=g) for _ in range(2))
    f = torch.arange(n, device="cuda")

    def plain():
        return krng.draw_at(k0[:, None], k1[:, None], f[None, :])

    before = threefry.launches["H1"]
    u = threefry.uniform(k0, k1, n)
    folded = threefry.fold(k0, k1, 1003)
    torch.cuda.synchronize()
    check(threefry.launches["H1"] == before + 2, "one H1 launch a draw of "
          f"{lanes * n} floats and one a fold of {lanes} keys")
    err, same = 0.0, True
    for lo in range(0, lanes, chunk):
        want = krng.draw_at(k0[lo:lo + chunk, None], k1[lo:lo + chunk, None],
                            f[None, :])
        err = max(err, (u[lo:lo + chunk] - want).abs().max().item())
        same = same and torch.equal(u[lo:lo + chunk], want)
    w0, w1 = krng.fold2(k0, k1, torch.full_like(k0, 1003))
    check(same and err == 0.0 and torch.equal(folded[0], w0)
          and torch.equal(folded[1], w1),
          f"H1 equals the int64 cipher bit for bit (max_abs_err {err})")
    del u, want, folded
    ms, how = kernel_ms(lambda: threefry.uniform(k0, k1, n),
                        "threefry_uniform", reps=20)
    fold_ms, _ = kernel_ms(lambda: threefry.fold(k0, k1, 1003),
                           "threefry_fold", reps=20)
    plain_ms = cuda_ms(plain, reps=3)
    draws = lanes * n
    int_ops = draws * H1_INT_OPS_A_DRAW
    nbytes = draws * 4 + lanes * 16
    t_ops = int_ops / PEAK_INT_OPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    bound_ms = max(t_ops, t_bytes)
    fold_bytes = lanes * 40
    fold_bound = max(lanes * H1_INT_OPS_A_FOLD / PEAK_INT_OPS,
                     fold_bytes / PEAK_BYTES) * 1e3
    sass = {name: ops for name, ops in _functions(
        _build._target("threefry")).items() if "threefry_" in name}
    shape = {}
    for name, ops in sass.items():
        # Opcodes without their modifiers (SHF.L.W -> SHF), predicates off.
        codes = [op.split()[1 if op.startswith("@") else 0].split(".")[0]
                 for op in ops]
        hist = {c: codes.count(c) for c in sorted(set(codes))}
        shape[name.split("threefry_")[1].split("_kernel")[0]] = dict(
            instructions=len(ops), shf=hist.get("SHF", 0), opcodes=hist)
    # The inverse cell's step eager, with the int64 cipher refused on CUDA
    # tensors: H1's launches, folds and draws a step.
    step = inverse_step((0, 11))
    before = threefry.launches["H1"], dict(threefry.stats)
    with compiled.eager(), ForbidPlain((krng, "cipher2x32", on_cuda)):
        step()
        torch.cuda.synchronize()
    step_counts = dict(launches=threefry.launches["H1"] - before[0], **{
        k: v - before[1][k] for k, v in threefry.stats.items()})
    check(step_counts["launches"] > 0, "the inverse cell's step launches H1 "
          f"{step_counts['launches']} times, the int64 cipher on no CUDA "
          "tensor")
    print(f"  H1 a step of the inverse cell (eager): "
          f"{json.dumps(step_counts)}", flush=True)
    print(f"  H1 uniform {ms:.5f} ms ({how}) for {draws} draws; bound "
          f"{bound_ms:.5f} ms (integer operations {t_ops:.5f} ms at "
          f"{H1_INT_OPS_A_DRAW} a draw, bytes {t_bytes:.5f} ms), "
          f"{bound_ms / ms:.3f} of it; the int64 cipher (plain) "
          f"{plain_ms:.3f} ms; fold of {lanes} keys {fold_ms:.5f} ms, bound "
          f"{fold_bound:.5f} ms; SASS {json.dumps(shape)}", flush=True)
    numbers["H1"] = dict(lanes=lanes, draws_a_lane=n, uniform_ms=ms,
                         timed_by=how, bound_ms=bound_ms, bound_ops_ms=t_ops,
                         bound_bytes_ms=t_bytes, plain_ms=plain_ms,
                         fold_ms=fold_ms, fold_bound_ms=fold_bound,
                         max_abs_err=err, sass=shape, step=step_counts)
    torch.cuda.synchronize()


def main():
    if not torch.cuda.is_available():
        print("no CUDA device: the port's kernels run only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from qaray_tpu_torch.core import krng
    from qaray_tpu_torch.core.constants import BIAS
    from qaray_tpu_torch.integrators import engine
    from qaray_tpu_torch.integrators.engine import (
        IntegratorConfig,
        render_batch,
        render_batch_wavefront,
    )
    from qaray_tpu_torch.fb.framebuffer import FrameBuffer
    from qaray_tpu_torch import diff
    from qaray_tpu_torch.ops import _build, adjoint, analytic, megakernel
    from qaray_tpu_torch.ops import bvh_packed, mesh_sweep, trace
    from qaray_tpu_torch.ops import mtl_gather, photon, threefry
    from qaray_tpu_torch.ops import intersect as I
    from qaray_tpu_torch.ops import tiles
    from qaray_tpu_torch.ops.mesh_stream import (
        StreamTris,
        _chunk_test,
        exact_winner,
        stream_any_hit,
        stream_closest,
    )
    from qaray_tpu_torch.ops.mesh_tiles import TiledMesh, tiled_sweep
    from qaray_tpu_torch.renderer import Renderer, RendererParam, key_words
    from qaray_tpu_torch.scene import bvh as bvh_mod
    from qaray_tpu_torch.scene.compiler import compile_scene
    from qaray_tpu_torch.photon.build import build_photon_maps
    from qaray_tpu_torch.photon.cluster import cluster_photon_map
    from qaray_tpu_torch.scene.procedural import (
        icosphere,
        scatter_instances,
        with_glass,
        with_mesh,
        with_shared_mesh,
        with_texture,
    )
    from qaray_tpu_torch.scene.textures import load_image
    from qaray_tpu_torch.tools.kernel_times import w1_walked
    from qaray_tpu_torch.scene.xml_parser import load_scene
    from qaray_tpu_torch.utils import compiled

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    card = card_line()
    print(card, flush=True)
    global PEAK_INT_OPS
    PEAK_INT_OPS = 64 * 132 * max_sm_clock_hz()
    print(f"integer rate {PEAK_INT_OPS:.4g} operations/s (64 a clock an SM, "
          "132 SMs, the maximum SM clock)", flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # -- 1. build ----------------------------------------------------------
    t = time.time()
    reports = _build.build()
    print(f"phase 1: built {sorted(reports) or 'nothing (cached)'} in "
          f"{time.time() - t:.1f} s", flush=True)
    for name, log in reports.items():
        for line in log.splitlines():
            if "Function properties for" in line:
                print(f"  {name}: {line.split('for ', 1)[1].strip()}")
            elif "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    for name in _build.SOURCES:
        _build.load(name)
    from qaray_tpu_torch import native

    t = time.time()
    check(native.available(), "the native host library (BVH builder, OBJ "
          f"parser, PNG encoder) built and loaded in {time.time() - t:.2f} s"
          f" ({native.error or 'no error'}); compile_scene builds its trees "
          "with it")
    numbers = {}

    def ptxas_info(name, symbol_part):
        """Registers and spill bytes (stores, loads) of the kernel whose
        mangled name holds symbol_part, from nvcc's -Xptxas=-v report of
        library `name`, which ops/_build writes beside the library."""
        log = _build._target(name).with_suffix(".log").read_text()
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Function properties for" in line and symbol_part in line:
                spill = dict((k, int(v)) for v, k in re.findall(
                    r"(\d+) bytes spill (stores|loads)", lines[i + 1]))
                frame = re.search(r"(\d+) bytes stack frame", lines[i + 1])
                regs = re.search(r"Used (\d+) registers", lines[i + 2])
                return dict(registers=int(regs.group(1)),
                            stack_frame_bytes=int(frame.group(1)),
                            spill_store_bytes=spill["stores"],
                            spill_load_bytes=spill["loads"])
        raise AssertionError(f"no ptxas report for {symbol_part} in {name}")

    # -- 2. kernels against their plain versions -----------------------------
    # Phases 2 and 3 hold each kernel against its plain version, which they
    # run eagerly, as before captured execution (QARAY_EAGER); the main
    # path from phase 4 on runs captured (utils/compiled.py), and 4w holds
    # captured against eager.
    os.environ["QARAY_EAGER"] = "1"
    print("phase 2a: analytic kernels vs plain, 1M random rays", flush=True)
    arr, meta = compile_scene(load_scene(SCENE), device="cuda")
    prims = arr.analytic
    gen = torch.Generator(device="cuda").manual_seed(0)
    n_rays = 1 << 20
    p = torch.rand((n_rays, 3), device="cuda", generator=gen) * 60.0 - 30.0
    d = torch.randn((n_rays, 3), device="cuda", generator=gen)
    d = d / d.norm(dim=1, keepdim=True)
    t_max = torch.rand(n_rays, device="cuda", generator=gen) * 59.0 + 1.0
    t_k, i_k = analytic.closest(p, d, prims)
    t_p, i_p = analytic.closest_plain(p, d, prims)
    _, err = t_bars(t_p, i_p, t_k, i_k, "K2a")
    numbers["K2a"] = {"max_abs_err": err}
    full_k = analytic.closest_full(p, d, prims)
    full_p = analytic.closest_full_plain(p, d, prims)
    agree, err = t_bars(full_p["t"], full_p["prim_idx"], full_k["t"],
                        full_k["prim_idx"], "K2b")
    for k in ("n", "p", "uvw"):
        e = (full_k[k] - full_p[k])[agree].abs().max().item()
        check(e < 1e-4, f"K2b: {k} max error {e:.3g} < 1e-4 on agreeing lanes")
        err = max(err, e)
    for k in ("front", "mtl"):
        check(bool((full_k[k] == full_p[k])[agree].all()),
              f"K2b: {k} equal on agreeing lanes")
    numbers["K2b"] = {"max_abs_err": err}
    full_n = analytic.closest_full(p, d, prims, want_uv=False)
    check(not full_n["uvw"].any() and not analytic.closest_full_plain(
        p, d, prims, want_uv=False)["uvw"].any() and all(
        torch.equal(full_n[k], v) for k, v in full_k.items() if k != "uvw"),
        "K2b without the uv: uvw 0 on every lane (and in the plain "
        "version), every other output equal to K2b with it, bit for bit")
    occ_k = analytic.shadow(p, d, t_max, prims)
    occ_p = analytic.shadow_plain(p, d, t_max, prims)
    dis = (occ_k != occ_p).float().mean().item()
    check(dis < 0.005, f"K2c: occlusion disagreements {dis:.3g} < 0.005")
    numbers["K2c"] = {"max_abs_err": float(dis > 0), "disagree_frac": dis}
    # The same rays as views at a 4-byte offset (which K2c takes one ray a
    # thread) and heads that take one ray a thread or, at 1,000,001 (past
    # 3 rays a thread of its grid on 132 SMs), pairs and a last ray: the
    # same bits.
    flat = [torch.empty(t.numel() + 1, device="cuda") for t in (p, d, t_max)]
    for f, t in zip(flat, (p, d, t_max)):
        f[1:].copy_(t.reshape(-1))
    po, do, to = flat[0][1:].view(-1, 3), flat[1][1:].view(-1, 3), flat[2][1:]
    check(torch.equal(analytic.shadow(po, do, to, prims), occ_k),
          "K2c on p, d and t_max at a 4-byte offset equals K2c on the "
          "aligned rays, bit for bit")
    for n in (1, 31, 65537, 1000001):
        got = analytic.shadow(p[:n], d[:n], t_max[:n], prims)
        off = analytic.shadow(po[:n], do[:n], to[:n], prims)
        check(torch.equal(got, occ_k[:n]) and torch.equal(off, got),
              f"K2c on the first {n} rays (aligned and at a 4-byte offset) "
              "equals K2c on all of them")

    # K2a and K2b (with and without the uv) on the same views and heads:
    # the bits of K2a and K2b on all the aligned rays.
    def k2_outputs(p_, d_):
        t_, i_ = analytic.closest(p_, d_, prims)
        return {"K2a t": t_, "K2a prim": i_,
                **{f"K2b {k}": v for k, v in
                   analytic.closest_full(p_, d_, prims).items()},
                **{f"K2b no uv {k}": v for k, v in analytic.closest_full(
                    p_, d_, prims, want_uv=False).items()}}

    k2_all = k2_outputs(p, d)
    check(torch.equal(k2_all["K2a t"], t_k)
          and torch.equal(k2_all["K2a prim"], i_k)
          and torch.equal(k2_all["K2b t"], k2_all["K2a t"])
          and torch.equal(k2_all["K2b prim_idx"], k2_all["K2a prim"]),
          "K2a and K2b give the same (t, prim), and K2a the same bits twice")
    for n in (None, 1, 31, 65537, 1000001):
        sl = slice(None) if n is None else slice(0, n)
        for what, (ps, ds) in (("aligned", (p[sl], d[sl])),
                               ("at a 4-byte offset", (po[sl], do[sl]))):
            if n is None and what == "aligned":
                continue
            got = k2_outputs(ps, ds)
            check(all(torch.equal(got[k], v[sl]) for k, v in k2_all.items()),
                  f"K2a and K2b on {'all' if n is None else f'the first {n}'}"
                  f" rays {what} equal K2a and K2b on all the aligned rays, "
                  "bit for bit")
    del flat, po, do, to, k2_all
    torch.cuda.synchronize()

    print("phase 2b: mesh kernels vs plain: ico5 (K3) and ico6 (K4a/K4b), "
          "1M random rays and 480,000 camera rays at 800x600", flush=True)
    mesh_base = load_scene(MESH_SCENE)
    mesh_base.camera.img_width, mesh_base.camera.img_height = 800, 600
    ico5 = with_mesh(mesh_base, *icosphere(5), name="ico5")
    ico6 = with_mesh(mesh_base, *icosphere(6), name="ico6")
    t = time.time()
    a5, m5 = compile_scene(ico5, device="cuda")
    t5 = time.time() - t
    t = time.time()
    a6, m6 = compile_scene(ico6, device="cuda")
    t6 = time.time() - t
    # The world BVH, which W1 walks under QARAY_MESH_PATH=bvh: its share of
    # compile with the native builder and with the numpy one (the same
    # tree, node for node).
    wv6 = a6.mesh.tri_v.cpu().numpy()
    t = time.time()
    b6 = bvh_mod.build_bvh(wv6, m6.max_leaf)
    bvh_mod.pack_bvh(b6.bounds, b6.left, b6.right, b6.count, b6.elems, wv6)
    tb6 = time.time() - t
    t = time.time()
    b6n = bvh_mod.build_bvh(wv6, m6.max_leaf, use_native=False)
    tb6n = time.time() - t
    check(all(np.array_equal(x, y) for x, y in zip(b6, b6n)),
          "ico6's native BVH equals the numpy build, node for node")
    native_build = native.bvh_build_native
    native.bvh_build_native = lambda *a, **k: None
    try:
        t = time.time()
        compile_scene(ico6, device="cuda")
        t6n = time.time() - t
    finally:
        native.bvh_build_native = native_build
    print(f"  compiled ico5 in {t5:.3f} s, ico6 in {t6:.3f} s with the "
          f"native builder, {t6n:.3f} s with the numpy one; ico6's BVH "
          f"build and pack alone {tb6:.3f} s (numpy build {tb6n:.3f} s)",
          flush=True)
    numbers["compile"] = dict(ico6_native_s=t6, ico6_numpy_s=t6n,
                              ico6_bvh_native_s=tb6, ico6_bvh_numpy_s=tb6n)
    check(m5.num_tris == 20480 and m5.mesh_stream and m5.mesh_mega,
          "ico5: dense-sweep (K3) and megakernel (K1c) tables")
    check(m6.num_tris == 81920 and m6.mesh_tiled and not m6.mesh_mega,
          "ico6: tiled (K4a/K4b) tables, above the megakernel's limit")
    c16 = a5.mesh.stream_c16
    plain5 = StreamTris(a5.mesh.stream_coeff, a5.mesh.stream_const)
    m6t = a6.mesh
    tm6 = TiledMesh(m6t.tile_coeff, m6t.tile_const, m6t.tile_gid,
                    m6t.tile_cbounds)
    rp, rd, rt = mesh_rays(1 << 20, 7)
    cpx, cpy, csid = lanes(800, 600, 1)
    cp, cd, *_ = engine.generate_camera_rays(a5, m5, cpx, cpy, csid, None)
    cp, cd = cp.contiguous(), cd.contiguous()
    light = -torch.tensor([1.0, 0.5, -1.0], device="cuda")
    light = light / light.norm()
    mesh_err = {"K3": 0.0, "K4a": 0.0, "K4b": 0.0}
    mesh5 = a5.mesh
    tabs5 = a5.kernel  # K1c's tables of ico5 (phase 2d)
    walk5 = mesh_sweep.walk_of(mesh5)
    # K3's walk is the dense sweep's function: equal (t, row, row2) on every
    # ray, also where t_cur falls short of every hit (the runner-up is then
    # the nearest hit beyond t_cur) and where hits tie exactly in t (rays
    # aimed at the vertices: the lower triangle id wins).
    vp, vd = vertex_rays(a5.mesh.tri_v, 1 << 18, 5)
    for what, p_, d_, t_cur in (
            ("random", rp, rd, torch.full_like(rt, BIG)),
            ("random, t_cur short of the hits", rp, rd, rt * 0.1),
            ("vertex-aimed", vp, vd, torch.full((vp.shape[0],), BIG,
                                                device="cuda")),
            ("camera", cp, cd, torch.full((cp.shape[0],), BIG,
                                          device="cuda"))):
        got = mesh_sweep.sweep_closest(p_, d_, t_cur, c16, walk=walk5)
        want = stream_closest(p_, d_, t_cur, plain5)
        off = sum(int((a != b).sum()) for a, b in zip(want, got))
        t2 = _chunk_test(p_[:, None], d_[:, None],
                         plain5.coeff[want[2].clamp_min(0).long()][:, None],
                         plain5.const[want[2].clamp_min(0).long()][:, None])
        ties = int(((want[1] >= 0) & (want[2] >= 0)
                    & (t2[:, 0, 0] == want[0])).sum())
        beyond = int(((want[1] < 0) & (want[2] >= 0)).sum())
        mesh_err["K3"] = max(mesh_err["K3"],
                             (got[0] - want[0]).abs().max().item())
        check(off == 0, f"K3 ico5 {what}: (t, row, row2) of stream_closest "
              f"on every ray of {p_.shape[0]} ({ties} exact ties in t, "
              f"{beyond} runner-ups beyond t_cur)")
        del got, want, t2
    for what, p_, d_, tmax_ in (("random", rp, rd, rt),
                                ("camera", cp, cd, rt[: cp.shape[0]])):
        occ_k = mesh_sweep.sweep_occluded(p_, d_, tmax_, c16, walk=walk5)
        occ_p = stream_any_hit(p_, d_, tmax_, plain5)
        check(torch.equal(occ_k, occ_p), f"K3 any hit ico5 {what}: every "
              "ray equal")
    for what, p_, d_, tmax_ in (("random", rp, rd, rt),
                                ("camera", cp, cd, rt[: cp.shape[0]])):
        t_cur = torch.full_like(tmax_, BIG)
        got = tiles.tiled_sweep_kernel(p_, d_, t_cur, tm6, m6t.tile_c16T,
                                       tree=m6t.tile_tree)
        want = tiled_sweep(p_, d_, t_cur, tm6)
        mesh_err["K4a"] = max(mesh_err["K4a"],
                              row_bars(want, got, f"K4a ico6 {what}"))
        row2_bar(want, got, f"K4a ico6 {what}")
        capped = tiles.tiled_sweep_kernel(p_, d_, t_cur, tm6, m6t.tile_c16T,
                                          max_steps=12, tree=m6t.tile_tree)
        res = capped[3]
        check(all(torch.equal(a[res], b[res])
                  for a, b in zip(capped[:3], got[:3])),
              f"K4a ico6 {what}, 12 clusters a ray: the "
              f"{res.double().mean().item():.4f} of rays marked resolved "
              "have their uncapped top-2")
        del capped, res
        if what == "camera":
            # Shadow rays toward mesh_scene's direct light from the camera
            # rays' hits; misses get budget 0, as the engine gives them.
            hit = want[1] >= 0
            sp = (p_ + torch.where(hit, want[0], 0.0)[:, None] * d_)
            tmax_ = torch.where(hit, BIG, 0.0)
            d_ = light.expand_as(sp).contiguous()
            p_ = sp.contiguous()
            shadow6 = (p_, d_, tmax_)
        occ_k = tiles.tiled_sweep_kernel(p_, d_, tmax_, tm6, m6t.tile_c16T,
                                         any_hit=True, tree=m6t.tile_tree)
        occ_p = tiled_sweep(p_, d_, tmax_, tm6, any_hit=True)
        check(torch.equal(occ_k, occ_p), f"K4b ico6 {what}: every ray equal "
              f"({occ_k.double().mean().item():.4f} occluded)")
        del got, want
    for what, p_, d_ in (("random", rp, rd), ("camera", cp, cd)):
        # Two-phase against single-phase, both on the coherence-sorted rays:
        # a ray's walk takes the same clusters in the same order in both.
        t_cur = torch.full((p_.shape[0],), BIG, device="cuda")
        t0, r0, s0 = tiles.tiled_closest_twophase(
            p_, d_, t_cur, tm6, m6t.tile_c16T, budget=0, tree=m6t.tile_tree)
        t1, r1, s1 = tiles.tiled_closest_twophase(
            p_, d_, t_cur, tm6, m6t.tile_c16T, budget=12, tree=m6t.tile_tree)
        check(torch.equal(t0, t1) and torch.equal(r0, r1)
              and torch.equal(s0, s1), f"K4a two-phase vs single-phase ico6 "
              f"{what}: t, rows and runner-ups identical")
    del t0, r0, s0, t1, r1, s1
    vertex_rays_no_hole()
    torch.cuda.synchronize()

    print("phase 2c: K5 vs photon_gather_plain, the global-map records of "
          "one photon-mapped dispatch of caustics_scene at 800x600",
          flush=True)
    caus_desc = with_glass(load_scene(SCENE), "mid")
    caus_desc.camera.img_width, caus_desc.camera.img_height = 800, 600
    c_arr, c_meta = compile_scene(caus_desc, device="cuda")
    p_photon = RendererParam(use_photon_map=True)
    with tempfile.TemporaryDirectory() as wd, contextlib.chdir(wd):
        t = time.time()
        gmap, cmap = build_photon_maps(c_arr, c_meta, p_photon)
        torch.cuda.synchronize()
        t_maps = time.time() - t
    pmaps = (cluster_photon_map(gmap), cluster_photon_map(cmap))
    print(f"  maps built in {t_maps:.3f} s: {int(gmap.valid.sum())} global "
          f"photons in {pmaps[0].cbounds.shape[0]} clusters, "
          f"{int(cmap.valid.sum())} caustics photons in "
          f"{pmaps[1].cbounds.shape[0]} clusters", flush=True)
    cfg_photon = Renderer(p_photon, device="cuda").integrator_config()
    rbg = key_words("rbg", RendererParam().seed)
    bpx, bpy, bsid = lanes(800, 600, 1)
    captured = {}
    gather_apply = photon.gather_apply

    def capture(gmap_, rec):
        captured["rec"] = rec.clone()
        return gather_apply(gmap_, rec)

    photon.gather_apply = capture
    try:
        megakernel.mega_render(c_arr, c_meta, cfg_photon, bpx, bpy, bsid, rbg,
                               photon_maps=pmaps)
    finally:
        photon.gather_apply = gather_apply
    packed = torch.stack(list(captured.pop("rec")), dim=-1)
    valid = packed[:, 16] > 0.5
    _, order = torch.sort(photon._morton_keys(packed[:, 0:3], valid),
                          stable=True)
    q5 = packed[order, 0:3].contiguous()
    a5 = packed[order, 16].contiguous()
    print(f"  {q5.shape[0]} queries, {int(valid.sum())} with a record "
          f"({valid.double().mean().item():.4f})", flush=True)
    k5_err = 0.0
    n5 = (a5 > 0.5).sum(dtype=torch.int32).reshape(1)
    for radius in (pmaps[0].radius, 50.0):
        got = photon.photon_gather(pmaps[0].ctable, pmaps[0].cbounds, radius,
                                   q5, a5)
        want = photon.photon_gather_plain(pmaps[0].ctable, pmaps[0].cbounds,
                                          radius, q5, a5)
        torch.cuda.synchronize()
        r_ = float(radius)
        for k, (w_, g_) in enumerate(zip(want[:2], got[:2])):
            bad = ((g_ - w_).abs() > 1e-7 + 1e-5 * w_.abs()).sum().item()
            check(bad == 0, f"K5 r {r_:g}: {('irradiance', 'direction')[k]} "
                  "sums within 1e-5 relative (1e-7 absolute)")
            k5_err = max(k5_err, (g_ - w_).abs().max().item())
        check(torch.equal(want[2], got[2]), f"K5 r {r_:g}: counts exact")
        # As gather_apply launches it: a warp to each of the leading
        # queries with a record, their count in device memory.
        got_c = photon.photon_gather(pmaps[0].ctable, pmaps[0].cbounds,
                                     radius, q5, a5, count=n5)
        check(all(torch.equal(x, y) for x, y in zip(got, got_c)),
              f"K5 r {r_:g}: the counted launch gives the flagged one's "
              "sums and counts bit for bit")
        same = torch.ones_like(valid)
        for w_, g_ in zip(want, got):
            same &= (w_ == g_).reshape(w_.shape[0], -1).all(-1)
        over = (got[2] > 100).double().mean().item()
        print(f"  K5 r {r_:g}: bit-equal lanes {same.double().mean().item()}"
              f", lanes over 100 photons {over:.6f}", flush=True)
        if r_ > 1.0:
            check(over > 0.01, f"K5 r 50: counts over 100 on {over:.4f} of "
                  "lanes")
        del got, want
    numbers["K5"] = {"max_abs_err": k5_err}
    torch.cuda.synchronize()

    print("phase 2d: K1c's mesh functions (the megakernel's tree walk, "
          "qr_mega_mesh_probe) vs the in-order fold, ico5, 2^20 rays",
          flush=True)
    n1c = 1 << 20
    pr, dr, tr = mesh_rays(n1c // 2, 21)
    pv, dv = vertex_rays(mesh5.tri_v, n1c // 2, 22)
    pr, dr = torch.cat([pr, pv]), torch.cat([dr, dv])
    big1 = torch.full((n1c,), BIG, device="cuda")
    t_m, row_m, _ = megakernel.mesh_fold_plain(tabs5.mesh_rows, pr, dr, big1,
                                               big1)
    third = torch.arange(n1c, device="cuda") % 3
    t_r = torch.cat([tr, tr])
    # A third with an analytic t equal to the mesh hit's (the analytic
    # winner keeps it), a third with a budget equal to it (not occluded).
    t_a = torch.where(third == 0, big1, torch.where(third == 1, t_r, t_m))
    t_b = torch.where(third == 0, t_m, torch.where(third == 1, big1, t_r))
    pwork = torch.zeros((n1c, 2), dtype=torch.int32, device="cuda")
    got = megakernel.mesh_probe(tabs5, pr, dr, t_a, t_b, work=pwork)
    want = megakernel.mesh_probe_plain(tabs5.mesh_rows, tabs5.mesh_attr, pr,
                                       dr, t_a, t_b)
    for name, w_, g_ in zip(("t", "normal", "front", "material row",
                             "occluded"), want, got):
        check(torch.equal(w_, g_), f"K1c probe: {name} equal to the fold's "
              "on every ray")
    ties = int(((third == 2) & (row_m >= 0)).sum())
    check(ties > 10000, f"K1c probe: {ties} rays tie the analytic t")
    print(f"  equal on {n1c} rays ({ties} analytic ties, "
          f"{int(got[4].sum())} occluded); triangle tests a ray: closest "
          f"{pwork[:, 0].double().mean().item():.2f}, any hit "
          f"{pwork[:, 1].double().mean().item():.2f}, of "
          f"{tabs5.mesh_rows.shape[0]} rows", flush=True)
    del pr, dr, pv, dv, got, want, pwork, t_m, row_m
    torch.cuda.synchronize()

    print("phase 2e: W1 (the packed BVH walk) vs its plain version: "
          "mesh_scene's icosphere and ico5 through QARAY_MESH_PATH=bvh, and "
          "grid_scene's 25 transformed instances", flush=True)
    grid_desc = load_scene(GRID_SCENE)
    grid_desc.camera.img_width, grid_desc.camera.img_height = 800, 600
    a_m, m_m = compile_scene(mesh_base, device="cuda")
    a_5, m_5 = compile_scene(ico5, device="cuda")
    a_g, m_g = compile_scene(grid_desc, device="cuda", world_bvh=False)
    check(not m_g.world_bvh and m_g.num_mesh_instances == 25
          and m_g.num_tris == 320, "grid_scene per instance: 25 instances "
          "of one 320-triangle tree")
    # 300 transformed instances of mesh_scene's icosphere (one mirrored),
    # scattered around it: more than one of W1's staged chunks.
    a_i, m_i = compile_scene(mesh_base, device="cuda", world_bvh=False)
    many_xf = torch.tensor(scatter_instances(
        a_i.kernel.inst_xf[0].cpu().numpy(), 300, 5), device="cuda")
    many_tabs = (a_i.mesh.pnodes, a_i.mesh.ltri,
                 a_i.instances.proot[:1].repeat(300).contiguous(), many_xf)
    w1_sets = {}
    w1_err = 0.0

    def w1_diff(got, want):
        # Largest |W1 - plain| over every output (ids and flags as
        # numbers); equal entries count 0, so a miss's t of BIG is no NaN.
        out = 0.0
        for x, y in zip(got, want):
            x, y = x.double(), y.double()
            out = max(out, torch.where(x == y, 0.0, (x - y).abs()).max()
                      .item())
        return out

    w1_ties = {}
    gp, gd, *_ = engine.generate_camera_rays(a_g, m_g, cpx, cpy, csid, None)
    for what, arr, meta, sets in (
            ("mesh_scene", a_m, m_m, (("random", rp, rd, rt),
                                      ("camera", cp, cd, None))),
            ("ico5", a_5, m_5, (("random", rp, rd, rt),
                              ("vertex", vp, vd, None),
                              ("camera", cp, cd, None))),
            ("grid 25 instances", a_g, m_g, (
                ("camera", gp.contiguous(), gd.contiguous(), None),
                ("random", *mesh_rays(1 << 20, 31)))),
            ("300 instances", a_i, m_i, (
                ("random", *mesh_rays(1 << 14, 37)), ))):
        tabs = ((arr.mesh.pnodes, arr.mesh.ltri, arr.instances.proot[:1],
                 None) if meta.world_bvh else
                many_tabs if what == "300 instances" else
                (arr.mesh.pnodes, arr.mesh.ltri, arr.instances.proot,
                 arr.kernel.inst_xf))
        stack = meta.bvh_depth + 2
        for name, p_, d_, t_ in sets:
            n_ = p_.shape[0]
            big = torch.full((n_,), BIG, device="cuda")
            work = torch.zeros((n_, 2), dtype=torch.int32, device="cuda")
            got = bvh_packed.closest(p_, d_, big, *tabs, stack_size=stack,
                                     work=work)
            want = bvh_packed.closest(p_, d_, big, *tabs, stack_size=stack,
                                      plain=True)
            torch.cuda.synchronize()
            w1_err = max(w1_err, w1_diff(got, want))
            check(all(torch.equal(x, y) for x, y in zip(got, want)),
                  f"W1 closest {what} {name} ({n_} rays): (t, instance, "
                  "triangle, bary, front) equal to the plain walk's, "
                  f"{int((got[2] >= 0).sum())} hits on "
                  f"{len(set(got[1][got[1] >= 0].tolist()))} instances")
            budget = t_ if t_ is not None else torch.full((n_,), 60.0,
                                                          device="cuda")
            occ_in = torch.arange(n_, device="cuda") % 7 == 0
            occ = bvh_packed.occluded(p_, d_, budget, occ_in, *tabs,
                                      stack_size=stack)
            occ_p = bvh_packed.occluded(p_, d_, budget, occ_in, *tabs,
                                        stack_size=stack, plain=True)
            w1_err = max(w1_err, w1_diff((occ, ), (occ_p, )))
            check(torch.equal(occ, occ_p), f"W1 any hit {what} {name}: "
                  f"occluded equal to the plain walk's ({int(occ.sum())})")
            if meta.world_bvh:
                # Exact ties in t (an edge or vertex two triangles share)
                # go to the triangle visited first; the dense sweep gives
                # them to the lower id. Lanes where the two differ on the
                # triangle but not on t:
                _, gid, _ = stream_closest(p_, d_, big, StreamTris(
                    arr.mesh.stream_coeff, arr.mesh.stream_const))
                t_e, *_, valid = exact_winner(p_, d_, gid, arr.mesh.tri_v)
                hit = got[2] >= 0
                ties = int((hit & valid & (gid != got[2])
                            & (t_e == got[0])).sum())
                off = int((hit & valid & (t_e != got[0])).sum())
                w1_ties[f"{what} {name}"] = ties
                print(f"  {what} {name}: {ties} exact-tie lanes where W1 and "
                      f"the dense sweep take different triangles; {off} "
                      "lanes where the sweep's winner has another t",
                      flush=True)
            w1_sets[f"{what} {name}"] = (p_, d_, tabs, stack)
    # The route switch itself: under QARAY_MESH_PATH=bvh, ops/trace walks
    # the world tree with W1 (one launch).
    os.environ["QARAY_MESH_PATH"] = "bvh"
    try:
        before = bvh_packed.launches["W1"]
        big = torch.full((cp.shape[0],), BIG, device="cuda")
        via = trace._mesh_closest(a_5, m_5, cp, cd, big)
        torch.cuda.synchronize()
    finally:
        os.environ.pop("QARAY_MESH_PATH", None)
    via_launches = bvh_packed.launches["W1"] - before
    direct = bvh_packed.closest(cp, cd, big, *w1_sets["ico5 camera"][2],
                                stack_size=w1_sets["ico5 camera"][3])
    check(via_launches == 1
          and all(torch.equal(x, y) for x, y in zip(via, direct)),
          "QARAY_MESH_PATH=bvh: ops/trace's world-mesh closest hit is one W1 "
          "launch")
    numbers["W1"] = {"max_abs_err": w1_err, "tie_lanes": w1_ties}
    torch.cuda.synchronize()

    # -- 3. the megakernel against the engine --------------------------------
    print("phase 3a: K1a vs the wavefront engine, softdof 200x150 x 2 spp",
          flush=True)
    small = load_scene(SCENE)
    small.camera.img_width, small.camera.img_height = 200, 150
    s_arr, s_meta = compile_scene(small, device="cuda")
    spx, spy, ssid = lanes(200, 150, 2)
    k1a_err = 0.0
    for integ in ("pathtrace", "photonmap"):
        cfg = IntegratorConfig(integrator=integ, max_bounce=4)
        rad_k, t0_k = megakernel.mega_render(s_arr, s_meta, cfg, spx, spy,
                                             ssid, (0, 3))
        rad_p, t0_p = render_batch_wavefront(s_arr, s_meta, cfg, spx, spy,
                                             ssid, (0, 3))
        k1a_err = max(k1a_err, compare_render(rad_p, t0_p, rad_k, t0_k,
                                              f"K1a {integ}"))
    torch.cuda.synchronize()

    print("phase 3b: K1a vs the wavefront engine at the main path's shapes, "
          "softdof 800x600, max_bounce 5", flush=True)
    scene = load_scene(SCENE)
    scene.camera.img_width, scene.camera.img_height = 800, 600
    m_arr, m_meta = compile_scene(scene, device="cuda")
    cfg_pm = Renderer(RendererParam(), device="cuda").integrator_config()
    cfg_pt = IntegratorConfig(integrator="pathtrace", max_bounce=5)
    rbg = key_words("rbg", RendererParam().seed)
    bpx, bpy, bsid = lanes(800, 600, 1)

    def plain_render(cfg, px, py, sid, words):
        """The engine in 65,536-lane batches; (radiance, t0, ms)."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        outs = [render_batch_wavefront(m_arr, m_meta, cfg, px[lo:lo + 65536],
                                       py[lo:lo + 65536], sid[lo:lo + 65536],
                                       words)
                for lo in range(0, px.shape[0], 65536)]
        end.record()
        end.synchronize()
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]), start.elapsed_time(end))

    plain_ms = None
    for what, cfg, (cpx, cpy, csid), words in (
            ("photonmap 960000 lanes rbg", cfg_pm, lanes(800, 600, 2), rbg),
            ("pathtrace 480000 lanes rbg", cfg_pt, (bpx, bpy, bsid), rbg),
            ("photonmap 480000 lanes sample 5 threefry", cfg_pm,
             (bpx, bpy, bsid + 5), (0, 3))):
        rad_k, t0_k = megakernel.mega_render(m_arr, m_meta, cfg, cpx, cpy,
                                             csid, words)
        rad_p, t0_p, ms_p = plain_render(cfg, cpx, cpy, csid, words)
        if cfg is cfg_pt:
            plain_ms = ms_p
        k1a_err = max(k1a_err, compare_render(rad_p, t0_p, rad_k, t0_k,
                                              f"K1a {what}"))
        del rad_k, t0_k, rad_p, t0_p
    numbers["K1a"] = {"max_abs_err": k1a_err}
    torch.cuda.synchronize()

    print("phase 3c: K1c vs the wavefront engine (which runs on K3), "
          "mesh_scene, its ico5 and mirror_scene", flush=True)
    k1c_err = 0.0
    mesh_bars = {"mesh": (2e-3, 5e-3, 2e-3), "ico5": (5e-3, 1e-2, 2e-3),
                 "mirror": (2e-3, 5e-3, 2e-3)}
    for what in ("mesh", "ico5", "mirror"):
        # mirror_scene: a mirror-instanced icosphere and no analytic
        # primitive at all.
        small = load_scene(MIRROR_SCENE if what == "mirror" else MESH_SCENE)
        if what == "ico5":
            small = with_mesh(small, *icosphere(5), name="ico5")
        small.camera.img_width, small.camera.img_height = 200, 150
        k_arr, k_meta = compile_scene(small, device="cuda")
        check(k_meta.mesh_mega, f"{what}: megakernel mesh tables")
        spx, spy, ssid = lanes(200, 150, 2)
        for integ in ("pathtrace", "photonmap"):
            cfg = IntegratorConfig(integrator=integ, max_bounce=3)
            rad_k, t0_k = megakernel.mega_render(k_arr, k_meta, cfg, spx, spy,
                                                 ssid, (0, 5))
            rad_p, t0_p = render_batch_wavefront(k_arr, k_meta, cfg, spx, spy,
                                                 ssid, (0, 5))
            k1c_err = max(k1c_err, compare_mesh_render(
                rad_p, t0_p, rad_k, t0_k, f"K1c {what} 200x150 {integ}",
                mesh_bars[what]))
    mesh_arr = {}
    for what, desc in (("mesh", mesh_base), ("ico5", ico5)):
        k_arr, k_meta = compile_scene(desc, device="cuda")
        mesh_arr[what] = (k_arr, k_meta)
        rad_k, t0_k = megakernel.mega_render(k_arr, k_meta, cfg_pm, bpx, bpy,
                                             bsid, rbg)
        rad_p, t0_p = render_batch_wavefront(k_arr, k_meta, cfg_pm, bpx, bpy,
                                             bsid, rbg)
        k1c_err = max(k1c_err, compare_mesh_render(
            rad_p, t0_p, rad_k, t0_k,
            f"K1c {what} 800x600 photonmap max_bounce 5 rbg", mesh_bars[what]))
        del rad_k, t0_k, rad_p, t0_p
    numbers["K1c"] = {"max_abs_err": k1c_err}
    torch.cuda.synchronize()

    print("phase 3d: K1b vs the wavefront engine with its texture stack, "
          "texture_scene and a two-slot variant", flush=True)
    tex_desc = load_scene(TEXTURE_SCENE)
    two_slot = with_texture(tex_desc, ("ballmtl", "specular"),
                            checker=((1.0, 0.2, 0.1), (0.1, 0.3, 1.0)),
                            scale=0.07, angle=30.0,
                            offset=(0.013, 0.027, 0.0))
    two_slot = with_texture(two_slot, ("floor", "diffuse"),
                            checker=((0.1,) * 3, (0.9,) * 3), scale=0.05,
                            angle=17.0, offset=(0.4, 0.3, 0.0))
    k1b_err = 0.0
    spx, spy, ssid = lanes(200, 150, 2)
    for what, desc in (("texture_scene", tex_desc), ("two-slot", two_slot)):
        desc.camera.img_width, desc.camera.img_height = 200, 150
        k_arr, k_meta = compile_scene(desc, device="cuda")
        check(k_meta.mega_tex_ok and k_arr.kernel.mtl.shape[1] == 102,
              f"{what}: checker columns in the kernel's material table, "
              f"slots {k_meta.mega_tex_slots}")
        for integ in ("pathtrace", "photonmap"):
            cfg = IntegratorConfig(integrator=integ, max_bounce=4)
            before = megakernel.launches["K1b"]
            rad_k, t0_k = megakernel.mega_render(k_arr, k_meta, cfg, spx, spy,
                                                 ssid, (0, 3))
            check(megakernel.launches["K1b"] == before + 1,
                  "the textured kernel was launched")
            rad_p, t0_p = render_batch_wavefront(k_arr, k_meta, cfg, spx, spy,
                                                 ssid, (0, 3))
            k1b_err = max(k1b_err, compare_tex_render(
                rad_p, t0_p, rad_k, t0_k, f"K1b {what} 200x150 {integ}"))
    tex_desc.camera.img_width, tex_desc.camera.img_height = 800, 600
    t_arr, t_meta = compile_scene(tex_desc, device="cuda")
    rad_k, t0_k = megakernel.mega_render(t_arr, t_meta, cfg_pm, bpx, bpy,
                                         bsid, rbg)
    rad_p, t0_p = render_batch_wavefront(t_arr, t_meta, cfg_pm, bpx, bpy,
                                         bsid, rbg)
    k1b_err = max(k1b_err, compare_tex_render(
        rad_p, t0_p, rad_k, t0_k,
        "K1b texture_scene 800x600 photonmap max_bounce 5 rbg"))
    del rad_k, t0_k, rad_p, t0_p
    numbers["K1b"] = {"max_abs_err": k1b_err}
    torch.cuda.synchronize()

    print("phase 3e: K1a+K1d vs the wavefront engine with its exact gathers, "
          "caustics_scene with the default maps", flush=True)

    def plain_photon(arr, meta_, cfg, px, py, sid, words, maps):
        """The engine with exact gathers in 65,536-lane batches:
        ((radiance, t0, irr0), ms)."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        outs = [render_batch_wavefront(arr, meta_, cfg, px[lo:lo + 65536],
                                       py[lo:lo + 65536], sid[lo:lo + 65536],
                                       words, photon_maps=maps,
                                       want_aux=True)
                for lo in range(0, px.shape[0], 65536)]
        end.record()
        end.synchronize()
        return (tuple(torch.cat([o[k] for o in outs]) for k in range(3)),
                start.elapsed_time(end))

    k1d_err = 0.0
    small = with_glass(load_scene(SCENE), "mid")
    small.camera.img_width, small.camera.img_height = 200, 150
    sc_arr, sc_meta = compile_scene(small, device="cuda")
    spx, spy, ssid = lanes(200, 150, 2)
    cfg_small = IntegratorConfig(integrator="photonmap", max_bounce=4,
                                 use_photon_map=True)
    blown = tuple(m._replace(radius=torch.tensor(50.0)) for m in pmaps)
    # The control of compare_photon_render: the global map with an empty
    # caustics map.
    no_caustics = (pmaps[0], cluster_photon_map(
        cmap._replace(valid=torch.zeros_like(cmap.valid))))
    for what, maps in (("200x150 x 2 threefry", pmaps),
                       ("200x150 x 2 threefry, both radii 50", blown)):
        rad_k, t0_k, irr_k, esc = megakernel.mega_render(
            sc_arr, sc_meta, cfg_small, spx, spy, ssid, (0, 3),
            photon_maps=maps)
        ref, _ = plain_photon(sc_arr, sc_meta, cfg_small, spx, spy, ssid,
                              (0, 3), maps)
        if maps is blown:
            share = esc.double().mean().item()
            rel = ((ref[0] - rad_k).abs().amax(-1)
                   / (1.0 + ref[0].abs().amax(-1)))[~esc]
            check(share > 0.3, f"K1d {what}: escalated share {share:.4f} > "
                  "0.3")
            off = int((rel > 1e-3).sum().item())
            check(off == 0, f"K1d {what}: no unflagged lane off ({off})")
        else:
            ctl = megakernel.mega_render(sc_arr, sc_meta, cfg_small, spx,
                                         spy, ssid, (0, 3),
                                         photon_maps=no_caustics)[0]
            k1d_err = max(k1d_err, compare_photon_render(
                ref, (rad_k, t0_k, irr_k), esc, f"K1d {what}", ctl))
    for what, words in (("threefry", (0, 3)), ("rbg", rbg)):
        out = megakernel.mega_render(c_arr, c_meta, cfg_photon, bpx, bpy,
                                     bsid, words, photon_maps=pmaps)
        ctl = megakernel.mega_render(c_arr, c_meta, cfg_photon, bpx, bpy,
                                     bsid, words, photon_maps=no_caustics)[0]
        ref, photon_plain_ms = plain_photon(c_arr, c_meta, cfg_photon, bpx,
                                            bpy, bsid, words, pmaps)
        k1d_err = max(k1d_err, compare_photon_render(
            ref, out[:3], out[3], f"K1d 800x600 photonmap max_bounce 5 "
            f"{what}", ctl))
        del out, ref, ctl
    numbers["K1d"] = {"max_abs_err": k1d_err}
    torch.cuda.synchronize()

    print("phase 3f: K6 vs adjoint_render_plain at 200x150, max_bounce 5, "
          "threefry: spot_scene, mesh_scene, the glass scene", flush=True)
    cfg_g = IntegratorConfig(integrator="pathtrace", max_bounce=5,
                             shadow_spp=16)

    def grad_desc(what, w, h):
        if what == "glass":
            desc = with_glass(load_scene(SCENE), "mid")
            desc.camera.depth_of_field = 0.0
        else:
            desc = load_scene(SPOT_SCENE if what == "spot" else MESH_SCENE)
        desc.camera.img_width, desc.camera.img_height = w, h
        return desc

    gpx, gpy, gsid = lanes(200, 150, 1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    k6_err = 0.0
    for what in ("spot", "mesh", "glass"):
        g_arr, g_meta = compile_scene(grad_desc(what, 200, 150),
                                      device="cuda")
        check(adjoint.adjoint_supported(g_meta, cfg_g),
              f"{what}: the fused adjoint serves it")
        ct = torch.randn((gpx.shape[0], 3), device="cuda", generator=gen)
        got = adjoint.adjoint_render(g_arr, g_meta, cfg_g, gpx, gpy, gsid,
                                     (0, 3), ct)
        want = adjoint.adjoint_render_plain(g_arr, g_meta, cfg_g, gpx, gpy,
                                            gsid, (0, 3), ct)
        errs = grad_field_errors(diff._unpack_adjoint(got, g_meta, g_arr),
                                 diff._unpack_adjoint(want, g_meta, g_arr))
        print(f"  K6 {what}: " + ", ".join(f"{k} {v:.3g}"
                                          for k, v in errs.items()),
              flush=True)
        check(bool(got.isfinite().all()) and max(errs.values()) < K6_BAR,
              f"K6 {what}: every field within {K6_BAR:g} of its max|b| "
              f"(worst {max(errs.values()):.3g})")
        k6_err = max(k6_err, (got - want).abs().max().item())
        check(torch.equal(got, adjoint.adjoint_render(
            g_arr, g_meta, cfg_g, gpx, gpy, gsid, (0, 3), ct)),
            f"K6 {what}: a second launch gives the same bits")
    numbers["K6"] = {"max_abs_err": k6_err}

    print("phase 3f: render_batch's gradients on the megakernel route vs "
          "render_with_params', spot_scene 200x150", flush=True)
    g_arr, g_meta = compile_scene(grad_desc("spot", 200, 150), device="cuda")
    params = diff.DiffParams(*(t.detach().requires_grad_()
                               for t in diff.extract_params(g_arr)))
    ct = torch.rand((gpx.shape[0], 3), device="cuda", generator=gen)
    before = megakernel.launches["K1a"]
    rad_g, _ = render_batch(diff.splice_params(g_arr, params), g_meta, cfg_g,
                            gpx, gpy, gsid, (0, 3))
    check(megakernel.launches["K1a"] == before + 1
          and rad_g.grad_fn is not None,
          "render_batch launched K1a and its radiance carries a gradient")
    got = diff.DiffParams(*torch.autograd.grad(
        (rad_g * ct).sum(), params, allow_unused=True))
    rad_w = diff.render_with_params(g_arr, g_meta, cfg_g, params, gpx, gpy,
                                    gsid, (0, 3))
    want = diff.DiffParams(*torch.autograd.grad(
        (rad_w * ct).sum(), params, allow_unused=True))
    zero = diff.DiffParams(*(torch.zeros_like(p) for p in params))
    errs = grad_field_errors(
        diff.DiffParams(*(z if g is None else g for z, g in zip(zero, got))),
        diff.DiffParams(*(z if g is None else g for z, g in zip(zero, want))))
    check(max(errs.values()) < 1e-4, "render_batch gradients equal "
          f"render_with_params' (worst field {max(errs.values()):.3g} < "
          "1e-4 of max|b|)")
    del params, rad_g, rad_w
    torch.cuda.synchronize()
    g1_phase(numbers)
    h1_phase(numbers)

    # -- 4. the main path ----------------------------------------------------
    os.environ.pop("QARAY_EAGER", None)
    counters = (analytic.launches, megakernel.launches, mesh_sweep.launches,
                tiles.launches, photon.launches, adjoint.launches,
                bvh_packed.launches, mtl_gather.launches, threefry.launches)
    forbid = ForbidPlain(
        (analytic, "closest_plain"), (analytic, "closest_full_plain"),
        (analytic, "shadow_plain"), (mesh_sweep, "stream_closest"),
        (mesh_sweep, "stream_any_hit"), (tiles, "walk_plain"),
        (photon, "photon_gather_plain"), (bvh_packed, "traverse_bvh_packed"),
        (mtl_gather, "gather_bwd_plain"), (krng, "cipher2x32", on_cuda))

    def reset_counts():
        for counts in counters:
            for k in counts:
                counts[k] = 0
        engine.wavefront_lanes = 0

    def read_counts():
        out = {}
        for counts in counters:
            out.update(counts)
        out["wavefront_lanes"] = engine.wavefront_lanes
        return out

    def render_main(what, desc, param, no_mega=False, max_mean=10.0,
                    world_bvh=True, mesh=None):
        """One Renderer.render() on the main path (over `mesh`, where one
        is given): counts set to 0 just before and read just after, plain
        versions refused. Returns (frame buffer, wall seconds, counts,
        renderer)."""
        reset_counts()
        if no_mega:
            os.environ["QARAY_NO_MEGAKERNEL"] = "1"
        try:
            with forbid:
                r = Renderer(param, device="cuda", mesh=mesh)
                r.compute_scene(desc, world_bvh=world_bvh)
                torch.cuda.synchronize()
                t = time.time()
                fb = r.render()
                torch.cuda.synchronize()
                wall = time.time() - t
        finally:
            os.environ.pop("QARAY_NO_MEGAKERNEL", None)
        counts = read_counts()
        rays = int(fb.count.sum())
        print(f"  {what}: Renderer wall {wall:.4f} s, {rays} primary rays, "
              f"{rays / wall:.4e} primary rays/s, spp per pixel "
              f"{fb.count.min()}..{fb.count.max()} "
              f"(mean {fb.count.mean():.3f})", flush=True)
        print(f"  launch counts: {json.dumps(counts)}", flush=True)
        if counts["wavefront_lanes"]:
            check(counts["H1"] > 0, f"H1 launched {counts['H1']} times for "
                  "the wavefront engine's draws")
        check(fb.img.shape == (800 * 600, 3), "colour buffer is 800x600x3")
        check(bool(np.isfinite(fb.mean).all()), "radiance finite")
        check(0.0 < float(fb.mean.mean()) < max_mean,
              f"mean radiance {float(fb.mean.mean()):.4f} plausible")
        check(param.spp_min <= fb.count.min()
              and fb.count.max() <= param.spp_max,
              f"spp within {param.spp_min}..{param.spp_max}")
        return fb, wall, counts, r

    # The sizes of K2c's launches over 4a-4m: a wavefront batch's hard
    # shadow rays (one a lane), its soft-shadow rays (16 a lane) and their
    # 48 more on escalation.
    k2c_sizes = {}
    shadow_fn = analytic.shadow

    # Under capture (utils/compiled.py) these hooks see the calls Python
    # runs, the warm-ups and the eager ones: a replay runs no Python. They
    # do nothing while a graph is being captured.
    def shadow_sized(p_, d_, t_, prims_, **kw):
        if (p_.is_cuda and p_.shape[0]
                and not torch.cuda.is_current_stream_capturing()):
            k2c_sizes[p_.shape[0]] = k2c_sizes.get(p_.shape[0], 0) + 1
        return shadow_fn(p_, d_, t_, prims_, **kw)

    analytic.shadow = shadow_sized

    # The sizes of K2b's launches over 4a-4m, and the rays of the first two
    # launches (a batch's bounces 0 and 1) at the largest size so far and at
    # 65,536 rays (a wavefront batch), with their primitives, for phase 5.
    k2b_sizes, k2b_rays = {}, {}
    full_fn = analytic.closest_full

    def full_sized(p_, d_, prims_, **kw):
        n_ = p_.shape[0]
        if p_.is_cuda and n_ and not torch.cuda.is_current_stream_capturing():
            k2b_sizes[n_] = k2b_sizes.get(n_, 0) + 1
            keep = (max(k2b_sizes), 65536)
            for m in [m for m in k2b_rays if m not in keep]:
                del k2b_rays[m]
            if n_ in keep and len(k2b_rays.setdefault(n_, [])) < 2:
                k2b_rays[n_].append((p_.contiguous().clone(),
                                     d_.contiguous().clone(), prims_))
        return full_fn(p_, d_, prims_, **kw)

    analytic.closest_full = full_sized

    # Escalated lanes, and the lanes of their re-renders (padded to their
    # buckets, as every dispatch is).
    escalated, escalated_padded = [0], [0]
    render_escalated = Renderer._render_escalated

    def count_escalated(self, ids, sids, esc):
        fixed = render_escalated(self, ids, sids, esc)
        escalated[0] += 0 if fixed is None else fixed[0].size
        escalated_padded[0] += 0 if fixed is None else fixed[3].shape[0]
        return fixed

    Renderer._render_escalated = count_escalated

    print("phase 4a: Renderer, softdof 800x600, defaults", flush=True)
    fb, wall, _, renderer = render_main("softdof", scene, RendererParam())
    fb_a = fb
    with tempfile.TemporaryDirectory() as out_dir:
        prefix = os.path.join(out_dir, "smoke_")
        fb.save_image(prefix + "colorBuffer.png")
        fb.save_z_image(prefix + "depthBuffer.png")
        fb.save_sample_count_image(prefix + "sampleBuffer.png")
        sizes = [os.path.getsize(prefix + f) for f in (
            "colorBuffer.png", "depthBuffer.png", "sampleBuffer.png")]
    check(min(sizes) > 100, f"PNGs written ({sizes} bytes)")
    s_arr, s_meta = renderer.scene_arrays, renderer.meta
    torch.cuda.synchronize()
    with forbid:
        t = time.time()
        rad_b, t0_b = render_batch(s_arr, s_meta, cfg_pt, bpx, bpy, bsid,
                                   rbg)
        torch.cuda.synchronize()
        wall_b = time.time() - t
    check(rad_b.shape == (480000, 3) and bool(rad_b.isfinite().all()),
          "render_batch radiance [480000, 3] finite")
    print(f"  render_batch pathtrace 480000 lanes: wall {wall_b:.4f} s, "
          f"{480000 / wall_b:.4e} primary rays/s", flush=True)
    counts_a = read_counts()
    print(f"  launch counts: {json.dumps(counts_a)}", flush=True)
    check(counts_a["K1a"] > 0, f"K1a launched {counts_a['K1a']} times")
    check(counts_a["wavefront_lanes"] == 0, "no lane on the wavefront engine")

    print("phase 4b: wavefront route (QARAY_NO_MEGAKERNEL), 800x600 x 1 spp",
          flush=True)
    fb_wf, _, counts_b, _ = render_main(
        "softdof wavefront", scene,
        RendererParam(spp_min=1, spp_max=1, batch_pixels=1 << 16),
        no_mega=True)
    check(counts_b["K2b"] > 0 and counts_b["K2c"] > 0,
          "K2b and K2c launched on the wavefront route")
    check(counts_b["K1a"] == 0, "no K1a launch on the wavefront route")

    print("phase 4c: Renderer, mesh_scene 800x600 (320 triangles), defaults",
          flush=True)
    _, _, counts_c, _ = render_main("mesh_scene", mesh_base, RendererParam())
    check(counts_c["K1c"] > 0 and counts_c["K1c"] == counts_c["K1a"],
          f"K1a launched {counts_c['K1a']} times, all with the mesh sweep")
    check(counts_c["wavefront_lanes"] == 0, "no lane on the wavefront engine")

    print("phase 4d: Renderer, mesh_scene with ico5 (20,480 triangles) "
          "800x600, defaults", flush=True)
    _, _, counts_d, _ = render_main("ico5", ico5, RendererParam())
    check(counts_d["K1c"] > 0 and counts_d["K1c"] == counts_d["K1a"],
          f"K1a launched {counts_d['K1a']} times, all with the mesh sweep")
    check(counts_d["wavefront_lanes"] == 0, "no lane on the wavefront engine")

    print("phase 4e: Renderer, mesh_scene with ico6 (81,920 triangles) "
          "800x600 x 1 spp: the wavefront route", flush=True)
    _, _, counts_e, _ = render_main("ico6", ico6,
                                    RendererParam(spp_min=1, spp_max=1))
    check(counts_e["K4a"] > 0 and counts_e["K4b"] > 0,
          f"K4a launched {counts_e['K4a']} times, K4b {counts_e['K4b']}")
    check(counts_e["K1a"] == 0 and counts_e["K3"] == 0,
          "no K1a or K3 launch above 65,536 triangles")

    print("phase 4f: Renderer, mesh_scene 800x600 x 1 spp under "
          "QARAY_NO_MEGAKERNEL: the dense route (K3's walk)", flush=True)
    _, _, counts_f, _ = render_main("mesh_scene wavefront", mesh_base,
                                    RendererParam(spp_min=1, spp_max=1),
                                    no_mega=True)
    check(counts_f["K3"] > 0, f"K3 launched {counts_f['K3']} times")
    check(counts_f["K1a"] == 0 and counts_f["K4a"] == 0,
          "no K1a or K4a launch on the dense route")

    print("phase 4g: Renderer, texture_scene 800x600, defaults: the "
          "megakernel with checker textures", flush=True)
    _, _, counts_g, _ = render_main("texture_scene", tex_desc,
                                    RendererParam())
    check(counts_g["K1b"] > 0 and counts_g["K1b"] == counts_g["K1a"],
          f"K1a launched {counts_g['K1a']} times, all with K1b's textures")
    check(counts_g["wavefront_lanes"] == 0, "no lane on the wavefront engine")

    # One 480,000-lane batch a bounce (the Renderer's default batch size):
    # these scenes' hard lights need none of softdof's 64 shadow samples a
    # lane, which is what phase 4b's smaller batches make room for.
    wave_1spp = RendererParam(spp_min=1, spp_max=1)
    print("phase 4h: texture_scene 800x600 x 1 spp under "
          "QARAY_NO_MEGAKERNEL: the wavefront route with the texture stack",
          flush=True)
    _, _, counts_h, _ = render_main("texture_scene wavefront", tex_desc,
                                    wave_1spp, no_mega=True)
    check(counts_h["K2b"] > 0 and counts_h["K2c"] > 0,
          f"K2b launched {counts_h['K2b']} times, K2c {counts_h['K2c']}")
    check(counts_h["K1a"] == 0 and counts_h["K1b"] == 0,
          "no megakernel launch on the wavefront route")

    print("phase 4i: spot_scene with a file texture on a material, the "
          "background and the environment, 800x600 x 1 spp", flush=True)
    image = load_image(IMAGE)
    file_desc = load_scene(SPOT_SCENE)
    file_desc = with_texture(file_desc,
                             (file_desc.materials[0].name, "diffuse"),
                             image=image, color=(1.0, 1.0, 1.0), scale=0.5)
    file_desc = with_texture(file_desc, "background", image=image,
                             color=(1.0, 0.9, 0.8))
    file_desc = with_texture(file_desc, "environment", image=image,
                             color=(0.8, 0.9, 1.0), scale=0.5, angle=25.0)
    file_desc.camera.img_width, file_desc.camera.img_height = 800, 600
    _, _, counts_i, r_file = render_main("file textures", file_desc,
                                         wave_1spp)
    fm = r_file.meta
    check(fm.has_mtl_textures and fm.has_bg_texture and fm.has_env_texture
          and not fm.mega_tex_ok, "file textures on a material, the "
          "background and the environment")
    check(counts_i["K2b"] > 0 and counts_i["K1a"] == 0,
          f"K2b launched {counts_i['K2b']} times, no megakernel launch")
    file_desc.camera.img_width, file_desc.camera.img_height = 200, 150
    cfg_f = IntegratorConfig(integrator="photonmap", max_bounce=3)
    outs = []
    for dev in ("cuda", "cpu"):
        f_arr, f_meta = compile_scene(file_desc, device=dev)
        fpx, fpy, fsid = lanes(200, 150, 1, device=dev)
        rad_f, t0_f = render_batch_wavefront(f_arr, f_meta, cfg_f, fpx, fpy,
                                             fsid, (0, 3))
        outs.append((rad_f.cpu(), t0_f.cpu()))
    compare_render(*outs[1], *outs[0], "file textures 200x150, card vs CPU")
    miss = outs[0][1] > 1e29
    check(bool(miss.any()) and outs[0][0][miss].std().item() > 0.02,
          "the background shows the image")

    print("phase 4j: basic, phong and mcgi on spot_scene 800x600 x 1 spp: "
          "the wavefront route", flush=True)
    spot_desc = load_scene(SPOT_SCENE)
    spot_desc.camera.img_width, spot_desc.camera.img_height = 800, 600
    counts_j = []
    for integ in ("basic", "phong", "mcgi"):
        # Without falloff (basic, phong) the spot's intensity of 400
        # arrives undimmed: a bright image, as in the reference.
        _, _, c_j, _ = render_main(
            integ, spot_desc, RendererParam(
                integrator=integ, spp_min=1, spp_max=1),
            max_mean=10.0 if integ == "mcgi" else 1e4)
        check(c_j["K2b"] > 0 and c_j["K2c"] > 0 and c_j["K1a"] == 0,
              f"{integ}: K2b launched {c_j['K2b']} times, K2c {c_j['K2c']}, "
              "no megakernel launch")
        counts_j.append(c_j)

    print("phase 4k: Renderer, caustics_scene 800x600, -use-photon-map "
          "defaults", flush=True)
    with tempfile.TemporaryDirectory() as wd, contextlib.chdir(wd):
        escalated[0] = escalated_padded[0] = 0
        fb_k, wall_k, counts_k, r_k = render_main(
            "caustics_scene photon map", caus_desc, p_photon)
        files = {n_: os.path.getsize(os.path.join(wd, n_))
                 for n_ in ("photonmap.dat", "caustics.dat")}
        fb_k.save_irradiance_image(os.path.join(wd, "irr.png"))
    rays_k = int(fb_k.count.sum())
    gk, ck = r_k.photon_maps
    print(f"  maps: {int(gk.valid.sum())} global and {int(ck.valid.sum())} "
          f"caustics photons; files {json.dumps(files)}; escalated lanes "
          f"{escalated[0]} of {rays_k} ({escalated[0] / rays_k:.6g}); "
          f"irradiance plane {(fb_k.irrad > 0).mean():.4f} of pixels",
          flush=True)
    check(files == {"photonmap.dat": 26 * int(gk.valid.sum()),
                    "caustics.dat": 26 * int(ck.valid.sum())},
          "photonmap.dat and caustics.dat written in the working directory")
    check(counts_k["K1d"] > 0 and counts_k["K1d"] == counts_k["K1a"]
          and counts_k["K5"] == counts_k["K1d"],
          f"K1a launched {counts_k['K1a']} times, all with K1d, and K5 "
          f"{counts_k['K5']} times")
    check(counts_k["wavefront_lanes"] == escalated_padded[0],
          "only the escalated lanes (padded to their buckets, "
          f"{escalated_padded[0]} lanes) on the wavefront engine")
    check(counts_k["H1"] > 0, f"H1 launched {counts_k['H1']} times (the "
          "photon tracing in set-up and the escalated lanes)")
    check(0.0 < (fb_k.irrad > 0).mean() < 1.0, "irradiance plane filled")

    print("phase 4l: caustics_scene 800x600 x 1 spp, -use-photon-map, under "
          "QARAY_NO_MEGAKERNEL: the exact gathers on the wavefront route",
          flush=True)
    with tempfile.TemporaryDirectory() as wd, contextlib.chdir(wd):
        _, wall_l, counts_l, _ = render_main(
            "caustics_scene photon map wavefront", caus_desc,
            RendererParam(use_photon_map=True, spp_min=1, spp_max=1,
                          batch_pixels=1 << 16), no_mega=True)
    check(counts_l["K2b"] > 0 and counts_l["K1a"] == 0
          and counts_l["K5"] == 0,
          f"K2b launched {counts_l['K2b']} times, no K1a or K5 launch")
    Renderer._render_escalated = render_escalated

    print("phase 4m: the gradient path, render_value_and_grad at 800x600, "
          "max_bounce 5, shadow_spp 16, rbg", flush=True)
    cfg_gp = IntegratorConfig(integrator="pathtrace", max_bounce=5,
                              shadow_spp=16)
    forbid_grad = ForbidPlain(*forbid.targets,
                              (adjoint, "adjoint_render_plain"))
    grad_cells = {}

    grad_steps = {}

    def grad_path(what, batch, no_mega, rounds):
        """bench.py's _grad_bench: `rounds` steps of render_value_and_grad
        on `batch` lanes, one sample index a step, after a warm-up step;
        counts set to 0 just before and read just after, plain versions
        refused. Keeps the step for phase 5's idle share. Returns (counts,
        (loss, grads) of the step at sample index 1, the first timed one,
        the scene and its lanes)."""
        g_arr, g_meta = compile_scene(grad_desc(what, 800, 600),
                                      device="cuda")
        ids = torch.arange(batch, device="cuda", dtype=torch.int32)
        gx, gy = ids % 800, (ids // 800) % 600

        def step(s):
            return diff.render_value_and_grad(
                g_arr, g_meta, cfg_gp, gx, gy, torch.full_like(ids, s), rbg)

        reset_counts()
        if no_mega:
            os.environ["QARAY_NO_MEGAKERNEL"] = "1"
        try:
            with forbid_grad:
                caps = [compiled.stats["captures"]]
                step(0)
                torch.cuda.synchronize()
                caps.append(compiled.stats["captures"])
                h1 = threefry.launches["H1"], dict(threefry.stats)
                t = time.time()
                outs = [step(s) for s in range(1, rounds + 1)]
                torch.cuda.synchronize()
                wall = time.time() - t
                h1 = ((threefry.launches["H1"] - h1[0]) / rounds,
                      {k: (v - h1[1][k]) / rounds
                       for k, v in threefry.stats.items()})
                caps = [caps[1] - caps[0],
                        compiled.stats["captures"] - caps[1]]
                counts = read_counts()
        finally:
            os.environ.pop("QARAY_NO_MEGAKERNEL", None)
        route = "autograd" if no_mega else "fast"
        rate = rounds * batch / wall
        loss, grads = outs[0]
        print(f"  {what} {route} route, {batch} lanes: {rounds} steps in "
              f"{wall:.4f} s, {rate:.4e} forward+backward paths/s; "
              f"captured (utils/compiled.py): {caps[0]} captures in the "
              f"first step, {caps[1]} in the timed steps", flush=True)
        check(caps[1] == 0, f"{what} {route}: the timed steps replay the "
              "step's graph, capturing nothing")
        print(f"  launch counts: {json.dumps(counts)}; a timed step (a "
              f"replay): {h1[0]:g} H1 launches, {json.dumps(h1[1])}",
              flush=True)
        if no_mega:
            check(h1[0] > 0, f"{what} {route}: H1 launched {h1[0]:g} times "
                  "a step")
        check(bool(torch.isfinite(loss)) and all(
            bool(g.isfinite().all()) for g in grads),
            f"{what} {route}: loss {float(loss):.6g} and gradients finite")
        grad_cells[(what, route)] = dict(paths_per_s=rate, wall_s=wall)
        grad_steps[(what, route)] = (lambda: step(rounds + 1), no_mega)
        del outs
        return counts, (loss, grads), (g_arr, g_meta, gx, gy)

    counts_m = []
    g_path = {}
    for what, batch in (("spot", 1 << 18), ("mesh", 1 << 17)):
        c_fast, out_fast, g_path[what] = grad_path(what, batch, False, 5)
        check(c_fast["K1a"] > 0 and c_fast["K6"] == c_fast["K1a"]
              and c_fast["wavefront_lanes"] == 0,
              f"{what} fast route: K1a and K6 launched {c_fast['K6']} times "
              "each, no lane on the wavefront engine")
        if what == "mesh":
            check(c_fast["K1c"] == c_fast["K1a"], "every K1a launch swept "
                  "the mesh (K1c)")
        c_auto, out_auto, _ = grad_path(what, batch, True, 2)
        check(c_auto["K6"] == 0 and c_auto["K1a"] == 0
              and c_auto["K2b"] > 0 and c_auto["K2c"] > 0
              and (what != "mesh" or c_auto["K3"] > 0),
              f"{what} autograd route: K2b {c_auto['K2b']}, K2c "
              f"{c_auto['K2c']}, K3 {c_auto['K3']} launches, no K1a or K6")
        counts_m += [c_fast, c_auto]
        errs = grad_field_errors(out_fast[1], out_auto[1])
        errs.pop("texture_texels", None)
        print(f"  {what} fast vs autograd route: " + ", ".join(
            f"{k} {v:.3g}" for k, v in errs.items()), flush=True)
        check(max(errs.values()) < K6_BAR, f"{what}: the routes' gradients "
              f"within {K6_BAR:g} of each field's max|b|")
        del out_fast, out_auto
    torch.cuda.synchronize()

    print("phase 4n: mesh_scene and ico5 800x600 x 1 spp under "
          "QARAY_NO_MEGAKERNEL and QARAY_MESH_PATH=bvh: the world tree on "
          "W1", flush=True)
    counts_n = []
    os.environ["QARAY_MESH_PATH"] = "bvh"
    try:
        for what, desc in (("mesh_scene", mesh_base), ("ico5", ico5)):
            _, _, c_n, _ = render_main(f"{what} bvh route", desc,
                                       RendererParam(spp_min=1, spp_max=1),
                                       no_mega=True)
            check(c_n["W1"] > 0 and c_n["K3"] == 0 and c_n["K1a"] == 0,
                  f"{what}: W1 launched {c_n['W1']} times, no K3 or K1a")
            counts_n.append(c_n)
    finally:
        os.environ.pop("QARAY_MESH_PATH", None)

    # W1's launches on the per-instance routes by rays, and the inputs of
    # the first closest-hit and any-hit launches at the largest size of
    # each kind, for phase 5 (w1_rays[kind]: p, d, t, occ_in, tables,
    # keywords).
    w1_sizes, w1_rays = {}, {}
    w1_closest, w1_occluded = bvh_packed.closest, bvh_packed.occluded

    def w1_keep(kind, p_, d_, t_, occ_, tabs_, kw):
        if torch.cuda.is_current_stream_capturing():
            return
        n_ = p_.shape[0]
        w1_sizes[(kind, n_)] = w1_sizes.get((kind, n_), 0) + 1
        if kind not in w1_rays or n_ > w1_rays[kind][0].shape[0]:
            w1_rays[kind] = (p_.clone(), d_.clone(), t_.clone(),
                             None if occ_ is None else occ_.clone(), tabs_,
                             kw)

    def w1_closest_sized(p_, d_, t_, *tabs_, **kw):
        w1_keep("closest", p_, d_, t_, None, tabs_, kw)
        return w1_closest(p_, d_, t_, *tabs_, **kw)

    def w1_occluded_sized(p_, d_, t_, occ_, *tabs_, **kw):
        w1_keep("any hit", p_, d_, t_, torch.zeros(
            p_.shape[0], dtype=torch.bool, device=p_.device)
            if occ_ is None else occ_, tabs_, kw)
        return w1_occluded(p_, d_, t_, occ_, *tabs_, **kw)

    bvh_packed.closest, bvh_packed.occluded = (w1_closest_sized,
                                               w1_occluded_sized)
    print("phase 4o: Renderer, grid_scene 800x600 (25 instances of a "
          "320-triangle mesh), defaults: per instance (W1) against the world "
          "route", flush=True)
    fb_ow, wall_ow, counts_ow, _ = render_main("grid_scene world",
                                               grid_desc, RendererParam())
    fb_oi, wall_oi, counts_oi, _ = render_main(
        "grid_scene per instance", grid_desc, RendererParam(),
        world_bvh=False)
    check(counts_oi["W1"] > 0 and counts_oi["K1a"] == 0
          and counts_oi["K3"] == 0, f"per instance: W1 launched "
          f"{counts_oi['W1']} times (K2b {counts_oi['K2b']}, K2c "
          f"{counts_oi['K2c']}), no K1a or K3")
    a_ = np.asarray(fb_ow.img, np.float32) / 255.0
    b_ = np.asarray(fb_oi.img, np.float32) / 255.0
    frac = float((np.abs(a_ - b_).max(axis=-1) > 2 / 255.0).mean())
    check(frac < 0.005, f"grid_scene: {frac:.6f} of pixels differ by more "
          "than 2/255 between the routes (< 0.005)")
    bvh_packed.closest, bvh_packed.occluded = w1_closest, w1_occluded
    print("  W1's launches in 4o by kind and rays: " + ", ".join(
        f"{k} {n} x {c}" for (k, n), c in sorted(w1_sizes.items())),
        flush=True)
    w1_4o = dict(w1_rays)

    print("phase 4p: a 5x5 grid of ico5 instances (grid_scene with "
          "procedural.with_shared_mesh) 800x600 x 1 spp: 20,480 triangles "
          "kept once (W1) against 512,000 baked (the tiled route)",
          flush=True)
    grid5 = with_shared_mesh(grid_desc, *icosphere(5), name="ico5")
    counts_p = []
    grid5_cells = {}
    for world in (False, True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        t = time.time()
        r5 = Renderer(RendererParam(spp_min=1, spp_max=1), device="cuda")
        r5.compute_scene(grid5, world_bvh=world)
        t_compile = time.time() - t
        what = "baked" if world else "per instance"
        check(r5.meta.num_tris == (512000 if world else 20480),
              f"grid of ico5 {what}: {r5.meta.num_tris} triangles")
        # The warm-up render keeps the per-instance route's largest
        # closest-hit launch for phase 5.
        w1_rays.clear()
        bvh_packed.closest, bvh_packed.occluded = (w1_closest_sized,
                                                   w1_occluded_sized)
        try:
            r5.render()  # warm-up
        finally:
            bvh_packed.closest, bvh_packed.occluded = (w1_closest,
                                                       w1_occluded)
        if not world:
            w1_4p = w1_rays["closest"]
        r5.fb = FrameBuffer(800, 600)
        flush_profiler()
        reset_counts()
        with forbid, torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t = time.time()
            fb5 = r5.render()
            torch.cuda.synchronize()
            wall5 = (time.time() - t) * 1e3
        c_p = read_counts()
        busy5 = sum(device_us(e) for e in prof.key_averages()) / 1e3
        mem = (torch.cuda.max_memory_allocated() - base_mem) / 2**20
        grid5_cells[what] = dict(compile_s=t_compile, wall_ms=wall5,
                                 busy_ms=busy5, idle_share=1 - busy5 / wall5,
                                 peak_mib=mem)
        print(f"  {what}: compile {t_compile:.3f} s, wall {wall5:.3f} ms, "
              f"device busy {busy5:.3f} ms, idle share "
              f"{1 - busy5 / wall5:.4f}, peak memory {mem:.1f} MiB above "
              f"the start; launches {json.dumps(c_p)}", flush=True)
        check(bool(np.isfinite(fb5.mean).all()) and fb5.mean.mean() > 0,
              f"{what}: radiance finite and not black")
        for key in ("W1", "H1") if not world else ("K4a",):
            check(c_p[key] > 0, f"{what}: {key} launched {c_p[key]} times")
        counts_p.append(c_p)
        del r5, fb5
    numbers["W1"]["grid5"] = grid5_cells

    print("phase 4q: checkpoints: softdof 800x600, threefry, "
          "checkpoint_every 2, stopped after its checkpoint at 2 samples "
          "and resumed, against the uninterrupted render", flush=True)
    with tempfile.TemporaryDirectory() as ck_dir:
        def ck_renderer(path, stop_at=None):
            r = Renderer(RendererParam(rng_impl="threefry2x32",
                                       checkpoint_every=2,
                                       checkpoint_path=path), device="cuda")
            r.compute_scene(scene)
            if stop_at is not None:
                r.set_progress_callback(
                    lambda spp, _: spp >= stop_at and r.signal_stop())
            return r

        fb_full = ck_renderer(os.path.join(ck_dir, "full.npz")).render()
        part = os.path.join(ck_dir, "part.npz")
        ck_renderer(part, stop_at=2).render()
        saved = FrameBuffer.load_state(part)
        r_res = ck_renderer(part)
        r_res.load_checkpoint(part)
        fb_res = r_res.render()
        check(int(saved.count.max()) == 2 and all(
            np.array_equal(getattr(fb_res, k), getattr(fb_full, k))
            for k in ("mean", "color_std", "count", "zbuffer")),
            "resumed from the checkpoint at 2 samples: mean, std, count and "
            "depth equal to the uninterrupted render's, bit for bit")

    counts_mp = multi_device_phases(
        HERE, scene, fb_a, s_arr, s_meta, cfg_pt, bpx, bpy, bsid, rbg,
        caus_desc, p_photon, fb_k, g_path["spot"], cfg_gp, render_main,
        reset_counts, read_counts, forbid, forbid_grad, numbers)

    launches = {k: sum(c.get(k, 0) for c in (
        counts_a, counts_b, counts_c, counts_d, counts_e, counts_f,
        counts_g, counts_h, counts_i, *counts_j, counts_k, counts_l,
        *counts_m, *counts_n, counts_ow, counts_oi, *counts_p, *counts_mp))
                for k in ("K1a", "K1b", "K1c", "K1d", "K2a", "K2b", "K2c",
                          "K3", "K4a", "K4b", "K5", "K6", "W1", "G1", "H1")}
    print(f"  launches on the main path (4a-4v): {json.dumps(launches)}",
          flush=True)
    analytic.shadow = shadow_fn
    analytic.closest_full = full_fn
    print(f"  K2c's launches in phase 4 by rays (sum {sum(k2c_sizes.values())}"
          "): " + ", ".join(f"{n} x {c}" for n, c in sorted(k2c_sizes.items())),
          flush=True)
    print(f"  K2b's launches in phase 4 by rays (sum {sum(k2b_sizes.values())}"
          ", 4i's comparison at 200x150 with the CPU included): " + ", ".join(
              f"{n} x {c}" for n, c in sorted(k2b_sizes.items())), flush=True)
    print("  (the sizes count the calls Python runs, the graphs' warm-ups "
          "and the eager ones, not their replays)", flush=True)

    captured = captured_phase(numbers)

    # -- 5. timings at the path's shapes -------------------------------------
    print("phase 5: kernel times at the path's shapes", flush=True)
    ms, src = kernel_ms(lambda: megakernel.mega_render(
        s_arr, s_meta, cfg_pt, bpx, bpy, bsid, rbg), "mega_kernel", 5)

    def mega_work(arr, meta_, cfg=cfg_pt, maps=None):
        """Per-lane work counters of one K1a launch: [480000, 8] int32
        (primitive tests, threefry ciphers, shaded vertices, triangle
        tests, checker tests, photon tests, caustics cluster tests,
        soft-shadow estimates past shadow_spp), and their sums."""
        work = torch.zeros((480000, 8), dtype=torch.int32, device="cuda")
        megakernel.mega_render(arr, meta_, cfg, bpx, bpy, bsid, rbg,
                               work=work, photon_maps=maps)
        return work, work.sum(0, dtype=torch.int64).tolist()

    def mega_bounds(nbytes, work, wsum, tri_need=None):
        """The launch's bound from its counters, recounted: the largest of
        its bytes at PEAK_BYTES, its float32 operations at PEAK_OPS and its
        ciphers' integer operations at PEAK_INT_OPS; with tri_need, the
        triangle tests the exact function needs (k1c_need) in place of
        those the kernel counted. Beside it the figure of PRs 1-6 (every
        operation at PEAK_OPS) and the bound from the kernel's own counters
        with each lane's raised to its warp's maximum (lanes in launch
        order, 32 to a warp): what one thread a lane pays where a warp
        waits for its slowest lane."""
        if tri_need is not None:
            wsum = list(wsum)
            wsum[3] = tri_need
        f32, i32 = mega_ops(wsum)
        b_ms, b_by = bound(nbytes, f32, i32)
        n_w = work.shape[0] - work.shape[0] % 32
        wmax = (work[:n_w].view(-1, 32, 8).amax(1).to(torch.int64).sum(0)
                * 32 + work[n_w:].to(torch.int64).sum(0)).tolist()
        return dict(bound_ms=b_ms, bound_by=b_by,
                    bound_bytes_ms=nbytes / PEAK_BYTES * 1e3,
                    bound_f32_ms=f32 / PEAK_OPS * 1e3,
                    bound_int32_ms=i32 / PEAK_INT_OPS * 1e3,
                    bound_f32_rate_ms=bound(nbytes, f32 + i32)[0],
                    bound_warp_max_ms=bound(nbytes, *mega_ops(wmax))[0])

    def warp_stats(work, cols):
        """Each warp's maximum of each counter against its lanes' mean,
        averaged over warps (lanes in launch order, 32 to a warp)."""
        n_w = work.shape[0] - work.shape[0] % 32
        w = work[:n_w].view(-1, 32, 8).double()
        out = {}
        for name, c in cols:
            out[f"warp_max_{name}"] = w[:, :, c].amax(1).mean().item()
            out[f"lane_mean_{name}"] = w[:, :, c].mean().item()
        return out

    def mega_ptxas(symbol, arr, meta_, cfg):
        """Registers and spills of the instantiation whose mangled name
        holds symbol, its shared memory at this scene's tables and cfg's
        soft-shadow window (none without a soft light, kind 0 ambient and
        1 direct), and the blocks of 128 threads an SM holds by those
        registers and that shared memory (blocks_per_sm)."""
        info = ptxas_info("megakernel", symbol)
        tab = arr.kernel
        smem = 4 * (meta_.num_analytic * 14 + tab.mtl.numel()
                    + meta_.num_lights * 14 + 25)
        soft = any(k not in (0, 1) and on for k, on in
                   zip(meta_.light_kinds, meta_.light_soft))
        w = max(1, min(max(cfg.shadow_spp_max, cfg.shadow_spp), 64))
        smem += 4 * (9 * 128 + 3 + (w * 129 if soft else 0))
        blocks = blocks_per_sm(info["registers"], 128, smem)
        return dict(info, smem_bytes=smem, blocks_per_sm=blocks,
                    occupancy=blocks * 128 / 2048)

    def mega_ops(wsum):
        """(float32 operations, integer operations) of the summed
        counters: the ciphers are integer work, the rest float32."""
        f32 = (wsum[0] * OPS_PER_TEST + wsum[3] * OPS_PER_TRI
               + wsum[4] * OPS_PER_CHECKER + wsum[5] * OPS_PER_PHOTON
               + wsum[6] * OPS_PER_PCLUSTER)
        return f32, wsum[1] * OPS_PER_CIPHER

    def engine_ms(arr, meta_):
        """The plain version (the wavefront engine, eager as in earlier
        PRs' figures) on the same lanes."""
        from qaray_tpu_torch.utils import compiled

        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        with compiled.eager():
            for lo in range(0, 480000, 65536):
                render_batch_wavefront(arr, meta_, cfg_pt,
                                       bpx[lo:lo + 65536],
                                       bpy[lo:lo + 65536],
                                       bsid[lo:lo + 65536], rbg)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    soft_lights = int(((s_arr.kernel.light_soft > 0)
                       & (s_arr.kernel.light_kind != 1)
                       & (s_arr.kernel.light_kind != 0)).sum())
    work, wsum = mega_work(s_arr, s_meta)
    numbers["K1a"].update(ms=ms, plain_ms=plain_ms, library_ms=None,
                          timed_by=src, lanes=480000, prim_tests=wsum[0],
                          ciphers=wsum[1], vertices=wsum[2],
                          soft_tails=wsum[7],
                          tail_share=wsum[7] / max(1, wsum[2] * soft_lights),
                          **mega_bounds(480000 * (12 + 16), work, wsum),
                          **warp_stats(work, (("ciphers", 1),
                                              ("prim_tests", 0),
                                              ("vertices", 2))),
                          **mega_ptxas("mega_kernelILb0ELb0ELb0E", s_arr,
                                       s_meta, cfg_pt))
    k1 = numbers["K1a"]
    print(f"  K1a softdof, pathtrace 480000 lanes: {ms:.4f} ms by {src}, "
          f"bound {k1['bound_ms']:.5f} ms by {k1['bound_by']} (bytes "
          f"{k1['bound_bytes_ms']:.5f}, float32 {k1['bound_f32_ms']:.5f}, "
          f"int32 {k1['bound_int32_ms']:.5f}; every operation at the "
          f"float32 rate {k1['bound_f32_rate_ms']:.5f}; lanes raised to "
          f"their warp's maximum {k1['bound_warp_max_ms']:.5f}); a warp's "
          f"maximum against a lane's mean: ciphers "
          f"{k1['warp_max_ciphers']:.1f} / {k1['lane_mean_ciphers']:.1f}, "
          f"primitive tests {k1['warp_max_prim_tests']:.1f} / "
          f"{k1['lane_mean_prim_tests']:.1f}, vertices "
          f"{k1['warp_max_vertices']:.3f} / {k1['lane_mean_vertices']:.3f}; "
          f"soft-shadow estimates past shadow_spp {k1['tail_share']:.4f} of "
          f"lane-vertices; {k1['registers']} registers, spills "
          f"{k1['spill_store_bytes']}/{k1['spill_load_bytes']} bytes, "
          f"{k1['smem_bytes']} bytes of shared memory, {k1['blocks_per_sm']} "
          f"blocks an SM (occupancy {k1['occupancy']:.4f})", flush=True)
    del work

    # K1c: the same launch on mesh_scene (320 triangles) and its ico5
    # (20,480); its plain version is the wavefront engine on the same lanes.
    # Its bound counts the triangle tests the exact function needs
    # (k1c_need), the same figure for any walk; the kernel's own count of
    # leaf rows tested gives the leaves a lane visits.
    k1c_ptx = ptxas_info("megakernel", "mega_kernelILb0ELb0ELb1E")
    for what in ("mesh", "ico5"):
        k_arr, k_meta = mesh_arr[what]
        ms, src = kernel_ms(lambda: megakernel.mega_render(
            k_arr, k_meta, cfg_pt, bpx, bpy, bsid, rbg), "mega_kernel", 5)
        work, wsum = mega_work(k_arr, k_meta)
        need_c, need_a = k1c_need(k_arr, k_meta, cfg_pt, bpx, bpy, bsid, rbg)
        tab = k_arr.kernel
        leaf = megakernel.MEGA_LEAF
        nbytes = (480000 * (12 + 16) + 4 * (tab.mesh_rows.numel()
                                            + tab.mesh_attr.numel()
                                            + tab.mesh_tree.numel()))
        n_w = work.shape[0] - work.shape[0] % 32
        leaves = work[:n_w, 3].double().view(-1, 32) / leaf
        row = dict(ms=ms, plain_ms=engine_ms(k_arr, k_meta), timed_by=src,
                   prim_tests=wsum[0], ciphers=wsum[1], vertices=wsum[2],
                   tri_tests=wsum[3], tri_tests_needed=need_c + need_a,
                   tri_tests_needed_closest=need_c,
                   tri_tests_needed_any=need_a, leaf_rows=leaf,
                   lane_leaves=leaves.mean().item(),
                   warp_max_leaves=leaves.amax(1).mean().item(),
                   bound_kernel_count_ms=mega_bounds(nbytes, work,
                                                     wsum)["bound_ms"],
                   **mega_bounds(nbytes, work, wsum, need_c + need_a),
                   **warp_stats(work, (("tri_tests", 3), ("ciphers", 1))))
        if what == "mesh":
            numbers["K1c"].update(library_ms=None, lanes=480000,
                                  triangles=k_meta.num_tris, **k1c_ptx,
                                  **row)
        else:
            numbers["K1c"].update({f"ico5_{k}": v for k, v in row.items()})
        print(f"  K1c {what} ({k_meta.num_tris} triangles), pathtrace 480000 "
              f"lanes: {ms:.4f} ms by {src}, bound {row['bound_ms']:.5f} ms "
              f"by {row['bound_by']} from {need_c + need_a} triangle tests "
              f"the function needs ({need_c} closest, {need_a} any hit; "
              f"float32 rate {row['bound_f32_rate_ms']:.5f}; from the "
              f"kernel's own {wsum[3]} tests "
              f"{row['bound_kernel_count_ms']:.5f}, with lanes at their "
              f"warp's maximum {row['bound_warp_max_ms']:.5f}), engine "
              f"{row['plain_ms']:.3f} ms; leaves of {leaf} rows a lane "
              f"{row['lane_leaves']:.3f}, for a warp's slowest lane "
              f"{row['warp_max_leaves']:.3f}; triangle tests a warp's "
              f"maximum {row['warp_max_tri_tests']:.1f} against a lane's "
              f"mean {row['lane_mean_tri_tests']:.1f}", flush=True)
        del work
    print(f"  K1c ptxas (mega_kernel<false, false, true>): "
          f"{k1c_ptx}", flush=True)

    # K1b: the textured launch on texture_scene, beside K1a's time on
    # softdof above; its plain version is the wavefront engine with the
    # texture stack on the same lanes.
    ms, src = kernel_ms(lambda: megakernel.mega_render(
        t_arr, t_meta, cfg_pt, bpx, bpy, bsid, rbg), "mega_kernel", 5)
    work, wsum = mega_work(t_arr, t_meta)
    numbers["K1b"].update(ms=ms, plain_ms=engine_ms(t_arr, t_meta),
                          library_ms=None, timed_by=src, lanes=480000,
                          prim_tests=wsum[0], ciphers=wsum[1],
                          vertices=wsum[2], checker_tests=wsum[4],
                          **mega_bounds(480000 * (12 + 16), work, wsum),
                          **mega_ptxas("mega_kernelILb1ELb0ELb0E", t_arr,
                                       t_meta, cfg_pt))
    k1 = numbers["K1b"]
    print(f"  K1a+K1b texture_scene, pathtrace 480000 lanes: {ms:.4f} ms by "
          f"{src} (K1a on softdof {numbers['K1a']['ms']:.4f} ms), bound "
          f"{k1['bound_ms']:.5f} ms by {k1['bound_by']} (float32 rate "
          f"{k1['bound_f32_rate_ms']:.5f}, warp maximum "
          f"{k1['bound_warp_max_ms']:.5f}), engine {k1['plain_ms']:.3f} ms, "
          f"{wsum[4]} checker tests on {wsum[2]} vertices; "
          f"{k1['registers']} registers, spills {k1['spill_store_bytes']}/"
          f"{k1['spill_load_bytes']} bytes", flush=True)
    del work

    # K1d: the gathering launch on caustics_scene with the default maps
    # (photonmap, max_bounce 5, rbg), beside K1a's time on softdof above;
    # its plain version is the wavefront engine with the exact gathers.
    ms, src = kernel_ms(lambda: megakernel.mega_render(
        c_arr, c_meta, cfg_photon, bpx, bpy, bsid, rbg, photon_maps=pmaps),
        "mega_kernel", 5)
    work, wsum = mega_work(c_arr, c_meta, cfg_photon, pmaps)
    ctab = pmaps[1]
    numbers["K1d"].update(
        ms=ms, plain_ms=photon_plain_ms, library_ms=None, timed_by=src,
        lanes=480000, prim_tests=wsum[0], ciphers=wsum[1], vertices=wsum[2],
        photon_tests=wsum[5], cluster_tests=wsum[6],
        **mega_bounds(480000 * (12 + 4 * 4 + 4 * 19)
                      + 4 * (ctab.ctable.numel() + ctab.cbounds.numel()),
                      work, wsum),
        **mega_ptxas("mega_kernelILb0ELb1ELb0E", c_arr, c_meta, cfg_photon))
    k1 = numbers["K1d"]
    print(f"  K1a+K1d caustics_scene, photonmap 480000 lanes: {ms:.4f} ms by "
          f"{src} (K1a on softdof {numbers['K1a']['ms']:.4f} ms), bound "
          f"{k1['bound_ms']:.5f} ms by {k1['bound_by']} (float32 rate "
          f"{k1['bound_f32_rate_ms']:.5f}, warp maximum "
          f"{k1['bound_warp_max_ms']:.5f}), engine {photon_plain_ms:.3f} ms, "
          f"{wsum[5]} photon tests, {wsum[6]} cluster tests on {wsum[2]} "
          f"vertices; {k1['registers']} registers, spills "
          f"{k1['spill_store_bytes']}/{k1['spill_load_bytes']} bytes",
          flush=True)
    del work

    # K5 on the records of phase 2c's dispatch. The bound counts, for each
    # query with a record, the rows of the clusters within r of that query
    # alone (what a per-query cull must sweep). Its bytes: each query's
    # active flag in and 28 bytes out, the 12-byte position of each query
    # with a record, the cluster boxes once, and the 9 columns the sweep
    # reads of the rows of the clusters within r of some such query.
    g5 = pmaps[0]
    r5 = float(g5.radius)
    qa = q5[a5 > 0.5]
    cb = g5.cbounds
    near = ((cb[None, :, 0] <= cb[None, :, 3])
            & (cb[None, :, 0:3] - r5 <= qa[:, None, :]).all(-1)
            & (cb[None, :, 3:6] + r5 >= qa[:, None, :]).all(-1))
    tests5 = int(near.sum().item()) * 128
    near5 = int(near.any(0).sum().item())
    b_ms, b_by = bound(q5.shape[0] * (4 + 28) + qa.shape[0] * 12
                       + 4 * cb.numel() + near5 * 128 * 9 * 4,
                       tests5 * OPS_PER_PHOTON)
    # Timed as gather_apply launches it: the queries with a record first,
    # their count in device memory, a warp to each.
    work5 = torch.zeros(q5.shape[0], dtype=torch.int32, device="cuda")
    photon.photon_gather(g5.ctable, g5.cbounds, g5.radius, q5, a5,
                         count=n5, work=work5)
    visits = work5[a5 > 0.5].double()
    ms, src = kernel_ms(lambda: photon.photon_gather(
        g5.ctable, g5.cbounds, g5.radius, q5, a5, count=n5),
        "gather_kernel", 20)
    ms_flags, _ = kernel_ms(lambda: photon.photon_gather(
        g5.ctable, g5.cbounds, g5.radius, q5, a5), "gather_kernel", 20)
    numbers["K5"].update(
        ms=ms, ms_flags=ms_flags,
        plain_ms=cuda_ms(lambda: photon.photon_gather_plain(
            g5.ctable, g5.cbounds, g5.radius, q5, a5), 1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, timed_by=src,
        wrapper_ms=cuda_ms(lambda: photon.photon_gather(
            g5.ctable, g5.cbounds, g5.radius, q5, a5, count=n5), 20),
        queries=q5.shape[0], active=int(qa.shape[0]), photon_tests=tests5,
        clusters_near=near5, photons=int(gmap.valid.sum()),
        warps_launched=photon.gather_warps(q5.shape[0]),
        query_clusters=visits.mean().item(),
        query_clusters_max=int(visits.max().item()),
        clusters=g5.cbounds.shape[0])
    print(f"  K5 {q5.shape[0]} queries ({qa.shape[0]} with a record): "
          f"{ms:.5f} ms by {src} (every query's flag read: {ms_flags:.5f} "
          f"ms), bound {b_ms:.6f} ms by {b_by}, plain "
          f"{numbers['K5']['plain_ms']:.3f} ms, {tests5} photon tests; "
          f"{numbers['K5']['warps_launched']} warps launched, a warp to "
          f"each of the {qa.shape[0]} queries with a record, which visits "
          f"{visits.mean().item():.3f} of {g5.cbounds.shape[0]} clusters "
          f"(at most {int(visits.max().item())})", flush=True)

    n2 = 1 << 16  # one wavefront batch of primary rays
    n_sh = 1 << 20  # its first 16 soft-shadow rays per lane
    pk = p[:n2].contiguous()
    dk = d[:n2].contiguous()
    num_p = meta.num_analytic
    # K2a and K2b at the largest of K2b's launch sizes in phase 4 and at a
    # wavefront batch's 65,536 rays, on phase 2a's random rays (softdof) and
    # on the rays of the first two launches phase 4 made at that size (a
    # batch's bounces 0 and 1, against that scene's primitives). The row's
    # figures: the largest size, bounce 0. Bytes: 24 in and 8 out a ray
    # (K2a), 49 out (K2b: t, prim, mtl, n, uvw, p, front; has_texture is
    # all true, a constant of the function, so its byte is not counted).
    n_big = max(k2b_sizes)
    k2_sets = {}
    for n in (n_big, n2):
        if n <= p.shape[0]:
            k2_sets[f"random_{n}"] = (p[:n].contiguous(), d[:n].contiguous(),
                                      prims)
        for b, rays in enumerate(k2b_rays.get(n, ())):
            k2_sets[f"bounce{b}_{n}"] = rays
    row_set = f"bounce0_{n_big}"

    def k2_calls(name, ps, ds, pr):
        """{tag: a launch} and the plain version of K2a or K2b."""
        if name == "K2a":
            return ({"": lambda: analytic.closest(ps, ds, pr)},
                    lambda: analytic.closest_plain(ps, ds, pr))
        return ({"": lambda: analytic.closest_full(ps, ds, pr),
                 "_no_uv": lambda: analytic.closest_full(ps, ds, pr,
                                                         want_uv=False)},
                lambda: analytic.closest_full_plain(ps, ds, pr))

    for name, kname, out_bytes in (("K2a", "closest_kernel", 8),
                                   ("K2b", "closest_full_kernel", 49)):
        sets = {}
        for what, (ps, ds, pr) in k2_sets.items():
            n = ps.shape[0]
            fns, plain = k2_calls(name, ps, ds, pr)
            tests = n * pr.kind.shape[0]
            b_ms, b_by = bound(n * (24 + out_bytes), tests * OPS_PER_TEST)
            row = dict(rays=n, prim_tests=tests, bound_ms=b_ms, bound_by=b_by)
            for tag, fn in fns.items():
                row[f"ms{tag}"], row["timed_by"] = kernel_ms(fn, kname, 20)
            if what == row_set:
                row.update(plain_ms=cuda_ms(plain, 5),
                           wrapper_ms=cuda_ms(fns[""], 20))
            sets[what] = row
            no_uv = (f" (no uv {row['ms_no_uv']:.5f})" if name == "K2b"
                     else "")
            print(f"  {name} {what}: {row['ms']:.5f} ms{no_uv} by "
                  f"{row['timed_by']}, bound {b_ms:.6f} ms by {b_by} "
                  f"({b_ms / row['ms']:.3f} of it)", flush=True)
        top = sets[row_set]
        numbers[name].update(
            ms=top["ms"], plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
            bound_by=top["bound_by"], library_ms=None,
            timed_by=top["timed_by"], wrapper_ms=top["wrapper_ms"],
            rays=top["rays"], prim_tests=top["prim_tests"], sets=sets)
    # Registers, spills and blocks an SM of K2a and both K2b
    # instantiations, at softdof's table in shared memory.
    smem = 52 * meta.num_analytic
    inst = {}
    for key, symbol in (("K2a", "closest_kernelENS"),
                        ("K2b", "closest_full_kernelILb1E"),
                        ("K2b_no_uv", "closest_full_kernelILb0E")):
        info = ptxas_info("analytic", symbol)
        inst[key] = dict(info, blocks_per_sm=blocks_per_sm(
            info["registers"], 256, smem))
    numbers["K2a"]["ptxas"] = inst["K2a"]
    numbers["K2b"].update(ptxas={k: inst[k] for k in ("K2b", "K2b_no_uv")},
                          launch_sizes={str(k): v for k, v in
                                        sorted(k2b_sizes.items())})
    print(f"  K2a/K2b resources, {smem} bytes of shared memory: "
          f"{json.dumps(inst)}", flush=True)
    del k2_sets, k2b_rays

    for name, kname, fn, plain, n, nbytes in (
        ("K2c", "shadow_kernel", lambda: analytic.shadow(p, d, t_max, prims),
         lambda: analytic.shadow_plain(p, d, t_max, prims), n_sh,
         n_sh * (28 + 1)),
    ):
        if name == "K2c":
            t_all = I.intersect_analytic_t(p, d, prims)
            hit = t_all < t_max[:, None]
            first = torch.where(hit.any(-1), hit.float().argmax(-1) + 1,
                                num_p)
            tests = int(first.sum().item())
        else:
            tests = n * num_p
        b_ms, b_by = bound(nbytes, tests * OPS_PER_TEST)
        k_ms, src = kernel_ms(fn, kname, 20)
        numbers[name].update(ms=k_ms, plain_ms=cuda_ms(plain, 5),
                             bound_ms=b_ms, bound_by=b_by, library_ms=None,
                             timed_by=src, wrapper_ms=cuda_ms(fn, 20),
                             rays=n, prim_tests=tests)
        if name == "K2c":
            # Its launches of one ray a lane (a batch's hard shadows), and
            # the sizes of its launches on the main path.
            n_tests = int(first[:n2].sum().item())
            b2_ms, b2_by = bound(n2 * (28 + 1), n_tests * OPS_PER_TEST)
            numbers[name]["at_65536"] = dict(
                ms=kernel_ms(lambda: analytic.shadow(
                    pk, dk, t_max[:n2], prims), kname, 20)[0],
                bound_ms=b2_ms, bound_by=b2_by, prim_tests=n_tests)
            numbers[name]["launch_sizes"] = {
                str(k): v for k, v in sorted(k2c_sizes.items())}
            # Both instantiations: pairs (this shape's) and one ray a
            # thread (65,536 rays').
            smem = 52 * num_p  # the table: 12 floats and a kind a primitive
            inst = {}
            for key, symbol in (("pairs", "shadow_kernelILb1E"),
                                ("one_ray", "shadow_kernelILb0E")):
                info = ptxas_info("analytic", symbol)
                inst[key] = dict(info, blocks_per_sm=blocks_per_sm(
                    info["registers"], 256, smem))
            numbers[name].update(ptxas=inst, smem_bytes=smem)
            k2 = numbers[name]
            print(f"  K2c {n} rays: {k_ms:.5f} ms by {src}, bound "
                  f"{b_ms:.5f} ms by {b_by} ({b_ms / k_ms:.3f} of it); "
                  f"{n2} rays: {k2['at_65536']['ms']:.5f} ms, bound "
                  f"{b2_ms:.5f}; {smem} bytes of shared memory; "
                  f"{json.dumps(inst)}", flush=True)
    torch.cuda.synchronize()

    # K3 on ico5 and on mesh_scene's own 320 triangles (the shape of its
    # launches in 4f and 4m), K4a/K4b on ico6, at the 480,000 camera rays of
    # mesh_scene at 800x600 (and, for K4b, their shadow rays). The tiled
    # route walks rays in coherence order, so K4a/K4b are timed on sorted
    # rays; the dense route walks them as they come, and so is K3 timed.
    n_cam = cp.shape[0]
    t_big = torch.full((n_cam,), BIG, device="cuda")

    def k3_row(mesh_):
        """K3 on the camera rays: time, clusters a ray and for its warp's
        slowest ray, and its bound: the tests of the clusters whose entry
        bound lies at or below the ray's final reach (the runner-up's t, or
        BIGFLOAT where it has none), beside the dense sweep's (every
        row)."""
        walk = mesh_sweep.walk_of(mesh_)
        leaf = mesh_sweep.WALK_LEAF
        n_leaves = walk.tree.shape[0] // 2
        n_cl = walk.rows.shape[0] // leaf
        cb = walk.tree[n_leaves:n_leaves + n_cl, :6]
        c16_ = mesh_.stream_c16
        steps = torch.zeros(n_cam, dtype=torch.int32, device="cuda")
        out = mesh_sweep.sweep_closest(cp, cd, t_big, c16_, walk=walk,
                                       steps=steps)
        tab = mesh_sweep.unpack_coeff16(c16_)
        r2 = out[2].clamp_min(0).long()
        t2 = _chunk_test(cp[:, None], cd[:, None], tab.coeff[r2][:, None],
                         tab.const[r2][:, None])[:, 0, 0]
        need = clusters_within(cp, cd, cb, torch.where(out[2] >= 0, t2,
                                                       t_big), ties=True)
        check(bool((need <= steps).all()), f"K3 {mesh_.tri_v.shape[0]} "
              "triangles: every ray visited the clusters it needs")
        tests = int(need.sum(dtype=torch.int64).item()) * leaf
        nbytes = (n_cam * (24 + 4 + 12) + 4 * (walk.rows.numel()
                                               + walk.gid.numel()
                                               + walk.tree.numel()))
        b_ms, b_by = bound(nbytes, tests * OPS_PER_TRI)
        def run():
            return mesh_sweep.sweep_closest(cp, cd, t_big, c16_, walk=walk)

        k_ms, src = kernel_ms(run, "walk_kernel", 10)
        n_w = n_cam - n_cam % 32
        visited = int(steps.sum(dtype=torch.int64).item())
        return dict(
            ms=k_ms, bound_ms=b_ms, bound_by=b_by, timed_by=src,
            wrapper_ms=cuda_ms(run, 10), clusters=n_cl,
            triangles=mesh_.tri_v.shape[0], tri_tests=tests,
            clusters_visited=visited, mean_ray_clusters=visited / n_cam,
            warp_ray_clusters=steps[:n_w].view(-1, 32).amax(1).double()
            .mean().item(), max_ray_clusters=int(steps.max().item()),
            bound_dense_ms=bound(n_cam * 40 + c16_.numel() * 4,
                                 n_cam * c16_.shape[0] * OPS_PER_TRI)[0])

    ms_arr, _ = compile_scene(mesh_base, device="cuda")
    rows3 = {}
    for what, mesh_ in (("ico5", mesh5), ("mesh_scene", ms_arr.mesh)):
        r = rows3[what] = k3_row(mesh_)
        print(f"  K3 {what} ({r['triangles']} triangles) camera rays: "
              f"{r['ms']:.4f} ms by {r['timed_by']}, bound "
              f"{r['bound_ms']:.5f} ms by {r['bound_by']} (dense sweep's "
              f"{r['bound_dense_ms']:.5f}), {r['mean_ray_clusters']:.3f} "
              f"clusters a ray, {r['warp_ray_clusters']:.3f} for its "
              f"warp's slowest, at most {r['max_ray_clusters']}", flush=True)
    numbers["K3"] = dict(
        max_abs_err=mesh_err["K3"], **rows3["ico5"],
        plain_ms=cuda_ms(lambda: stream_closest(cp, cd, t_big, plain5), 1),
        library_ms=None, rays=n_cam, mesh_scene=rows3["mesh_scene"],
        **ptxas_info("tiles", "walk_kernelILi2E"))
    print(f"  K3 ptxas: {ptxas_info('tiles', 'walk_kernelILi2E')}",
          flush=True)
    del ms_arr

    lo6 = m6t.tile_cbounds[:, :3].amin(0)
    hi6 = m6t.tile_cbounds[:, 3:6].amax(0)
    fp6 = m6t.tile_c16T.shape[0] * 8
    tree6 = m6t.tile_tree
    cb6 = m6t.tile_cbounds

    for name, (p_, d_, t_) in (("K4a", (cp, cd, t_big)), ("K4b", shadow6)):
        any_hit = name == "K4b"
        perm = tiles.coherence_order(p_, d_, lo6, hi6)
        ps, ds, ts = (x[perm].contiguous() for x in (p_, d_, t_))
        n = ps.shape[0]
        steps = torch.zeros(n, dtype=torch.int32, device="cuda")
        work = torch.zeros(n, dtype=torch.int32, device="cuda")
        out = tiles.tiled_sweep_kernel(ps, ds, ts, tm6, m6t.tile_c16T,
                                       any_hit=any_hit, steps=steps,
                                       work=work, tree=tree6)
        check(bool((work % 256 == 0).all() & (work <= 256 * steps).all()),
              f"{name}: per-ray work in whole clusters, within those "
              "visited")
        # Two bounds. The winner's: the clusters within reach of the
        # winner (its final t; the any hit: those the walk visited while
        # open, the kernel's work). The exact top-2's: the clusters within
        # reach of the runner-up (the any hit: every cluster within the
        # budget of a ray left open, one for an occluded ray).
        if any_hit:
            need = torch.where(out, 1, clusters_within(ps, ds, cb6, ts))
            need_win = work // 256
        else:
            # The runner-up's t, from its row as the sweep computes it.
            r2 = out[2].clamp_min(0).long()
            t2 = _chunk_test(ps[:, None], ds[:, None], tm6.coeff[r2][:, None],
                             tm6.const[r2][:, None])[:, 0, 0]
            need = clusters_within(ps, ds, cb6,
                                   torch.where(out[2] >= 0, t2, ts))
            del r2, t2
            need_win = clusters_within(ps, ds, cb6, out[0])
        check(bool((need <= steps).all()), f"{name}: every ray visited the "
              "clusters it needs")
        if any_hit:
            check(bool((work[ts <= BIAS] == 0).all()),
                  "K4b: no test counted for a ray without budget")
        else:
            check(bool((steps[out[1] >= 0] > 0).all()),
                  "K4a: every ray with a hit visited a cluster")
        # A warp's 32 rays take as long as its slowest walk: the clusters
        # a ray's warp visits at most, averaged over rays.
        warp_max = steps[: n - n % 32].view(-1, 32).amax(1)
        warp_clusters = warp_max.double().mean().item()
        tests = int(need.sum(dtype=torch.int64).item()) * 256
        tests_win = int(need_win.sum(dtype=torch.int64).item()) * 256
        visited = int(steps.sum(dtype=torch.int64).item())
        nbytes = n * (24 + 4 + (1 if any_hit else 13)) + fp6 * 64 \
            + tree6.numel() * 4
        b_ms, b_by = bound(nbytes, tests * OPS_PER_TRI)
        bw_ms, _ = bound(nbytes, tests_win * OPS_PER_TRI)
        kname = "walk_kernel<kAnyHit>" if any_hit else "walk_kernel<kTiled>"
        k_ms, src = kernel_ms(lambda: tiles.tiled_sweep_kernel(
            ps, ds, ts, tm6, m6t.tile_c16T, any_hit=any_hit, tree=tree6),
            "walk_kernel", 10)
        numbers[name] = dict(
            max_abs_err=mesh_err[name], ms=k_ms,
            plain_ms=cuda_ms(lambda: tiles.walk_plain(
                ps, ds, ts, m6t.tile_c16T, m6t.tile_cbounds, any_hit), 1),
            bound_ms=b_ms, bound_by=b_by, bound_winner_ms=bw_ms,
            library_ms=None, timed_by=src,
            wrapper_ms=cuda_ms(lambda: tiles.tiled_sweep_kernel(
                ps, ds, ts, tm6, m6t.tile_c16T, any_hit=any_hit,
                tree=tree6), 10),
            rays=n, triangles=m6.num_tris, clusters_visited=visited,
            mean_ray_clusters=visited / n, warp_ray_clusters=warp_clusters,
            max_ray_clusters=int(steps.max().item()), tri_tests=tests,
            tri_tests_win=tests_win,
            **ptxas_info("tiles", "walk_kernelILi1E" if any_hit
                         else "walk_kernelILi0E"))
        print(f"  {name} ({kname}): {k_ms:.4f} ms by {src}, bound "
              f"{b_ms:.5f} ms (runner-up reach; winner reach "
              f"{bw_ms:.5f} ms), {visited / n:.3f} clusters a ray, "
              f"{warp_clusters:.3f} for its warp's slowest, at most "
              f"{int(steps.max().item())}", flush=True)
    numbers["K4a"]["twophase_wrapper_ms"] = cuda_ms(
        lambda: tiles.tiled_closest_twophase(cp, cd, t_big, tm6,
                                             m6t.tile_c16T, tree=tree6), 10)
    numbers["K4a"]["twophase_budget0_wrapper_ms"] = cuda_ms(
        lambda: tiles.tiled_closest_twophase(cp, cd, t_big, tm6,
                                             m6t.tile_c16T, budget=0,
                                             tree=tree6), 10)
    print(f"  K4a two-phase whole: budget 12 "
          f"{numbers['K4a']['twophase_wrapper_ms']:.4f} ms, budget 0 "
          f"{numbers['K4a']['twophase_budget0_wrapper_ms']:.4f} ms",
          flush=True)
    torch.cuda.synchronize()

    # K6 at the gradient path's shapes of 4m (spot_scene 262,144 lanes;
    # mesh_scene 131,072), on spot_scene's full frame and on the glass
    # scene (480,000 lanes each, 800x600), on the mean loss's cotangent.
    # The bound counts the replay's primitive tests, ciphers and triangle
    # tests, and as bytes the lanes' ids and cotangents in and the
    # gradient out (the hooks are the kernel's own scratch). Beside it a
    # warp's maximum of the counters against a lane's mean (lanes in
    # launch order, 32 to a warp).
    ids_f = torch.arange(800 * 600, device="cuda", dtype=torch.int32)
    s_arr, s_meta = g_path["spot"][:2]
    g_path["spot_frame"] = (s_arr, s_meta, ids_f % 800, ids_f // 800)
    g_path["glass"] = (*compile_scene(grad_desc("glass", 800, 600),
                                      device="cuda"),
                       ids_f % 800, ids_f // 800)
    for what in ("spot", "mesh", "spot_frame", "glass"):
        g_arr, g_meta, gx, gy = g_path[what]
        n_l = gx.shape[0]
        gs = torch.zeros_like(gx)
        ct = torch.full((n_l, 3), 1.0 / (3 * n_l), device="cuda")
        ms, src = kernel_ms(lambda: adjoint.adjoint_render(
            g_arr, g_meta, cfg_gp, gx, gy, gs, rbg, ct), "adjoint_kernel", 5)
        work = torch.zeros((n_l, 4), dtype=torch.int32, device="cuda")
        adjoint.adjoint_render(g_arr, g_meta, cfg_gp, gx, gy, gs, rbg, ct,
                               work=work)
        wsum = work.sum(0, dtype=torch.int64).tolist()
        n_par = adjoint.param_layout(g_meta.num_materials,
                                     g_meta.num_lights)
        nbytes = n_l * (12 + 12) + 4 * n_par
        tri_need = wsum[3]
        if g_meta.mesh_mega:
            tab = g_arr.kernel
            nbytes += 4 * (tab.mesh_rows.numel() + tab.mesh_attr.numel()
                           + tab.mesh_tree.numel())
            # The replay's mesh queries are the forward's: K1c's count.
            tri_need = sum(k1c_need(g_arr, g_meta, cfg_gp, gx, gy, gs, rbg))
        f32 = wsum[0] * OPS_PER_TEST + tri_need * OPS_PER_TRI
        b_ms, b_by = bound(nbytes, f32, wsum[1] * OPS_PER_CIPHER)
        b_old = bound(nbytes, f32 + wsum[1] * OPS_PER_CIPHER)[0]
        n_w = n_l - n_l % 32
        wv = work[:n_w].view(-1, 32, 4).double()
        gap = {f"{stat}_{name}": (wv[:, :, c].amax(1).mean() if stat ==
                                  "warp_max" else wv[:, :, c].mean()).item()
               for stat in ("warp_max", "lane_mean")
               for name, c in (("ciphers", 1), ("vertices", 2))}
        row = dict(ms=ms, bound_ms=b_ms, bound_by=b_by,
                   bound_f32_rate_ms=b_old, timed_by=src, lanes=n_l,
                   prim_tests=wsum[0], ciphers=wsum[1], vertices=wsum[2],
                   tri_tests=wsum[3], tri_tests_needed=tri_need, **gap)
        if what in ("spot", "mesh"):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            adjoint.adjoint_render_plain(g_arr, g_meta, cfg_gp, gx, gy, gs,
                                         rbg, ct)
            end.record()
            end.synchronize()
            row["plain_ms"] = start.elapsed_time(end)
        if what == "spot":
            numbers["K6"].update(library_ms=None, **row)
        else:
            numbers["K6"].update({f"{what}_{k}": v for k, v in row.items()})
        print(f"  K6 {what}, pathtrace {n_l} lanes: {ms:.4f} ms by {src}, "
              f"bound {b_ms:.5f} ms by {b_by}, plain "
              f"{row.get('plain_ms', float('nan')):.3f} ms, {wsum[2]} "
              f"vertices, {wsum[1]} ciphers; a warp's maximum against a "
              f"lane's mean: ciphers {gap['warp_max_ciphers']:.2f} / "
              f"{gap['lane_mean_ciphers']:.2f}, vertices "
              f"{gap['warp_max_vertices']:.3f} / "
              f"{gap['lane_mean_vertices']:.3f}", flush=True)
    # The device's idle share over three more steps of each route of 4m,
    # with the count of K1a and K6 records the profiler kept (it may drop
    # the last ones it traced; busy time is then read low).
    for (what, route), (one_step, no_mega) in grad_steps.items():
        if no_mega:
            os.environ["QARAY_NO_MEGAKERNEL"] = "1"
        try:
            flush_profiler()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t = time.time()
                for _ in range(3):
                    one_step()
                torch.cuda.synchronize()
                wall_p = (time.time() - t) * 1e3
        finally:
            os.environ.pop("QARAY_NO_MEGAKERNEL", None)
        events = prof.key_averages()
        busy = sum(device_us(e) for e in events) / 1e3
        kept = {k: sum(e.count for e in events if n in e.key)
                for k, n in (("K1a", "mega_kernel"),
                             ("K6", "adjoint_kernel"))}
        grad_cells[(what, route)].update(idle_share=1.0 - busy / wall_p)
        print(f"  {what} {route} route, three steps under the profiler: "
              f"wall {wall_p:.3f} ms, device busy {busy:.3f} ms, idle share "
              f"{1.0 - busy / wall_p:.4f}, records kept {json.dumps(kept)}",
              flush=True)
    numbers["K6"]["grad_path"] = {f"{w} {r}": v
                                  for (w, r), v in grad_cells.items()}
    # Registers, spills, shared memory and blocks an SM of both
    # instantiations, at spot_scene's, the glass scene's and mesh_scene's
    # tables and at the gate's largest (8 material rows, 8 lights).
    for key, symbol, what in (("ptxas", "adjoint_kernelILb0E", "spot"),
                              ("mesh_ptxas", "adjoint_kernelILb1E", "mesh")):
        info = ptxas_info("adjoint", symbol)
        smem = {w: adjoint.block_smem_bytes(
            g_path[w][1].num_analytic, g_path[w][1].num_materials,
            g_path[w][1].num_lights)
            for w in (what, "glass")[:1 if what == "mesh" else 2]}
        smem["gate_max"] = adjoint.block_smem_bytes(
            g_path[what][1].num_analytic, 8, 8)
        info["smem_bytes"] = smem
        info["blocks_per_sm"] = {w: blocks_per_sm(info["registers"],
                                                  adjoint.THREADS, b)
                                 for w, b in smem.items()}
        numbers["K6"][key] = info
        print(f"  K6 {symbol}: {json.dumps(info)}", flush=True)
    torch.cuda.synchronize()

    # W1 at four launches: the per-instance route's largest closest-hit
    # and any-hit launches of 4o (25 instances of a 320-triangle tree), the
    # largest closest-hit launch of 4p (25 instances of ico5's deep tree)
    # and the camera rays of ico5's world tree (4n's route). Its bound
    # counts the work its counters report: inner nodes (two slab tests
    # each) and triangle tests, and the rays' moves into each instance's
    # space: every instance for a closest hit, and for an any hit those up
    # to the first that occludes the ray (kernel_times.w1_walked: one
    # any-hit launch an instance, not counted on the main path).
    w1_rows = {}
    ico5_launch = (cp, cd, torch.full((cp.shape[0],), BIG, device="cuda"),
                   None, w1_sets["ico5 camera"][2],
                   dict(stack_size=w1_sets["ico5 camera"][3]))
    for what, (p_, d_, t_, occ_, tabs_, kw_) in (
            ("4o closest", w1_4o["closest"]),
            ("4o any hit", w1_4o["any hit"]),
            ("4p closest", w1_4p), ("ico5 world", ico5_launch)):
        n_ = p_.shape[0]
        n_inst = tabs_[2].numel()
        kw_ = {k: v for k, v in kw_.items() if k != "plain"}
        work = torch.zeros((n_, 2), dtype=torch.int32, device="cuda")
        if occ_ is None:
            call = (lambda plain=False: bvh_packed.closest(
                p_, d_, t_, *tabs_, plain=plain, **kw_))
            bvh_packed.closest(p_, d_, t_, *tabs_, work=work, **kw_)
            moves = n_ * n_inst
            nbytes = n_ * (24 + 4) + n_ * 25
        else:
            call = (lambda plain=False: bvh_packed.occluded(
                p_, d_, t_, occ_, *tabs_, plain=plain, **kw_))
            bvh_packed.occluded(p_, d_, t_, occ_, *tabs_, work=work, **kw_)
            moves = int(w1_walked((p_, d_, t_, occ_, tabs_, kw_)).sum())
            nbytes = n_ * (24 + 4 + 1) + n_
        ms, src = kernel_ms(call, "bvh_kernel")
        # The plain loop walks each instance until its slowest ray is done:
        # on 4p's deep trees that takes minutes, so it is timed at 4o's
        # closest-hit launch and on ico5's world tree only.
        plain_ms = (cuda_ms(lambda: call(plain=True), 1)
                    if what in ("4o closest", "ico5 world") else None)
        inner, tested = (int(x) for x in work.sum(0))
        nbytes += sum(x.numel() * x.element_size()
                      for x in tabs_ if x is not None)
        ops = (inner * OPS_PER_NODE + tested * OPS_PER_TRI
               + (moves * OPS_PER_XFORM if tabs_[3] is not None else 0))
        b_ms, b_by = bound(nbytes, ops)
        steps = work.sum(1).double()
        warp = steps[: n_ // 32 * 32].reshape(-1, 32)
        smem = bvh_packed.block_smem_bytes(n_inst)
        w1_rows[what] = dict(
            ms=ms, timed_by=src, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=None, lanes=n_, instances=n_inst,
            stack_size=kw_["stack_size"], smem_bytes=smem,
            instance_moves_per_ray=moves / n_ if tabs_[3] is not None else 0,
            inner_nodes_per_ray=inner / n_, tri_tests_per_ray=tested / n_,
            warp_max_over_mean=(warp.max(1).values.mean()
                                / warp.mean(1).mean()).item())
        print(f"  W1 {what}, {n_} rays x {n_inst} instances (stack "
              f"{kw_['stack_size']}, {smem} bytes of shared memory a "
              f"block): {ms:.4f} ms by {src}, plain {plain_ms} ms, "
              f"bound {b_ms:.5f} ms by {b_by}; {inner / n_:.2f} inner nodes "
              f"and {tested / n_:.2f} triangle tests a ray, a warp's "
              f"slowest lane {w1_rows[what]['warp_max_over_mean']:.3f}x its "
              "mean", flush=True)
    numbers["W1"].update(w1_rows["4o closest"])
    for what in ("4o any hit", "4p closest", "ico5 world"):
        numbers["W1"][what.replace(" ", "_")] = w1_rows[what]
    numbers["W1"]["ptxas"] = {
        k: ptxas_info("bvh", sym) for k, sym in (
            ("closest", "bvh_kernelILb0E"), ("any_hit", "bvh_kernelILb1E"))}
    for k, info in numbers["W1"]["ptxas"].items():
        info["blocks_per_sm"] = {
            what: blocks_per_sm(info["registers"], bvh_packed.THREADS,
                                row["smem_bytes"])
            for what, row in w1_rows.items()
            if (what == "4o any hit") == (k == "any_hit")}
    print(f"  W1 ptxas: {json.dumps(numbers['W1']['ptxas'])}", flush=True)
    check(all(i["spill_store_bytes"] == 0 and i["spill_load_bytes"] == 0
              for i in numbers["W1"]["ptxas"].values()),
          "W1: neither instantiation spills")
    torch.cuda.synchronize()

    # Device busy share of one Renderer.render() at the 4a, 4c, 4d, 4g and
    # 4e settings, captured. 4k's and 4o's (and 4a's, 4b's and 4e's again)
    # come from 4w's process, in turns against eager: this process has made
    # some two hundred graphs by now, and its profiler reads device busy
    # time high after that (softdof: 12.0 ms against 1.4 in 4w's process,
    # PERF.md §7), and its sessions on the photon-mapped and per-instance
    # renders cost some ten seconds each.
    def profile_render(what, desc, param, r=None, world_bvh=True):
        if r is None:
            r = Renderer(param, device="cuda")
            r.compute_scene(desc, world_bvh=world_bvh)
        else:
            r.fb = FrameBuffer(r.meta.img_width, r.meta.img_height)
        flush_profiler()
        reset_counts()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t = time.time()
            r.render()
            torch.cuda.synchronize()
            wall_p = (time.time() - t) * 1e3
        busy = {}
        for evt in prof.key_averages():
            dt = device_us(evt)
            if dt > 0:
                busy[evt.key] = dt / 1e3
        total_busy = sum(busy.values())
        top = sorted(busy.items(), key=lambda kv: -kv[1])[:5]
        print(f"  {what} Renderer under the profiler: wall {wall_p:.3f} ms, "
              f"device busy {total_busy:.3f} ms, idle share "
              f"{1.0 - total_busy / wall_p:.4f}, launches "
              f"{json.dumps(read_counts())}", flush=True)
        for key, val in top:
            print(f"    {val:.3f} ms  {key[:90]}")

    profile_render("softdof defaults", scene, RendererParam())
    profile_render("mesh_scene defaults", mesh_base, RendererParam())
    profile_render("ico5 defaults", ico5, RendererParam())
    profile_render("texture_scene defaults", tex_desc, RendererParam())
    profile_render("ico6 1 spp", ico6, RendererParam(spp_min=1, spp_max=1))

    # The Renderer's synchronous loop (Renderer._pipelined False) against
    # its one-deep pipeline, in turns (sync, pipe, pipe, sync) on one
    # renderer a scene: wall, device busy and idle share under the
    # profiler, and the planes of all the renders equal, bit for bit.
    def turns(what, desc, param, r=None, rounds=1):
        if r is None:
            r = Renderer(param, device="cuda")
            r.compute_scene(desc)
        w_, h_ = r.meta.img_width, r.meta.img_height
        r.fb = FrameBuffer(w_, h_)
        r.render()
        rows, fbs = [], []
        for pipelined in (False, True, True, False) * rounds:
            r._pipelined = pipelined
            r.fb = FrameBuffer(w_, h_)
            flush_profiler()
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as pr:
                t = time.time()
                fbs.append(r.render())
                torch.cuda.synchronize()
                wall_t = (time.time() - t) * 1e3
            busy_t = sum(device_us(e) for e in pr.key_averages()) / 1e3
            rows.append((wall_t, busy_t, 1.0 - busy_t / wall_t))
        r._pipelined = True
        print(f"  {what} {'sync/pipe/pipe/sync ' * rounds}: walls " + " / ".join(
            f"{x[0]:.3f}" for x in rows) + " ms, busy " + " / ".join(
            f"{x[1]:.3f}" for x in rows) + " ms, idle shares " + " / ".join(
            f"{x[2]:.4f}" for x in rows), flush=True)
        check(all(np.array_equal(getattr(f, k), getattr(fbs[0], k))
                  for f in fbs[1:] for k in ("mean", "color_std", "count",
                                             "zbuffer", "irrad")),
              f"{what}: pipelined and synchronous planes equal, bit for bit")
        return rows

    pipeline_turns = {}
    for what, desc in (("softdof", scene), ("mesh_scene", mesh_base),
                       ("ico5", ico5), ("texture_scene", tex_desc)):
        pipeline_turns[what] = turns(what, desc, RendererParam())
    pipeline_turns["caustics_scene photon map"] = turns(
        "caustics_scene photon map", caus_desc, p_photon, r_k)

    # Host syncs a dispatch round under torch.cuda.set_sync_debug_mode:
    # one render of softdof with the defaults in each mode.
    import warnings

    sync_counts = {}
    for pipelined in (False, True):
        r_s = Renderer(RendererParam(), device="cuda")
        r_s.compute_scene(scene)
        r_s._pipelined = pipelined
        r_s.render()
        r_s.fb = FrameBuffer(800, 600)
        stage, staged = r_s._stage, [0]

        def stage_counted(*args, _stage=stage, _n=staged):
            _n[0] += 1
            return _stage(*args)

        r_s._stage = stage_counted
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                r_s.render()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        n_sync = sum("synchroniz" in str(w_.message) for w_ in caught)
        mode = "pipelined" if pipelined else "synchronous"
        sync_counts[mode] = dict(syncs=n_sync, dispatches=staged[0])
        print(f"  softdof {mode}: {n_sync} synchronizing operations over "
              f"{staged[0]} dispatches ({n_sync / max(staged[0], 1):.2f} a "
              "dispatch)", flush=True)
    # set_sync_debug_mode does not see torch.cuda.Event.synchronize, the
    # wait in Renderer._read (once a dispatch, in either loop). Its calls
    # and the host's time blocked in them, over renders of softdof with the
    # defaults in turns (sync, pipe, pipe, sync), beside each render's wall.
    r_w = Renderer(RendererParam(), device="cuda")
    r_w.compute_scene(scene)
    r_w.render()
    read = r_w._read
    event_waits = []
    for pipelined in (False, True, True, False):
        waited = [0, 0.0]

        def read_timed(job, _read=read, _w=waited):
            if not job.done_reading and job.event is not None:
                t0 = time.perf_counter()
                job.event.synchronize()
                _w[1] += (time.perf_counter() - t0) * 1e3
                _w[0] += 1
            return _read(job)

        r_w._read = read_timed
        r_w._pipelined = pipelined
        r_w.fb = FrameBuffer(800, 600)
        torch.cuda.synchronize()
        t = time.perf_counter()
        r_w.render()
        torch.cuda.synchronize()
        wall_w = (time.perf_counter() - t) * 1e3
        mode = "pipelined" if pipelined else "synchronous"
        event_waits.append(dict(mode=mode, waits=waited[0],
                                blocked_ms=waited[1], wall_ms=wall_w))
        print(f"  softdof {mode}: {waited[0]} event waits in _read, host "
              f"blocked {waited[1]:.3f} ms of a {wall_w:.3f} ms wall",
              flush=True)
    numbers["renderer"] = dict(pipeline_turns=pipeline_turns,
                               sync_debug=sync_counts,
                               event_waits=event_waits)

    # The device's idle share eager against captured and the host's time
    # of one render of 4a and 4b in each mode (phase 4w's process).
    for name in ("4a", "4b", "4e", "4k", "4o"):
        rows = captured[name]["turns"]
        print(f"  {name} {captured[name]['what']}: idle shares " + " / ".join(
            f"{x['mode']} {x['idle_share']:.4f}" for x in rows) + ", walls "
            + " / ".join(f"{x['wall_ms']:.3f}" for x in rows) + " ms",
            flush=True)
    for name, split in captured["profile"].items():
        for mode, row in split.items():
            print(f"  {name} host split {mode}: wall {row['wall_ms']:.3f} ms; "
                  + ", ".join(f"{k} {v:.3f}"
                              for k, v in row["parts_ms"].items()),
                  flush=True)

    meta_k = {
        "K1a": ("qaray_tpu_torch/csrc/megakernel.cu",
                "qaray_tpu/ops/pallas_pathtrace.py:1614"),
        "K1b": ("qaray_tpu_torch/csrc/megakernel.cu",
                "qaray_tpu/ops/pallas_pathtrace.py:1614"),
        "K1c": ("qaray_tpu_torch/csrc/megakernel.cu",
                "qaray_tpu/ops/pallas_pathtrace.py:1614"),
        "K1d": ("qaray_tpu_torch/csrc/megakernel.cu",
                "qaray_tpu/ops/pallas_pathtrace.py:1614"),
        "K5": ("qaray_tpu_torch/csrc/photon.cu",
               "qaray_tpu/ops/pallas_photon.py:164"),
        "K3": ("qaray_tpu_torch/csrc/tiles.cu",
               "qaray_tpu/ops/pallas_mesh.py:143"),
        "K4a": ("qaray_tpu_torch/csrc/tiles.cu",
                "qaray_tpu/ops/pallas_tiles.py:385"),
        "K4b": ("qaray_tpu_torch/csrc/tiles.cu",
                "qaray_tpu/ops/pallas_tiles.py:374"),
        "K2a": ("qaray_tpu_torch/csrc/analytic.cu",
                "qaray_tpu/ops/pallas_analytic.py:212"),
        "K2b": ("qaray_tpu_torch/csrc/analytic.cu",
                "qaray_tpu/ops/pallas_analytic.py:405"),
        "K2c": ("qaray_tpu_torch/csrc/analytic.cu",
                "qaray_tpu/ops/pallas_analytic.py:174"),
        "K6": ("qaray_tpu_torch/csrc/adjoint.cu",
               "qaray_tpu/ops/pallas_adjoint.py:639"),
        "W1": ("qaray_tpu_torch/csrc/bvh.cu",
               "qaray_tpu/ops/bvh_packed.py:126 (XLA)"),
    }
    kernels = []
    for name in ("K1a", "K1b", "K1c", "K1d", "K2a", "K2b", "K2c", "K3", "K4a",
                 "K4b", "K5", "K6", "W1"):
        src, rep = meta_k[name]
        row = {"name": name, "route": "cuda", "source": src, "replaces": rep,
               "launches": launches[name]}
        row.update(numbers[name])
        kernels.append(row)
        print(f"  {name}: {row['ms']:.4f} ms by {row['timed_by']} (plain "
              f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms by "
              f"{row['bound_by']})")
    print(f"total {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def captured_phase(numbers):
    """Phase 4w: captured execution (utils/compiled.py) against the eager
    one, bit for bit, in a process of its own
    (qaray_tpu_torch/tools/capture_turns.py), whose profiler has seen no
    graphs of the phases before: the Renderer on 4a, 4b, 4e, 4k and 4o in
    turns (eager, captured, captured, eager) under the profiler,
    render_batch's and a fold's replays under sync debug mode "error", the
    fast gradient route over 3 steps with changing parameters (4m's path),
    the autograd route's step in turns with the split of its eager device
    time, a photon map build and the host's time of one render of 4a and 4b in
    each mode; captures, capture seconds, graphs and peak memory. Returns
    the figures (numbers["captured"])."""
    print("phase 4w: captured against eager, bit for bit (a process of "
          "tools/capture_turns.py)", flush=True)
    cmd = [sys.executable, "-m", "qaray_tpu_torch.tools.capture_turns",
           "sync", "4a", "4b", "4e", "4k", "4o", "grad", "autograd", "photon",
           "profile"]
    proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True)
    lines = proc.stdout.strip().splitlines()
    for line in lines[1:-1]:
        print(line, flush=True)
    check(proc.returncode == 0 and lines, "tools/capture_turns.py exits 0 "
          f"(rc {proc.returncode}; {proc.stderr.strip()[-2000:]})")
    out = numbers["captured"] = json.loads(lines[-1])
    check(out["sync"]["equal"], "render_batch (both routes) and a fold "
          "replayed under sync debug mode \"error\" equal their eager runs")
    for name in ("4a", "4b", "4e", "4k", "4o"):
        res = out[name]
        check(res["planes_equal"], f"{name}: captured and eager planes "
              "equal, bit for bit")
        check(res["again_captures"] == 0 and all(
            x["captures"] == 0 for x in res["turns"]),
            f"{name}: renders after the first capture nothing")
    check(out["grad"]["equal"] and out["grad"]["captures"][1:] == [0, 0]
          and out["grad"]["captures_again"] == [0, 0, 0]
          and out["grad"]["gradients_move"], "fast gradient route: 3 "
          "steps with changing parameters equal eager, captured on the "
          "first step only")
    for name, res in out["autograd"].items():
        check(res["loss_equal"] and res["within_eager_spread"]
              and res["launches_equal"] and res["first_captures"] >= 1
              and all(x["captures"] == 0 for x in res["turns"]),
              f"autograd step on {name}: the loss equal eager's bit for "
              "bit, every field within the eager turns' spread, eager's "
              "launches, captured on the first step only, a replay under "
              "sync debug \"error\"")
    check(out["op_split"]["busy_ms"] > 0, "the eager autograd step's "
          "device time split by operator")
    check(out["photon"]["equal"] and out["photon"]["captures"][-1] == 0,
          "photon maps: captured equal eager, a second build captures "
          "nothing")
    return out


def multi_device_phases(here, scene, fb_a, s_arr, s_meta, cfg_pt, bpx, bpy,
                        bsid, rbg, caus_desc, p_photon, fb_k, spot_grad,
                        cfg_gp, render_main, reset_counts, read_counts,
                        forbid, forbid_grad, numbers):
    """Phases 4r-4v: the sharded Renderer and render_batch on one card, two
    processes of the CLI, the sharded gradient, -profile and the preview
    server. Each launch count is set to 0 just before a driven path and
    read just after. Returns those counts (the two processes' K1a and K1d
    counts as their CLIs printed them); keeps the figures in
    numbers["multi_device"]."""
    import io
    import socket
    import urllib.request

    from PIL import Image

    from qaray_tpu_torch import cli, diff
    from qaray_tpu_torch.core.rng import key_words
    from qaray_tpu_torch.integrators.engine import render_batch
    from qaray_tpu_torch.parallel.mesh import (
        make_render_mesh,
        shard_bounds,
        shard_render_batch,
    )
    from qaray_tpu_torch.renderer import Renderer, RendererParam
    from qaray_tpu_torch.scene.xml_parser import load_scene
    from qaray_tpu_torch.utils import compiled
    from qaray_tpu_torch.viz.serve import RenderServer

    figures = numbers.setdefault("multi_device", {})
    counts_out = []
    mesh2 = make_render_mesh(["cuda:0", "cuda:0"])
    planes = ("mean", "color_std", "count", "zbuffer", "img")

    def field(out, pattern):
        m = re.search(pattern, out)
        return m.group(1) if m else None

    print("phase 4r: sharded rendering on one card: Renderer(num_devices=2) "
          "(a one-device mesh), render_batch over [cuda:0, cuda:0], and the "
          "photon-mapped caustics_scene over it", flush=True)
    fb_r, _, c_r, r_r = render_main("softdof num_devices=2", scene,
                                    RendererParam(num_devices=2))
    counts_out.append(c_r)
    check(r_r._mesh.size == 1 and c_r["K1a"] > 0,
          f"num_devices=2 on one card is a one-device mesh; K1a launched "
          f"{c_r['K1a']} times")
    check(all(np.array_equal(getattr(fb_r, k), getattr(fb_a, k))
              for k in planes), "its planes equal 4a's, bit for bit")
    run2 = shard_render_batch(mesh2)
    tf = key_words("threefry2x32", 0)
    for words, what in ((rbg, "rbg"), (tf, "threefry")):
        want = render_batch(s_arr, s_meta, cfg_pt, bpx, bpy, bsid, words,
                            want_aux=True)
        reset_counts()
        with forbid:
            got = run2(s_arr, s_meta, cfg_pt, bpx, bpy, bsid, words,
                       want_aux=True)
            torch.cuda.synchronize()
        c = read_counts()
        counts_out.append(c)
        check(c["K1a"] == 2 and c["wavefront_lanes"] == 0,
              f"two shards of 240,000 lanes, {what}: K1a launched twice")
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"{what}: radiance, depth and aux plane equal to one "
              "render_batch's, bit for bit")
    with tempfile.TemporaryDirectory() as wd, contextlib.chdir(wd):
        fb_rk, _, c_rk, _ = render_main("caustics_scene photon map, 2 shards",
                                        caus_desc, p_photon, mesh=mesh2)
    counts_out.append(c_rk)
    err_k = float(np.abs(fb_rk.mean - fb_k.mean).max())
    check(c_rk["K1d"] > 0 and c_rk["K5"] == c_rk["K1d"]
          and c_rk["K1a"] == c_rk["K1d"],
          f"K1a and K1d launched {c_rk['K1d']} times, K5 {c_rk['K5']}")
    check(np.array_equal(fb_rk.count, fb_k.count) and err_k < 1e-5,
          f"counts equal to 4k's, mean within {err_k:.3g} < 1e-5")

    # Sharded against unsharded, in turns: the Renderer with the defaults
    # and one 480,000-lane render_batch, and the gather alone (the cat of
    # the two shards' outputs).
    walls = []
    for sharded in (False, True, True, False):
        r_t = Renderer(RendererParam(), device="cuda",
                       mesh=mesh2 if sharded else None)
        r_t.compute_scene(scene)
        torch.cuda.synchronize()
        t = time.perf_counter()
        r_t.render()
        torch.cuda.synchronize()
        walls.append(((time.perf_counter() - t) * 1e3, sharded))
    cuts = shard_bounds(bpx.shape[0], 2)
    halves = [render_batch(s_arr, s_meta, cfg_pt, bpx[a:b], bpy[a:b],
                           bsid[a:b], rbg) for a, b in zip(cuts, cuts[1:])]
    batch_ms = [cuda_ms(lambda: render_batch(s_arr, s_meta, cfg_pt, bpx,
                                             bpy, bsid, rbg), 5),
                cuda_ms(lambda: run2(s_arr, s_meta, cfg_pt, bpx, bpy, bsid,
                                     rbg), 5)]
    batch_ms += [cuda_ms(lambda: run2(s_arr, s_meta, cfg_pt, bpx, bpy,
                                      bsid, rbg), 5),
                 cuda_ms(lambda: render_batch(s_arr, s_meta, cfg_pt, bpx,
                                              bpy, bsid, rbg), 5)]
    cat_ms = cuda_ms(lambda: [torch.cat([h[j] for h in halves])
                              for j in range(2)], 10)
    share = cat_ms / (0.5 * (batch_ms[1] + batch_ms[2]))
    print("  Renderer wall ms in turns (unsharded, 2 shards, 2 shards, "
          "unsharded): " + ", ".join(f"{w:.3f}" for w, _ in walls),
          flush=True)
    print("  render_batch 480,000 lanes ms in turns (unsharded, 2 shards, 2 "
          "shards, unsharded): " + ", ".join(f"{m:.4f}" for m in batch_ms)
          + f"; the gather (cat) {cat_ms:.4f} ms, {share:.4f} of a sharded "
          "dispatch", flush=True)
    figures.update(renderer_turns_ms=[w for w, _ in walls],
                   batch_turns_ms=batch_ms, gather_ms=cat_ms,
                   gather_share=share)

    torch.cuda.empty_cache()  # room for the children's contexts
    print("phase 4s: two processes of the CLI, -multihost -coordinator "
          "localhost:P,2,r -rank-debug (gloo, both on cuda:0), softdof "
          "800x600 x 2 spp, against one process", flush=True)
    child = ("import json, sys\n"
             f"sys.path.insert(0, {here!r})\n"
             "from qaray_tpu_torch.cli import main\n"
             "rc = main(sys.argv[1:])\n"
             "from qaray_tpu_torch.ops import megakernel\n"
             "print('launches ' + json.dumps(megakernel.launches), "
             "flush=True)\n"
             "sys.exit(rc)\n")
    base = [SCENE, "-res", "800x600", "-spp", "2"]
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    with tempfile.TemporaryDirectory() as wd:
        def spawn(args):
            return subprocess.Popen([sys.executable, "-c", child, *base,
                                     *args], cwd=wd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)

        t = time.perf_counter()
        procs = [spawn(["-multihost", "-coordinator",
                        f"localhost:{port},2,{r}", "-rank-debug", "-out",
                        f"mh{r}_"]) for r in range(2)]
        outs, proc_s = [], []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=300)[0])
                proc_s.append(time.perf_counter() - t)
        finally:
            for p in procs:
                p.kill()
        t = time.perf_counter()
        solo = spawn(["-out", "sp_"])
        try:
            solo_out = solo.communicate(timeout=300)[0]
        finally:
            solo.kill()
        solo_s = time.perf_counter() - t

        def png(name):
            return np.asarray(Image.open(os.path.join(wd, name))).astype(int)

        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                print(out[-4000:], flush=True)
            check(p.returncode == 0 and f"multihost: process {r}/2, 2 "
                  "devices" in out and "collectives on gloo" in out,
                  f"rank {r} exits 0 after rendering with gloo")
            on = field(out, rf"multihost: process {r} on ([^\n]*)")
            check(torch.cuda.get_device_name(0) in (on or ""),
                  f"rank {r}'s output names the card: {on}")
            c = json.loads(field(out, r"launches (\{[^\n]*\})"))
            check(c["K1a"] > 0, f"rank {r} launched K1a {c['K1a']} times")
            counts_out.append(c)
        check(solo.returncode == 0, "the single-process CLI exits 0")
        check(not os.path.exists(os.path.join(wd, "mh1_colorBuffer.png")),
              "rank 1 writes no colour buffer")
        check(np.array_equal(png("mh0_colorBuffer.png"),
                             png("sp_colorBuffer.png")),
              "the primary's colorBuffer.png equals the single-process "
              "render's, bit for bit")
        masks = png("mh0_rank0_maskBuffer.png") + png(
            "mh1_rank1_maskBuffer.png")
        check(bool((masks == 2).all()), "the ranks' mask planes sum to the "
              "spp (2) at every pixel")
        elapsed = [float(field(o, r"Elapsed Time is ([0-9.]+) s"))
                   for o in outs + [solo_out]]
        blocked = [(int(field(o, r"process \d, (\d+) all_gathers")),
                    float(field(o, r"all_gathers \(gloo\), ([0-9.]+) s")))
                   for o in outs]
    print(f"  two processes: render (Elapsed Time) {elapsed[0]:.4f} / "
          f"{elapsed[1]:.4f} s, process wall {proc_s[0]:.3f} / "
          f"{proc_s[1]:.3f} s; one process: render {elapsed[2]:.4f} s, "
          f"process wall {solo_s:.3f} s; all_gathers a rank and the host "
          f"seconds blocked in them: {blocked}", flush=True)
    figures.update(two_process_render_s=elapsed[:2],
                   two_process_wall_s=proc_s, single_render_s=elapsed[2],
                   single_wall_s=solo_s, all_gather_blocked=blocked)

    print("phase 4t: the sharded gradient, render_value_and_grad over "
          "[cuda:0, cuda:0] on spot_scene's 262,144 lanes, fast route and "
          "autograd", flush=True)
    g_arr, g_meta, gx, gy = spot_grad
    gs = torch.ones_like(gx)
    for no_mega in (False, True):
        route = "autograd" if no_mega else "fast"
        if no_mega:
            os.environ["QARAY_NO_MEGAKERNEL"] = "1"
        try:
            loss_1, want = diff.render_value_and_grad(g_arr, g_meta, cfg_gp,
                                                      gx, gy, gs, rbg)
            reset_counts()
            with forbid_grad:
                loss_2, got = diff.render_value_and_grad(
                    g_arr, g_meta, cfg_gp, gx, gy, gs, rbg, mesh=mesh2)
                torch.cuda.synchronize()
            c = read_counts()
        finally:
            os.environ.pop("QARAY_NO_MEGAKERNEL", None)
        counts_out.append(c)
        if no_mega:
            check(c["K6"] == 0 and c["K1a"] == 0 and c["K2b"] > 0
                  and c["H1"] > 0, f"autograd route: K2b {c['K2b']}, H1 "
                  f"{c['H1']} launches, no K1a or K6")
        else:
            check(c["K1a"] == 2 and c["K6"] == 2,
                  "fast route: K1a and K6 launched once a shard")
        errs = {f: ((getattr(got, f).double() - getattr(want, f).double())
                    .abs().max() / (1.0 + getattr(want, f).double().abs()
                                    .max())).item()
                for f in diff.DiffParams._fields}
        worst = max(errs.values())
        print(f"  {route}: loss {float(loss_2):.8g} against "
              f"{float(loss_1):.8g}; worst field {worst:.3g} of 1 + max|b|",
              flush=True)
        check(worst <= 1e-5, f"{route}: every field within 1e-5 of 1 + "
              "max|b| of the unsharded gradient")

    print("phase 4u: timing and profiling, the CLI with -profile on softdof "
          "200x150", flush=True)
    with tempfile.TemporaryDirectory() as pd:
        buf = io.StringIO()
        reset_counts()
        with forbid, contextlib.redirect_stdout(buf):
            rc = cli.main([SCENE, "-res", "200x150", "-profile",
                           os.path.join(pd, "prof"), "-out",
                           os.path.join(pd, "p_")])
        c = read_counts()
        trace = os.path.join(pd, "prof", "trace.json")
        text = open(trace).read() if os.path.exists(trace) else ""
    counts_out.append(c)
    line = field(buf.getvalue(), r"(Elapsed Time is [0-9.]+ s)")
    check(rc == 0 and line is not None, f"the CLI exits 0 and prints "
          f"'{line}'")
    check(c["K1a"] > 0 and "mega_kernel" in text, f"K1a launched "
          f"{c['K1a']} times and the trace ({len(text)} bytes) names its "
          "kernel, mega_kernel")

    print("phase 4v: the preview server on the card: spot_scene 200x150, "
          "spp 2, port 0", flush=True)
    sd = load_scene(SPOT_SCENE)
    sd.camera.img_width, sd.camera.img_height = 200, 150

    def get(srv, path):
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{path}",
                                    timeout=60) as resp:
            return resp.read()

    def finished(srv, gen0):
        deadline = time.time() + 120
        while time.time() < deadline:
            st = json.loads(get(srv, "/status"))
            if st["generation"] > gen0 and not st["rendering"] \
                    and st["spp"] >= 2:
                return st
            time.sleep(0.1)
        raise AssertionError(f"no finished render after generation {gen0}")

    reset_counts()
    with forbid:
        srv = RenderServer(Renderer(RendererParam(spp_min=2, spp_max=2),
                                    device="cuda"), sd, port=0)
        srv.serve(block=False)
        try:
            st = finished(srv, 0)
            first, depth = get(srv, "/image.png"), get(srv, "/depth.png")
            orbit_caps = []
            for _ in range(3):
                c0 = compiled.stats["captures"]
                get(srv, "/orbit?dyaw=30")
                st = finished(srv, st["generation"])
                orbit_caps.append(compiled.stats["captures"] - c0)
                if len(orbit_caps) == 1:
                    second = get(srv, "/image.png")
        finally:
            srv.shutdown()
    c = read_counts()
    print(f"  graphs captured by each of three /orbit frames: {orbit_caps}",
          flush=True)
    check(orbit_caps == [0, 0, 0], "/orbit frames replay the first "
          "render's graphs (a new camera is a table copied in)")
    figures["orbit_captures"] = orbit_caps
    counts_out.append(c)
    check(st["spp"] >= 2 and first[:4] == depth[:4] == b"\x89PNG",
          f"/status reached spp {st['spp']}; /image.png and /depth.png are "
          "PNGs")
    check(second[:4] == b"\x89PNG" and second != first,
          "/orbit?dyaw=30 rendered a different image")
    check(c["K1a"] > 0, f"K1a launched {c['K1a']} times by the server")
    return counts_out


if __name__ == "__main__":
    sys.exit(main())
