"""Device times of the port's kernels on one GPU at the main path's
shapes, for comparing two trees in one call:

- the megakernel at 480,000 pathtrace lanes (800x600, one sample a pixel,
  max_bounce 5, shadows 16 -> 64, the Renderer's rbg key words) of softdof
  (K1a), texture_scene (K1b), mesh_scene and its icosphere at ico5 (K1c),
  and its photonmap launch on caustics_scene (softdof with a glass middle
  sphere) with the default maps (K1d), as chip_smoke.py phase 5 launches
  them;
- K5 in that photonmap launch (its records through ops/photon.gather_apply);
- K6 on mesh_scene at the gradient path's shape (131,072 lanes, the mean
  loss's cotangent), on spot_scene at that shape (262,144 lanes) and on
  its full 800x600 frame (480,000), and on the glass scene (softdof with
  its middle sphere glass and no depth of field, 480,000 lanes; its soft
  light);
- K2c on 1,048,576 random rays against softdof's primitives (a wavefront
  batch's 16 soft-shadow rays a lane, chip_smoke.py phase 5's shape) and
  on the first 5,008 to 3,145,728 of such rays (K2C_SIZES: the sizes of
  its launches on the main path);
- K3 on the camera rays of mesh_scene and of ico5, K4a and K4b on those of
  ico6 (coherence-sorted, as the tiled route walks them; K4b on rays from
  their hit points towards the point (10, 80, 60), budget its distance);
- K2a and K2b against softdof's primitives at K2_SIZES (a wavefront
  batch's 65,536 and 480,000 rays and the largest of K2b's launches on
  the main path, a photon pass's 1,048,576),
  on chip_smoke.py phase 2a's random rays and on the rays of bounces 0
  and 1 of one wavefront batch of softdof of that size (batch_rays); K2b
  also without the uv where the tree's closest_full takes want_uv, and
  the time of a call of its wrapper by CUDA events (wrapper_ms);
- W1 at four launches (w1_launches): the largest closest-hit and any-hit
  launches of one Renderer.render() of grid_scene per instance with the
  defaults (chip_smoke.py 4o), the largest closest-hit launch of the 5x5
  grid of ico5 per instance at 1 spp (4p), and ico5's world tree on
  mesh_scene's 480,000 camera rays (4n's route); with ptxas's registers,
  spills and stack frame of both instantiations from the tree's build.

    python -m qaray_tpu_torch.tools.kernel_times [GROUP ...]

GROUP is any of K1 (K1a-K1d and K5), K6, K2c, K3, K4, K2, W1 (default:
all).

Each time is torch.profiler's device time of the kernel, the mean over 20
launches after one that is not counted. The script reaches the package
through the import path and uses only entry points older trees have, so
that one copy of it times another tree's kernels in the same call:

    PYTHONPATH=<tree> python qaray_tpu_torch/tools/kernel_times.py

Prints the card's name and power limit and, last, one JSON line.
"""

import contextlib
import json
import os
import subprocess
import sys
import tempfile

import torch


def device_ms(fn, kernel, reps=20):
    """Mean device milliseconds a launch of the kernels whose name holds
    `kernel`, fn launching one. The profiler now and then records none of
    a run's launches; the run is then repeated, up to three times."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        seen = [e for e in prof.key_averages() if kernel in e.key]
        total = sum(getattr(e, "self_device_time_total", None)
                    or getattr(e, "self_cuda_time_total", 0) for e in seen)
        count = sum(e.count for e in seen)
        if count and total > 0:
            return total / count / 1e3
    raise SystemExit(f"the profiler recorded no {kernel} launch")


def wrapper_ms(fn, reps=50):
    """Milliseconds a call of fn, by CUDA events around `reps` calls after
    one that is not counted: where each call's kernel is short, the host's
    time to make the call."""
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


def shadow_rays(n, seed=0):
    """n of chip_smoke.py phase 2a's random rays: p in [-30, 30]^3, unit d,
    t_max in [1, 60], from a seeded CUDA generator."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    p = torch.rand((n, 3), device="cuda", generator=gen) * 60.0 - 30.0
    d = torch.randn((n, 3), device="cuda", generator=gen)
    d = d / d.norm(dim=1, keepdim=True)
    t_max = torch.rand(n, device="cuda", generator=gen) * 59.0 + 1.0
    return p, d, t_max


def batch_rays(arr, meta, n):
    """The rays of K2b's first two launches (bounces 0 and 1) in one
    wavefront batch of n lanes of the scene at 800x600 (pathtrace,
    max_bounce 5, the Renderer's rbg key words): [(p, d), (p, d)]."""
    from qaray_tpu_torch.core.rng import key_words
    from qaray_tpu_torch.integrators.engine import (
        IntegratorConfig,
        render_batch_wavefront,
    )
    from qaray_tpu_torch.ops import analytic
    from qaray_tpu_torch.renderer import RendererParam

    ids = torch.arange(n, device="cuda", dtype=torch.int32)
    calls = []
    full = analytic.closest_full

    def capture(p, d, prims, **kw):
        if len(calls) < 2:
            calls.append((p.contiguous().clone(), d.contiguous().clone()))
        return full(p, d, prims, **kw)

    analytic.closest_full = capture
    try:
        render_batch_wavefront(arr, meta, IntegratorConfig(
            integrator="pathtrace", max_bounce=5), ids % 800,
            (ids // 800) % 600, ids // (800 * 600),
            key_words("rbg", RendererParam().seed))
    finally:
        analytic.closest_full = full
    return calls


def glass_desc(desc):
    """The gradient path's glass scene: softdof with its middle sphere
    glass and no depth of field (chip_smoke.py phase 3f)."""
    from qaray_tpu_torch.scene.procedural import with_glass

    desc = with_glass(desc, "mid")
    desc.camera.depth_of_field = 0.0
    return desc


def w1_launches(assets, images=None):
    """W1's four timed launches: {name: (p, d, t, occ_in, tabs, kwargs)},
    any hit where occ_in is not None ("4o closest", "4o any hit", "4p
    closest", "ico5 world"). The 4o and 4p launches are captured from one
    Renderer.render() each (the first launch at the largest size of each
    kind; the inputs cloned); with a dict `images`, those renders' frame
    buffers (mean, count, 8-bit image) go into it under "4o" and "4p"."""
    from qaray_tpu_torch.integrators import engine
    from qaray_tpu_torch.ops import bvh_packed
    from qaray_tpu_torch.renderer import Renderer, RendererParam
    from qaray_tpu_torch.scene.compiler import compile_scene
    from qaray_tpu_torch.scene.procedural import (
        icosphere,
        with_mesh,
        with_shared_mesh,
    )
    from qaray_tpu_torch.scene.xml_parser import load_scene

    def desc_of(name):
        desc = load_scene(os.path.join(assets, name))
        desc.camera.img_width, desc.camera.img_height = 800, 600
        return desc

    def largest(desc, param, what):
        seen = {}
        closest, occluded = bvh_packed.closest, bvh_packed.occluded

        def keep(kind, p, d, t, occ_in, tabs, kw):
            if kind not in seen or p.shape[0] > seen[kind][0].shape[0]:
                seen[kind] = (p.clone(), d.clone(), t.clone(),
                              None if occ_in is None else occ_in.clone(),
                              tabs, dict(kw))

        def closest_kept(p, d, t, *tabs, **kw):
            keep("closest", p, d, t, None, tabs, kw)
            return closest(p, d, t, *tabs, **kw)

        def occluded_kept(p, d, t, occ_in, *tabs, **kw):
            keep("any hit", p, d, t, occ_in if occ_in is not None else
                 torch.zeros(p.shape[0], dtype=torch.bool,
                             device=p.device), tabs, kw)
            return occluded(p, d, t, occ_in, *tabs, **kw)

        bvh_packed.closest, bvh_packed.occluded = closest_kept, occluded_kept
        try:
            r = Renderer(param, device="cuda")
            r.compute_scene(desc, world_bvh=False)
            fb = r.render()
        finally:
            bvh_packed.closest, bvh_packed.occluded = closest, occluded
        if images is not None:
            images[what] = {k: torch.from_numpy(getattr(fb, k).copy())
                            for k in ("mean", "count", "img")}
        return seen

    grid = desc_of("grid_scene.xml")
    out = {}
    o = largest(grid, RendererParam(), "4o")
    out["4o closest"], out["4o any hit"] = o["closest"], o["any hit"]
    out["4p closest"] = largest(
        with_shared_mesh(grid, *icosphere(5), name="ico5"),
        RendererParam(spp_min=1, spp_max=1), "4p")["closest"]
    arr, meta = compile_scene(with_mesh(desc_of("mesh_scene.xml"),
                                        *icosphere(5), name="ico5"),
                              device="cuda")
    ids = torch.arange(800 * 600, device="cuda", dtype=torch.int32)
    p, d, *_ = engine.generate_camera_rays(arr, meta, ids % 800, ids // 800,
                                           ids * 0, None)
    out["ico5 world"] = (
        p.contiguous(), d.contiguous(),
        torch.full((p.shape[0],), 1e30, device="cuda"), None,
        (arr.mesh.pnodes, arr.mesh.ltri, arr.instances.proot[:1], None),
        dict(max_leaf=meta.max_leaf, stack_size=meta.bvh_depth + 2))
    return out


def w1_walked(launch):
    """Instances each ray of an any-hit launch of w1_launches walks: 0
    where occluded on entry, else up to and including the first instance
    that occludes it (from one any-hit launch of W1 an instance)."""
    from qaray_tpu_torch.ops import bvh_packed

    p, d, t, occ_in, tabs, kw = launch
    kw = {k: v for k, v in kw.items() if k != "plain"}
    n_inst = tabs[2].numel()
    first = torch.full((p.shape[0],), n_inst, device=p.device)
    for i in reversed(range(n_inst)):
        occ_i = bvh_packed.occluded(p, d, t, None, tabs[0], tabs[1],
                                    tabs[2][i:i + 1], tabs[3][i:i + 1], **kw)
        first = torch.where(occ_i, i + 1, first)
    return torch.where(occ_in, 0, first)


def w1_call(launch, plain=False):
    """fn() that makes one of w1_launches' calls."""
    from qaray_tpu_torch.ops import bvh_packed

    p, d, t, occ_in, tabs, kw = launch
    kw = dict(kw, plain=plain)
    if occ_in is None:
        return lambda: bvh_packed.closest(p, d, t, *tabs, **kw)
    return lambda: bvh_packed.occluded(p, d, t, occ_in, *tabs, **kw)


def ptxas_report(name, symbols):
    """{key: registers, spill bytes, stack frame and static shared memory}
    of the kernels whose mangled names hold symbols[key], from nvcc's
    -Xptxas=-v report of library `name` of the tree on the import path
    (ops/_build writes it beside the library)."""
    import re

    from qaray_tpu_torch.ops import _build

    lines = _build._target(name).with_suffix(".log").read_text().splitlines()
    out = {}
    for key, sym in symbols.items():
        i = next(i for i, ln in enumerate(lines)
                 if "Function properties for" in ln and sym in ln)
        frame = re.search(r"(\d+) bytes stack frame", lines[i + 1])
        spill = dict((k, int(v)) for v, k in re.findall(
            r"(\d+) bytes spill (stores|loads)", lines[i + 1]))
        regs = re.search(r"Used (\d+) registers", lines[i + 2])
        smem = re.search(r"(\d+) bytes smem", lines[i + 2])
        out[key] = dict(registers=int(regs.group(1)),
                        stack_frame_bytes=int(frame.group(1)),
                        spill_store_bytes=spill["stores"],
                        spill_load_bytes=spill["loads"],
                        static_smem_bytes=int(smem.group(1)) if smem else 0)
    return out


W1_SYMBOLS = {"closest": "bvh_kernelILb0E", "any_hit": "bvh_kernelILb1E"}
GROUPS = ("K1", "K6", "K2c", "K3", "K4", "K2", "W1")
# K2c's sizes: those of its launches on the main path (chip_smoke.py phase
# 4), from the photon paths' 5,008 to a batch's 3,145,728 escalated
# soft-shadow rays, and a batch's 65,536 hard shadow rays.
K2C_SIZES = (5008, 30624, 60572, 65536, 131072, 262144, 480000, 605720,
             1048576, 3145728)
# K2a's and K2b's sizes: a wavefront batch's 65,536 rays (phase 4b), one of
# 480,000 (the Renderer's batch of a frame) and the largest of K2b's
# launches on the main path, a photon pass of 1,048,576 paths
# (chip_smoke.py phase 4).
K2_SIZES = (65536, 480000, 1048576)


def main(argv=()):
    want = set(argv) or set(GROUPS)
    if not want <= set(GROUPS):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import qaray_tpu_torch
    from qaray_tpu_torch.integrators import engine
    from qaray_tpu_torch.integrators.engine import IntegratorConfig
    from qaray_tpu_torch.ops import adjoint, analytic, megakernel
    from qaray_tpu_torch.ops import mesh_sweep, photon
    from qaray_tpu_torch.ops import tiles
    from qaray_tpu_torch.ops.mesh_tiles import TiledMesh, coherence_order
    from qaray_tpu_torch.core.rng import key_words
    from qaray_tpu_torch.photon.build import build_photon_maps
    from qaray_tpu_torch.photon.cluster import cluster_photon_map
    from qaray_tpu_torch.renderer import Renderer, RendererParam
    from qaray_tpu_torch.scene.compiler import compile_scene
    from qaray_tpu_torch.scene.procedural import (
        icosphere,
        with_glass,
        with_mesh,
    )
    from qaray_tpu_torch.scene.xml_parser import load_scene

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    assets = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(qaray_tpu_torch.__file__))), "tests", "assets")
    cfg = IntegratorConfig(integrator="pathtrace", max_bounce=5)
    rbg = key_words("rbg", RendererParam().seed)
    ids = torch.arange(800 * 600, device="cuda", dtype=torch.int32)
    px, py, sid = ids % 800, ids // 800, ids * 0
    out = {"card": card, "package": os.path.dirname(qaray_tpu_torch.__file__)}

    def scene(name, edit=None):
        desc = load_scene(os.path.join(assets, name))
        if edit is not None:
            desc = edit(desc)
        desc.camera.img_width, desc.camera.img_height = 800, 600
        return compile_scene(desc, device="cuda")

    def mega(name, arr, meta, cfg_=cfg, maps=None):
        before = megakernel.launches[name]
        out[name if name not in out else f"{name}_ico5"] = device_ms(
            lambda: megakernel.mega_render(arr, meta, cfg_, px, py, sid, rbg,
                                           photon_maps=maps), "mega_kernel")
        if megakernel.launches[name] == before:
            raise SystemExit(f"no {name} launch")

    if "K1" in want:
        mega("K1a", *scene("softdof_scene.xml"))
        mega("K1b", *scene("texture_scene.xml"))
        mega("K1c", *scene("mesh_scene.xml"))
        mega("K1c", *scene("mesh_scene.xml", lambda d: with_mesh(
            d, *icosphere(5), name="ico5")))
        c_arr, c_meta = scene("softdof_scene.xml",
                              lambda d: with_glass(d, "mid"))
        p_photon = RendererParam(use_photon_map=True)
        with tempfile.TemporaryDirectory() as wd, contextlib.chdir(wd):
            maps = tuple(cluster_photon_map(m) for m in build_photon_maps(
                c_arr, c_meta, p_photon))
        cfg_ph = Renderer(p_photon, device="cuda").integrator_config()
        mega("K1d", c_arr, c_meta, cfg_ph, maps)
        out["K5"] = device_ms(lambda: megakernel.mega_render(
            c_arr, c_meta, cfg_ph, px, py, sid, rbg, photon_maps=maps),
            "gather_kernel")

    # K6 at the gradient path's shapes and on the glass scene.
    cfg_g = IntegratorConfig(integrator="pathtrace", max_bounce=5,
                             shadow_spp=16)
    if "K6" in want:
        spot = scene("spot_scene.xml")
        for name, (arr, meta), n_g in (
                ("K6_mesh", scene("mesh_scene.xml"), 1 << 17),
                ("K6_spot", spot, 1 << 18),
                ("K6_spot_frame", spot, 800 * 600),
                ("K6_glass", scene("softdof_scene.xml", glass_desc),
                 800 * 600)):
            g_ids = torch.arange(n_g, device="cuda", dtype=torch.int32)
            ct = torch.full((n_g, 3), 1.0 / (3 * n_g), device="cuda")
            out[name] = device_ms(lambda: adjoint.adjoint_render(
                arr, meta, cfg_g, g_ids % 800, (g_ids // 800) % 600,
                g_ids * 0, rbg, ct), "adjoint_kernel")

    # K2c at a wavefront batch's soft-shadow shape ("K2c") and at the sizes
    # of its other launches.
    if "K2c" in want:
        prims = scene("softdof_scene.xml")[0].analytic
        p, d, t_max = shadow_rays(max(K2C_SIZES))
        for n in K2C_SIZES:
            out["K2c" if n == 1 << 20 else f"K2c_{n}"] = device_ms(
                lambda: analytic.shadow(p[:n], d[:n], t_max[:n], prims),
                "shadow_kernel")

    # K2a and K2b on random rays and on a softdof batch's bounces 0 and 1.
    if "K2" in want:
        import inspect

        s_arr, s_meta = scene("softdof_scene.xml")
        prims = s_arr.analytic
        no_uv = "want_uv" in inspect.signature(
            analytic.closest_full).parameters
        for n in K2_SIZES:
            p, d, _ = shadow_rays(n)
            (p0, d0), (p1, d1) = batch_rays(s_arr, s_meta, n)
            for what, (pr, dr) in (("random", (p, d)), ("bounce0", (p0, d0)),
                                   ("bounce1", (p1, d1))):
                out[f"K2a_{what}_{n}"] = device_ms(
                    lambda: analytic.closest(pr, dr, prims), "closest_kernel")
                out[f"K2b_{what}_{n}"] = device_ms(
                    lambda: analytic.closest_full(pr, dr, prims),
                    "closest_full_kernel")
                if no_uv:
                    out[f"K2b_nouv_{what}_{n}"] = device_ms(
                        lambda: analytic.closest_full(pr, dr, prims,
                                                      want_uv=False),
                        "closest_full_kernel")
            out[f"K2b_wrapper_{n}"] = wrapper_ms(
                lambda: analytic.closest_full(p, d, prims))

    # W1 at its four launches, and both instantiations' ptxas report.
    if "W1" in want:
        for name, launch in w1_launches(assets).items():
            out[f"W1 {name}"] = device_ms(w1_call(launch), "bvh_kernel")
        out["W1 ptxas"] = ptxas_report("bvh", W1_SYMBOLS)

    # K3 on camera rays as they come; K4a/K4b on ico6's, sorted.
    for what, edit in (("mesh_scene", None),
                       ("ico5", lambda d: with_mesh(d, *icosphere(5),
                                                    name="ico5"))):
        if "K3" not in want:
            break
        arr, meta = scene("mesh_scene.xml", edit)
        p, d, *_ = engine.generate_camera_rays(arr, meta, px, py, sid, None)
        p, d = p.contiguous(), d.contiguous()
        t_big = torch.full((p.shape[0],), 1e30, device="cuda")
        walk = mesh_sweep.walk_of(arr.mesh)
        out[f"K3_{what}"] = device_ms(lambda: mesh_sweep.sweep_closest(
            p, d, t_big, arr.mesh.stream_c16, walk=walk), "walk_kernel")
    if "K4" not in want:
        print(card, flush=True)
        print(json.dumps(out), flush=True)
        return 0
    arr, meta = scene("mesh_scene.xml",
                      lambda d: with_mesh(d, *icosphere(6), name="ico6"))
    m = arr.mesh
    tm = TiledMesh(m.tile_coeff, m.tile_const, m.tile_gid, m.tile_cbounds)
    p, d, *_ = engine.generate_camera_rays(arr, meta, px, py, sid, None)
    perm = coherence_order(p, d, m.tile_cbounds[:, :3].amin(0),
                           m.tile_cbounds[:, 3:6].amax(0))
    ps, ds = p[perm].contiguous(), d[perm].contiguous()
    t_big = torch.full((ps.shape[0],), 1e30, device="cuda")
    out["K4a"] = device_ms(lambda: tiles.tiled_sweep_kernel(
        ps, ds, t_big, tm, m.tile_c16T, tree=m.tile_tree), "walk_kernel")
    t_hit = tiles.tiled_sweep_kernel(ps, ds, t_big, tm, m.tile_c16T,
                                     tree=m.tile_tree)[0]
    hp = ps + ds * torch.where(t_hit < 1e29, t_hit, 0.0)[:, None]
    light = torch.tensor([10.0, 80.0, 60.0], device="cuda")
    to_l = light - hp
    dist = to_l.norm(dim=1)
    sd = (to_l / dist[:, None]).contiguous()
    out["K4b"] = device_ms(lambda: tiles.tiled_sweep_kernel(
        hp.contiguous(), sd, dist, tm, m.tile_c16T, any_hit=True,
        tree=m.tile_tree), "walk_kernel")
    print(card, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
