"""Outputs of the kernels K1c, K2a-K2c, K5, K6 and W1 at the main path's
shapes, written by one tree and compared with another's, to hold a
redesigned kernel to its parent bit for bit on one GPU.

    PYTHONPATH=<tree> python qaray_tpu_torch/tools/parity_dump.py \
        dump OUT.pt [--records FILE] [--only W1]
    python qaray_tpu_torch/tools/parity_dump.py compare A.pt B.pt
    python qaray_tpu_torch/tools/parity_dump.py sass TREE_A TREE_B [LIB ...]

`dump` writes, for the tree on the import path:
- K1c: radiance, primary depth and the 8 work counters of one megakernel
  launch of 480,000 lanes (800x600, one sample a pixel, max_bounce 5, rbg
  key words, shadows 16 -> 64), pathtrace and photonmap, on
  tests/assets/mesh_scene.xml (320 triangles), on it with its icosphere at
  ico5 (20,480) and on tests/assets/mirror_scene.xml;
- K6: the loss and gradients of diff.render_value_and_grad's fast route
  at chip_smoke.py phase 4m's shapes (sample 1) on mesh_scene (131,072
  lanes) and spot_scene (262,144), and on the glass scene (softdof with
  its middle sphere glass and no depth of field; 262,144 lanes), twice
  each, and the adjoint's 4 work counters;
- K2c: occlusion of chip_smoke.py phase 2a's 1,048,576 random rays
  against softdof's primitives, of the 1,048,576 soft-shadow rays of one
  wavefront batch of softdof (65,536 lanes, 16 samples a lane, rbg), of
  the random rays as views at a 4-byte offset, and of their first 1, 31,
  65,537 and 1,000,001 (on 132 SMs past 3 rays a thread of K2c's grid,
  from where rays go in pairs);
- K2a and K2b (every output, with the uv): on chip_smoke.py phase 2a's
  1,048,576 random rays against softdof's primitives, on them as views at
  a 4-byte offset, on their first 1, 31 and 65,537, and on the rays of
  bounces 0 and 1 of one wavefront batch of softdof of 480,000 lanes
  (kernel_times.batch_rays);
- the wavefront route (QARAY_NO_MEGAKERNEL): one Renderer.render() at
  800x600 and 1 spp of softdof, mesh_scene and texture_scene (the mean,
  the count and the 8-bit image of the frame buffer), and the photon maps
  of caustics_scene (build_photon_maps, traced on K2b);
- K5: the global-map records of one photon-mapped dispatch of
  caustics_scene at 800x600 (softdof with a glass middle sphere, default
  maps), Morton-sorted as gather_apply sorts them, and photon_gather's
  sums and counts on them at r 0.2 and 50. With --records the records,
  the soft-shadow rays and K2a/K2b's batch rays are read from an earlier
  dump, so that both trees gather the same queries and test the same
  rays;
- W1: at kernel_times.w1_launches' four launches (4o's largest
  closest-hit and any-hit launches, 4p's largest closest-hit launch,
  ico5's world tree on mesh_scene's camera rays) its outputs (t,
  instance, triangle, bary, front; the any-hit flags) and its work
  counters (inner nodes, triangle tests), and the frame buffers of the
  4o and 4p renders those launches were captured from. With --records
  the launches' inputs are read from the earlier dump. --only W1 dumps
  W1's outputs alone.

`sass` compares, kernel by kernel, the SASS (cuobjdump -sass) of the
libraries LIB (default megakernel and adjoint) that runs of two trees
built under their build/kernels/, and ptxas's registers and spills of
their builds: a change to a shared header that must leave those kernels'
code alone shows it there.

`compare` prints, for each output, whether the two dumps hold the same
bits (work column 3, K1c's and K6's triangle tests, is compared by its
mean: a redesign of the mesh walk changes it; a gradient that differs
also prints its largest difference over the field's max|b|), and one
JSON line.
"""

import contextlib
import json
import os
import sys
import tempfile

import torch

K1C_SCENES = ("mesh", "ico5", "mirror")


def k6(out, what, arr, meta, n_g):
    """K6's outputs on `what` at n_g lanes of 800x600, sample 1: the fast
    route's loss and gradients twice, and the adjoint's work counters."""
    from qaray_tpu_torch import diff
    from qaray_tpu_torch.core.rng import key_words
    from qaray_tpu_torch.integrators.engine import IntegratorConfig
    from qaray_tpu_torch.ops import adjoint
    from qaray_tpu_torch.renderer import RendererParam

    rbg = key_words("rbg", RendererParam().seed)
    cfg_g = IntegratorConfig(integrator="pathtrace", max_bounce=5,
                             shadow_spp=16)
    g = torch.arange(n_g, device="cuda", dtype=torch.int32)
    gx, gy, gs = g % 800, (g // 800) % 600, torch.full_like(g, 1)
    for k in range(2):
        loss, grads = diff.render_value_and_grad(arr, meta, cfg_g, gx, gy,
                                                 gs, rbg)
        out[f"K6/{what}/run{k}"] = {
            "loss": loss.detach().cpu(),
            **{f"grad{i}": t.detach().cpu() for i, t in enumerate(grads)}}
    work = torch.zeros((n_g, 4), dtype=torch.int32, device="cuda")
    ct = torch.full((n_g, 3), 1.0 / (3 * n_g), device="cuda")
    adjoint.adjoint_render(arr, meta, cfg_g, gx, gy, gs, rbg, ct, work=work)
    out[f"K6/{what}/work"] = {"work": work.cpu()}


def soft_shadow_rays(scene, rbg):
    """The first 16-sample K2c call of one wavefront batch of softdof
    (65,536 lanes, pathtrace, max_bounce 5): its soft-shadow rays."""
    from qaray_tpu_torch.integrators.engine import (
        IntegratorConfig,
        render_batch_wavefront,
    )
    from qaray_tpu_torch.ops import analytic

    arr, meta = scene("softdof_scene.xml")
    ids = torch.arange(1 << 16, device="cuda", dtype=torch.int32)
    calls = []
    shadow = analytic.shadow

    def capture(p, d, t_max, prims):
        calls.append((p.clone(), d.clone(), t_max.clone()))
        return shadow(p, d, t_max, prims)

    analytic.shadow = capture
    try:
        render_batch_wavefront(arr, meta, IntegratorConfig(
            integrator="pathtrace", max_bounce=5), ids % 800, ids // 800,
            ids * 0, rbg)
    finally:
        analytic.shadow = shadow
    return next(c for c in calls if c[0].shape[0] == 16 << 16)


def w1(out, assets, records=None):
    """W1's outputs and work counters at its four launches, and the 4o and
    4p renders' frame buffers; the launches' inputs under "W1/records"."""
    from kernel_times import w1_launches
    from qaray_tpu_torch.ops import bvh_packed

    images = {}
    launches = w1_launches(assets, images)
    if records is not None:
        launches = {k: tuple(x.cuda() if torch.is_tensor(x) else x
                             for x in rec[:4]) + launches[k][4:]
                    for k, rec in records.items()}
    for what, fb in images.items():
        out[f"W1/{what} image"] = fb
    for name, (p, d, t, occ_in, tabs, kw) in launches.items():
        kw = {k: v for k, v in kw.items() if k != "plain"}
        counters = torch.zeros((p.shape[0], 2), dtype=torch.int32,
                               device="cuda")
        if occ_in is None:
            res = bvh_packed.closest(p, d, t, *tabs, work=counters, **kw)
            out[f"W1/{name}"] = dict(zip(
                ("t", "instance", "triangle", "bary", "front"),
                (x.cpu() for x in res)), counters=counters.cpu())
        else:
            occ = bvh_packed.occluded(p, d, t, occ_in, *tabs,
                                      work=counters, **kw)
            out[f"W1/{name}"] = {"occluded": occ.cpu(),
                                 "counters": counters.cpu()}
    out["W1/records"] = {k: tuple(None if x is None else x.cpu()
                                  for x in v[:4])
                         for k, v in launches.items()}


def dump(path, records=None, only=None, earlier=None):
    import qaray_tpu_torch
    from qaray_tpu_torch.core.rng import key_words
    from qaray_tpu_torch.integrators.engine import IntegratorConfig
    from qaray_tpu_torch.ops import analytic, megakernel, photon
    # The sibling script's helpers (its directory leads sys.path), not the
    # tree's: an older tree on the path may lack them.
    from kernel_times import batch_rays, glass_desc, shadow_rays
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

    assets = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(qaray_tpu_torch.__file__))), "tests", "assets")

    def scene(name, edit=None):
        desc = load_scene(os.path.join(assets, name))
        if edit is not None:
            desc = edit(desc)
        desc.camera.img_width, desc.camera.img_height = 800, 600
        return compile_scene(desc, device="cuda")

    rbg = key_words("rbg", RendererParam().seed)
    ids = torch.arange(800 * 600, device="cuda", dtype=torch.int32)
    px, py, sid = ids % 800, ids // 800, ids * 0
    out = {"package": os.path.dirname(qaray_tpu_torch.__file__)}
    w1(out, assets, None if earlier is None else earlier.get("W1/records"))
    if only == "W1":
        torch.save(out, path)
        print(f"wrote {path} from {out['package']}", flush=True)
        return
    edits = {"mesh": ("mesh_scene.xml", None),
             "ico5": ("mesh_scene.xml",
                      lambda d: with_mesh(d, *icosphere(5), name="ico5")),
             "mirror": ("mirror_scene.xml", None)}
    for what in K1C_SCENES:
        arr, meta = scene(*edits[what])
        assert meta.mesh_mega, what
        for integ in ("pathtrace", "photonmap"):
            cfg = IntegratorConfig(integrator=integ, max_bounce=5)
            work = torch.zeros((ids.shape[0], 8), dtype=torch.int32,
                               device="cuda")
            rad, t0 = megakernel.mega_render(arr, meta, cfg, px, py, sid, rbg,
                                             work=work)
            out[f"K1c/{what}/{integ}"] = {"radiance": rad.cpu(),
                                         "t0": t0.cpu(), "work": work.cpu()}
        if what == "mesh":
            k6(out, "mesh", arr, meta, 1 << 17)
        del arr
    k6(out, "spot", *scene("spot_scene.xml"), 1 << 18)
    k6(out, "glass", *scene("softdof_scene.xml", glass_desc), 1 << 18)

    # K2c on the random rays, their views at a 4-byte offset, their heads,
    # and one wavefront batch's soft-shadow rays.
    prims = scene("softdof_scene.xml")[0].analytic
    p, d, t_max = shadow_rays(1 << 20)
    sets = {"random": (p, d, t_max)}
    fp = torch.empty(3 * p.shape[0] + 1, device="cuda")
    fd = torch.empty(3 * p.shape[0] + 1, device="cuda")
    ft = torch.empty(p.shape[0] + 1, device="cuda")
    fp[1:].copy_(p.reshape(-1))
    fd[1:].copy_(d.reshape(-1))
    ft[1:].copy_(t_max)
    sets["offset4"] = (fp[1:].view(-1, 3), fd[1:].view(-1, 3), ft[1:])
    for n in (1, 31, 65537, 1000001):
        sets[f"head{n}"] = (p[:n], d[:n], t_max[:n])
    if records is None:
        soft = soft_shadow_rays(scene, rbg)
    else:
        soft = tuple(t.cuda() for t in records["K2c/soft_rays"])
    sets["soft"] = soft
    for name, (ps, ds, ts) in sets.items():
        out[f"K2c/{name}"] = {
            "occluded": analytic.shadow(ps, ds, ts, prims).cpu()}

    # K2a and K2b on the same random rays, views and heads, and on a
    # softdof batch's bounces 0 and 1.
    sets.pop("head1000001")
    sets.pop("soft")
    if records is None:
        batch = batch_rays(*scene("softdof_scene.xml"), 800 * 600)
    else:
        batch = [tuple(t.cuda() for t in r) for r in records["K2/batch"]]
    for b, (ps, ds) in enumerate(batch):
        sets[f"bounce{b}"] = (ps, ds, None)
    for name, (ps, ds, _) in sets.items():
        t, prim = analytic.closest(ps, ds, prims)
        full = analytic.closest_full(ps, ds, prims)
        out[f"K2a/{name}"] = {"t": t.cpu(), "prim": prim.cpu()}
        out[f"K2b/{name}"] = {k: v.cpu() for k, v in full.items()}

    # The wavefront route's images and caustics_scene's photon maps.
    os.environ["QARAY_NO_MEGAKERNEL"] = "1"
    try:
        for name in ("softdof_scene.xml", "mesh_scene.xml",
                     "texture_scene.xml"):
            desc = load_scene(os.path.join(assets, name))
            desc.camera.img_width, desc.camera.img_height = 800, 600
            r = Renderer(RendererParam(spp_min=1, spp_max=1), device="cuda")
            r.compute_scene(desc)
            fb = r.render()
            out[f"wavefront/{name}"] = {
                k: torch.from_numpy(getattr(fb, k).copy())
                for k in ("mean", "count", "img")}
    finally:
        os.environ.pop("QARAY_NO_MEGAKERNEL", None)
    c_arr, c_meta = scene("softdof_scene.xml", lambda d: with_glass(d, "mid"))
    with tempfile.TemporaryDirectory() as wd, contextlib.chdir(wd):
        pmaps = build_photon_maps(c_arr, c_meta,
                                  RendererParam(use_photon_map=True))
    for which, m in zip(("global", "caustics"), pmaps):
        out[f"photon_maps/{which}"] = {
            k: v.cpu() for k, v in m._asdict().items() if torch.is_tensor(v)}

    if records is None:
        c_arr, c_meta = scene("softdof_scene.xml",
                              lambda d: with_glass(d, "mid"))
        p_photon = RendererParam(use_photon_map=True)
        with tempfile.TemporaryDirectory() as wd, contextlib.chdir(wd):
            maps = tuple(cluster_photon_map(m) for m in build_photon_maps(
                c_arr, c_meta, p_photon))
        cfg_ph = Renderer(p_photon, device="cuda").integrator_config()
        captured = {}
        gather_apply = photon.gather_apply

        def capture(gmap, rec):
            captured["rec"] = torch.stack(list(rec), dim=-1).clone()
            return gather_apply(gmap, rec)

        photon.gather_apply = capture
        try:
            megakernel.mega_render(c_arr, c_meta, cfg_ph, px, py, sid, rbg,
                                   photon_maps=maps)
        finally:
            photon.gather_apply = gather_apply
        packed = captured["rec"]
        valid = packed[:, 16] > 0.5
        _, order = torch.sort(photon._morton_keys(packed[:, 0:3], valid),
                              stable=True)
        g = maps[0]
        records = {"q": packed[order, 0:3].cpu(),
                   "act": packed[order, 16].cpu(), "ctable": g.ctable.cpu(),
                   "cbounds": g.cbounds.cpu(),
                   "radius": torch.tensor(float(g.radius))}
    records = dict(records, **{
        "K2c/soft_rays": tuple(t.cpu() for t in soft),
        "K2/batch": [tuple(t.cpu() for t in r) for r in batch]})
    out["K5/records"] = records
    q, act = records["q"].cuda(), records["act"].cuda()
    tab, cb = records["ctable"].cuda(), records["cbounds"].cuda()
    for r in (float(records["radius"]), 50.0):
        sums = photon.photon_gather(tab, cb, r, q, act)
        out[f"K5/r{r:g}"] = {"irradiance": sums[0].cpu(),
                             "direction": sums[1].cpu(),
                             "count": sums[2].cpu()}
    torch.save(out, path)
    print(f"wrote {path} from {out['package']}", flush=True)


def compare(path_a, path_b):
    a, b = torch.load(path_a), torch.load(path_b)
    result = {}
    for key in sorted(k for k in a if isinstance(a[k], dict)):
        if key not in b:
            continue
        row = {}
        for f, x in a[key].items():
            y = b[key][f]
            if not torch.is_tensor(x):
                continue
            if f == "work":
                other = [c for c in range(x.shape[1]) if c != 3]
                row["work_except_tri_tests_equal"] = torch.equal(
                    x[:, other], y[:, other])
                if x.shape[1] > 3:
                    row["tri_tests_mean"] = [x[:, 3].double().mean().item(),
                                             y[:, 3].double().mean().item()]
                continue
            if x.dtype.is_floating_point:
                same = torch.equal(x, y)
                row[f"{f}_equal"] = same
                if not same and x.shape == y.shape:
                    diff = (x - y).abs().max().item()
                    row[f"{f}_max_abs_diff"] = diff
                    if f.startswith("grad") and y.abs().max() > 0:
                        row[f"{f}_of_max_b"] = diff / y.abs().max().item()
                elif not same:
                    row[f"{f}_max_abs_diff"] = None
            else:
                row[f"{f}_equal"] = torch.equal(x, y)
        result[key] = row
        print(f"{key}: {json.dumps(row)}", flush=True)
    print(json.dumps(result), flush=True)
    return 0


def _functions(so):
    """{kernel: its SASS instructions} of a built library (cuobjdump
    -sass), the file's anonymous-namespace hash taken out of the names."""
    import re
    import subprocess

    from qaray_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "_GLOBAL__N_",
                          m.group(1))
            out[name] = []
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", line)
        if name is not None and m:
            out[name].append(m.group(1).strip())
    return out


def sass(tree_a, tree_b, names=("megakernel", "adjoint")):
    """Whether the libraries `names` built by two trees (their newest
    build/kernels/lib<name>-*.so, the build a run of the tree left) hold
    the same SASS, kernel by kernel, with ptxas's registers and spills of
    each from the build's log."""
    import glob

    result = {}
    for name in names:
        libs, logs = [], []
        for tree in (tree_a, tree_b):
            found = [f for f in glob.glob(os.path.join(
                tree, "build", "kernels", f"lib{name}-*.so"))
                if "-host-" not in f]
            if not found:
                raise SystemExit(f"{tree}: no built lib{name}")
            so = max(found, key=os.path.getmtime)
            libs.append(_functions(so))
            log = so[:-3] + ".log"
            logs.append([ln.strip() for ln in open(log).read().splitlines()
                         if "registers" in ln or "spill" in ln]
                        if os.path.exists(log) else None)
        a, b = libs
        row = {"kernels": len(a), "same_kernels": sorted(a) == sorted(b),
               "differ": sorted(k for k in a if a[k] != b.get(k)),
               "instructions": sum(len(v) for v in a.values()),
               "ptxas_same": logs[0] == logs[1], "ptxas": logs}
        result[name] = row
        print(f"{name}: {row['kernels']} kernels, SASS differs in "
              f"{row['differ'] or 'none'}; ptxas reports "
              f"{'the same' if row['ptxas_same'] else 'differ'}",
              flush=True)
    print(json.dumps(result), flush=True)
    return 0


def main(argv):
    if len(argv) >= 2 and argv[0] == "dump":
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 2
        opts = dict(zip(argv[2::2], argv[3::2]))
        if len(argv) % 2 or not set(opts) <= {"--records", "--only"} or (
                opts.get("--only", "W1") != "W1"):
            print(__doc__, file=sys.stderr)
            return 2
        earlier = (torch.load(opts["--records"]) if "--records" in opts
                   else None)
        dump(argv[1], None if earlier is None or "K5/records" not in earlier
             else earlier["K5/records"], opts.get("--only"), earlier)
        return 0
    if len(argv) == 3 and argv[0] == "compare":
        return compare(argv[1], argv[2])
    if len(argv) >= 3 and argv[0] == "sass":
        return sass(argv[1], argv[2], tuple(argv[3:]) or
                    ("megakernel", "adjoint"))
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
