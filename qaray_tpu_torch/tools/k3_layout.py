"""K3's two layout choices, measured on one GPU: the walk's leaf size and
whether the dense route walks its rays in coherence order.

    python -m qaray_tpu_torch.tools.k3_layout

At the 480,000 camera rays of tests/assets/mesh_scene.xml at 800x600, on
its icosphere made ico5 (20,480 triangles) and on its own 320:
  - the K3 kernel's time (CUDA events, 20 launches) with the compiled
    64-row leaves and with 256-row leaves, on rays as they come and in
    coherence order (ops/mesh_tiles.coherence_order over the root's box),
    the walks' clusters a ray, and their (t, row, row2) held equal;
  - the route's step, mesh_sweep.sweep_closest, as it comes and sorted
    (the sort and its inverse included);
  - phase 4f of chip_smoke.py, one Renderer.render() of mesh_scene at 1
    spp on the wavefront route, with the dense route's sweeps as they are
    and wrapped in the sort, in turns (as they are, sorted, sorted, as
    they are), after one render that is not counted.
Prints the card's name and power limit and, last, one JSON line. The
library walks its rays as they come, with 64-row leaves (PERF.md).
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MESH_SCENE = os.path.join(HERE, "tests", "assets", "mesh_scene.xml")
BIG = 1e30


def events_ms(fn, reps=20):
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


def main():
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from qaray_tpu_torch.integrators import engine
    from qaray_tpu_torch.ops import _build, mesh_sweep
    from qaray_tpu_torch.ops.mesh_tiles import build_tiles, coherence_order
    from qaray_tpu_torch.ops.tiles import cluster_tree
    from qaray_tpu_torch.renderer import Renderer, RendererParam
    from qaray_tpu_torch.scene.compiler import compile_scene
    from qaray_tpu_torch.scene.procedural import icosphere, with_mesh
    from qaray_tpu_torch.scene.xml_parser import load_scene

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    base = load_scene(MESH_SCENE)
    base.camera.img_width, base.camera.img_height = 800, 600
    ids = torch.arange(800 * 600, device="cuda", dtype=torch.int32)
    fn = mesh_sweep._lib()

    def walk_of_leaf(tri_v, leaf):
        """The walk's tables at `leaf` rows a cluster (build_walk's)."""
        tm = build_tiles(tri_v.cpu().numpy(), cluster=leaf)
        rows = mesh_sweep.pack_coeff16(tm.coeff, tm.const)[
            : tm.coeff.shape[0]]
        return (torch.from_numpy(np.ascontiguousarray(rows)).cuda(),
                tm.gid.cuda(), cluster_tree(tm.cbounds).cuda())

    def walk(p, d, t_cur, tables, leaf, steps=None):
        """One K3 launch at `leaf` rows a cluster: (t, row, row2)."""
        rows, gid, tree = tables
        n = p.shape[0]
        t = torch.empty(n, dtype=torch.float32, device="cuda")
        row, row2 = (torch.empty(n, dtype=torch.int32, device="cuda")
                     for _ in range(2))
        flag = torch.empty(n, dtype=torch.bool, device="cuda")
        rc = fn(p.data_ptr(), d.data_ptr(), t_cur.data_ptr(),
                rows.data_ptr(), gid.data_ptr(), tree.data_ptr(), n,
                tree.shape[0] // 2, leaf, 0, t.data_ptr(), row.data_ptr(),
                row2.data_ptr(), flag.data_ptr(),
                steps.data_ptr() if steps is not None else None, None,
                torch.cuda.current_stream().cuda_stream)
        _build.check(rc, "K3 mesh walk")
        return t, row, row2

    out = {"card": card, "meshes": {}}
    for what, desc in (("ico5", with_mesh(base, *icosphere(5), name="ico5")),
                       ("mesh_scene", base)):
        arr, meta = compile_scene(desc, device="cuda")
        p, d, *_ = engine.generate_camera_rays(arr, meta, ids % 800,
                                               ids // 800, ids * 0, None)
        p, d = p.contiguous(), d.contiguous()
        t_big = torch.full((p.shape[0],), BIG, device="cuda")
        m = arr.mesh
        compiled = mesh_sweep.walk_of(m)
        tree = compiled.tree
        perm = coherence_order(p, d, tree[1, :3], tree[1, 3:6])
        ps, ds = p[perm].contiguous(), d[perm].contiguous()
        rec = {}
        want = None
        for leaf in (mesh_sweep.WALK_LEAF, 256):
            tables = (tuple(compiled) if leaf == mesh_sweep.WALK_LEAF
                      else walk_of_leaf(m.tri_v, leaf))
            for order, (p_, d_) in (("as_they_come", (p, d)),
                                    ("sorted", (ps, ds))):
                steps = torch.zeros(p.shape[0], dtype=torch.int32,
                                    device="cuda")
                got = walk(p_, d_, t_big, tables, leaf, steps)
                if order == "sorted":
                    inv = torch.argsort(perm)
                    got = tuple(x[inv] for x in got)
                if want is None:
                    want = got
                for a, b in zip(want, got):
                    if not torch.equal(a, b):
                        raise SystemExit(f"{what}: leaf {leaf}, {order}: "
                                         "the walks disagree")
                rec[f"leaf_{leaf}_{order}_ms"] = events_ms(
                    lambda: walk(p_, d_, t_big, tables, leaf))
                rec[f"leaf_{leaf}_{order}_clusters_a_ray"] = (
                    steps.sum(dtype=torch.int64).item() / p.shape[0])

        def sorted_step():
            o = coherence_order(p, d, tree[1, :3], tree[1, 3:6])
            r = mesh_sweep.sweep_closest(p[o], d[o], t_big, m.stream_c16,
                                         walk=compiled)
            inv = torch.argsort(o)
            return tuple(x[inv] for x in r)

        rec["route_as_they_come_ms"] = events_ms(
            lambda: mesh_sweep.sweep_closest(p, d, t_big, m.stream_c16,
                                             walk=compiled))
        rec["route_sorted_ms"] = events_ms(sorted_step)
        out["meshes"][what] = rec
        print(f"  {what}: {json.dumps(rec)}", flush=True)
        del arr

    plain = (mesh_sweep.sweep_closest, mesh_sweep.sweep_occluded)

    def in_order(sweep):
        def run(p, d, t, coeff16, walk=None, steps=None):
            tree = walk.tree
            o = coherence_order(p, d, tree[1, :3], tree[1, 3:6])
            r = sweep(p[o], d[o], t[o], coeff16, walk=walk)
            inv = torch.argsort(o)
            return (tuple(x[inv] for x in r) if isinstance(r, tuple)
                    else r[inv])
        return run

    def wall_4f(sort):
        mesh_sweep.sweep_closest, mesh_sweep.sweep_occluded = (
            tuple(in_order(s) for s in plain) if sort else plain)
        os.environ["QARAY_NO_MEGAKERNEL"] = "1"
        try:
            r = Renderer(RendererParam(spp_min=1, spp_max=1), device="cuda")
            r.compute_scene(base)
            torch.cuda.synchronize()
            t = time.time()
            fb = r.render()
            torch.cuda.synchronize()
            wall = time.time() - t
        finally:
            os.environ.pop("QARAY_NO_MEGAKERNEL", None)
            mesh_sweep.sweep_closest, mesh_sweep.sweep_occluded = plain
        if not np.isfinite(fb.mean).all():
            raise SystemExit("4f: radiance not finite")
        return wall

    wall_4f(False)
    walls = {"as_they_come_s": [], "sorted_s": []}
    for sort in (False, True, True, False):
        walls["sorted_s" if sort else "as_they_come_s"].append(wall_4f(sort))
    out["wall_4f"] = walls
    print(card, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
