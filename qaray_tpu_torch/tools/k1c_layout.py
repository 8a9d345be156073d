"""K1c's leaf size, measured on one GPU: the megakernel's world-mesh walk
over leaves of 64 rows (ops/megakernel.MEGA_LEAF, the dense route's walk
leaf) against leaves of 256 (the JAX package's clusters).

    python -m qaray_tpu_torch.tools.k1c_layout

At 480,000 pathtrace lanes of tests/assets/mesh_scene.xml at 800x600 (one
sample a pixel, max_bounce 5, the Renderer's rbg key words), on its own
320 triangles and with its icosphere at ico5 (20,480): the megakernel's
device time (torch.profiler, 20 launches after one not counted) with each
leaf size, in turns (64, 256, 256, 64), and its triangle tests a lane and
for a warp's slowest lane; radiance, primary depth and every work counter
but the triangle tests held equal between the two. Prints the card's name
and power limit and, last, one JSON line.
"""

import json
import os
import subprocess
import sys

import torch

from qaray_tpu_torch.tools.kernel_times import device_ms

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MESH_SCENE = os.path.join(HERE, "tests", "assets", "mesh_scene.xml")


def main():
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from qaray_tpu_torch.core.rng import key_words
    from qaray_tpu_torch.integrators.engine import IntegratorConfig
    from qaray_tpu_torch.ops import megakernel
    from qaray_tpu_torch.renderer import RendererParam
    from qaray_tpu_torch.scene.compiler import compile_scene
    from qaray_tpu_torch.scene.procedural import icosphere, with_mesh
    from qaray_tpu_torch.scene.xml_parser import load_scene

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfg = IntegratorConfig(integrator="pathtrace", max_bounce=5)
    rbg = key_words("rbg", RendererParam().seed)
    ids = torch.arange(800 * 600, device="cuda", dtype=torch.int32)
    px, py, sid = ids % 800, ids // 800, ids * 0
    compiled = megakernel.MEGA_LEAF
    base = load_scene(MESH_SCENE)
    base.camera.img_width, base.camera.img_height = 800, 600
    out = {"card": card, "compiled_leaf": compiled, "meshes": {}}
    for what, desc in (("mesh_scene", base),
                       ("ico5", with_mesh(base, *icosphere(5), name="ico5"))):
        arr, meta = compile_scene(desc, device="cuda")
        tabs = arr.kernel
        rows = tabs.mesh_rows.shape[0]
        trees = {leaf: megakernel.build_mega_tree(
            arr.mesh.tri_v.cpu().numpy(), rows, leaf).cuda()
            for leaf in (64, 256)}
        if not torch.equal(trees[compiled], tabs.mesh_tree):
            raise SystemExit(f"{what}: the compiled tree is not "
                             "build_mega_tree's")

        def with_leaf(leaf):
            megakernel.MEGA_LEAF = leaf
            return arr._replace(kernel=tabs._replace(mesh_tree=trees[leaf]))

        rec, want = {}, None
        try:
            for leaf in (64, 256):
                a = with_leaf(leaf)
                work = torch.zeros((ids.shape[0], 8), dtype=torch.int32,
                                   device="cuda")
                rad, t0 = megakernel.mega_render(a, meta, cfg, px, py, sid,
                                                 rbg, work=work)
                other = [c for c in range(8) if c != 3]
                got = (rad, t0, work[:, other])
                if want is None:
                    want = got
                if not all(torch.equal(x, y) for x, y in zip(want, got)):
                    raise SystemExit(f"{what}: leaves of {leaf} rows change "
                                     "the render")
                tri = work[:, 3].double()
                rec[f"leaf_{leaf}_tri_tests_a_lane"] = tri.mean().item()
                rec[f"leaf_{leaf}_tri_tests_warp_max"] = (
                    tri.view(-1, 32).amax(1).mean().item())
                rec[f"leaf_{leaf}_ms"] = []
            for leaf in (64, 256, 256, 64):
                a = with_leaf(leaf)
                rec[f"leaf_{leaf}_ms"].append(device_ms(
                    lambda: megakernel.mega_render(a, meta, cfg, px, py, sid,
                                                   rbg), "mega_kernel"))
        finally:
            megakernel.MEGA_LEAF = compiled
        out["meshes"][what] = rec
        print(f"  {what}: {json.dumps(rec)}", flush=True)
    print(card, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
