"""Where the time of the K6 with atomic sums went, measured on one GPU:
that kernel's source (csrc/adjoint.cu as of commit 598879d, whose sums are
shared-memory atomicAdd on one row a block and whose hooks go to a global
scratch buffer) built as it is, with its atomics made plain adds (racy, so its
gradient is wrong: timing only), with its hook stores and its reverse
sweep compiled out, and with both.

    PYTHONPATH=<a tree with that K6> python qaray_tpu_torch/tools/k6_split.py

The variants are built with nvcc, the library's flags, into build/split/
of that tree and launched through its ops/adjoint._launch on spot_scene
at the gradient path's shape (262,144 lanes) and its full 800x600 frame,
the glass scene (480,000 lanes) and mesh_scene (131,072), max_bounce 5,
shadow_spp 16, the Renderer's rbg key words, the mean loss's cotangent.
Times are torch.profiler's device time, the mean over 20 launches after
one that is not counted, each variant timed twice in turns. Prints each
variant's registers and spills, the card's name and power limit and,
last, one JSON line.
"""

import ctypes
import json
import os
import subprocess
import sys

import torch

# The sibling scripts' helpers (this directory leads sys.path).
from kernel_times import device_ms, glass_desc

INCLUDE = '#include "mega_common.cuh"\n'
PLAIN_ADDS = INCLUDE + "#define atomicAdd(a, v) (*(a) += (v))\n"
NO_HOOKS = (("  for (int h = 0; h < NUM_HOOKS; ++h) hk[h * stride] = v[h];",
             "  (void)hk; (void)stride; (void)v;"),
            ("for (int b = stored - 1; b >= 0; --b) {",
             "for (int b = -1; b >= 0; --b) {"))
SIGNATURE = "pppipppipipppifpuuiiiipppiipppiipp"


def variants(src):
    """{name: source} of the four variants of the atomic K6's source."""
    if INCLUDE not in src or "atomicAdd(g, a.x);" not in src:
        raise SystemExit("the tree's csrc/adjoint.cu is not the K6 with "
                         "atomic sums")
    out = {"atomics": src, "plain_adds": src.replace(INCLUDE, PLAIN_ADDS)}
    for a, b in NO_HOOKS:
        if a not in src:
            raise SystemExit(f"no {a!r} in the tree's csrc/adjoint.cu")
        src = src.replace(a, b)
    out["no_hooks"] = src
    out["plain_adds_no_hooks"] = src.replace(INCLUDE, PLAIN_ADDS)
    return out


def main():
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from qaray_tpu_torch.core.rng import key_words
    from qaray_tpu_torch.integrators.engine import IntegratorConfig
    from qaray_tpu_torch.ops import _build, adjoint
    from qaray_tpu_torch.renderer import RendererParam
    from qaray_tpu_torch.scene.compiler import compile_scene
    from qaray_tpu_torch.scene.xml_parser import load_scene

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out_dir = _build.BUILD_DIR.parent / "split"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants((_build.CSRC / "adjoint.cu").read_text()
                               ).items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        so = out_dir / f"lib{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.FLAGS, f"-I{_build.CSRC}", "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)
        fns[name] = _build.bind(ctypes.CDLL(str(so)), "qr_adjoint_render",
                                SIGNATURE)

    assets = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(adjoint.__file__)))), "tests", "assets")

    def scene(name, edit=None):
        desc = load_scene(os.path.join(assets, name))
        if edit is not None:
            desc = edit(desc)
        desc.camera.img_width, desc.camera.img_height = 800, 600
        return compile_scene(desc, device="cuda")

    cfg = IntegratorConfig(integrator="pathtrace", max_bounce=5,
                           shadow_spp=16)
    rbg = key_words("rbg", RendererParam().seed)
    spot = scene("spot_scene.xml")
    res = {"card": card}
    for what, (arr, meta), n in (
            ("spot", spot, 1 << 18), ("spot_frame", spot, 800 * 600),
            ("glass", scene("softdof_scene.xml", glass_desc), 800 * 600),
            ("mesh", scene("mesh_scene.xml"), 1 << 17)):
        ids = torch.arange(n, device="cuda", dtype=torch.int32)
        gx, gy, gs = ids % 800, (ids // 800) % 600, ids * 0
        ct = torch.full((n, 3), 1.0 / (3 * n), device="cuda")
        names = list(fns)
        res[what] = {k: [] for k in names}
        for name in names + names[::-1]:
            fn = fns[name]
            res[what][name].append(device_ms(lambda: adjoint._launch(
                fn, torch.cuda.current_stream().cuda_stream, arr, meta, cfg,
                gx, gy, gs, rbg, ct, None), "adjoint_kernel"))
        for k, v in res[what].items():
            print(f"  {what} {n} lanes, {k}: {v[0]:.5f} / {v[1]:.5f} ms",
                  flush=True)
    print(card, flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
