"""The megakernel's device time on one GPU at the main path's shapes:
480,000 pathtrace lanes (800x600, one sample a pixel, max_bounce 5,
shadows 16 -> 64, the Renderer's rbg key words) of softdof (K1a),
texture_scene (K1b) and mesh_scene (K1c), as chip_smoke.py phase 5
launches them.

    python -m qaray_tpu_torch.tools.k1_times

Each time is torch.profiler's device time of mega_kernel, the mean over
20 launches after one that is not counted. The script reaches the
package through the import path, so that one copy of it times another
tree's kernels in the same call:

    PYTHONPATH=<tree> python qaray_tpu_torch/tools/k1_times.py

Prints the card's name and power limit and, last, one JSON line.
"""

import json
import os
import subprocess
import sys

import torch


def device_ms(fn, reps=20):
    """Mean device milliseconds a launch of mega_kernel, fn launching it
    once."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    seen = [e for e in prof.key_averages() if "mega_kernel" in e.key]
    total = sum(getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0) for e in seen)
    count = sum(e.count for e in seen)
    if not count or total <= 0:
        raise SystemExit("the profiler recorded no mega_kernel launch")
    return total / count / 1e3


def main():
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import qaray_tpu_torch
    from qaray_tpu_torch.integrators.engine import IntegratorConfig
    from qaray_tpu_torch.ops import megakernel
    from qaray_tpu_torch.core.rng import key_words
    from qaray_tpu_torch.renderer import RendererParam
    from qaray_tpu_torch.scene.compiler import compile_scene
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
    for name, scene in (("K1a", "softdof_scene.xml"),
                        ("K1b", "texture_scene.xml"),
                        ("K1c", "mesh_scene.xml")):
        desc = load_scene(os.path.join(assets, scene))
        desc.camera.img_width, desc.camera.img_height = 800, 600
        arr, meta = compile_scene(desc, device="cuda")
        before = megakernel.launches[name]
        out[name] = device_ms(lambda: megakernel.mega_render(
            arr, meta, cfg, px, py, sid, rbg))
        if megakernel.launches[name] == before:
            raise SystemExit(f"{scene} did not launch {name}")
    print(card, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
