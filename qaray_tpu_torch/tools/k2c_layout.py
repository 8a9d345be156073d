"""K2c's launch choices, measured on one GPU.

    python -m qaray_tpu_torch.tools.k2c_layout

K2c (csrc/analytic.cu) takes one ray a thread, a block per 256 rays,
until there are more than kPairsFrom rays a thread of a persistent grid of
8 blocks of 256 threads an SM; beyond that, aligned rays go in pairs on
that grid (float2 loads, both tested together, an instantiation of its
own). The variants, each built with nvcc from a patched copy of the
source into build/k2c_layout/:
- "kept": the source as it is;
- "pairs from 1" and "pairs from 4": kPairsFrom 1 and 4;
- "pairs always": pairs at every size;
- "one ray a thread": never pairs;
- "pairs always, a block per 512 rays": pairs at every size and no cap
  on the grid.
They run at kernel_times.K2C_SIZES, the sizes of K2c's launches on the
main path (chip_smoke.py phase 4: the photon paths' 5,008-60,572 rays,
131,072-605,720, a batch's 1,048,576 soft-shadow rays and 3,145,728
escalated ones) and a batch's 65,536 hard shadow rays, on
random rays against softdof's primitives (chip_smoke.py phase 2a's rays);
beside them the kept variant on the same rays as views at a 4-byte offset
(taken one ray a thread). Every variant's occlusion is held equal to
analytic.shadow's, bit for bit.

Times are torch.profiler's device time of the kernel, the mean over 20
launches after one that is not counted, each variant timed twice in
turns (forward, then in reverse order). Prints the card's name and power
limit and, last, one JSON line.
"""

import ctypes
import json
import os
import re
import subprocess
import sys

import torch

from qaray_tpu_torch.tools.kernel_times import (
    K2C_SIZES,
    device_ms,
    shadow_rays,
)

# (pattern, replacement) edits of the source, each matching once.
RULE = r"\(size_t\)n > \(size_t\)kPairsFrom \* grid \* kThreads &&"
GRID = r"const int blocks = pairs \? grid :"
FROM = r"constexpr int kPairsFrom = \d+;"
PATCHES = {
    "kept": (),
    "pairs from 1": ((FROM, "constexpr int kPairsFrom = 1;"),),
    "pairs from 4": ((FROM, "constexpr int kPairsFrom = 4;"),),
    "pairs always": ((RULE, "n > 1 &&"),),
    "one ray a thread": ((RULE, "false &&"),),
    "pairs always, a block per 512 rays": (
        (RULE, "n > 1 &&"),
        (GRID, "const int blocks = pairs ? (n / 2 + kThreads - 1) / kThreads "
               ":")),
}


def build_variants():
    """{name: qr_shadow} of each patched copy of csrc/analytic.cu, built
    in parallel."""
    from qaray_tpu_torch.ops import _build

    src = (_build.CSRC / "analytic.cu").read_text()
    out_dir = _build.BUILD_DIR.parent / "k2c_layout"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(PATCHES.items()):
        text = src
        for a, b in edits:
            text, count = re.subn(a, b, text)
            if count != 1:
                raise SystemExit(f"{a!r} matches csrc/analytic.cu {count} "
                                 "times")
        cu, so = out_dir / f"v{i}.cu", out_dir / f"libv{i}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.FLAGS, f"-I{_build.CSRC}", "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        fns[name] = _build.bind(ctypes.CDLL(str(so)), "qr_shadow",
                                "pppippipp")
    return fns


def main():
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import qaray_tpu_torch
    from qaray_tpu_torch.ops import _build, analytic
    from qaray_tpu_torch.scene.compiler import compile_scene
    from qaray_tpu_torch.scene.xml_parser import load_scene

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    assets = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(qaray_tpu_torch.__file__))), "tests", "assets")
    prims = compile_scene(load_scene(os.path.join(
        assets, "softdof_scene.xml")), device="cuda")[0].analytic
    fns = build_variants()
    tab, kinds = prims.table, prims.kind

    def run(fn, p, d, t_max):
        occ = torch.empty(p.shape[0], dtype=torch.bool, device="cuda")
        _build.check(fn(p.data_ptr(), d.data_ptr(), t_max.data_ptr(),
                        p.shape[0], tab.data_ptr(), kinds.data_ptr(),
                        tab.shape[0], occ.data_ptr(),
                        torch.cuda.current_stream().cuda_stream), "K2c")
        return occ

    out = {"card": card}
    p, d, t_max = shadow_rays(max(K2C_SIZES))
    flat = [torch.empty(t.numel() + 1, device="cuda") for t in (p, d, t_max)]
    for f, t in zip(flat, (p, d, t_max)):
        f[1:].copy_(t.reshape(-1))
    for n in K2C_SIZES:
        rays = (p[:n], d[:n], t_max[:n])
        offset = (flat[0][1:3 * n + 1].view(n, 3),
                  flat[1][1:3 * n + 1].view(n, 3), flat[2][1:n + 1])
        want = analytic.shadow(*rays, prims)
        cases = {name: (fn, rays) for name, fn in fns.items()}
        cases["kept, at a 4-byte offset"] = (fns["kept"], offset)
        for name, (fn, r) in cases.items():
            if not torch.equal(run(fn, *r), want):
                raise SystemExit(f"K2c {name}, {n} rays: occlusion differs")
        row = {name: [] for name in cases}
        for name in list(cases) + list(reversed(cases)):
            fn, r = cases[name]
            row[name].append(device_ms(lambda: run(fn, *r), "shadow_kernel"))
        out[str(n)] = row
        for name, t in row.items():
            print(f"  K2c {n} rays, {name}: {t[0]:.5f} / {t[1]:.5f} ms",
                  flush=True)
    print(card, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
