"""Several devices and several processes across distinct cards (or, to
check the same paths first, on the CPU).

    python -m qaray_tpu_torch.tools.multi_card              # every card
    python -m qaray_tpu_torch.tools.multi_card --device cpu --ranks 4

1. One process over a mesh of every card (["cpu"] * ranks on the CPU):
   the Renderer with the defaults on softdof, and one render_batch on the
   image's lanes, against the first device alone in turns (one, mesh,
   mesh, one): planes and outputs equal bit for bit, walls printed; and
   render_value_and_grad over the mesh against one device on spot_scene
   (fast route on a card): every field within 1e-5 of 1 + max|b|.
2. --ranks processes of the CLI (-multihost -coordinator), one card a
   rank, so the collectives run on NCCL where the cards are distinct
   (gloo on the CPU), against one process: the primary's colorBuffer.png
   equal bit for bit, no colour buffer from the other ranks, the ranks'
   mask planes summing to the spp; each rank's render (Elapsed Time) and
   the seconds it was blocked in all_gather.

Exits non-zero on a failed check; prints one JSON line of figures last.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOFTDOF = os.path.join(REPO, "tests", "assets", "softdof_scene.xml")
SPOT = os.path.join(REPO, "tests", "assets", "spot_scene.xml")


def check(cond, what):
    if not cond:
        raise AssertionError(what)
    print(f"  ok: {what}", flush=True)


def sync(device):
    if device.type == "cuda":
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def one_process(device, ranks, res):
    from qaray_tpu_torch import diff
    from qaray_tpu_torch.core.rng import key_words
    from qaray_tpu_torch.integrators.engine import (
        IntegratorConfig,
        render_batch,
    )
    from qaray_tpu_torch.parallel.mesh import (
        default_devices,
        make_render_mesh,
        shard_render_batch,
    )
    from qaray_tpu_torch.renderer import Renderer, RendererParam
    from qaray_tpu_torch.scene.compiler import compile_scene
    from qaray_tpu_torch.scene.xml_parser import load_scene

    if device.type == "cpu":
        mesh = make_render_mesh(["cpu"] * ranks)
    else:
        mesh = make_render_mesh(default_devices("cuda"))
    print(f"one process over {mesh}", flush=True)
    desc = load_scene(SOFTDOF)
    desc.camera.img_width, desc.camera.img_height = res
    walls, fbs = [], []
    for sharded in (False, True, True, False):
        r = Renderer(RendererParam(), device=device,
                     mesh=mesh if sharded else None)
        r.compute_scene(desc)
        sync(device)
        t = time.perf_counter()
        fbs.append(r.render())
        sync(device)
        walls.append((time.perf_counter() - t) * 1e3)
    check(all(np.array_equal(getattr(fb, k), getattr(fbs[0], k))
              for fb in fbs[1:] for k in ("mean", "color_std", "count",
                                          "zbuffer", "img")),
          "the Renderer over the mesh gives one device's planes bit for bit")
    arr, meta = r.scene_arrays, r.meta
    cfg = IntegratorConfig(integrator="pathtrace", max_bounce=5,
                           shadow_spp=16)
    ids = torch.arange(res[0] * res[1], dtype=torch.int32, device=device)
    px, py, sid = ids % res[0], ids // res[0], torch.zeros_like(ids)
    words = key_words("rbg", 0)
    run = shard_render_batch(mesh)
    batch_ms, outs = [], []
    for sharded in (False, True, True, False):
        fn = run if sharded else render_batch
        fn(arr, meta, cfg, px, py, sid, words)
        sync(device)
        t = time.perf_counter()
        for _ in range(5):
            out = fn(arr, meta, cfg, px, py, sid, words)
        sync(device)
        batch_ms.append((time.perf_counter() - t) * 1e3 / 5)
        outs.append(out)
    check(all(torch.equal(a, b) for o in outs[1:]
              for a, b in zip(o, outs[0])),
          f"render_batch over the mesh equals one device's on "
          f"{px.shape[0]} lanes, bit for bit")
    spot = load_scene(SPOT)
    spot.camera.img_width, spot.camera.img_height = res
    g_arr, g_meta = compile_scene(spot, device=device)
    loss_1, want = diff.render_value_and_grad(g_arr, g_meta, cfg, px, py,
                                              sid, words)
    loss_m, got = diff.render_value_and_grad(g_arr, g_meta, cfg, px, py,
                                             sid, words, mesh=mesh)
    worst = max(((getattr(got, f).double() - getattr(want, f).double())
                 .abs().max() / (1.0 + getattr(want, f).double().abs().max()))
                .item() for f in diff.DiffParams._fields)
    check(worst <= 1e-5, f"the sharded gradient within {worst:.3g} <= 1e-5 "
          "of 1 + max|b| of one device's")
    print("  Renderer wall ms (one, mesh, mesh, one): "
          + ", ".join(f"{w:.3f}" for w in walls), flush=True)
    print("  render_batch ms (one, mesh, mesh, one): "
          + ", ".join(f"{m:.4f}" for m in batch_ms), flush=True)
    return dict(mesh=[str(d.device) for d in mesh.devices],
                renderer_turns_ms=walls, batch_turns_ms=batch_ms,
                lanes=px.shape[0], grad_worst=worst,
                loss=[float(loss_1), float(loss_m)])


def ranks_of_the_cli(device, ranks, res):
    from PIL import Image

    base = [sys.executable, "-m", "qaray_tpu_torch.cli", SOFTDOF, "-res",
            f"{res[0]}x{res[1]}", "-spp", "2"]
    if device.type == "cpu":
        base += ["-device", "cpu", "-threads", "1"]
    env = dict(os.environ, PYTHONPATH=REPO)
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    with tempfile.TemporaryDirectory() as wd:
        def spawn(args):
            return subprocess.Popen(base + args, cwd=wd, env=env,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)

        procs = [spawn(["-multihost", "-coordinator",
                        f"localhost:{port},{ranks},{r}", "-rank-debug",
                        "-out", f"mh{r}_"]) for r in range(ranks)]
        try:
            outs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        solo = spawn(["-out", "sp_"])
        try:
            solo_out = solo.communicate(timeout=600)[0]
        finally:
            solo.kill()
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                print(out[-4000:], flush=True)
            check(p.returncode == 0, f"rank {r} exits 0")
            print("  " + "\n  ".join(line for line in out.splitlines()
                                     if line.startswith("multihost")),
                  flush=True)
        check(solo.returncode == 0, "one process exits 0")

        def png(name):
            return np.asarray(Image.open(os.path.join(wd, name))).astype(int)

        check(np.array_equal(png("mh0_colorBuffer.png"),
                             png("sp_colorBuffer.png")),
              "the primary's colorBuffer.png equals one process's")
        check(not any(os.path.exists(os.path.join(wd, f"mh{r}_colorBuffer"
                                                  ".png"))
                      for r in range(1, ranks)),
              "no other rank writes a colour buffer")
        masks = sum(png(f"mh{r}_rank{r}_maskBuffer.png")
                    for r in range(ranks))
        check(bool((masks == 2).all()), "the mask planes sum to the spp")

    def num(out, pattern):
        return float(re.search(pattern, out).group(1))

    backend = re.search(r"collectives on (\w+)", outs[0]).group(1)
    return dict(
        backend=backend,
        rank_render_s=[num(o, r"Elapsed Time is ([0-9.]+) s") for o in outs],
        single_render_s=num(solo_out, r"Elapsed Time is ([0-9.]+) s"),
        all_gather_blocked_s=[num(o, r"all_gathers \(\w+\), ([0-9.]+) s")
                              for o in outs])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=0,
                    help="processes (default: every card)")
    ap.add_argument("--res", default=None, help="WxH (800x600 on a card, "
                    "64x48 on the CPU)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    ranks = args.ranks or torch.cuda.device_count()
    res = args.res or ("64x48" if device.type == "cpu" else "800x600")
    res = tuple(int(x) for x in res.lower().split("x"))
    if device.type == "cuda":
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout
        print(out.strip(), flush=True)
    figures = dict(one_process=one_process(device, ranks, res))
    print(f"{ranks} ranks of the CLI", flush=True)
    figures["ranks"] = ranks_of_the_cli(device, ranks, res)
    print(json.dumps(figures))
    return 0


if __name__ == "__main__":
    sys.exit(main())
