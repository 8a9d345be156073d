"""grad_loop: an inverse-rendering optimiser, through
diff.render_value_and_grad.

The target image is rendered by the plain reference at the scene's own
parameters (one sample of every pixel, in blocks small enough to stay
under the program's memory peak). The optimiser starts from every material
and light value perturbed by up to +-`perturb` of itself (a generator
seeded from --seed) and takes steps of plain SGD at fixed per-field rates
(`lr`): each step one render_value_and_grad over every pixel at one
sample (sample index = step number, so each step's rows differ) and an
update of the parameters on the device, which the program's captured step
reads as changed tables. A step ends when its loss is read on the host.

Set-up builds the optimiser and drives it through its first
`check_steps` steps (the first captures its graphs): their losses, the
first step's gradients and the parameters' change over them are what the
reference is held to. setup_s leaves out the seconds of the reference's
target, which is the benchmark's input and not the program's work. The window continues the same optimiser; it closes with the first
step that ends after --seconds and lasts until that step's end.
"""

from __future__ import annotations

import time

from portbench import bench, check, devtrace

FIELDS = ("mtl_diffuse", "mtl_specular", "mtl_emission", "mtl_reflection",
          "mtl_refraction", "mtl_glossiness", "light_intensity",
          "texture_texels", "background", "environment")
# Fields the optimiser moves (texels: the scene has no texture).
MOVED = ("mtl_diffuse", "mtl_specular", "mtl_emission", "mtl_reflection",
         "mtl_refraction", "mtl_glossiness", "light_intensity",
         "background", "environment")


def start_params(true: dict, seed: int, perturb: float) -> dict:
    """The optimiser's start: each moved field times (1 + perturb * u),
    u uniform in [-1, 1) from a CPU generator seeded from `seed`; made on
    the host so that both sides get the same numbers."""
    import torch

    g = torch.Generator(device="cpu")
    g.manual_seed(bench.derive_seed(seed, "start"))
    out = {}
    for k in FIELDS:
        v = true[k].detach().cpu().to(torch.float32)
        if k in MOVED:
            u = torch.rand(v.shape, generator=g) * 2.0 - 1.0
            v = v * (1.0 + perturb * u)
        out[k] = v
    return out


def sgd(params: dict, grads: dict, lr: dict) -> dict:
    return {k: (params[k] - lr[k] * grads[k]) if k in lr else params[k]
            for k in FIELDS}


class Optimiser:
    """The program's gradient step on one device, and its state."""

    def __init__(self, ctx):
        import torch

        from qaray_tpu_torch import diff
        from qaray_tpu_torch.core.rng import key_words
        from qaray_tpu_torch.integrators.engine import IntegratorConfig
        from qaray_tpu_torch.scene.compiler import compile_scene
        from qaray_tpu_torch.scene.xml_parser import load_scene

        cfg, par = ctx.config, ctx.params
        rp = dict(cfg["renderer"])
        rp.update(par.get("renderer", {}))
        self.ctx, self.diff = ctx, diff
        desc = load_scene(str(bench.ROOT / cfg["scene"]))
        desc.camera.img_width, desc.camera.img_height = (par["width"],
                                                         par["height"])
        self.scene, self.meta = compile_scene(desc, device=ctx.device)
        self.cfg = IntegratorConfig(
            integrator=rp["integrator"], max_bounce=rp["max_bounce"],
            shadow_spp=rp["shadow_spp"], shadow_spp_max=rp["shadow_spp_max"])
        self.rp = rp
        dev = ctx.device
        n = par["width"] * par["height"]
        ids = torch.arange(n, dtype=torch.int32, device=dev)
        self.px, self.py = ids % par["width"], ids // par["width"]
        self.lanes = n
        self.words = key_words(rp["rng_impl"],
                               bench.derive_seed(ctx.seed, "grad"))
        true = diff.extract_params(self.scene)
        self.true = {k: getattr(true, k) for k in FIELDS}
        self.lr = {k: float(v) for k, v in par["lr"].items()}
        self.step_no = 0

    def set_params(self, params: dict):
        self.params = {k: v.to(self.ctx.device) for k, v in params.items()}

    def step(self):
        """One step: (loss on the host, gradients {field: tensor})."""
        import torch

        d = self.diff
        spliced = d.splice_params(self.scene, d.DiffParams(
            *(self.params[k] for k in FIELDS)))
        sid = torch.full_like(self.px, self.step_no)
        loss, grads = d.render_value_and_grad(
            spliced, self.meta, self.cfg, self.px, self.py, sid,
            self.words, target=self.target)
        grads = {k: getattr(grads, k) for k in FIELDS}
        self.params = sgd(self.params, grads, self.lr)
        self.step_no += 1
        return float(loss), grads


def reference_target(ctx, opt_words_seed, rp, block=1 << 16):
    """The target image: the reference's radiance of every pixel at the
    scene's own parameters, one sample (index 65535), in blocks."""
    import torch

    from portbench.reference import render as R
    from portbench.reference.engine import render_lanes

    par = ctx.params
    arr, meta = R.load(str(bench.ROOT / ctx.config["scene"]), par["width"],
                       par["height"], ctx.device)
    icfg = _ref_cfg(R, rp)
    words = R.key_words(rp["rng_impl"], opt_words_seed)
    n = par["width"] * par["height"]
    out = []
    with torch.no_grad():
        for a in range(0, n, block):
            ids = torch.arange(a, min(a + block, n), device=ctx.device,
                               dtype=torch.int32)
            sid = torch.full_like(ids, 65535)
            rad, _ = render_lanes(arr, meta, icfg, ids % par["width"],
                                  ids // par["width"], sid, words)
            out.append(rad)
    return torch.cat(out)


def _ref_cfg(R, rp):
    return R.IntegratorConfig(integrator=rp["integrator"],
                              max_bounce=rp["max_bounce"],
                              shadow_spp=rp["shadow_spp"],
                              shadow_spp_max=rp["shadow_spp_max"])


def reference_steps(ctx, start: dict, target, steps: int, lr: dict, rp,
                    words_seed, lanes=None):
    """The reference's optimiser from the same start: (losses, first
    gradients, change over the steps), each {field: tensor}. lanes: the
    first `lanes` of the image only (calibrate.py's half-batch fault)."""
    import torch

    from portbench.reference import render as R

    par = ctx.params
    arr, meta = R.load(str(bench.ROOT / ctx.config["scene"]), par["width"],
                       par["height"], ctx.device)
    icfg = _ref_cfg(R, rp)
    words = R.key_words(rp["rng_impl"], words_seed)
    n = par["width"] * par["height"]
    ids = torch.arange(n, dtype=torch.int32, device=ctx.device)
    px, py = ids % par["width"], ids // par["width"]
    target = target.to(ctx.device)
    if lanes is not None:
        px, py, target = px[:lanes], py[:lanes], target[:lanes]
    params = {k: v.to(ctx.device) for k, v in start.items()}
    losses, first = [], None
    for s in range(steps):
        sid = torch.full_like(px, s)
        loss, grads = R.value_and_grad(arr, meta, icfg, params, px, py, sid,
                                       words, target)
        losses.append(float(loss))
        if first is None:
            first = grads
        params = sgd(params, grads, lr)
    change = {k: params[k] - start[k].to(ctx.device) for k in FIELDS}
    return losses, first, change


def run(ctx):
    import torch

    par = ctx.params
    opt = Optimiser(ctx)
    words_seed = bench.derive_seed(ctx.seed, "grad")
    # The target is the benchmark's input, worked out by the reference:
    # its seconds are not the program's set-up.
    t = time.perf_counter()
    opt.target = reference_target(ctx, words_seed, opt.rp).to(ctx.device)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    target_s = time.perf_counter() - t
    start = start_params(opt.true, ctx.seed, par["perturb"])
    opt.set_params(start)
    losses, first = [], None
    for _ in range(par["check_steps"]):
        loss, grads = opt.step()
        losses.append(loss)
        if first is None:
            first = {k: v.detach().clone() for k, v in grads.items()}
    change = {k: (opt.params[k] - start[k].to(ctx.device)).detach().clone()
              for k in FIELDS}
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - ctx.t_start - target_s

    before = bench.program_counters()
    items, t0 = [], time.perf_counter()
    while True:
        t = time.perf_counter()
        opt.step()
        items.append({"s": time.perf_counter() - t, "lanes": opt.lanes})
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    window_s = time.perf_counter() - t0
    counters = bench.counter_delta(before, bench.program_counters())
    rec = {"setup_s": setup_s, "window_s": window_s, "items": items,
           "counters": counters, "host": {"seconds": {}, "calls": {}},
           "setup_parts": {}, "target_s": target_s}
    if ctx.trace:
        rec["trace"] = _profiled_steps(opt, ctx)
    rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                if ctx.device.type == "cuda" else 0)
    target = opt.target
    del opt
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref_losses, ref_first, ref_change = reference_steps(
        ctx, start, target, par["check_steps"],
        {k: float(v) for k, v in par["lr"].items()},
        {**ctx.config["renderer"], **par.get("renderer", {})}, words_seed)
    numbers, leaves = check.grad_numbers(losses, ref_losses, first,
                                         ref_first, change, ref_change)
    rec["numbers"] = numbers
    rec["checked"] = {"losses": losses, "ref_losses": ref_losses,
                      "leaves": leaves}
    rec["reference_s"] = time.perf_counter() - t
    rec["attempted"] = len(items)
    rec["failed"] = 0
    return rec


def _profiled_steps(opt, ctx):
    """`profile_steps` whole steps under the profiler; the K2b records kept
    must equal K2b's launches (one retry after a flush)."""
    spans = ctx.spans
    for attempt in range(2):
        before = bench.program_counters()

        def run():
            for _ in range(ctx.params["profile_steps"]):
                with spans.span("step"):
                    opt.step()

        _, trace = devtrace.profile(run, spans)
        delta = bench.counter_delta(before, bench.program_counters())
        kept = devtrace.kept_launches(trace, "closest_full_kernel")
        if kept == delta["launches.K2b"]:
            return {"trace": trace, "steps": ctx.params["profile_steps"],
                    "counters": delta}
        print(f"portbench: the profiler kept {kept} K2b records of "
              f"{delta['launches.K2b']} launches (attempt {attempt + 1})",
              flush=True)
    raise RuntimeError("the device trace lost kernel records: no per-layer "
                       "numbers from it")
