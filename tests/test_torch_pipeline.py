"""The Renderer's one-deep dispatch pipeline against its synchronous loop,
and the order in which both fold escalated lanes against the JAX
Renderer's."""

import os
import shutil
from collections import defaultdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qaray_tpu.fb.device_accum as jax_accum
import qaray_tpu.integrators.engine as jax_engine
import qaray_tpu_torch.fb.device_accum as accum
import qaray_tpu_torch.integrators.engine as engine
import qaray_tpu_torch.renderer as renderer_mod
from qaray_tpu.renderer import Renderer as JaxRenderer
from qaray_tpu.renderer import RendererParam as JaxParam
from qaray_tpu.scene.xml_parser import load_scene as jax_load
from qaray_tpu_torch.ops import megakernel
from qaray_tpu_torch.renderer import Renderer, RendererParam
from qaray_tpu_torch.scene.procedural import with_glass
from qaray_tpu_torch.scene.xml_parser import load_scene

ASSETS = os.path.join(os.path.dirname(__file__), "assets")
PLANES = ("mean", "color_std", "count", "zbuffer", "irrad")

CASES = {
    # name: (scene, RendererParam keywords)
    "softdof-rbg-chunks": ("softdof", dict(spp_min=2, spp_max=6,
                                           round_spp=2, batch_pixels=500)),
    "softdof-threefry-packed": ("softdof", dict(spp_min=4, spp_max=6,
                                                rng_impl="threefry2x32")),
    "caustics-round1": ("caustics", dict(spp_min=2, spp_max=4)),
    "caustics-round2-chunks": ("caustics", dict(spp_min=2, spp_max=4,
                                                round_spp=2,
                                                batch_pixels=500)),
}


def render(case, pipelined, monkeypatch):
    scene, kw = CASES[case]
    desc = load_scene(os.path.join(ASSETS, "softdof_scene.xml"))
    desc.camera.img_width, desc.camera.img_height = 40, 30
    kw = dict(kw, max_bounce=3, shadow_spp=2, shadow_spp_max=4)
    if scene == "caustics":
        # The megakernel's source on the CPU, with the global radius blown
        # up to 50 so that lanes escalate (test_renderer_escalation_splice).
        monkeypatch.setattr(megakernel, "mega_render",
                            megakernel.mega_render_host)
        desc = with_glass(desc, "mid")
        kw.update(use_photon_map=True, photon_map_size=400,
                  caustics_map_size=120, photon_map_bounce=6,
                  caustics_map_bounce=6)
    r = Renderer(RendererParam(**kw), device="cpu")
    r._pipelined = pipelined
    r.compute_scene(desc)
    if scene == "caustics":
        g, c = r.photon_maps
        r.photon_maps = (g._replace(radius=torch.tensor(50.0)), c)
    before = renderer_mod.stats["escalated_lanes"]
    fb = r.render()
    return fb, renderer_mod.stats["escalated_lanes"] - before


@pytest.mark.parametrize("case", sorted(CASES))
def test_pipelined_equals_synchronous(case, monkeypatch, tmp_path):
    """softdof under rbg and threefry keys, and the photon-mapped
    caustics_scene on the megakernel's escalation route, at round_spp 1
    and 2, packed and chunked: the pipelined Renderer's planes equal the
    synchronous loop's bit for bit, escalated lanes included."""
    if CASES[case][0] == "caustics" and shutil.which("g++") is None:
        pytest.skip("needs g++ for the host build of the kernel source")
    monkeypatch.chdir(tmp_path)
    sync, n_sync = render(case, False, monkeypatch)
    pipe, n_pipe = render(case, True, monkeypatch)
    for k in PLANES:
        assert np.array_equal(getattr(pipe, k), getattr(sync, k)), k
    assert n_pipe == n_sync
    if CASES[case][0] == "caustics":
        assert n_pipe > 0
    assert sync.count.max() > CASES[case][1]["spp_min"]


def lane_code(px, py, sid):
    """Escalation flags that a fifth of the lanes raise."""
    return (px * 7 + py * 13 + sid * 3) % 5 == 0


def logger(log, n_pixels, contig):
    """A fold that records, for each pixel, channel 0 of what it folds."""

    def record(pixels, colors, skip):
        colors, pixels = np.asarray(colors), np.asarray(pixels)
        keep = (np.ones(len(pixels), bool) if skip is None
                else ~np.asarray(skip))
        for pix, c, k in zip(pixels, colors[:, 0], keep):
            if k and pix < n_pixels:
                log[int(pix)].append(float(c))

    def wrap(fn):
        def fold(state, where, colors, skip=None, irr=None):
            n = np.asarray(colors).shape[0]
            pixels = (int(where) + np.arange(n) if contig
                      else np.asarray(where))
            record(pixels, colors, skip)
            return fn(state, where, colors, skip=skip, irr=irr)

        return fold

    return wrap


@pytest.mark.parametrize("layout", ["packed", "chunks"])
def test_escalated_lanes_fold_in_the_jax_order(layout, monkeypatch):
    """ROADMAP C4. Both Renderers on a stand-in dispatch whose radiance
    carries each lane's sample index (and sample + 0.5 for its exact
    re-render) and which escalates a fifth of the lanes, on the right half
    of an 8x6 image (the left half converges at spp_min): every pixel folds
    its samples in the JAX Renderer's order, in which a dispatch's
    escalated lanes fold after all samples of a packed dispatch, or after
    the next chunk's main fold (phase 1 in two chunks, phase 2's 24 pixels
    in one chunk for 2 rounds, so that a chunk covers the same pixels in
    two consecutive rounds). The port's synchronous loop folded them right
    after their own sample."""
    w, h = 8, 6
    n_pix = w * h
    kw = dict(spp_min=4 if layout == "packed" else 2, spp_max=6,
              round_spp=2, batch_pixels=1 << 20 if layout == "packed"
              else 30, rng_impl="threefry2x32")
    logs = {}
    for pkg in ("jax", "port"):
        log = logs[pkg] = defaultdict(list)
        mod = jax_accum if pkg == "jax" else accum
        for name, contig in (("accumulate_round", False),
                             ("accumulate_contig", True)):
            monkeypatch.setattr(mod, name,
                                logger(log, n_pix, contig)(getattr(mod,
                                                                   name)))
        for eng in (jax_engine, engine):
            monkeypatch.setattr(eng, "use_pathtrace_mega", lambda *a: True)
        path = os.path.join(ASSETS, "spot_scene.xml")
        if pkg == "jax":
            desc = jax_load(path)
            desc.camera.img_width, desc.camera.img_height = w, h
            r = JaxRenderer(JaxParam(**kw))
        else:
            desc = load_scene(path)
            desc.camera.img_width, desc.camera.img_height = w, h
            r = Renderer(RendererParam(**kw), device="cpu")
        r.compute_scene(desc)
        r.param.use_photon_map = True

        def lanes(px, py, sid, lib):
            px, py, sid = (np.asarray(x) for x in (px, py, sid))
            right = px >= w // 2
            rad = np.stack([np.where(right, sid, 0), px, py],
                           axis=1).astype(np.float32)
            esc = lane_code(px, py, sid) & (py < h) & right
            return rad, esc

        if pkg == "jax":
            def dispatch(scene, meta, cfg, px, py, sid, key, maps,
                         want_aux=False):
                rad, esc = lanes(px, py, sid, jnp)
                n = rad.shape[0]
                return (jnp.asarray(rad), jnp.zeros(n), jnp.zeros(n, bool),
                        jnp.asarray(esc))

            def exact(scene, meta, cfg, px, py, sid, key, maps):
                rad, _ = lanes(px, py, sid, jnp)
                rad[:, 0] += 0.5
                return (jnp.asarray(rad), jnp.zeros(rad.shape[0]))

            r._render_fn = dispatch
            monkeypatch.setattr(jax_engine, "render_batch_xla", exact)
        else:
            def dispatch(scene, meta, cfg, px, py, sid, words, maps,
                         want_aux=False):
                rad, esc = lanes(px, py, sid, torch)
                n = rad.shape[0]
                return (torch.tensor(rad), torch.zeros(n),
                        torch.zeros(n, dtype=torch.bool), torch.tensor(esc))

            def exact(scene, meta, cfg, px, py, sid, words, maps):
                rad, _ = lanes(px, py, sid, torch)
                rad[:, 0] += 0.5
                return torch.tensor(rad), torch.zeros(rad.shape[0])

            r._render_fn = dispatch
            monkeypatch.setattr(engine, "render_batch_wavefront", exact)
        fb = r.render()
        count = np.asarray(fb.count).reshape(h, w)
        assert (count[:, w // 2:] == 6).all()
        assert (count[:, :w // 2] == kw["spp_min"]).all()
    assert logs["port"] == logs["jax"]
    assert sorted(logs["port"]) == list(range(n_pix))
    # The JAX order is not sample order: an escalated sample folds after a
    # later one on some pixel.
    assert any(seq != sorted(seq) for seq in logs["port"].values())
    assert any(x % 1 for seq in logs["port"].values() for x in seq)
