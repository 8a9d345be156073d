"""The frozen reference equals the port's CPU path at a tiny size: whole
images of both configurations through the Renderer (48x36, a few spp,
the adaptive loop, photon maps), and the autograd route's loss and
gradients on softdof."""

import os
import tempfile

import numpy as np
import pytest
import torch

from portbench import bench
from portbench.reference import render as R

W, H = 48, 36
SEED = 2**33 + 71


def _port_image(config, maps=None):
    from qaray_tpu_torch.renderer import Renderer, RendererParam
    from qaray_tpu_torch.scene.xml_parser import load_scene

    cfg = bench.load_json("configs", config)
    rp = dict(cfg["renderer"], spp_min=2, spp_max=4, seed=SEED)
    rp.update(maps or {})
    r = Renderer(RendererParam(**rp), device="cpu")
    desc = load_scene(str(bench.ROOT / cfg["scene"]))
    desc.camera.img_width, desc.camera.img_height = W, H
    cwd, work = os.getcwd(), tempfile.mkdtemp()
    try:
        os.chdir(work)
        r.compute_scene(desc)
    finally:
        os.chdir(cwd)
    r.param.seed = SEED + 1
    fb = r.render()
    return fb, cfg


@pytest.mark.parametrize("config,maps", [
    ("softdof", None),
    ("caustics", {"photon_map_size": 2000, "caustics_map_size": 200})])
def test_reference_image_equals_the_port(config, maps):
    fb, cfg = _port_image(config, maps)
    rp = dict(cfg["renderer"], **(maps or {}))
    arr, meta = R.load(str(bench.ROOT / cfg["scene"]), W, H, "cpu")
    icfg = R.IntegratorConfig(integrator=rp["integrator"],
                              max_bounce=rp["max_bounce"],
                              shadow_spp=rp["shadow_spp"],
                              shadow_spp_max=rp["shadow_spp_max"],
                              use_photon_map=rp["use_photon_map"])
    pmaps = None
    if rp["use_photon_map"]:
        pmaps = R.build_maps(arr, meta, SEED,
                             photon_map_size=rp["photon_map_size"],
                             caustics_map_size=rp["caustics_map_size"])
    mean, count = R.render_image(arr, meta, icfg,
                                 R.key_words("threefry2x32", SEED + 1), 2, 4,
                                 (0.005, 0.001, 0.005), maps=pmaps)
    assert np.array_equal(fb.count, count.numpy())
    assert np.array_equal(fb.mean, mean.numpy())
    assert fb.count.min() >= 2 and fb.count.max() == 4


def test_reference_gradients_equal_the_autograd_route():
    from qaray_tpu_torch import diff
    from qaray_tpu_torch.integrators.engine import IntegratorConfig
    from qaray_tpu_torch.scene.compiler import compile_scene
    from qaray_tpu_torch.scene.xml_parser import load_scene

    from portbench.traffic.grad_loop import FIELDS, start_params

    xml = str(bench.ROOT / "portbench/scenes/softdof_scene.xml")
    desc = load_scene(xml)
    desc.camera.img_width, desc.camera.img_height = 24, 18
    scene, meta = compile_scene(desc, device="cpu")
    cfg = IntegratorConfig(integrator="pathtrace", max_bounce=5,
                           shadow_spp=16)
    ids = torch.arange(24 * 18, dtype=torch.int32)
    px, py, sid = ids % 24, ids // 24, torch.zeros_like(ids)
    words = R.key_words("threefry2x32", SEED)
    true = diff.extract_params(scene)
    start = start_params({k: getattr(true, k) for k in FIELDS}, SEED, 0.25)
    target = torch.full((ids.shape[0], 3), 0.2)
    loss, grads = diff.render_value_and_grad(
        diff.splice_params(scene, diff.DiffParams(*(start[k]
                                                    for k in FIELDS))),
        meta, cfg, px, py, sid, words, target=target)
    arr, rmeta = R.load(xml, 24, 18, "cpu")
    rcfg = R.IntegratorConfig(integrator="pathtrace", max_bounce=5,
                              shadow_spp=16)
    rloss, rgrads = R.value_and_grad(arr, rmeta, rcfg, start, px, py, sid,
                                     words, target)
    assert float(loss) == float(rloss)
    for k in FIELDS:
        assert torch.equal(getattr(grads, k), rgrads[k]), k
    assert float(rgrads["mtl_diffuse"].abs().sum()) > 0
