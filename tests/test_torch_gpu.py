"""The port's CUDA kernels against their plain versions, on a card.

Imports neither jax nor qaray_tpu, so it runs on the GPU machine, where JAX
is absent:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

Every case carries the `gpu` marker and skips without a CUDA device.
Bars: tests/test_pallas.py for K2a-K2c, tests/test_megakernel.py::_compare
for K1a against the wavefront engine (which itself runs on K2b/K2c).
"""

import numpy as np
import pytest
import torch

from qaray_tpu_torch.integrators.engine import (
    IntegratorConfig,
    render_batch_wavefront,
)
from qaray_tpu_torch.ops import analytic, megakernel
from qaray_tpu_torch.scene.compiler import compile_scene
from qaray_tpu_torch.scene.xml_parser import load_scene

SCENES = ["tests/assets/spot_scene.xml", "tests/assets/softdof_scene.xml"]

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")


def _t_bars(t_ref, i_ref, t_got, i_got):
    hits = (t_ref < 1e29) & (t_got < 1e29)
    rel = (t_got - t_ref).abs()[hits] / t_ref[hits].clamp_min(1.0)
    assert torch.quantile(rel.double(), 0.99).item() < 1e-5
    assert ((t_ref < 1e29) ^ (t_got < 1e29)).float().mean().item() < 0.005
    assert (i_got == i_ref)[hits].float().mean().item() > 0.995
    return hits & (i_got == i_ref)


@pytest.mark.parametrize("path", SCENES)
def test_analytic_kernels_match_plain(cuda, path):
    arr, _ = compile_scene(load_scene(path), device="cuda")
    rs = np.random.RandomState(3)
    n = 1 << 16
    p = torch.tensor(rs.uniform(-30, 30, (n, 3)).astype(np.float32),
                     device="cuda")
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d = torch.tensor(d / np.linalg.norm(d, axis=1, keepdims=True),
                     device="cuda")
    t_max = torch.tensor(rs.uniform(1, 60, n).astype(np.float32),
                         device="cuda")
    prims = arr.analytic
    _t_bars(*analytic.closest_plain(p, d, prims),
            *analytic.closest(p, d, prims))
    full_k = analytic.closest_full(p, d, prims)
    full_p = analytic.closest_full_plain(p, d, prims)
    agree = _t_bars(full_p["t"], full_p["prim_idx"], full_k["t"],
                    full_k["prim_idx"])
    for k in ("n", "p", "uvw"):
        assert (full_k[k] - full_p[k])[agree].abs().max().item() < 1e-4
    for k in ("front", "mtl"):
        assert bool((full_k[k] == full_p[k])[agree].all())
    occ_k = analytic.shadow(p, d, t_max, prims)
    occ_p = analytic.shadow_plain(p, d, t_max, prims)
    assert (occ_k != occ_p).float().mean().item() < 0.005


def _compare(rad_p, t0_p, rad_k, t0_k):
    assert torch.allclose(t0_p, t0_k, rtol=1e-4, atol=1e-3)
    rad_p, rad_k = rad_p.double(), rad_k.double()
    rel = (rad_p - rad_k).abs().amax(-1) / (1.0 + rad_p.abs().amax(-1))
    assert (rel > 1e-3).double().mean().item() < 2e-3
    assert rel.median().item() < 1e-6
    assert (rad_p.mean(0) - rad_k.mean(0)).abs().max().item() < 2e-3


def _render_both(res, spp, sid0, integrator, max_bounce, words):
    scene = load_scene(SCENES[1])
    scene.camera.img_width, scene.camera.img_height = res
    arr, meta = compile_scene(scene, device="cuda")
    w, h = res
    ids = torch.arange(w * h * spp, device="cuda", dtype=torch.int32)
    px, py, sid = ids % w, (ids // w) % h, sid0 + ids // (w * h)
    cfg = IntegratorConfig(integrator=integrator, max_bounce=max_bounce)
    before = megakernel.launches["K1a"]
    rad_k, t0_k = megakernel.mega_render(arr, meta, cfg, px, py, sid, words)
    assert megakernel.launches["K1a"] == before + 1
    rad_p, t0_p = render_batch_wavefront(arr, meta, cfg, px, py, sid, words)
    _compare(rad_p, t0_p, rad_k, t0_k)


@pytest.mark.parametrize("integrator", ["pathtrace", "photonmap"])
def test_megakernel_matches_engine(cuda, integrator):
    _render_both((200, 150), 2, 0, integrator, 4, (0, 3))


@pytest.mark.parametrize("words", [(0, 3), (0, 0, 0, 0)])
@pytest.mark.parametrize("integrator", ["pathtrace", "photonmap"])
def test_megakernel_matches_engine_at_800x600(cuda, integrator, words):
    """The Renderer's shapes: 800x600 lanes, max_bounce 5, a phase-2 sample
    index. Past pixel 32768 the fold datum rid * 65536 + sid wraps in 32
    bits; a kernel that wrapped otherwise would draw other numbers."""
    _render_both((800, 600), 1, 5, integrator, 5, words)
