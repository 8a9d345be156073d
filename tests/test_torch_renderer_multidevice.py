"""The port's Renderer over a device mesh: the counterparts of
tests/test_renderer_multidevice.py on in-repo scenes.

A mesh of ["cpu"] * 4 stands in for JAX's 8-device CPU mesh: every
dispatch splits into four shards, each rendered by engine.render_batch,
and the outputs come back in lane order. Under threefry keys a lane's
samples do not depend on the batch layout, so the image equals the
single-device render's.
"""

import os

import numpy as np
import pytest
import torch

from qaray_tpu_torch.ops import megakernel
from qaray_tpu_torch.parallel.mesh import make_render_mesh
from qaray_tpu_torch.renderer import Renderer, RendererParam
from qaray_tpu_torch.scene.procedural import with_glass
from qaray_tpu_torch.scene.xml_parser import load_scene

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")


def _scene(name="spot", res=(48, 36)):
    sd = load_scene(os.path.join(ASSETS, f"{name}_scene.xml"))
    sd.camera.img_width, sd.camera.img_height = res
    return sd


def _param(**kw):
    kw.setdefault("spp_min", 2)
    kw.setdefault("spp_max", 4)
    kw.setdefault("max_bounce", 2)
    kw.setdefault("shadow_spp", 4)
    kw.setdefault("shadow_spp_max", 8)
    kw.setdefault("integrator", "pathtrace")
    kw.setdefault("rng_impl", "threefry2x32")
    return RendererParam(**kw)


def _mesh4():
    return make_render_mesh(["cpu"] * 4)


def test_num_devices_takes_the_devices_there_are():
    """num_devices > 1 without a mesh takes the first num_devices devices
    of the Renderer's kind: one CPU (as jax.devices()[:n] gives the chips
    there are)."""
    r = Renderer(_param(num_devices=4), device="cpu")
    assert r._mesh.size == 1 and r._mesh.local == [0]
    assert Renderer(_param(), device="cpu")._mesh is None


@pytest.mark.parametrize("name", ["spot", "softdof"])
def test_renderer_4device_matches_single(name, tmp_path):
    """Adaptive rounds over four shards: counts equal, mean within 1e-6 and
    the image equal to the single-device render's; the rank-debug planes
    of the one process count every sample of every pixel."""
    r1 = Renderer(_param(), device="cpu")
    r1.compute_scene(_scene(name))
    fb1 = r1.render()

    r4 = Renderer(_param(num_devices=4, rank_debug=True), device="cpu",
                  mesh=_mesh4())
    r4.compute_scene(_scene(name))
    fb4 = r4.render()

    assert np.array_equal(fb1.count, fb4.count), "adaptive spp counts differ"
    assert fb1.count.max() > fb1.count.min(), "phase 2 ran"
    np.testing.assert_allclose(fb1.mean, fb4.mean, atol=1e-6)
    assert np.array_equal(fb1.img, fb4.img)
    assert np.array_equal(r4._rank_mask.numpy(), fb4.count)
    r4.save_rank_debug(str(tmp_path / "d_"), 0)
    from PIL import Image

    mask = np.asarray(Image.open(tmp_path / "d_rank0_maskBuffer.png"))
    assert np.array_equal(mask.reshape(-1), fb4.count)
    assert (tmp_path / "d_rank0_sampleBuffer.png").exists()


def test_renderer_4device_cancel_checkpoint_resume(tmp_path):
    """Cooperative stop at a round boundary on the 4-shard mesh: one sample
    a dispatch (batch_pixels 2048 >= 48 * 36), stopped after 2 spp, the
    checkpoint written there resumed by a fresh Renderer over the mesh,
    and the resumed image equal to an uninterrupted single-device one."""
    ckpt = str(tmp_path / "ck.npz")
    sd = _scene()
    r = Renderer(_param(spp_min=4, spp_max=4, num_devices=4,
                        batch_pixels=2048, checkpoint_every=2,
                        checkpoint_path=ckpt), device="cpu", mesh=_mesh4())
    r.compute_scene(sd)

    def cb(done, total):
        if done >= 2:
            r.signal_stop()

    r.set_progress_callback(cb)
    fb = r.render()
    assert int(fb.count.max()) == 2, "expected cancellation at 2 spp"
    assert fb.count.min() == fb.count.max(), "round boundary not respected"
    assert os.path.exists(ckpt)

    r2 = Renderer(_param(spp_min=4, spp_max=4, num_devices=4),
                  device="cpu", mesh=_mesh4())
    r2.compute_scene(sd)
    r2.load_checkpoint(ckpt)
    assert int(r2.fb.count.min()) == 2
    fb_res = r2.render()

    r_ref = Renderer(_param(spp_min=4, spp_max=4), device="cpu")
    r_ref.compute_scene(sd)
    fb_ref = r_ref.render()
    np.testing.assert_allclose(fb_ref.mean, fb_res.mean, atol=1e-6)
    assert np.array_equal(fb_ref.count, fb_res.count)


@pytest.mark.parametrize("route", ["plain", "escalating"])
def test_renderer_4device_photon_map(route, tmp_path, monkeypatch):
    """caustics_scene (softdof, its middle sphere glass) at 40x30 with
    photon maps over the 4-shard mesh (batch_pixels 512, so chunks too):
    mean within 1e-5 and counts equal to one device's. "escalating" runs
    the megakernel's source on the CPU (g++) with the global radius at 50,
    so that lanes escalate and render again unsharded on the Renderer's
    device (tests/test_torch_pipeline.py's setting)."""
    monkeypatch.chdir(tmp_path)  # the maps' .dat files
    if route == "escalating":
        monkeypatch.setattr(megakernel, "mega_render",
                            megakernel.mega_render_host)
    sd = with_glass(_scene("softdof", (40, 30)), "mid")

    def render(**kw):
        r = Renderer(_param(integrator="photonmap", use_photon_map=True,
                            photon_map_size=200, caustics_map_size=60,
                            photon_map_bounce=6, caustics_map_bounce=6,
                            spp_min=2, spp_max=2, **kw), device="cpu",
                     mesh=_mesh4() if kw else None)
        r.compute_scene(sd)
        if route == "escalating":
            g, c = r.photon_maps
            r.photon_maps = (g._replace(radius=torch.tensor(50.0)), c)
        escalated = []
        fix = r._render_escalated

        def counted(*args):
            out = fix(*args)
            escalated.append(0 if out is None else out[0].size)
            return out

        r._render_escalated = counted
        return r.render(), sum(escalated)

    fb1, esc1 = render()
    fb4, esc4 = render(num_devices=4, batch_pixels=512)
    assert np.isfinite(fb4.mean).all()
    np.testing.assert_allclose(fb1.mean, fb4.mean, atol=1e-5)
    assert np.array_equal(fb1.count, fb4.count)
    assert esc1 == esc4
    assert (esc4 > 0) == (route == "escalating")
