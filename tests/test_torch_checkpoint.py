"""Checkpoints (RendererParam.checkpoint_every, Renderer.load_checkpoint):
the counterpart of tests/test_checkpoint.py on softdof at 40x30 with
threefry keys, and the npz state shared with the JAX package's
FrameBuffer."""

import os

import numpy as np
import pytest

from qaray_tpu.fb.framebuffer import FrameBuffer as JaxFrameBuffer
from qaray_tpu_torch.fb.framebuffer import FrameBuffer
from qaray_tpu_torch.renderer import Renderer, RendererParam
from qaray_tpu_torch.scene.xml_parser import load_scene

SOFTDOF = os.path.join(os.path.dirname(__file__), "assets",
                       "softdof_scene.xml")
FIELDS = ("mean", "color_std", "count", "zbuffer")


def renderer(ckpt, stop_at=None):
    desc = load_scene(SOFTDOF)
    desc.camera.img_width, desc.camera.img_height = 40, 30
    # 1,200 lanes a dispatch: phase 1 takes one sample a dispatch, so a
    # checkpoint falls after samples 2 and 4.
    r = Renderer(RendererParam(spp_min=4, spp_max=6, rng_impl="threefry2x32",
                               batch_pixels=1200, checkpoint_every=2,
                               checkpoint_path=ckpt, max_bounce=3,
                               shadow_spp=4), device="cpu")
    r.compute_scene(desc)
    if stop_at is not None:
        def stop(spp, _):
            if spp >= stop_at:
                r.signal_stop()

        r.set_progress_callback(stop)
    return r


def test_resume_equals_uninterrupted(tmp_path):
    """A render stopped after its checkpoint at 2 samples, resumed by a new
    Renderer from that file, ends with the uninterrupted render's planes
    bit for bit (mean, std, count, depth)."""
    full = renderer(str(tmp_path / "full.npz")).render()
    part = str(tmp_path / "part.npz")
    first = renderer(part, stop_at=2)
    first.render()
    saved = FrameBuffer.load_state(part)
    assert (saved.count == 2).all()
    second = renderer(part)
    second.load_checkpoint(part)
    resumed = second.render()
    for k in FIELDS:
        assert np.array_equal(getattr(resumed, k), getattr(full, k)), k
    assert (full.count >= 4).all() and full.count.max() == 6


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_packages(writer, tmp_path):
    """A state that one package's FrameBuffer.save_state writes loads in
    the other's with every field equal."""
    rs = np.random.RandomState(3)
    w, h = 7, 5
    src = (JaxFrameBuffer if writer == "jax" else FrameBuffer)(w, h)
    src.mean = rs.uniform(size=(w * h, 3)).astype(np.float32)
    src.color_std = rs.uniform(size=(w * h, 3)).astype(np.float32)
    src.count = rs.randint(0, 9, w * h).astype(np.int32)
    src.zbuffer = rs.uniform(1, 50, w * h).astype(np.float32)
    path = str(tmp_path / "state.npz")
    src.save_state(path)
    dst = (FrameBuffer if writer == "jax" else JaxFrameBuffer).load_state(
        path)
    assert (dst.width, dst.height) == (w, h)
    for k in FIELDS:
        got, want = getattr(dst, k), getattr(src, k)
        assert got.dtype == want.dtype and np.array_equal(got, want), k
