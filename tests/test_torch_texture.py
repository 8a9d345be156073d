"""The port's texture stack (ops/texture.py) against qaray_tpu.ops.texture.

One atlas for both, compiled by qaray_tpu from texture_scene.xml with a
file texture (tests/assets/colorBuffer.png) bound to the ball beside the
floor's checker, and 4,096 random samples from a numpy seed with random
TextureMap transforms.

Tolerances. Given the same uvw, bilinear file samples agree within 1e-6
absolute (the same arithmetic; texels lie in [0, 1]) and checker samples are
exact. Through the TextureMap transform the two packages sum the 3x3
product in different orders (an einsum against a left-to-right sum), so the
transformed uvw differs in its last bits, by up to about 1e-6 at |uvw| of a
few units: a bilinear sample then moves by that times the image's width and
its texel contrast, inside 2e-3 absolute here, and a checker sample flips
on at most 1e-3 of the samples, those at a cell edge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qaray_tpu.ops import texture as JT
from qaray_tpu.scene.compiler import compile_scene as jax_compile
from qaray_tpu.scene.textures import load_image
from qaray_tpu.scene.xml_parser import load_scene as jax_load
from qaray_tpu_torch.ops import texture as T
from qaray_tpu_torch.scene.convert import from_numpy_arrays
from qaray_tpu_torch.scene.procedural import with_texture

N = 4096
IMAGE = "tests/assets/colorBuffer.png"


@pytest.fixture(scope="module")
def atlases():
    scene = with_texture(jax_load("tests/assets/texture_scene.xml"),
                         ("ballmtl", "diffuse"), image=load_image(IMAGE))
    arrays, meta = jax_compile(scene)
    tarr, _ = from_numpy_arrays(jax.tree.map(np.asarray, arrays), meta, "cpu")
    kinds = np.asarray(arrays.textures.kind)
    assert sorted(kinds.tolist()) == [0, 1]  # one file, one checker
    return arrays, tarr, int(np.argmin(kinds)), int(np.argmax(kinds))


@pytest.fixture(scope="module")
def samples():
    rs = np.random.RandomState(11)
    rot = rs.uniform(0, 2 * np.pi, N)
    scale = rs.uniform(0.5, 8.0, N)
    m = np.zeros((N, 3, 3), np.float32)
    m[:, 0, 0] = np.cos(rot) * scale
    m[:, 0, 1] = -np.sin(rot) * scale
    m[:, 1, 0] = np.sin(rot) * scale
    m[:, 1, 1] = np.cos(rot) * scale
    m[:, 2, 2] = scale
    return dict(
        uvw=rs.uniform(-2, 3, (N, 3)).astype(np.float32),
        tex_id=rs.randint(-1, 2, N).astype(np.int32),
        tex_m=m,
        tex_t=rs.uniform(-1, 1, (N, 3)).astype(np.float32),
        color=rs.uniform(0, 1, (N, 3)).astype(np.float32),
        has=rs.uniform(size=N) < 0.9,
        duvw0=(rs.normal(size=(N, 3)) * 0.02).astype(np.float32),
        duvw1=(rs.normal(size=(N, 3)) * 0.02).astype(np.float32),
        d=rs.normal(size=(N, 3)).astype(np.float32),
    )


def _t(x):
    return torch.tensor(x)


def _edge_bars(want, got, atol, flips=1e-3):
    """All samples within atol but for at most `flips` of them (checker
    samples whose transformed uv lies on a cell edge)."""
    err = np.abs(np.asarray(want) - got.numpy()).max(axis=-1)
    assert (err > atol).mean() <= flips, (err > atol).mean()


def test_sample_file_texture(atlases, samples):
    arrays, tarr, file_id, _ = atlases
    tid = np.full(N, file_id, np.int32)
    want = JT.sample_file_texture(arrays.textures, jnp.asarray(tid),
                                  jnp.asarray(samples["uvw"]))
    got = T.sample_file_texture(tarr.textures, _t(tid), _t(samples["uvw"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    assert float(got.std()) > 0.05  # the image, not a constant


def test_sample_checker_and_dispatch(atlases, samples):
    arrays, tarr, _, checker_id = atlases
    tid = np.full(N, checker_id, np.int32)
    want = JT.sample_checker(arrays.textures, jnp.asarray(tid),
                             jnp.asarray(samples["uvw"]))
    got = T.sample_checker(tarr.textures, _t(tid), _t(samples["uvw"]))
    assert np.array_equal(got.numpy(), np.asarray(want))
    want = JT.sample_texture(arrays.textures, jnp.asarray(samples["tex_id"]),
                             jnp.asarray(samples["uvw"]))
    got = T.sample_texture(tarr.textures, _t(samples["tex_id"]),
                           _t(samples["uvw"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def test_sample_textured_color(atlases, samples):
    arrays, tarr, _, _ = atlases
    s = samples
    want = JT.sample_textured_color(
        arrays.textures, *(jnp.asarray(s[k]) for k in (
            "color", "tex_id", "tex_m", "tex_t", "uvw", "has")))
    got = T.sample_textured_color(
        tarr.textures, *(_t(s[k]) for k in (
            "color", "tex_id", "tex_m", "tex_t", "uvw", "has")))
    _edge_bars(want, got, 2e-3)
    plain = (s["tex_id"] < 0) | ~s["has"]
    assert np.array_equal(got.numpy()[plain], s["color"][plain])


@pytest.mark.parametrize("footprint", ["random", "zero"])
def test_sample_textured_color_filtered(atlases, samples, footprint):
    arrays, tarr, _, _ = atlases
    s = dict(samples)
    if footprint == "zero":
        s["duvw0"] = np.zeros_like(s["duvw0"])
        s["duvw1"] = np.zeros_like(s["duvw1"])
    keys = ("color", "tex_id", "tex_m", "tex_t", "uvw", "duvw0", "duvw1",
            "has")
    want = JT.sample_textured_color_filtered(
        arrays.textures, *(jnp.asarray(s[k]) for k in keys))
    got = T.sample_textured_color_filtered(
        tarr.textures, *(_t(s[k]) for k in keys))
    # One of 32 checker samples flipping moves a filtered colour by 1/32.
    _edge_bars(want, got, 2e-3, flips=2e-2 if footprint == "random" else 1e-3)
    assert np.abs(np.asarray(want) - got.numpy()).max() < (
        0.04 if footprint == "random" else 1.0)
    if footprint == "zero":  # the point sample, as the reference's early out
        point = T.sample_textured_color(
            tarr.textures, *(_t(s[k]) for k in (
                "color", "tex_id", "tex_m", "tex_t", "uvw", "has")))
        assert torch.equal(got, point)


def test_elliptic_offsets_match(atlases):
    xs, ys = JT._elliptic_offsets()
    tx, ty = T._elliptic_offsets("cpu")
    assert np.array_equal(np.asarray(xs), tx.numpy())
    assert np.array_equal(np.asarray(ys), ty.numpy())
    assert tx.shape == (31,)


@pytest.mark.parametrize("which", ["environment", "background"])
def test_environment_and_background(samples, which):
    """A scene with the image bound to the background and, rotated and
    scaled, to the environment."""
    image = load_image(IMAGE)
    scene = jax_load("tests/assets/spot_scene.xml")
    scene = with_texture(scene, "background", image=image,
                         color=(1.0, 0.9, 0.8))
    scene = with_texture(scene, "environment", image=image,
                         color=(0.8, 0.9, 1.0), scale=0.5, angle=25.0,
                         offset=(0.1, 0.2, 0.0))
    arrays, meta = jax_compile(scene)
    assert meta.has_bg_texture and meta.has_env_texture
    tarr, _ = from_numpy_arrays(jax.tree.map(np.asarray, arrays), meta, "cpu")
    if which == "environment":
        d = samples["d"] / np.linalg.norm(samples["d"], axis=1, keepdims=True)
        want = JT.sample_environment(arrays.textures, arrays.environment,
                                     jnp.asarray(d))
        got = T.sample_environment(tarr.textures, tarr.environment, _t(d))
    else:
        uvw = np.abs(samples["uvw"]) / 3.0
        want = JT.sample_background(arrays.textures, arrays.background,
                                    jnp.asarray(uvw))
        got = T.sample_background(tarr.textures, tarr.background, _t(uvw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3,
                               rtol=0)
    assert float(got.std()) > 0.05
