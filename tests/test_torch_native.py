"""The port's native host library (qaray_tpu_torch/native.py, its copy of
the C++ source) against its Python paths: the BVH builds node for node,
the empty mesh, the PNG encoder and the OBJ parser (the counterparts of
tests/test_native.py)."""

import os

import numpy as np
import pytest

from qaray_tpu_torch import native
from qaray_tpu_torch.scene import bvh as bvh_mod

ICOSPHERE = os.path.join(os.path.dirname(__file__), "assets",
                         "icosphere.obj")


@pytest.fixture(autouse=True)
def _needs_native():
    if not native.available():
        pytest.skip(f"the native library did not build: {native.error}")


def soup(n, seed=0):
    rs = np.random.RandomState(seed)
    c = rs.uniform(-2, 2, (n, 1, 3))
    return (c + rs.uniform(-0.3, 0.3, (n, 3, 3))).astype(np.float32)


@pytest.mark.parametrize("method", ["mean", "sah"])
def test_bvh_native_matches_numpy(method, monkeypatch):
    """500 triangles: the native tree equals the numpy builder's, node for
    node and bit for bit, and QARAY_BVH selects the method."""
    tri = soup(500)
    a = bvh_mod.build_bvh(tri, use_native=True, method=method)
    b = bvh_mod.build_bvh(tri, use_native=False, method=method)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    other = "sah" if method == "mean" else "mean"
    monkeypatch.setenv("QARAY_BVH", method)
    c = bvh_mod.build_bvh(tri, use_native=False, method=other)
    for x, y in zip(c, b):
        np.testing.assert_array_equal(x, y)
    assert sorted(a.elems.tolist()) == list(range(500))


def test_bvh_native_empty():
    for use_native in (True, False):
        a = bvh_mod.build_bvh(np.zeros((0, 3, 3), np.float32),
                              use_native=use_native)
        assert a.left.tolist() == [-1] and a.count.tolist() == [0]
        assert a.elems.size == 0


@pytest.mark.parametrize("shape", [(33, 47, 3), (20, 21)])
def test_png_native_roundtrip(shape, tmp_path):
    """RGB and grey images through the native encoder read back equal."""
    from PIL import Image

    img = (np.random.RandomState(0).rand(*shape) * 255).astype(np.uint8)
    path = str(tmp_path / "t.png")
    assert native.png_write_native(path, img)
    back = np.asarray(Image.open(path).convert("RGB" if img.ndim == 3
                                               else "L"))
    np.testing.assert_array_equal(back, img)


def test_obj_native_matches_python():
    """The native parse of icosphere.obj equals the Python parser's, and
    load_obj takes it for this geometry-only file."""
    from qaray_tpu_torch.scene import obj_loader

    v, vn, vt, f_v, f_vt, f_vn = native.obj_load_native(ICOSPHERE)
    mesh = obj_loader._load_obj_python(ICOSPHERE)
    np.testing.assert_allclose(v, mesh.vertices, rtol=1e-6)
    np.testing.assert_array_equal(f_v, mesh.faces)
    np.testing.assert_allclose(vn, mesh.normals, rtol=1e-6)
    loaded = obj_loader.load_obj(ICOSPHERE)
    np.testing.assert_array_equal(loaded.vertices, v)
    np.testing.assert_array_equal(loaded.faces, f_v)
