"""The port's scene compiler against qaray_tpu's: same tables, same meta.

Also checks that scenes the port does not carry yet (per-instance
object-space meshes, textures) raise NotImplementedError instead of being
dropped.
"""

import jax
import numpy as np
import pytest
import torch

from qaray_tpu.scene.compiler import compile_scene as jax_compile
from qaray_tpu.scene.xml_parser import load_scene as jax_load
from qaray_tpu_torch.scene.compiler import compile_scene
from qaray_tpu_torch.scene.convert import from_numpy_arrays
from qaray_tpu_torch.scene.xml_parser import load_scene


@pytest.mark.parametrize("name", ["spot", "softdof"])
@pytest.mark.parametrize("res", [None, (32, 24)])
def test_compile_scene_matches_jax(name, res):
    path = f"tests/assets/{name}_scene.xml"
    jscene, tscene = jax_load(path), load_scene(path)
    if res is not None:
        jscene.camera.img_width, jscene.camera.img_height = res
        tscene.camera.img_width, tscene.camera.img_height = res
    arrays, meta = jax_compile(jscene)
    want, want_meta = from_numpy_arrays(jax.tree.map(np.asarray, arrays),
                                        meta, "cpu")
    got, got_meta = compile_scene(tscene, device="cpu")
    assert got_meta == want_meta
    assert hash(got_meta) == hash(want_meta)
    assert got.mesh is got.instances is want.mesh is want.instances is None
    for group_got, group_want in zip(got, want):
        if group_got is None:
            continue
        for f, a, b in zip(group_got._fields, group_got, group_want):
            assert (a is None) == (b is None), f
            if a is None:
                continue
            assert a.dtype == b.dtype and a.shape == b.shape, f
            assert torch.equal(a, b), f


def _same(a, b):
    """Equal dtype, shape and bits (the packed BVH nodes hold integers in
    float32 words, some of them NaN patterns)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


@pytest.mark.parametrize("name,subdiv,env", [
    ("mesh", None, {}),
    ("mirror", None, {}),
    ("grid", None, {}),
    # An ico3 forced onto the tiled route and onto the megakernel's
    # streamed mesh layout by the compiler's threshold variables.
    ("mesh", 3, {"QARAY_STREAM_MAX_TRIS": "1"}),
    ("mesh", 3, {"QARAY_MEGA_MESH_MAX_TRIS": "1"}),
], ids=["mesh", "mirror", "grid", "ico3-tiled", "ico3-mega-stream"])
def test_compile_mesh_scene_matches_jax(name, subdiv, env, monkeypatch):
    from qaray_tpu_torch.scene.procedural import icosphere, with_mesh

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    path = f"tests/assets/{name}_scene.xml"
    jscene, tscene = jax_load(path), load_scene(path)
    if subdiv is not None:
        jscene = with_mesh(jscene, *icosphere(subdiv))
        tscene = with_mesh(tscene, *icosphere(subdiv))
    arrays, meta = jax_compile(jscene)
    want, want_meta = from_numpy_arrays(jax.tree.map(np.asarray, arrays),
                                        meta, "cpu")
    got, got_meta = compile_scene(tscene, device="cpu")
    assert got_meta == want_meta
    assert got_meta.num_mesh_instances == 1 and got_meta.world_bvh
    if "QARAY_STREAM_MAX_TRIS" in env:
        assert got_meta.mesh_tiled and not got_meta.mesh_stream
    if "QARAY_MEGA_MESH_MAX_TRIS" in env:
        assert got_meta.mesh_mega and got_meta.mesh_mega_stream
    for group_got, group_want in zip(got, want):
        for f, a, b in zip(group_got._fields, group_got, group_want):
            assert (a is None) == (b is None), f
            assert a is None or _same(a, b), f


@pytest.mark.parametrize("case", ["empty", "five", "ico3", "soup",
                                  "flat-dups"])
@pytest.mark.parametrize("max_leaf", [1, 4])
def test_bvh_matches_jax_numpy_builder(case, max_leaf):
    """The port's level-at-a-time SAH build against the JAX package's
    node-at-a-time numpy build: the same nodes, numbering and leaf order,
    bit for bit, including bins that tie and centroids that coincide."""
    from qaray_tpu.scene.bvh import _build_bvh_sah_numpy, bvh_depth
    from qaray_tpu_torch.scene import bvh
    from qaray_tpu_torch.scene.procedural import icosphere

    rs = np.random.RandomState(4)
    soup = rs.normal(size=(2000, 3, 3)).astype(np.float32)
    flat = soup.copy()
    flat[:, :, 2] = 0.0
    flat[:200] = flat[0]
    v, f = icosphere(3)
    tris = {"empty": soup[:0], "five": soup[:5],
            "ico3": np.asarray(v, np.float32)[np.asarray(f)], "soup": soup,
            "flat-dups": flat}[case]
    want = _build_bvh_sah_numpy(tris, max_leaf)
    got = bvh.build_bvh(tris, max_leaf)
    for f_, a, b in zip(want._fields, want, got):
        assert a.dtype == b.dtype and a.shape == b.shape, f_
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), f_
    assert bvh.bvh_depth(got) == bvh_depth(want)


@pytest.mark.parametrize("name", ["mesh", "texture"])
def test_later_slices_raise(name):
    """Textures (texture slice) and per-instance object-space meshes,
    which the BVH walks trace (BVH-walk slice)."""
    kw = {"world_bvh": False} if name == "mesh" else {}
    with pytest.raises(NotImplementedError):
        compile_scene(load_scene(f"tests/assets/{name}_scene.xml"),
                      device="cpu", **kw)
