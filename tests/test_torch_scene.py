"""The port's scene compiler against qaray_tpu's: same tables, same meta.

Also checks that scenes this slice does not carry (meshes, textures) raise
NotImplementedError instead of being dropped.
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
    for group_got, group_want in zip(got, want):
        for f, a, b in zip(group_got._fields, group_got, group_want):
            assert a.dtype == b.dtype and a.shape == b.shape, f
            assert torch.equal(a, b), f


@pytest.mark.parametrize("name", ["mesh", "texture"])
def test_later_slices_raise(name):
    with pytest.raises(NotImplementedError):
        compile_scene(load_scene(f"tests/assets/{name}_scene.xml"),
                      device="cpu")
