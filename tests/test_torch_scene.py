"""The port's scene compiler against qaray_tpu's: same tables, same meta.

Also checks that what the port does not carry yet (per-instance
object-space meshes, photon maps) raises NotImplementedError instead of
being dropped.
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


def _assert_same_tables(got, want):
    for group_got, group_want in zip(got, want):
        if group_got is None:
            assert group_want is None
            continue
        for f, a, b in zip(group_got._fields, group_got, group_want):
            assert (a is None) == (b is None), f
            assert a is None or _same(a, b), f


@pytest.mark.parametrize("case", ["checker", "files", "uvmesh"])
def test_compile_textured_scene_matches_jax(case, tmp_path):
    """Texture tables: the atlas, the materials' tex_id/tex_m/tex_t, the
    textured background and environment and the meta's texture facts, on
    texture_scene.xml (checkers), on a scene with a file texture on a
    material, the background and the environment and a texture file that
    does not exist (folded to black), and on a UV mesh with a file
    texture."""
    from test_torch_engine import file_texture_scene, uv_mesh_scene

    path = {"checker": lambda _: "tests/assets/texture_scene.xml",
            "files": file_texture_scene, "uvmesh": uv_mesh_scene}[case](
                tmp_path)
    arrays, meta = jax_compile(jax_load(path))
    want, want_meta = from_numpy_arrays(jax.tree.map(np.asarray, arrays),
                                        meta, "cpu")
    got, got_meta = compile_scene(load_scene(path), device="cpu")
    assert got_meta == want_meta
    _assert_same_tables(got, want)
    assert got_meta.has_mtl_textures
    if case == "checker":
        assert got_meta.mega_tex_ok
        assert got_meta.mega_tex_slots == (True, False, False, False, False)
        assert got.kernel.mtl.shape == (2, 102)
    else:
        assert not got_meta.mega_tex_ok and got.kernel.mtl.shape[1] == 22
        assert got.textures.texels.shape[0] == 1 + 200 * 150
    if case == "files":
        assert got_meta.has_bg_texture and got_meta.has_env_texture
        # Interning order: background, environment, then the materials.
        assert int(got.background.tex_id) == 0
        assert int(got.materials.tex_id.max()) == 0  # the one image, shared
        # The missing specular texture: black, and no texture id.
        assert float(got.materials.specular[0].abs().max()) == 0.0
        assert int(got.materials.tex_id[0, 1]) == -1


def test_kernel_tables_match_pack_tables():
    """with_kernel_tables' material table, checker columns included,
    equals pallas_pathtrace._pack_tables(scene, want_tex=True) exactly, for
    texture_scene.xml and a two-slot variant with a rotated map."""
    from qaray_tpu.ops.pallas_pathtrace import _pack_tables
    from qaray_tpu_torch.scene.procedural import with_texture

    scene = jax_load("tests/assets/texture_scene.xml")
    two = with_texture(scene, ("ballmtl", "specular"),
                       checker=((1.0, 0.2, 0.1), (0.1, 0.3, 1.0)),
                       scale=0.07, angle=30.0, offset=(0.013, 0.027, 0.0))
    for desc in (scene, two):
        arrays, meta = jax_compile(desc)
        got, _ = from_numpy_arrays(jax.tree.map(np.asarray, arrays), meta,
                                   "cpu")
        _, mtl_tab, light_tab, cam_tab = _pack_tables(arrays, want_tex=True)
        assert got.kernel.mtl.shape == (2, 102)
        assert np.array_equal(got.kernel.mtl.numpy(), np.asarray(mtl_tab))
        assert np.array_equal(got.kernel.light.numpy(),
                              np.asarray(light_tab))
        assert np.array_equal(got.kernel.cam.numpy(), np.asarray(cam_tab)[0])
    assert meta.mega_tex_slots[:2] == (True, True)


@pytest.mark.parametrize("name", ["mesh", "texture"])
def test_later_slices_raise(name):
    """Nothing raises any more. Per-instance object-space meshes render
    since the BVH-walk slice: mesh_scene compiles per instance and renders
    on the wavefront engine. texture_scene compiles, and since the photon
    slice a photon-mapped config renders it (without maps: no gathers).
    Since the multi-device slice a Renderer with num_devices=2 builds its
    mesh (of the one CPU device) and renders each scene like one device."""
    from qaray_tpu_torch.integrators import engine
    from qaray_tpu_torch.renderer import Renderer, RendererParam

    if name == "mesh":
        arr, meta = compile_scene(load_scene("tests/assets/mesh_scene.xml"),
                                  device="cpu", world_bvh=False)
        assert not meta.world_bvh and meta.num_mesh_instances == 1
        lane = torch.arange(8, dtype=torch.int32)
        rad, _ = engine.render_batch(arr, meta, engine.IntegratorConfig(),
                                     lane * 40, lane * 30, lane, (0, 3))
        assert torch.isfinite(rad).all()
        _mesh_renderer_renders(Renderer, RendererParam, "mesh_scene.xml",
                               world_bvh=False)
        return

    arr, meta = compile_scene(load_scene("tests/assets/texture_scene.xml"),
                              device="cpu")
    lane = torch.zeros(1, dtype=torch.int32)
    rad, _ = engine.render_batch(arr, meta, engine.IntegratorConfig(
        use_photon_map=True), lane, lane, lane, (0, 3))
    assert torch.isfinite(rad).all()
    _mesh_renderer_renders(Renderer, RendererParam, "texture_scene.xml")


def _mesh_renderer_renders(Renderer, RendererParam, name, **kw):
    """Renderer(num_devices=2) over its one-device mesh renders the scene
    at 16x12 x 1 spp as one device does, bit for bit."""
    fbs = []
    for n in (0, 2):
        desc = load_scene(f"tests/assets/{name}")
        desc.camera.img_width, desc.camera.img_height = 16, 12
        r = Renderer(RendererParam(num_devices=n, spp_min=1, spp_max=1,
                                   max_bounce=2, shadow_spp=2,
                                   shadow_spp_max=2), device="cpu")
        assert (r._mesh is not None) == (n == 2)
        r.compute_scene(desc, **kw)
        fbs.append(r.render())
    assert np.array_equal(fbs[0].mean, fbs[1].mean)
