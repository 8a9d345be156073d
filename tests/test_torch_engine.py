"""The port's wavefront engine against qaray_tpu's render_batch_xla (its
mesh routes in tests/test_torch_engine_routes.py, which shares this
file's helpers).

Under a threefry2x32 key both draw the same random numbers, so the bar is
per-lane parity, as tests/test_megakernel.py::_compare holds the megakernel
to the XLA engine: primary depth to rtol 1e-4 / atol 1e-3; fewer than 0.2 %
of lanes above 1e-3 relative radiance error (lanes where float rounding
flips a roulette comparison); median relative error < 1e-6; image-mean
error < 2e-3. Scenes with a checker allow 0.5 % of lanes, the bar of
tests/test_megakernel.py::test_mega_checker_textures_parity: the two
packages' hit points differ in their last bits (primary depth agrees to
rtol 1e-4), and one of a footprint's 32 samples falling on the other side
of a cell edge moves a lane by 1/32 of the colours' difference.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qaray_tpu.integrators.engine import IntegratorConfig as JaxConfig
from qaray_tpu.integrators.engine import render_batch_xla
from qaray_tpu.scene.compiler import compile_scene
from qaray_tpu.scene.xml_parser import load_scene
from qaray_tpu_torch.fb import device_accum
from qaray_tpu_torch.integrators import engine
from qaray_tpu_torch.scene.convert import from_numpy_arrays

RES = (32, 24)
SPP = 2


def lanes(res=RES, spp=SPP):
    w, h = res
    ids = np.arange(w * h * spp, dtype=np.int32)
    return ids % w, (ids // w) % h, ids // (w * h)


def scenes(name, res=RES):
    scene = load_scene(f"tests/assets/{name}_scene.xml")
    scene.camera.img_width, scene.camera.img_height = res
    arrays, meta = compile_scene(scene)
    tarr, tmeta = from_numpy_arrays(jax.tree.map(np.asarray, arrays), meta,
                                    "cpu")
    return arrays, meta, tarr, tmeta


def write_uv_sphere(path, n_lat=8, n_lon=12):
    """A latitude-longitude unit sphere as an OBJ with texture coordinates
    (tests/assets/icosphere.obj has none): 2 * n_lat * n_lon triangles, the
    poles degenerate."""
    lines = []
    for i in range(n_lat + 1):
        for j in range(n_lon + 1):
            th, ph = np.pi * i / n_lat, 2 * np.pi * j / n_lon
            lines.append(f"v {np.sin(th) * np.cos(ph):.6f} "
                         f"{np.sin(th) * np.sin(ph):.6f} {np.cos(th):.6f}")
    for i in range(n_lat + 1):
        for j in range(n_lon + 1):
            lines.append(f"vt {j / n_lon:.6f} {1.0 - i / n_lat:.6f}")
    for i in range(n_lat):
        for j in range(n_lon):
            a = i * (n_lon + 1) + j + 1
            b, c, d = a + 1, a + n_lon + 1, a + n_lon + 2
            lines.append(f"f {a}/{a} {c}/{c} {b}/{b}")
            lines.append(f"f {b}/{b} {c}/{c} {d}/{d}")
    path.write_text("\n".join(lines) + "\n")


def uv_mesh_scene(tmp_path):
    """mesh_scene.xml with its icosphere replaced by the UV sphere, whose
    material carries the file texture tests/assets/colorBuffer.png; the
    ground keeps a plain colour. Returns the XML's path."""
    write_uv_sphere(tmp_path / "uvsphere.obj")
    shutil.copy("tests/assets/colorBuffer.png", tmp_path / "image.png")
    xml = open("tests/assets/mesh_scene.xml").read()
    xml = xml.replace("icosphere.obj", "uvsphere.obj").replace(
        '<diffuse  r="0.1" g="0.1" b="0.9"/>',
        '<diffuse r="1" g="1" b="1" texture="image.png"/>')
    assert "uvsphere.obj" in xml and "image.png" in xml
    (tmp_path / "uvmesh_scene.xml").write_text(xml)
    return str(tmp_path / "uvmesh_scene.xml")


def file_texture_scene(tmp_path):
    """spot_scene.xml with tests/assets/colorBuffer.png on its first
    material's diffuse slot (scaled), on the background and, rotated, on the
    environment, and a texture file that does not exist on the specular
    slot (the black fold). Returns the XML's path."""
    import re

    shutil.copy("tests/assets/colorBuffer.png", tmp_path / "image.png")
    xml = open("tests/assets/spot_scene.xml").read()
    xml, n = re.subn(r"<diffuse[^>]*/>",
                     '<diffuse r="1" g="1" b="1" texture="image.png">'
                     '<scale value="0.5"/></diffuse>', xml, count=1)
    xml, k = re.subn(r"<specular[^>]*/>",
                     '<specular value="0.5" texture="absent.png"/>', xml,
                     count=1)
    assert n == 1 and k == 1
    xml = xml.replace("</scene>", """
    <background r="1" g="0.9" b="0.8" texture="image.png"/>
    <environment r="0.8" g="0.9" b="1" texture="image.png">
      <scale value="0.5"/><rotate angle="25" z="1"/>
    </environment>
  </scene>""")
    (tmp_path / "filetex_scene.xml").write_text(xml)
    return str(tmp_path / "filetex_scene.xml")


def compare(rad_ref, t0_ref, rad, t0, outlier_frac=2e-3):
    """tests/test_megakernel.py::_compare's bars."""
    assert np.allclose(t0_ref, t0, rtol=1e-4, atol=1e-3), (
        np.abs(t0_ref - t0).max())
    rel = (np.abs(rad_ref - rad).max(axis=-1)
           / (1.0 + np.abs(rad_ref).max(axis=-1)))
    assert (rel > 1e-3).mean() < outlier_frac
    assert np.median(rel) < 1e-6
    assert np.abs(rad_ref.mean(axis=0) - rad.mean(axis=0)).max() < 2e-3


@pytest.mark.parametrize("integrator", ["pathtrace", "photonmap"])
@pytest.mark.parametrize("name", ["spot", "softdof"])
def test_engine_matches_jax(name, integrator):
    arrays, meta, tarr, tmeta = scenes(name)
    kw = dict(integrator=integrator, max_bounce=3, shadow_spp=4,
              shadow_spp_max=8)
    px, py, sid = lanes()
    key = jax.random.key(3, impl="threefry2x32")
    rad_x, t0_x = render_batch_xla(arrays, meta, JaxConfig(**kw),
                                   jnp.asarray(px), jnp.asarray(py),
                                   jnp.asarray(sid), key)
    words = tuple(int(w) for w in np.asarray(jax.random.key_data(key)))
    # render_batch routes this scene to the megakernel, whose CPU version
    # is the wavefront engine.
    assert engine.use_pathtrace_mega(tmeta, engine.IntegratorConfig(**kw))
    rad, t0 = engine.render_batch(tarr, tmeta, engine.IntegratorConfig(**kw),
                                  torch.tensor(px), torch.tensor(py),
                                  torch.tensor(sid), words)
    compare(np.asarray(rad_x), np.asarray(t0_x), rad.numpy(), t0.numpy())


def _both_engines(scene, res, spp, kw):
    """The same lanes under a threefry key through render_batch_xla and the
    port's wavefront engine, from one compile: (rad_x, t0_x, rad, t0,
    meta)."""
    scene.camera.img_width, scene.camera.img_height = res
    arrays, meta = compile_scene(scene)
    tarr, tmeta = from_numpy_arrays(jax.tree.map(np.asarray, arrays), meta,
                                    "cpu")
    px, py, sid = lanes(res, spp)
    key = jax.random.key(3, impl="threefry2x32")
    rad_x, t0_x = render_batch_xla(arrays, meta, JaxConfig(**kw),
                                   jnp.asarray(px), jnp.asarray(py),
                                   jnp.asarray(sid), key)
    words = tuple(int(w) for w in np.asarray(jax.random.key_data(key)))
    rad, t0 = engine.render_batch_wavefront(
        tarr, tmeta, engine.IntegratorConfig(**kw), torch.tensor(px),
        torch.tensor(py), torch.tensor(sid), words)
    return (np.asarray(rad_x), np.asarray(t0_x), rad.numpy(), t0.numpy(),
            tmeta)


@pytest.mark.parametrize("integrator", ["pathtrace", "photonmap"])
def test_engine_checker_textures_match_jax(integrator):
    """texture_scene.xml at 80x60 x 2: checkers on the floor and the ball,
    footprint-filtered at the primary hit, point-sampled after it."""
    kw = dict(integrator=integrator, max_bounce=3, shadow_spp=4,
              shadow_spp_max=8)
    rad_x, t0_x, rad, t0, meta = _both_engines(
        load_scene("tests/assets/texture_scene.xml"), (80, 60), 2, kw)
    assert meta.has_mtl_textures and meta.mega_tex_ok
    compare(rad_x, t0_x, rad, t0, outlier_frac=5e-3)


def test_engine_file_textures_match_jax(tmp_path):
    """A file texture on a material, the background and the environment,
    and a missing texture folded to black: the wavefront route."""
    kw = dict(integrator="photonmap", max_bounce=3, shadow_spp=4,
              shadow_spp_max=8)
    rad_x, t0_x, rad, t0, meta = _both_engines(
        load_scene(file_texture_scene(tmp_path)), (40, 30), 2, kw)
    assert meta.has_mtl_textures and not meta.mega_tex_ok
    assert meta.has_bg_texture and meta.has_env_texture
    assert not engine.use_pathtrace_mega(meta, engine.IntegratorConfig(**kw))
    compare(rad_x, t0_x, rad, t0)
    assert (t0 > 1e29).any() and rad[t0 > 1e29].std() > 0.02  # the image


def test_engine_textured_mesh_matches_jax(tmp_path):
    """A UV sphere (192 triangles) with a file texture: corner uvs
    interpolated at the hit, triangle footprints from the differential
    rays (_mesh_diff_uv)."""
    kw = dict(integrator="pathtrace", max_bounce=3, shadow_spp=4,
              shadow_spp_max=8)
    rad_x, t0_x, rad, t0, meta = _both_engines(
        load_scene(uv_mesh_scene(tmp_path)), (40, 30), 2, kw)
    assert meta.num_tris == 192 and meta.has_mtl_textures
    assert not engine.use_pathtrace_mega(meta, engine.IntegratorConfig(**kw))
    compare(rad_x, t0_x, rad, t0)


@pytest.mark.parametrize("integrator,name,mc", [
    ("basic", "spot", 10), ("whitted", "mesh", 10), ("phong", "phong", 10),
    ("mcgi", "spot", 1), ("mcgi", "mirror", 4),
], ids=["basic", "whitted", "phong", "mcgi-1", "mcgi-4"])
def test_engine_whitted_family_matches_jax(integrator, name, mc, tmp_path):
    """The four integrators of the Whitted family at 40x30 x 2; phong on
    spot_scene with its first material's glossiness and specular raised so
    that the Phong lobe shows; mcgi with and without the first-vertex
    expansion. Falloff off for basic and phong, as the Renderer sets it."""
    path = f"tests/assets/{name}_scene.xml"
    if name == "phong":
        import re

        xml = open("tests/assets/spot_scene.xml").read()
        xml, n = re.subn(r"<glossiness[^>]*/>", '<glossiness value="6"/>',
                         xml, count=1)
        assert n == 1
        path = str(tmp_path / "phong_scene.xml")
        open(path, "w").write(xml)
    kw = dict(integrator=integrator, max_bounce=3, shadow_spp=4,
              shadow_spp_max=8, mc_samples=mc,
              inverse_square_falloff=integrator == "mcgi")
    rad_x, t0_x, rad, t0, _ = _both_engines(load_scene(path), (40, 30), 2, kw)
    compare(rad_x, t0_x, rad, t0)
    assert rad.std() > 0.01


def test_engine_matches_jax_past_int32_fold():
    """The right 32 columns of an 800x600 image, every 25th row: lanes
    whose fold datum rid * 65536 + sid lies past 2^31 and 2^32 and wraps
    on both sides."""
    arrays, meta, tarr, tmeta = scenes("softdof", res=(800, 600))
    kw = dict(integrator="photonmap", max_bounce=3, shadow_spp=4,
              shadow_spp_max=8)
    px, py, sid = lanes()
    px, py, sid = px + 768, py * 25 + 17, sid + 5
    key = jax.random.key(3, impl="threefry2x32")
    rad_x, t0_x = render_batch_xla(arrays, meta, JaxConfig(**kw),
                                   jnp.asarray(px), jnp.asarray(py),
                                   jnp.asarray(sid), key)
    words = tuple(int(w) for w in np.asarray(jax.random.key_data(key)))
    rad, t0 = engine.render_batch_wavefront(
        tarr, tmeta, engine.IntegratorConfig(**kw), torch.tensor(px),
        torch.tensor(py), torch.tensor(sid), words)
    compare(np.asarray(rad_x), np.asarray(t0_x), rad.numpy(), t0.numpy())


def test_fold_datum_wraps_like_int32():
    """rid * 65536 + sid at 800x600 passes 2^31 and wraps as int32 does."""
    px = torch.tensor([0, 799, 5], dtype=torch.int32)
    py = torch.tensor([0, 599, 40000 // 800], dtype=torch.int32)
    sid = torch.tensor([0, 7, 3], dtype=torch.int32)
    got = engine.lane_fold_data(px, py, sid, 800)
    rid = np.asarray(py, np.int32) * np.int32(800) + np.asarray(px, np.int32)
    with np.errstate(over="ignore"):
        want = (rid * np.int32(65536) + np.asarray(sid, np.int32))
    assert np.array_equal(got.numpy(), want.view(np.uint32).astype(np.int64))


def test_accumulator_matches_jax():
    """Device Welford planes == qaray_tpu.fb.device_accum on the same
    samples, for scattered and contiguous updates."""
    from qaray_tpu.fb import device_accum as jacc
    from qaray_tpu.fb.framebuffer import FrameBuffer as JaxFB
    from qaray_tpu_torch.fb.framebuffer import FrameBuffer

    rs = np.random.RandomState(0)
    w, h = 8, 4
    jstate = jacc.init_state(JaxFB(w, h))
    tstate = device_accum.init_state(FrameBuffer(w, h), "cpu")
    for s in range(5):
        ids = rs.permutation(w * h)[: w * h - s].astype(np.int32)
        colors = rs.uniform(size=(ids.size, 3)).astype(np.float32)
        jstate, _ = jacc.accumulate_round(jstate, jnp.asarray(ids),
                                          jnp.asarray(colors))
        device_accum.accumulate_round(tstate, torch.tensor(ids),
                                      torch.tensor(colors))
    colors = rs.uniform(size=(10, 3)).astype(np.float32)
    jstate, _ = jacc.accumulate_contig(jstate, 3, jnp.asarray(colors))
    device_accum.accumulate_contig(tstate, 3, torch.tensor(colors))
    for k in ("mean", "std", "count"):
        np.testing.assert_allclose(tstate[k].numpy(),
                                   np.asarray(jstate[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    for spp in (4, 5):
        th = (0.005, 0.001, 0.005)
        assert np.array_equal(device_accum.unconverged_ids(tstate, th, spp),
                              jacc.unconverged_ids(jstate, th, spp))


# -- mesh scenes on the routes the TPU takes (tests/test_torch_mesh.py has
# the dense-sweep route on mesh_scene and mirror_scene) ---------------------
