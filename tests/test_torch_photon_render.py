"""Photon-mapped rendering in the port against qaray_tpu, on caustics_scene
(tests/assets/softdof_scene.xml with its middle sphere made glass by
scene.procedural.with_glass).

- The wavefront engine with both packages' maps carried across
  (photon_map_from_numpy) against render_batch_xla(want_aux=True), under a
  threefry key: the bars of tests/test_torch_engine.py, irr0 equal on at
  least 0.999 of lanes.
- The kernel source of K1a + K1d run on the CPU (mega_render_host) against
  the port's engine: the bars of test_mega_photon_gather_parity on lanes
  that are not escalated, with the share of lanes off tightened to 1e-4
  and held against a control without the caustics map, and with both
  radii blown up to 50 those of
  test_mega_photon_escalation_flags_dense_lanes.
- The Renderer's escalation splice and the CLI with -use-photon-map.
Maps are small (400 and 120 photons, 6 bounces), as in
tests/test_megakernel.py's _small_photon_maps.
"""

import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from qaray_tpu.integrators.engine import IntegratorConfig as JaxConfig
from qaray_tpu.integrators.engine import render_batch_xla
from qaray_tpu.photon.build import _build_one_map as jax_build_one_map
from qaray_tpu.photon.cluster import cluster_photon_map as jax_cluster
from qaray_tpu.renderer import RendererParam as JaxParam
from qaray_tpu_torch.integrators import engine
from qaray_tpu_torch.integrators.engine import IntegratorConfig
from qaray_tpu_torch.ops import megakernel
from qaray_tpu_torch.photon.cluster import cluster_photon_map
from qaray_tpu_torch.scene.convert import photon_map_from_numpy
from test_torch_engine import compare, lanes
from test_torch_photon import SOFTDOF, caustics_scenes

RES = (48, 36)
# K1d's bar: the share of unescalated lanes off by more than 1e-3 relative
# (test_mega_photon_gather_parity allows 1 %, more than the caustics gather
# touches on this scene).
OFF_BAR = 1e-4
KW = dict(integrator="photonmap", max_bounce=4, shadow_spp=4,
          shadow_spp_max=8, use_photon_map=True)


@pytest.fixture(scope="module")
def scene_and_maps():
    """caustics_scene at 48x36 in both packages and the JAX package's small
    maps, clustered, in both."""
    arrays, meta, tarr, tmeta = caustics_scenes(RES)
    param = JaxParam()
    jmaps = (jax_cluster(jax_build_one_map(arrays, meta, param, 400, 6, 0.2,
                                           caustics=False, seed=1)),
             jax_cluster(jax_build_one_map(arrays, meta, param, 120, 6, 1.0,
                                           caustics=True, seed=2)))
    tmaps = tuple(photon_map_from_numpy(jax.tree.map(np.asarray, m), "cpu")
                  for m in jmaps)
    return arrays, meta, jmaps, tarr, tmeta, tmaps


def test_wavefront_photon_render_matches_jax(scene_and_maps):
    arrays, meta, jmaps, tarr, tmeta, tmaps = scene_and_maps
    px, py, sid = lanes(RES, 2)
    key = jax.random.key(3, impl="threefry2x32")
    rad_j, t0_j, irr_j = render_batch_xla(
        arrays, meta, JaxConfig(**KW), jnp.asarray(px), jnp.asarray(py),
        jnp.asarray(sid), key, jmaps, want_aux=True)
    words = tuple(int(w) for w in np.asarray(jax.random.key_data(key)))
    rad, t0, irr = engine.render_batch_wavefront(
        tarr, tmeta, IntegratorConfig(**KW), torch.tensor(px),
        torch.tensor(py), torch.tensor(sid), words, photon_maps=tmaps,
        want_aux=True)
    compare(np.asarray(rad_j), np.asarray(t0_j), rad.numpy(), t0.numpy())
    assert (np.asarray(irr_j) == irr.numpy()).mean() >= 0.999
    assert 0.1 < irr.float().mean() < 0.9
    # The gathers add light: the same lanes without them are darker.
    no_maps, _ = engine.render_batch_wavefront(
        tarr, tmeta, IntegratorConfig(**KW), torch.tensor(px),
        torch.tensor(py), torch.tensor(sid), words)
    assert rad.sum() > no_maps.sum()


@pytest.mark.parametrize("radius", [None, 50.0], ids=["parity", "escalation"])
def test_k1d_source_on_the_host_matches_engine(scene_and_maps, radius):
    """csrc/megakernel.cu with K1d compiled by g++ and run one lane at a
    time, its records gathered by K5's plain version, against the port's
    engine at 48x36 x 2 under threefry words: under OFF_BAR of the
    unescalated lanes off, where the same kernel with an empty caustics
    map is off on 0.35 %. With both radii at 50 every gather is over the
    cap (the open scene sends few paths to a second diffuse vertex, so the
    global map alone flags about 5 % of lanes)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ for the host build of the kernel source")
    _, _, _, tarr, tmeta, tmaps = scene_and_maps
    if radius is not None:
        tmaps = tuple(m._replace(radius=torch.tensor(radius)) for m in tmaps)
    cfg = IntegratorConfig(**KW)
    px, py, sid = (torch.tensor(a) for a in lanes(RES, 2))
    work = torch.zeros((px.shape[0], 8), dtype=torch.int32)
    before = dict(megakernel.launches)
    rad_k, t0_k, irr_k, esc = megakernel.mega_render_host(
        tarr, tmeta, cfg, px, py, sid, (0, 3), photon_maps=tmaps, work=work)
    assert megakernel.launches == before
    rad_p, t0_p, irr_p = engine.render_batch_wavefront(
        tarr, tmeta, cfg, px, py, sid, (0, 3), photon_maps=tmaps,
        want_aux=True)
    rad_k, rad_p, esc = rad_k.numpy(), rad_p.numpy(), esc.numpy()
    rel = np.abs(rad_p - rad_k).max(-1) / (1.0 + np.abs(rad_p).max(-1))
    photons, clusters = work[:, 5:7].sum(0).tolist()
    assert clusters > 0 and photons % 128 == 0
    if radius is not None:
        assert esc.mean() > 0.3
        assert (rel[~esc] > 1e-3).mean() == 0.0
        return
    assert esc.mean() < 0.01
    ok = ~esc
    assert (rel[ok] > 1e-3).mean() < OFF_BAR
    # The control: the kernel with its caustics map emptied is off on ten
    # times the bar's share, so the bar sees a skipped caustics gather.
    cmap = tmaps[1]
    no_caustics = cluster_photon_map(cmap._replace(
        valid=torch.zeros_like(cmap.valid), ctable=None, cbounds=None))
    rad_c = megakernel.mega_render_host(
        tarr, tmeta, cfg, px, py, sid, (0, 3),
        photon_maps=(tmaps[0], no_caustics))[0].numpy()
    rel_c = np.abs(rad_p - rad_c).max(-1) / (1.0 + np.abs(rad_p).max(-1))
    assert (rel_c[ok] > 1e-3).mean() > 10 * OFF_BAR
    assert np.abs(rad_p[ok].mean(0) - rad_k[ok].mean(0)).max() < 2e-3
    assert (irr_p == irr_k).float().mean() > 0.999
    np.testing.assert_allclose(t0_k.numpy(), t0_p.numpy(), rtol=1e-4,
                               atol=1e-3)


def test_renderer_escalation_splice(monkeypatch, tmp_path):
    """The Renderer with its megakernel entry pointed at the kernel source
    on the CPU and the global radius blown up to 50: lanes whose global
    gather is over the cap are flagged, skipped and rendered again on the
    exact engine (one call a dispatch, here the 2 samples of the packed
    phase 1 together). Every pixel ends with its exact sample count, and the
    image equals the all-wavefront render within the bars of
    test_renderer_adaptive_matches_jax."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ for the host build of the kernel source")
    from qaray_tpu_torch.renderer import Renderer, RendererParam
    from qaray_tpu_torch.scene.procedural import with_glass
    from qaray_tpu_torch.scene.xml_parser import load_scene

    monkeypatch.chdir(tmp_path)
    escalated = []

    def run(mega: bool):
        if mega:
            monkeypatch.delenv("QARAY_NO_MEGAKERNEL", raising=False)
            monkeypatch.setattr(megakernel, "mega_render",
                                megakernel.mega_render_host)
        else:
            monkeypatch.setenv("QARAY_NO_MEGAKERNEL", "1")
        desc = with_glass(load_scene(os.path.join(os.path.dirname(
            __file__), "assets", "softdof_scene.xml")), "mid")
        desc.camera.img_width, desc.camera.img_height = 40, 30
        r = Renderer(RendererParam(
            spp_min=2, spp_max=2, use_photon_map=True, photon_map_size=400,
            caustics_map_size=120, photon_map_bounce=6, caustics_map_bounce=6,
            rng_impl="threefry2x32", max_bounce=3, shadow_spp=2,
            shadow_spp_max=4), device="cpu")
        r.compute_scene(desc)
        g, c = r.photon_maps
        r.photon_maps = (g._replace(radius=torch.tensor(50.0)), c)
        render_escalated = r._render_escalated

        def counted(ids, sids, esc):
            fixed = render_escalated(ids, sids, esc)
            escalated.append(0 if fixed is None else fixed[0].size)
            return fixed

        r._render_escalated = counted
        return r.render(), r

    fb_m, r_m = run(True)
    assert r_m._mega_photon and sum(escalated) > 0
    fb_x, r_x = run(False)
    assert not r_x._mega_photon
    assert (fb_m.count == 2).all() and (fb_x.count == 2).all()
    np.testing.assert_allclose(fb_m.mean, fb_x.mean, atol=1e-3)
    assert (fb_m.irrad == fb_x.irrad).all()


def caustics_xml(path):
    """caustics_scene as XML: softdof_scene.xml with a glass material on its
    middle sphere (with_glass's material)."""
    xml = open(SOFTDOF).read()
    xml = xml.replace('name="mid" material="mat2"', 'name="mid" '
                      'material="mid_glass"')
    xml = xml.replace("""    <light type="point" name="area">""",
                      """    <material type="blinn" name="mid_glass">
      <diffuse value="0"/>
      <specular value="0"/>
      <refraction value="0.9" index="1.5"/>
      <absorption r="0.01" g="0.001" b="0.01"/>
    </material>
    <light type="point" name="area">""")
    path.write_text(xml)
    return str(path)


def test_cli_photon_map_matches_jax_cli(tmp_path, monkeypatch):
    """Both CLIs with -use-photon-map -photon-map-size 300
    -caustics-map-size 80 on caustics_scene at 32x24 x 2 spp, each in its
    own working directory: colour buffers within 2e-3 mean absolute error
    per channel (the bar of test_cli_matches_jax_cli), irradianceBuffer.png
    equal, photon files of the same length. Both CLIs' RendererParam
    defaults are set to 6-bounce maps and threefry keys: qaray_tpu then
    renders on its XLA engine, which draws what the port's megakernel route
    draws (on the CPU, the port's engine), and compiles the maps' bounce
    loop in seconds; its interpret-mode megakernel with gathers and its
    20-bounce loop take over three minutes on a CPU."""
    from qaray_tpu import cli as jax_cli
    from qaray_tpu_torch import cli

    for mod in (cli, jax_cli):
        monkeypatch.setattr(mod, "RendererParam", functools.partial(
            mod.RendererParam, photon_map_bounce=6, caustics_map_bounce=6,
            rng_impl="threefry2x32"))

    scene = caustics_xml(tmp_path / "caustics_scene.xml")
    args = [scene, "-res", "32x24", "-spp", "2", "-bounce", "3",
            "-shadow-spp", "4", "-shadow-spp-max", "8", "-use-photon-map",
            "-photon-map-size", "300", "-caustics-map-size", "80"]
    for sub in ("t", "j"):
        (tmp_path / sub).mkdir()
    monkeypatch.chdir(tmp_path / "t")
    assert cli.main(args + ["-device", "cpu", "-out", "t_"]) == 0
    monkeypatch.chdir(tmp_path / "j")
    monkeypatch.delenv("QARAY_MEGAKERNEL", raising=False)
    monkeypatch.setenv("QARAY_COMPILE_CACHE", "0")
    assert jax_cli.main(args + ["-platform", "cpu", "-out", "j_"]) == 0

    def png(name):
        return np.asarray(Image.open(tmp_path / name), np.float64) / 255.0

    got, want = png("t/t_colorBuffer.png"), png("j/j_colorBuffer.png")
    assert got.shape == want.shape == (24, 32, 3)
    err = np.abs(got - want).reshape(-1, 3).mean(axis=0)
    assert (err < 2e-3).all(), err
    irr = png("t/t_irradianceBuffer.png")
    assert np.array_equal(irr, png("j/j_irradianceBuffer.png"))
    assert 0 < irr.mean() < 1
    for name in ("photonmap.dat", "caustics.dat"):
        t_bytes = (tmp_path / "t" / name).read_bytes()
        j_bytes = (tmp_path / "j" / name).read_bytes()
        assert len(t_bytes) == len(j_bytes) > 0
