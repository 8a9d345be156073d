"""The port's CLI and Renderer against qaray_tpu's, end to end.

Both CLIs render tests/assets/spot_scene.xml at 32x24 with 2 samples per
pixel under the default 'rbg' key, whose words xor-fold to (0, 0) on the
reference's megakernel path; qaray_tpu runs that path here in interpret
mode (QARAY_MEGAKERNEL=1), so both sides draw the same random numbers. The
colour buffers agree within 2e-3 mean absolute error per channel.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

ARGS = ["tests/assets/spot_scene.xml", "-res", "32x24", "-spp", "2",
        "-bounce", "3", "-shadow-spp", "4", "-shadow-spp-max", "8"]


def _png(path):
    return np.asarray(Image.open(path), np.float64) / 255.0


def test_cli_matches_jax_cli(tmp_path, monkeypatch):
    from qaray_tpu import cli as jax_cli
    from qaray_tpu_torch import cli

    assert cli.main(ARGS + ["-device", "cpu", "-out",
                            str(tmp_path / "t_")]) == 0
    monkeypatch.setenv("QARAY_MEGAKERNEL", "1")
    monkeypatch.setenv("QARAY_COMPILE_CACHE", "0")
    assert jax_cli.main(ARGS + ["-platform", "cpu", "-out",
                                str(tmp_path / "j_")]) == 0
    got = _png(tmp_path / "t_colorBuffer.png")
    want = _png(tmp_path / "j_colorBuffer.png")
    assert got.shape == want.shape == (24, 32, 3)
    err = np.abs(got - want).reshape(-1, 3).mean(axis=0)
    assert (err < 2e-3).all(), err
    for name in ("depthBuffer.png", "sampleBuffer.png"):
        assert np.array_equal(_png(tmp_path / f"t_{name}"),
                              _png(tmp_path / f"j_{name}")), name


def test_cli_mesh_scene_matches_jax_cli(tmp_path, monkeypatch):
    """mesh_scene.xml (a 320-triangle icosphere over an analytic ground) on
    the Renderer's default route, the megakernel with its mesh sweep, on
    both sides: channel means of the colour buffers within 2e-3."""
    from qaray_tpu import cli as jax_cli
    from qaray_tpu_torch import cli

    args = ["tests/assets/mesh_scene.xml"] + ARGS[1:]
    assert cli.main(args + ["-device", "cpu", "-out",
                            str(tmp_path / "t_")]) == 0
    monkeypatch.setenv("QARAY_MEGAKERNEL", "1")
    monkeypatch.setenv("QARAY_COMPILE_CACHE", "0")
    assert jax_cli.main(args + ["-platform", "cpu", "-out",
                                str(tmp_path / "j_")]) == 0
    got = _png(tmp_path / "t_colorBuffer.png")
    want = _png(tmp_path / "j_colorBuffer.png")
    assert got.shape == want.shape == (24, 32, 3)
    err = np.abs(got.reshape(-1, 3).mean(0) - want.reshape(-1, 3).mean(0))
    assert (err < 2e-3).all(), err
    assert got.std() > 0.01  # the icosphere and the ground are in view


def test_cli_texture_scene_matches_jax_cli(tmp_path, monkeypatch):
    """texture_scene.xml through both CLIs at 80x60 x 2 on the megakernel
    route (checker textures in the kernel on the JAX side, its plain
    version here): colour buffers within 2e-3 mean absolute error per
    channel, the bar of test_cli_matches_jax_cli, and equal depth and
    sample-count buffers."""
    from qaray_tpu import cli as jax_cli
    from qaray_tpu_torch import cli

    args = ["tests/assets/texture_scene.xml", "-res", "80x60"] + ARGS[3:]
    assert cli.main(args + ["-device", "cpu", "-out",
                            str(tmp_path / "t_")]) == 0
    monkeypatch.setenv("QARAY_MEGAKERNEL", "1")
    monkeypatch.setenv("QARAY_COMPILE_CACHE", "0")
    assert jax_cli.main(args + ["-platform", "cpu", "-out",
                                str(tmp_path / "j_")]) == 0
    got = _png(tmp_path / "t_colorBuffer.png")
    want = _png(tmp_path / "j_colorBuffer.png")
    assert got.shape == want.shape == (60, 80, 3)
    err = np.abs(got - want).reshape(-1, 3).mean(axis=0)
    assert (err < 2e-3).all(), err
    assert got.std() > 0.05  # the checkers are in view
    for name in ("depthBuffer.png", "sampleBuffer.png"):
        assert np.array_equal(_png(tmp_path / f"t_{name}"),
                              _png(tmp_path / f"j_{name}")), name


@pytest.mark.parametrize("integrator", ["basic", "whitted", "phong", "mcgi"])
def test_cli_integrators_render(tmp_path, integrator):
    """-integrator takes the Whitted family's names and writes an image
    that is not black."""
    from qaray_tpu_torch import cli

    assert cli.main(ARGS + ["-integrator", integrator, "-device", "cpu",
                            "-out", str(tmp_path / "i_")]) == 0
    img = _png(tmp_path / "i_colorBuffer.png")
    assert img.shape == (24, 32, 3) and img.mean() > 0.01


def test_cli_unknown_integrator_fails(tmp_path):
    from qaray_tpu_torch import cli
    from qaray_tpu_torch.integrators.engine import (
        IntegratorConfig,
        integrate,
    )

    with pytest.raises(ValueError):
        cli.main(ARGS + ["-integrator", "metropolis", "-device", "cpu",
                         "-out", str(tmp_path / "x_")])
    assert not (tmp_path / "x_colorBuffer.png").exists()
    with pytest.raises(ValueError):
        integrate(None, None, IntegratorConfig(integrator="metropolis"),
                  None, None, None)


def test_renderer_adaptive_matches_jax():
    """The adaptive loop (packed phase 1, compacted phase 2, batches smaller
    than the image) with threefry keys: per-pixel sample counts and means
    agree with qaray_tpu's Renderer on its wavefront engine."""
    from qaray_tpu.renderer import Renderer as JaxRenderer
    from qaray_tpu.renderer import RendererParam as JaxParam
    from qaray_tpu.scene.xml_parser import load_scene as jax_load
    from qaray_tpu_torch.renderer import Renderer, RendererParam
    from qaray_tpu_torch.scene.xml_parser import load_scene

    kw = dict(spp_min=2, spp_max=4, max_bounce=2, shadow_spp=4,
              shadow_spp_max=8, rng_impl="threefry2x32", seed=1,
              batch_pixels=128)
    fbs = []
    for renderer, load in ((Renderer(RendererParam(**kw), device="cpu"),
                            load_scene),
                           (JaxRenderer(JaxParam(**kw)), jax_load)):
        scene = load("tests/assets/softdof_scene.xml")
        scene.camera.img_width, scene.camera.img_height = 16, 12
        renderer.compute_scene(scene)
        fbs.append(renderer.render())
    got, want = fbs
    assert (got.count == 4).any() and (got.count == 2).any()
    assert (got.count == want.count).mean() > 0.99
    same = got.count == want.count
    np.testing.assert_allclose(got.mean[same], want.mean[same], atol=1e-3)


def test_renderer_param_mc_samples_and_exports():
    """ROADMAP C1: RendererParam carries mc_samples to the engine, an mcgi
    dispatch at 800x600 is cut to batch_pixels // mc_samples pixel lanes
    (qaray_tpu/renderer.py::_effective_batch), and the package exports what
    qaray_tpu exports."""
    from qaray_tpu_torch import (
        Renderer,
        RendererParam,
        compile_scene,
        load_scene,
    )

    assert callable(compile_scene)
    param = RendererParam(mc_samples=4)
    assert param.checkpoint_path == "render_checkpoint.npz"
    assert Renderer(param, device="cpu").integrator_config().mc_samples == 4
    r = Renderer(RendererParam(integrator="mcgi", spp_min=1, spp_max=1),
                 device="cpu")
    scene = load_scene("tests/assets/spot_scene.xml")
    scene.camera.img_width, scene.camera.img_height = 800, 600
    r.compute_scene(scene)
    lanes = []

    def dispatch(cfg, ids, sid, words):
        assert cfg.mc_samples == 10
        lanes.append(ids.shape[0])
        n = ids.shape[0]
        sid = torch.full((n,), sid) if isinstance(sid, int) else sid
        return torch.zeros((n, 3)), torch.zeros(n), None, None, ids, sid

    r._dispatch = dispatch
    r.render()
    assert sum(lanes) == 800 * 600
    assert max(lanes) <= (1 << 20) // 10, lanes


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import qaray_tpu_torch.cli, qaray_tpu_torch.renderer\n"
        "import qaray_tpu_torch.ops.megakernel, qaray_tpu_torch.ops._build\n"
        "import qaray_tpu_torch.scene.convert\n"
        "import qaray_tpu_torch.ops.tiles, qaray_tpu_torch.ops.mesh_sweep\n"
        "import qaray_tpu_torch.scene.procedural\n"
        "import qaray_tpu_torch.ops.texture, qaray_tpu_torch.ops.photon\n"
        "import qaray_tpu_torch.photon.build\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'qaray_tpu')]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr


def test_cuda_entry_point_without_card_raises(tmp_path):
    """The CLI renders on the GPU unless told otherwise: with no card it
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from qaray_tpu_torch import cli

    with pytest.raises((RuntimeError, AssertionError)):
        cli.main(ARGS + ["-out", str(tmp_path / "x_")])
    assert not (tmp_path / "x_colorBuffer.png").exists()


def test_later_slices_raise(monkeypatch):
    """Nothing of the JAX package's Renderer and CLI raises any more: the
    multi-device slice's flags (-devices, -multihost, -coordinator,
    -rank-debug), the preview server (-serve) and profiling (-profile)
    parse into their settings, and Renderer(num_devices=2) or rank_debug
    builds a mesh (on the CPU, of the one device). Photon maps,
    checkpoints and per-instance meshes (compute_scene(world_bvh=False),
    QARAY_NO_WORLD_BVH) work as well."""
    from qaray_tpu_torch import cli
    from qaray_tpu_torch.renderer import Renderer, RendererParam
    from qaray_tpu_torch.scene.xml_parser import load_scene

    param, _, _, opts = cli.parse_args(
        ["scene.xml", "-devices", "2", "-rank-debug", "-multihost",
         "-coordinator", "localhost:1234,2,1", "-serve", "0", "-profile",
         "prof"])
    assert param.num_devices == 2 and param.rank_debug
    assert opts["multihost"] and opts["coordinator"] == ("localhost:1234",
                                                         2, 1)
    assert opts["serve"] == 0 and opts["profile"] == "prof"
    for param in (RendererParam(num_devices=2),
                  RendererParam(num_devices=2, rank_debug=True)):
        r = Renderer(param, device="cpu")
        assert r._mesh is not None and r._mesh.size == 1
    Renderer(RendererParam(checkpoint_every=1), device="cpu")
    scene = "tests/assets/grid_scene.xml"
    _, meta = Renderer(device="cpu").compute_scene(load_scene(scene),
                                                   world_bvh=False)
    assert not meta.world_bvh and meta.num_mesh_instances == 25
    monkeypatch.setenv("QARAY_NO_WORLD_BVH", "1")
    _, meta = Renderer(device="cpu").compute_scene(load_scene(scene))
    assert not meta.world_bvh and meta.num_mesh_instances == 25
    param, _, _, _ = cli.parse_args(["scene.xml", "-use-photon-map",
                                     "-photon-map-size", "300"])
    assert param.use_photon_map and param.photon_map_size == 300
    Renderer(param, device="cpu")
