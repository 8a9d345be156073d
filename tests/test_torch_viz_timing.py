"""The port's photon viewer (viz/photon_viz.py), frame timer and profiler
hook (utils/timing.py) against qaray_tpu's, and the CLI's -profile and
timing line.

The dump is what photon/build.save_photon_map writes: 26-byte records,
the JAX package's bytes (tests/test_torch_photon.py). The JAX viewer
strides 28 bytes over them (ROADMAP C3); the port's reads every record.
"""

import json
import time

import jax
import numpy as np
import pytest

from qaray_tpu.utils import timing as jax_timing
from qaray_tpu.viz import photon_viz as jax_viz
from qaray_tpu_torch import cli
from qaray_tpu_torch.photon import build as tbuild
from qaray_tpu_torch.scene.convert import photon_map_from_numpy
from qaray_tpu_torch.utils import timing
from qaray_tpu_torch.viz import photon_viz
from test_torch_photon import random_map

ARGS = ["tests/assets/spot_scene.xml", "-device", "cpu", "-res", "24x18",
        "-spp", "1", "-bounce", "2", "-shadow-spp", "2",
        "-shadow-spp-max", "4"]


def test_read_photon_dump_reads_every_record(tmp_path):
    tmap = photon_map_from_numpy(
        jax.tree.map(np.asarray, random_map(n=300, n_valid=283)), "cpu")
    path = str(tmp_path / "photonmap.dat")
    tbuild.save_photon_map(tmap, path)
    pos, power, color = photon_viz.read_photon_dump(path)
    valid = tmap.valid.numpy()
    assert pos.shape == (283, 3) and power.shape == (283,)
    assert np.array_equal(pos, tmap.pos.numpy()[valid])
    want_power = tmap.power.numpy()[valid].max(axis=1)
    assert np.array_equal(power, want_power)
    rgb = np.clip(tmap.power.numpy()[valid] / want_power[:, None] * 255.0,
                  0, 255).astype(np.uint8)
    assert np.array_equal(color, rgb.astype(np.float32) / 255.0)
    # The JAX viewer's 28-byte stride finds fewer records than were written.
    assert jax_viz.read_photon_dump(path)[0].shape[0] == 283 * 26 // 28


@pytest.mark.parametrize("power", [False, True])
def test_render_scatter_png_equals_jax(tmp_path, power):
    rs = np.random.RandomState(5)
    pos = rs.uniform(-3.0, 3.0, (2000, 3)).astype(np.float32)
    color = rs.uniform(0.0, 1.0, (2000, 3)).astype(np.float32)
    if power:
        color = np.clip(rs.uniform(0.0, 2.0, 2000)[:, None]
                        * np.ones((1, 3)), 0, 1)
    jax_viz.render_scatter(pos, color, str(tmp_path / "j.png"), size=96)
    photon_viz.render_scatter(pos, color, str(tmp_path / "t.png"), size=96)
    want = (tmp_path / "j.png").read_bytes()
    assert want[:4] == b"\x89PNG"
    assert (tmp_path / "t.png").read_bytes() == want


def test_photon_viz_main(tmp_path, capsys):
    tmap = photon_map_from_numpy(
        jax.tree.map(np.asarray, random_map(n=100, n_valid=90)), "cpu")
    tbuild.save_photon_map(tmap, str(tmp_path / "p.dat"))
    assert photon_viz.main([str(tmp_path / "p.dat"),
                            str(tmp_path / "p.png"), "--power"]) == 0
    assert capsys.readouterr().out.startswith("90 photons, bbox ")
    assert (tmp_path / "p.png").read_bytes()[:4] == b"\x89PNG"
    assert photon_viz.main([]) == 1


def test_frame_timer_prints_the_jax_lines(monkeypatch, capsys):
    """The same clock readings give the JAX FrameTimer's lines exactly."""
    out = {}
    for name, mod in (("jax", jax_timing), ("port", timing)):
        clock = iter([10.0, 10.5, 20.0, 21.25, 30.0, 30.75])
        monkeypatch.setattr(time, "time", lambda: next(clock))
        t = mod.FrameTimer()
        for _ in range(3):
            t.start()
            t.stop()
        t.kill()
        out[name] = capsys.readouterr().out
    assert out["port"] == out["jax"]
    assert "\nElapsed Time is 0.500000 s\n" in out["port"]
    assert "Program Ends, Average Frame Time 1.000000 s" in out["port"]


def test_cli_profile_writes_a_trace(tmp_path, capsys):
    assert cli.main(ARGS + ["-profile", str(tmp_path / "prof"), "-out",
                            str(tmp_path / "x_")]) == 0
    assert "Elapsed Time is" in capsys.readouterr().out
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert len(names) > 10
    assert (tmp_path / "x_colorBuffer.png").exists()
    with timing.profile(None):
        pass
    assert sorted(p.name for p in (tmp_path / "prof").iterdir()) == [
        "trace.json"]
