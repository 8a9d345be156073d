"""The port's photon maps against qaray_tpu's: clustering, photon
tracing, map builds and the map files. The gathers (the exact ones, K5's
plain version and source, the record gather) are in
tests/test_torch_photon_gather.py, which shares this file's helpers.

Inputs are made with numpy from fixed seeds; scenes are built for both
packages from the same XML with scene.procedural.with_glass. Tolerances:
the gathers sum the same float32 terms in another order (XLA's products
against torch's), so sums agree within 1e-5 relative; counts are exact.
Photon paths store where they store in the other package; there,
positions agree within 1e-4 of the point's distance from the origin (at
least 1) on one batch. Over whole maps they agree so on at least 0.999 of
the rows when both packages build in float64; in float32 on 0.95 of them,
and within 2e-3 on all: the two packages' cos, sin and pow differ in their
last bits, and refraction through the glass sphere and grazing hits on the
60-unit floor magnify that.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qaray_tpu.photon import build as jbuild
from qaray_tpu.photon import gather as jgather
from qaray_tpu.photon.cluster import cluster_photon_map as jcluster
from qaray_tpu.renderer import RendererParam as JaxParam
from qaray_tpu.scene.compiler import compile_scene
from qaray_tpu.scene.xml_parser import load_scene
from qaray_tpu_torch.core.rng import key_words
from qaray_tpu_torch.ops import analytic as tanalytic
from qaray_tpu_torch.photon import build as tbuild
from qaray_tpu_torch.photon.cluster import cluster_photon_map
from qaray_tpu_torch.renderer import RendererParam
from qaray_tpu_torch.scene.convert import (
    from_numpy_arrays,
    photon_map_from_numpy,
)
from qaray_tpu_torch.scene.procedural import with_glass

SOFTDOF = "tests/assets/softdof_scene.xml"


def random_map(n=700, radius=0.5, n_valid=650, dense=0.5, seed=0):
    """A JAX PhotonMapData: half the photons uniform in [-1, 1]^3, the rest
    (the `dense` share) in a 0.2-wide cube at the origin, where more than
    100 lie within the radius; rows from n_valid on are padding."""
    rs = np.random.RandomState(seed)
    n_dense = int(n * dense)
    pos = np.concatenate([rs.uniform(-1, 1, (n - n_dense, 3)),
                          rs.uniform(-0.1, 0.1, (n_dense, 3))]
                         ).astype(np.float32)
    power = rs.uniform(0, 0.1, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jgather.PhotonMapData(
        pos=jnp.asarray(pos), power=jnp.asarray(power),
        max_power=jnp.asarray(power.max(axis=1)), direction=jnp.asarray(d),
        radius=jnp.asarray(np.float32(radius)),
        valid=jnp.asarray(np.arange(n) < n_valid))


def queries(n=256, seed=1):
    """Query points in [-1, 1]^3, a quarter of them in the dense cube."""
    q = np.random.RandomState(seed).uniform(-1, 1, (n, 3)).astype(np.float32)
    q[: n // 4] *= 0.1
    return q


def both_maps(jmap):
    """(clustered JAX map, the same map in the port on the CPU)."""
    jmap = jcluster(jmap)
    return jmap, photon_map_from_numpy(jax.tree.map(np.asarray, jmap), "cpu")


def close(want, got, rtol=1e-5):
    want, got = np.asarray(want), np.asarray(got)
    scale = max(float(np.abs(want).max()), 1e-30) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def caustics_scenes(res=(48, 36)):
    """caustics_scene (softdof with its middle sphere made glass) compiled
    by qaray_tpu and carried into the port: (arrays, meta, tarr, tmeta)."""
    desc = with_glass(load_scene(SOFTDOF), "mid")
    desc.camera.img_width, desc.camera.img_height = res
    arrays, meta = compile_scene(desc)
    tarr, tmeta = from_numpy_arrays(jax.tree.map(np.asarray, arrays), meta,
                                    "cpu")
    return arrays, meta, tarr, tmeta


@pytest.mark.parametrize("which", ["random", "empty"])
def test_pack_photon_clusters_matches_jax(which):
    jmap = random_map()
    if which == "empty":
        jmap = jmap._replace(valid=jnp.zeros(700, bool))
    jmap, tmap = both_maps(jmap)
    tmap = cluster_photon_map(tmap._replace(ctable=None, cbounds=None))
    assert np.array_equal(tmap.ctable.numpy(), np.asarray(jmap.ctable))
    assert np.array_equal(tmap.cbounds.numpy(), np.asarray(jmap.cbounds))
    if which == "empty":
        assert tmap.ctable.shape == (128, 16)
        assert (tmap.cbounds[0, :3] > tmap.cbounds[0, 3:6]).all()


def test_trace_photon_paths_matches_jax():
    """One batch of caustics photon paths under the threefry key
    PRNGKey(123): store masks equal on at least 0.999 of entries; where
    both store, positions within 1e-4 of max(1, |p|), directions within
    1e-4, powers within 1e-4 relative."""
    arrays, meta, tarr, tmeta = caustics_scenes()
    want = [np.asarray(x) for x in jbuild.trace_photon_paths(
        arrays, meta, jax.random.PRNGKey(123), 4096, 6, True)]
    got = [x.numpy() for x in tbuild.trace_photon_paths(
        tarr, tmeta, key_words("threefry2x32", 123), 4096, 6, True)]
    assert (want[0] == got[0]).mean() >= 0.999
    both = want[0] & got[0]
    assert both.sum() > 0
    pos_err = (np.abs(want[1] - got[1]).max(-1)
               / np.maximum(1.0, np.abs(want[1]).max(-1)))
    assert pos_err[both].max() < 1e-4
    assert np.abs(want[2] - got[2]).max(-1)[both].max() < 1e-4
    pow_err = (np.abs(want[3] - got[3]).max(-1)
               / np.abs(want[3]).max(-1).clip(1e-30))
    assert pow_err[both].max() < 1e-4


def float64_copy(x):
    """x with every float tensor in it (through dataclasses and named
    tuples) made float64."""
    if isinstance(x, torch.Tensor):
        return x.double() if x.is_floating_point() else x
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: float64_copy(getattr(x, f.name))
            for f in dataclasses.fields(x)})
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*map(float64_copy, x))
    return x


@pytest.mark.parametrize("caustics", [False, True],
                         ids=["global", "caustics"])
def test_build_one_map_matches_jax(caustics, monkeypatch):
    """_build_one_map at the sizes of tests/test_megakernel.py's
    _small_photon_maps (400 global photons at r 0.2, 120 caustics photons
    at r 1.0, 6 bounces) on caustics_scene.

    In float64 (the JAX package under jax.enable_x64, the port on float64
    copies of its tables) both store the same photons, with positions
    within 1e-4 of max(1, |p|) and powers within 1e-4 relative on at least
    0.999 of the rows. In float32 they store the same photons, with powers
    within 1e-4 relative on 0.999 of the rows and positions within 1e-4 on
    0.95 of them and within 2e-3 on all: paths through the glass sphere
    and grazing hits on the 60-unit floor magnify each package's float32
    rounding (on the caustics map's worst row the JAX package's own
    float32 build lies 8.4e-4 from its float64 build)."""
    arrays, meta, tarr, tmeta = caustics_scenes()
    size, radius, seed = (120, 1.0, 2) if caustics else (400, 0.2, 1)

    def builds(arrays, tarr, dtype):
        want = jbuild._build_one_map(arrays, meta, JaxParam(), size, 6,
                                     radius, caustics=caustics, seed=seed)
        got = tbuild._build_one_map(tarr, tmeta, RendererParam(), size, 6,
                                    radius, caustics=caustics, seed=seed)
        assert np.asarray(want.pos).dtype == got.pos.numpy().dtype == dtype
        valid = np.asarray(want.valid)
        assert valid.sum() == size
        assert np.array_equal(valid, got.valid.numpy())
        wp, wpow = np.asarray(want.pos)[valid], np.asarray(want.power)[valid]
        pos_err = np.abs(wp - got.pos.numpy()[valid]).max(-1) / np.maximum(
            1.0, np.abs(wp).max(-1))
        pow_err = (np.abs(wpow - got.power.numpy()[valid]).max(-1)
                   / wpow.max(-1).clip(1e-30))
        return pos_err, pow_err

    pos_err, pow_err = builds(arrays, tarr, np.float32)
    assert (pos_err < 1e-4).mean() >= 0.95
    assert pos_err.max() < 2e-3
    assert (pow_err < 1e-4).mean() >= 0.999
    # The float64 builds: the plain versions of the ray kernels take float64
    # rays on the CPU; the kernel wrappers' float32 check is lifted here.
    monkeypatch.setattr(tanalytic, "_check_rays", lambda *_: None)
    with jax.enable_x64(True):
        arrays64 = jax.tree.map(
            lambda a: (np.asarray(a, np.float64)
                       if np.asarray(a).dtype == np.float32 else a), arrays)
        pos_err, pow_err = builds(arrays64, float64_copy(tarr),
                                  np.float64)
    assert (pos_err < 1e-4).mean() >= 0.999
    assert (pow_err < 1e-4).mean() >= 0.999


def test_caustics_map_degrades_on_softdof(capsys):
    """On softdof_scene.xml every material has diffuse luma > 0, so no
    caustics photon can be stored: both packages leave the map empty (with
    the same warning); a global map that cannot fill raises."""
    desc = load_scene(SOFTDOF)
    desc.camera.img_width, desc.camera.img_height = 40, 30
    arrays, meta = compile_scene(desc)
    tarr, tmeta = from_numpy_arrays(jax.tree.map(np.asarray, arrays), meta,
                                    "cpu")
    want = jbuild._build_one_map(arrays, meta, JaxParam(), 100, 6, 1.0,
                                 caustics=True, seed=7, batch=512)
    got = tbuild._build_one_map(tarr, tmeta, RendererParam(), 100, 6, 1.0,
                                caustics=True, seed=7, batch=512)
    assert int(np.asarray(want.valid).sum()) == 0
    assert int(got.valid.sum()) == 0
    assert capsys.readouterr().out.count("caustics map cannot fill") == 2
    empty = cluster_photon_map(got)
    assert empty.ctable.shape == (128, 16)


def test_save_photon_map_writes_the_same_bytes(tmp_path):
    jmap = random_map(n=300, n_valid=283)
    tmap = photon_map_from_numpy(jax.tree.map(np.asarray, jmap), "cpu")
    jbuild.save_photon_map(jmap, str(tmp_path / "j.dat"))
    tbuild.save_photon_map(tmap, str(tmp_path / "t.dat"))
    want = (tmp_path / "j.dat").read_bytes()
    assert len(want) == 283 * 26
    assert (tmp_path / "t.dat").read_bytes() == want
