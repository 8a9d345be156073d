"""The port's photon maps against qaray_tpu's: clustering, the exact
gathers, the plain version of the gather kernel K5 (against the Pallas
kernel in interpret mode), the record gather, photon tracing, map builds
and the map files.

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
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qaray_tpu.ops import pallas_photon as jpp
from qaray_tpu.photon import build as jbuild
from qaray_tpu.photon import gather as jgather
from qaray_tpu.photon.cluster import cluster_photon_map as jcluster
from qaray_tpu.renderer import RendererParam as JaxParam
from qaray_tpu.scene.compiler import compile_scene
from qaray_tpu.scene.xml_parser import load_scene
from qaray_tpu_torch.core.rng import key_words
from qaray_tpu_torch.ops import analytic as tanalytic
from qaray_tpu_torch.ops import photon as tphoton
from qaray_tpu_torch.photon import build as tbuild
from qaray_tpu_torch.photon import gather as tgather
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


@pytest.mark.parametrize("form", ["capped", "stream", "uncapped"])
def test_estimate_irradiance_matches_jax(form):
    """The capped estimate where the 100-photon cap binds (the dense cube),
    the streamed one above 32,768 photons, and the uncapped sweep."""
    if form == "stream":
        jmap = random_map(n=33000, radius=0.1, n_valid=32900, dense=0.05)
        assert jmap.pos.shape[0] > tgather._STREAM_THRESHOLD
    else:
        jmap = random_map()
    _, tmap = both_maps(jmap)
    q = queries(64 if form == "stream" else 256)
    cap = None if form == "uncapped" else 100
    ji, jd = jgather.estimate_irradiance(jmap, jnp.asarray(q), chunk=128,
                                         max_photons=cap)
    ti, td = tgather.estimate_irradiance(tmap, torch.tensor(q), chunk=128,
                                         max_photons=cap)
    close(ji, ti)
    close(jd, td, rtol=1e-4)  # unit vectors of sums that nearly cancel
    if form != "uncapped":
        d2 = ((q[:, None] - np.asarray(jmap.pos)[None]) ** 2).sum(-1)
        inside = (d2 < float(jmap.radius) ** 2)[:, np.asarray(jmap.valid)]
        assert (inside.sum(-1) > 100).any()  # the cap binds somewhere


def test_gather_blinn_matches_jax():
    jmap, tmap = both_maps(random_map())
    rs = np.random.RandomState(5)
    q = queries()
    n = rs.normal(size=q.shape).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    v = rs.normal(size=q.shape).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    diff = rs.uniform(0, 1, q.shape).astype(np.float32)
    spec = rs.uniform(0, 1, q.shape).astype(np.float32)
    gloss = rs.uniform(1, 50, q.shape[0]).astype(np.float32)
    args = (q, n, v, diff, spec, gloss)
    want = jgather.gather_blinn(jmap, *map(jnp.asarray, args))
    got = tgather.gather_blinn(tmap, *map(torch.tensor, args))
    close(want, got)
    assert np.abs(np.asarray(want)).max() > 0


@pytest.mark.parametrize("which", ["map", "empty"])
def test_photon_gather_plain_matches_pallas_interpret(which):
    """photon_gather_plain (the plain version of K5; photon_gather takes it
    for CPU tensors) against pallas_gather(interpret=True): sums within
    1e-5 relative, counts exact; inactive lanes and the empty map give
    zeros."""
    jmap = random_map()
    if which == "empty":
        jmap = jmap._replace(valid=jnp.zeros(700, bool))
    jmap, tmap = both_maps(jmap)
    q = queries()
    act = (np.arange(q.shape[0]) % 3 != 0).astype(np.float32)
    want = jpp.pallas_gather(jmap.ctable, jmap.cbounds, jmap.radius,
                             jnp.asarray(q), jnp.asarray(act),
                             interpret=True)
    before = tphoton.launches["K5"]
    got = tphoton.photon_gather(tmap.ctable, tmap.cbounds, tmap.radius,
                                torch.tensor(q), torch.tensor(act))
    assert tphoton.launches["K5"] == before  # no kernel on the CPU
    for w, g in zip(want[:2], got[:2]):
        close(w, g)
    assert np.array_equal(np.asarray(want[2]), got[2].numpy())
    inactive = act == 0
    for g in got:
        assert (g[torch.tensor(inactive)] == 0).all()
    if which == "empty":
        assert all((g == 0).all() for g in got)
    else:
        assert got[2].max() > 100  # the dense cube is over the cap


@pytest.mark.parametrize("launch", ["flags", "count"])
def test_k5_source_on_the_host_matches_plain(launch):
    """csrc/photon.cu itself (K5: a warp a query), compiled by g++ against
    csrc/host/cuda_runtime.h, whose blocks of 32 threads are warps
    (photon_gather_host), against photon_gather_plain bit for bit: sums and
    counts, on 1,000 photons at r 0.2 (half in the dense cube, where over
    100 lie in a query's radius; elsewhere a few or none) and 2,000
    queries, a fifth inactive. With
    `flags` every query's active flag decides; with `count` the queries
    with a record come first and only their count is passed, as
    gather_apply launches it. The work counts clusters a query visited."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ for the host build of the kernel source")
    _, tmap = both_maps(random_map(n=1000, radius=0.2, n_valid=1000))
    q = torch.tensor(queries(2000, seed=4))
    act = torch.tensor((np.random.RandomState(5).uniform(size=2000) > 0.2)
                       .astype(np.float32))
    count = None
    if launch == "count":
        order = torch.argsort((act < 0.5).to(torch.int32), stable=True)
        q, act = q[order].contiguous(), act[order].contiguous()
        count = (act > 0.5).sum(dtype=torch.int32).reshape(1)
    want = tphoton.photon_gather_plain(tmap.ctable, tmap.cbounds,
                                       tmap.radius, q, act)
    work = torch.full((2000,), -1, dtype=torch.int32)
    before = tphoton.launches["K5"]
    got = tphoton.photon_gather_host(tmap.ctable, tmap.cbounds, tmap.radius,
                                     q, act, count=count, work=work)
    assert tphoton.launches["K5"] == before
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    assert got[2].max() > 100 and (got[2][act > 0.5] == 0).any()
    n_c = tmap.cbounds.shape[0]
    assert (work[act < 0.5] == 0).all()
    assert (work[act > 0.5] > 0).any() and (work <= n_c).all()


def test_gather_apply_matches_jax():
    """Records of random lanes (a third invalid) through both gather_apply:
    contributions within 1e-5 relative, escalation flags equal."""
    jmap, tmap = both_maps(random_map())
    rs = np.random.RandomState(9)
    b = 300
    rec = [rs.uniform(-1, 1, b).astype(np.float32) for _ in range(15)]
    rec[0:3] = [x * 0.15 for x in rec[0:3]]  # near the dense cube
    rec += [rs.uniform(1, 40, b).astype(np.float32),
            (rs.uniform(size=b) > 0.33).astype(np.float32)]
    cj, ej = jpp.gather_apply(jmap, [jnp.asarray(r) for r in rec],
                              interpret=True)
    ct, et = tphoton.gather_apply(tmap, [torch.tensor(r) for r in rec])
    close(cj, ct)
    assert np.array_equal(np.asarray(ej), et.numpy())
    assert et.any() and not et.all()
    assert (ct[torch.tensor(rec[16] == 0)] == 0).all()


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


def test_accumulator_skip_and_irradiance_match_jax():
    """fb/device_accum with skip= and irr= (the photon-mapped Renderer's
    folds) == qaray_tpu.fb.device_accum: skipped lanes keep their pixel's
    planes and count, the irradiance plane max-folds the flags (on the
    scattered fold not those of skipped lanes), the skipped counts agree."""
    from qaray_tpu.fb import device_accum as jacc
    from qaray_tpu.fb.framebuffer import FrameBuffer as JaxFB
    from qaray_tpu_torch.fb import device_accum
    from qaray_tpu_torch.fb.framebuffer import FrameBuffer

    rs = np.random.RandomState(4)
    w, h = 8, 4
    jstate = jacc.init_state(JaxFB(w, h), want_irr=True)
    tstate = device_accum.init_state(FrameBuffer(w, h), "cpu", want_irr=True)
    for s in range(4):
        ids = rs.permutation(w * h)[: w * h - s].astype(np.int32)
        colors = rs.uniform(size=(ids.size, 3)).astype(np.float32)
        skip = rs.uniform(size=ids.size) < 0.2
        irr = rs.uniform(size=ids.size) < 0.5
        jstate, jn = jacc.accumulate_round(
            jstate, jnp.asarray(ids), jnp.asarray(colors),
            skip=jnp.asarray(skip), irr=jnp.asarray(irr))
        tn = device_accum.accumulate_round(
            tstate, torch.tensor(ids), torch.tensor(colors),
            skip=torch.tensor(skip), irr=torch.tensor(irr))
        assert tn == int(jn) == skip.sum()
    colors = rs.uniform(size=(10, 3)).astype(np.float32)
    skip = np.arange(10) % 3 == 0
    irr = np.arange(10) % 2 == 0
    jstate, jn = jacc.accumulate_contig(jstate, 3, jnp.asarray(colors),
                                        skip=jnp.asarray(skip),
                                        irr=jnp.asarray(irr))
    tn = device_accum.accumulate_contig(tstate, 3, torch.tensor(colors),
                                        skip=torch.tensor(skip),
                                        irr=torch.tensor(irr))
    assert tn == int(jn) == 4
    jfb = jacc.sync_to_fb(jstate, JaxFB(w, h))
    tfb = device_accum.sync_to_fb(tstate, FrameBuffer(w, h))
    for k in ("mean", "color_std"):
        np.testing.assert_allclose(getattr(tfb, k), getattr(jfb, k),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    assert np.array_equal(tfb.count, jfb.count)
    assert np.array_equal(tfb.irrad, jfb.irrad) and tfb.irrad.any()
