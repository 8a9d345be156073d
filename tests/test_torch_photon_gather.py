"""The port's photon gathers against qaray_tpu's: the exact estimates, the
plain version of K5 (against the Pallas kernel in interpret mode), K5's
source built for the host, the record gather and the accumulator's
skipped lanes, with tests/test_torch_photon.py's maps, tolerances and
seeds (split from that file so that the test workers share the load).
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qaray_tpu.ops import pallas_photon as jpp
from qaray_tpu.photon import gather as jgather
from qaray_tpu_torch.ops import photon as tphoton
from qaray_tpu_torch.photon import gather as tgather

from test_torch_photon import both_maps, close, queries, random_map


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
