"""The port's analytic intersection (plain versions of kernels K2a-K2c)
against qaray_tpu.ops.intersect and the Pallas kernels of
qaray_tpu/ops/pallas_analytic.py in interpret mode, on random rays against
the primitives of the in-repo scenes. Bars of tests/test_pallas.py: 99th
percentile relative t error < 1e-5, < 0.5 % hit/miss flips, > 99.5 % same
primitive, attributes equal (atol 1e-4) on agreeing lanes, < 0.5 % shadow
disagreements. The CUDA kernels are held to the same bars on the card by
tests/test_torch_gpu.py and chip_smoke.py; their source, built with g++,
is held to the plain versions and the Pallas kernels here.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qaray_tpu.ops import intersect as JI
from qaray_tpu.ops.pallas_analytic import (
    _closest_full_raw,
    closest_analytic_pallas,
    shadow_analytic_pallas,
)
from qaray_tpu.scene.compiler import compile_scene
from qaray_tpu.scene.xml_parser import load_scene
from qaray_tpu_torch.ops import analytic
from qaray_tpu_torch.scene.convert import from_numpy_arrays

SCENES = ["tests/assets/spot_scene.xml", "tests/assets/softdof_scene.xml"]


def _rays(seed, num):
    rs = np.random.RandomState(seed)
    p = rs.uniform(-30, 30, (num, 3)).astype(np.float32)
    d = rs.normal(size=(num, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = rs.uniform(1, 60, num).astype(np.float32)
    return p, d, t_max


def _scenes(path, device):
    arrays, meta = compile_scene(load_scene(path))
    tarr, tmeta = from_numpy_arrays(jax.tree.map(np.asarray, arrays), meta,
                                    device)
    return arrays, meta, tarr, tmeta


def _t_bars(t_ref, i_ref, t_got, i_got):
    hits = (t_ref < 1e29) & (t_got < 1e29)
    rel = np.abs(t_got[hits] - t_ref[hits]) / np.maximum(t_ref[hits], 1.0)
    assert np.percentile(rel, 99) < 1e-5
    assert ((t_ref < 1e29) ^ (t_got < 1e29)).mean() < 0.005
    assert (i_got[hits] == i_ref[hits]).mean() > 0.995
    return hits & (i_got == i_ref)


@pytest.mark.parametrize("path", SCENES)
def test_closest_matches_jax(path):
    arrays, meta, tarr, _ = _scenes(path, "cpu")
    p, d, _ = _rays(0, 2048)
    t_got, i_got = analytic.closest(torch.tensor(p), torch.tensor(d),
                                    tarr.analytic)
    t_got, i_got = t_got.numpy(), i_got.numpy()
    t_x, i_x = JI.closest_analytic(jnp.asarray(p), jnp.asarray(d),
                                   arrays.analytic)
    _t_bars(np.asarray(t_x), np.asarray(i_x), t_got, i_got)
    t_pl, i_pl = closest_analytic_pallas(
        jnp.asarray(p), jnp.asarray(d), arrays.analytic, meta.analytic_kinds,
        interpret=True)
    _t_bars(np.asarray(t_pl), np.asarray(i_pl), t_got, i_got)


@pytest.mark.parametrize("path", SCENES)
def test_closest_full_matches_pallas(path):
    arrays, meta, tarr, _ = _scenes(path, "cpu")
    p, d, _ = _rays(1, 2048)
    got = analytic.closest_full(torch.tensor(p), torch.tensor(d),
                                tarr.analytic)
    want = _closest_full_raw(jnp.asarray(p), jnp.asarray(d), arrays.analytic,
                             meta.analytic_kinds, want_uv=True,
                             interpret=True)
    agree = _t_bars(np.asarray(want["t"]), np.asarray(want["prim_idx"]),
                    got["t"].numpy(), got["prim_idx"].numpy())
    for k in ("n", "uvw", "p"):
        np.testing.assert_allclose(got[k].numpy()[agree],
                                   np.asarray(want[k])[agree], atol=1e-4)
    for k in ("front", "mtl"):
        assert np.array_equal(got[k].numpy()[agree],
                              np.asarray(want[k])[agree])


@pytest.mark.parametrize("path", SCENES)
def test_shadow_matches_jax(path):
    arrays, meta, tarr, _ = _scenes(path, "cpu")
    p, d, t_max = _rays(2, 2048)
    got = analytic.shadow(torch.tensor(p), torch.tensor(d),
                          torch.tensor(t_max), tarr.analytic).numpy()
    pj, dj, tj = jnp.asarray(p), jnp.asarray(d), jnp.asarray(t_max)
    ref = np.asarray(jnp.any(
        JI.intersect_analytic_t(pj, dj, arrays.analytic) < tj[:, None],
        axis=-1))
    assert (got != ref).mean() < 0.005
    pal = np.asarray(shadow_analytic_pallas(pj, dj, tj, arrays.analytic,
                                            meta.analytic_kinds,
                                            interpret=True))
    assert (got != pal).mean() < 0.005


def test_closest_full_plain_without_uv_matches_pallas():
    """closest_full_plain(want_uv=False) against _closest_full_raw(want_uv=
    False) in interpret mode on softdof's primitives: uvw 0 on every lane,
    the rest at the file's bars."""
    arrays, meta, tarr, _ = _scenes(SCENES[1], "cpu")
    p, d, _ = _rays(6, 2048)
    got = analytic.closest_full_plain(torch.tensor(p), torch.tensor(d),
                                      tarr.analytic, want_uv=False)
    want = _closest_full_raw(jnp.asarray(p), jnp.asarray(d), arrays.analytic,
                             meta.analytic_kinds, want_uv=False,
                             interpret=True)
    assert not np.asarray(want["uvw"]).any() and not got["uvw"].any()
    agree = _t_bars(np.asarray(want["t"]), np.asarray(want["prim_idx"]),
                    got["t"].numpy(), got["prim_idx"].numpy())
    for k in ("n", "p"):
        np.testing.assert_allclose(got[k].numpy()[agree],
                                   np.asarray(want[k])[agree], atol=1e-4)
    for k in ("front", "mtl"):
        assert np.array_equal(got[k].numpy()[agree],
                              np.asarray(want[k])[agree])


@pytest.mark.parametrize("want_uv", [True, False])
@pytest.mark.parametrize("path", SCENES)
def test_closest_sources_on_the_host_match_plain(path, want_uv):
    """K2a's and K2b's source under g++ (analytic.closest_host,
    closest_full_host) on 3,001 random rays, in host blocks of 1 and 256
    threads: held to closest_plain / closest_full_plain and to the Pallas
    kernels in interpret mode at the file's bars (K2b with the same
    want_uv; uvw 0 without it); the two block sizes give the same bits, as
    do the rays as views at a 4-byte offset and their aligned copies."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ for the host build of the kernel source")
    arrays, meta, tarr, _ = _scenes(path, "cpu")
    prims = tarr.analytic
    p, d, _ = _rays(5, 3001)
    tp, td = torch.tensor(p), torch.tensor(d)
    jp, jd = jnp.asarray(p), jnp.asarray(d)
    t_pl, i_pl = (np.asarray(a) for a in closest_analytic_pallas(
        jp, jd, arrays.analytic, meta.analytic_kinds, interpret=True))
    full_pl = _closest_full_raw(jp, jd, arrays.analytic, meta.analytic_kinds,
                                want_uv=want_uv, interpret=True)
    full_plain = analytic.closest_full_plain(tp, td, prims, want_uv=want_uv)
    runs = {}
    for block in (1, 256):
        t, i = analytic.closest_host(tp, td, prims, block=block)
        full = analytic.closest_full_host(tp, td, prims, want_uv=want_uv,
                                          block=block)
        runs[block] = (t, i, full)
        for t_ref, i_ref in (analytic.closest_plain(tp, td, prims),
                             (t_pl, i_pl)):
            _t_bars(np.asarray(t_ref), np.asarray(i_ref), t.numpy(),
                    i.numpy())
        for ref in (full_plain, full_pl):
            agree = _t_bars(np.asarray(ref["t"]), np.asarray(ref["prim_idx"]),
                            full["t"].numpy(), full["prim_idx"].numpy())
            for k in ("n", "uvw", "p"):
                np.testing.assert_allclose(full[k].numpy()[agree],
                                           np.asarray(ref[k])[agree],
                                           atol=1e-4)
            for k in ("front", "mtl"):
                assert np.array_equal(full[k].numpy()[agree],
                                      np.asarray(ref[k])[agree])
        assert torch.equal(full["t"], t) and torch.equal(full["prim_idx"], i)
        assert full["has_texture"].all()
        assert want_uv == bool(full["uvw"].any())
        miss = t >= 1e29
        assert miss.any() and not full["prim_idx"][miss].any()
        assert bool((full["n"][miss] == torch.tensor([0.0, 0.0, 1.0])).all())
        assert bool(full["front"][miss].all())
    po, do = _at_offset(tp, td)
    offset = (*analytic.closest_host(po, do, prims),
              analytic.closest_full_host(po, do, prims, want_uv=want_uv))
    for other in (runs[256], offset):
        assert torch.equal(other[0], runs[1][0])
        assert torch.equal(other[1], runs[1][1])
        for k, v in runs[1][2].items():
            assert torch.equal(other[2][k], v), k


@pytest.mark.parametrize("own_t", [False, True])
def test_closest_full_outputs_keep_t_apart_for_autograd(own_t):
    """K2b's outputs as its wrapper allocates them, filled by the source
    under g++: one buffer, or with own_t (the autograd route, which saves
    t and prim_idx for the backward rule) a buffer of 8 bytes a ray for t
    and prim_idx and another for the rest. Either way closest_full_plain's
    dtypes, shapes and contiguity and closest_full_host's bits."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ for the host build of the kernel source")
    _, _, tarr, _ = _scenes(SCENES[1], "cpu")
    prims = tarr.analytic
    p, d, _ = (torch.tensor(a) for a in _rays(6, 1001))
    want = analytic.closest_full_host(p, d, prims, block=256)
    plain = analytic.closest_full_plain(p, d, prims)
    got = analytic._on_host(256, lambda f: analytic._full_launch(
        f, p, d, prims, True, None, "K2b closest_full (host)", own_t))
    assert got.keys() == plain.keys()
    for k, v in got.items():
        assert (v.dtype, v.shape) == (plain[k].dtype, plain[k].shape), k
        assert v.is_contiguous() and torch.equal(v, want[k]), k
    base = {k: v.untyped_storage().data_ptr() for k, v in got.items()}
    head = {base["t"], base["prim_idx"]}
    rest = {v for k, v in base.items() if k not in ("t", "prim_idx")}
    assert len(head) == 1 and len(rest) == 1
    assert (head != rest) == own_t
    if own_t:
        assert got["t"].untyped_storage().nbytes() == 8 * p.shape[0]


# Ray sets of the host build's K2c test, as slices of 20,001 rays. The
# host stands in for a card of one SM, a grid of 2,048 threads, from whose
# few rays a thread on aligned rays go in pairs: "pairs" and "pairs odd"
# (an odd count leaves a last ray); "offset" is a view at a 4-byte offset
# (one ray a thread), "head 31" and "one" are launches smaller than the
# grid.
SHADOW_SETS = {"pairs": slice(0, 20000), "pairs odd": slice(0, 20001),
               "offset": slice(1, 20001), "head 31": slice(0, 31),
               "one": slice(5, 6)}


def _at_offset(*tensors):
    """Copies of the tensors as views at a 4-byte offset, which K2c takes
    one ray a thread."""
    out = []
    for t in tensors:
        flat = torch.empty(t.numel() + 1, dtype=t.dtype)
        flat[1:] = t.reshape(-1)
        out.append(flat[1:].view(t.shape))
    return out


@pytest.mark.parametrize("rays", list(SHADOW_SETS))
@pytest.mark.parametrize("path", SCENES)
def test_shadow_source_on_the_host_matches_plain(path, rays):
    """K2c's source under g++ (analytic.shadow_host), in host blocks of one
    thread and of 256 (a card block), against shadow_plain on random rays,
    a third of them with t_max equal to their closest hit's t (not
    occluded: the test is t < t_max) and the last an occluded one, for
    each set of SHADOW_SETS. The card test's bar (under 0.005 of rays
    disagree; expect 0), and the same rays at a 4-byte offset (one ray a
    thread) give the same bits."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ for the host build of the kernel source")
    _, _, tarr, _ = _scenes(path, "cpu")
    prims = tarr.analytic
    p, d, t_max = (torch.tensor(a) for a in _rays(4, 20001))
    t_hit, _ = analytic.closest_plain(p, d, prims)
    edge = (torch.arange(p.shape[0]) % 3 == 0) & (t_hit < 1e29)
    t_max = torch.where(edge, t_hit, t_max)
    assert int(edge.sum()) > 100
    k = int(torch.nonzero(analytic.shadow_plain(p, d, t_max, prims))[0])
    p[-1], d[-1], t_max[-1] = p[k], d[k], t_max[k]
    sl = SHADOW_SETS[rays]
    want = analytic.shadow_plain(p[sl], d[sl], t_max[sl], prims)
    assert not bool(want[edge[sl]].any()) or sl.stop - sl.start < 100
    one = analytic.shadow_host(*_at_offset(p[sl], d[sl], t_max[sl]), prims)
    for block in (1, 256):
        got = analytic.shadow_host(p[sl], d[sl], t_max[sl], prims,
                                   block=block)
        off = int((got != want).sum())
        print(f"{path} {rays} rays {sl.start}:{sl.stop} block {block}: "
              f"{off} of {want.numel()} disagree")
        assert off < 0.005 * want.numel()
        assert torch.equal(got, one)


def test_cuda_tensors_never_take_the_plain_path(monkeypatch):
    """A CUDA tensor launches the kernel or raises: with no card (or a
    failing build) the wrapper raises instead of computing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the gpu case covers this")
    _, _, tarr, _ = _scenes(SCENES[0], "cpu")
    monkeypatch.setattr(analytic, "closest_plain", None)
    monkeypatch.setattr(analytic, "shadow_plain", None)
    p = torch.zeros((4, 3))
    d = torch.zeros((4, 3))
    d[:, 2] = -1.0
    prims = tarr.analytic._replace(
        **{f: getattr(tarr.analytic, f).to("meta")
           for f in tarr.analytic._fields})
    with pytest.raises((RuntimeError, ValueError, NotImplementedError)):
        analytic.closest(p.to("meta"), d.to("meta"), prims)


def test_diff_uv_matches_jax():
    """Texture footprints of texture_scene.xml's 2,048 first camera rays at
    64x32: analytic_diff_uv alone on JAX's winners, then trace_closest with
    the differential rays, which adds duvw0/duvw1 to the hit record.
    Tolerance: 1e-5 relative + 1e-6 absolute on the uvs. A footprint is
    the difference of two nearly equal uvs times RCP_DX = 100, so the uvs'
    last-bit differences between the packages (atan2, asin, the summation
    order of the object-space transform) arrive amplified: 1e-5 relative +
    1e-4 absolute on duvw0 and duvw1."""
    from qaray_tpu.integrators.engine import IntegratorConfig as JaxConfig
    from qaray_tpu.integrators.engine import generate_camera_rays as jax_rays
    from qaray_tpu.ops.trace import trace_closest as jax_trace
    from qaray_tpu_torch.integrators import engine
    from qaray_tpu_torch.ops import intersect as TI
    from qaray_tpu_torch.ops.trace import trace_closest

    scene = load_scene("tests/assets/texture_scene.xml")
    scene.camera.img_width, scene.camera.img_height = 64, 32
    arrays, meta = compile_scene(scene)
    tarr, tmeta = from_numpy_arrays(jax.tree.map(np.asarray, arrays), meta,
                                    "cpu")
    ids = np.arange(2048, dtype=np.int32)
    px, py, sid = ids % 64, ids // 64, np.zeros_like(ids)
    p, d, _, _, diff = jax_rays(arrays, meta, JaxConfig(), jnp.asarray(px),
                                jnp.asarray(py), jnp.asarray(sid), None)
    tp, td, _, _, tdiff = engine.generate_camera_rays(
        tarr, tmeta, torch.tensor(px), torch.tensor(py), torch.tensor(sid),
        None)
    for a, b in zip((p, d, *diff), (tp, td, *tdiff)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)

    want = jax_trace(arrays, meta, p, d, diff=diff)
    hit = np.asarray(want["hit"])
    assert 0.3 < hit.mean() < 1.0 and "duvw0" in want

    def close(got, ref, what):
        ref = np.asarray(ref)[hit]
        err = np.abs(got.numpy()[hit] - ref)
        bar = 1e-4 + 1e-5 * np.abs(ref)
        # Near a sphere's silhouette the tangent plane is almost parallel
        # to the offset ray and the footprint is ill-conditioned: 1 % of
        # the hits may miss the bar.
        assert (err > bar).mean() < 0.01, (what, (err > bar).mean())
        assert np.abs(ref).max() > 0.01  # footprints, not zeros

    # The function alone, on JAX's t, winners and uvw.
    t_attr = np.where(hit, np.asarray(want["t"]), 1.0).astype(np.float32)
    _, prim = JI.closest_analytic(p, d, arrays.analytic)
    d0, d1 = TI.analytic_diff_uv(
        tp, td, *tdiff, torch.tensor(t_attr),
        torch.tensor(np.asarray(prim)), tarr.analytic,
        torch.tensor(np.asarray(want["uvw"])))
    close(d0, want["duvw0"], "analytic_diff_uv duvw0")
    close(d1, want["duvw1"], "analytic_diff_uv duvw1")
    # Through trace_closest.
    got = trace_closest(tarr, tmeta, tp, td, diff=tdiff)
    assert np.array_equal(got["hit"].numpy(), hit)
    close(got["duvw0"], want["duvw0"], "trace_closest duvw0")
    close(got["duvw1"], want["duvw1"], "trace_closest duvw1")
    assert "duvw0" not in trace_closest(tarr, tmeta, tp, td)
