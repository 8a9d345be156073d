"""The port's mesh path against qaray_tpu's, on the CPU.

- the host builds (sweep coefficients, Morton tiles, the packed tables the
  kernels read, the megakernel's mesh tables) are bit-equal;
- the plain versions of the mesh kernels (stream_closest, stream_any_hit,
  exact_winner, tiled_sweep, coherence_order) and the CPU side of the
  kernel wrappers (sweep_closest, tiled_sweep_kernel,
  tiled_closest_twophase) agree with qaray_tpu's functions, whose Pallas
  kernels run in interpret mode, with the bars of
  tests/test_pallas_tiles.py: rows equal on > 99.9 % of rays, t to
  rtol/atol 1e-5 where they agree, runner-ups equal on > 99 % of agreeing
  rays, occlusion equal on every ray; the tiled walk's runner-up, exact
  below t_cur, equals tiled_sweep's on > 99 % of the rays where that has
  one, and rays aimed at an icosphere's vertices open no hole after the
  exact re-test's fallback;
- csrc/tiles.cu, built for the CPU by g++, agrees with its plain version,
  and the kernel wrappers agree with the Pallas kernels in interpret mode
  (tests/test_torch_mesh_kernels.py, which shares this file's helpers);
- the wavefront engine matches render_batch_xla on the mesh scenes with
  the TPU's mesh routes forced on the JAX side (QARAY_MESH_PATH), with
  tests/test_megakernel.py::_compare's bars.

Inputs are made with numpy from fixed seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qaray_tpu.integrators.engine import IntegratorConfig as JaxConfig
from qaray_tpu.integrators.engine import render_batch_xla
from qaray_tpu.ops import mesh_stream as jms
from qaray_tpu.ops import mesh_tiles as jmt
from qaray_tpu.ops.pallas_mesh import pack_coeff16 as jax_pack16
from qaray_tpu.ops.pallas_pathtrace import build_mega_mesh as jax_mega_mesh
from qaray_tpu.ops.pallas_tiles import pack_coeffT as jax_packT
from qaray_tpu.scene.compiler import compile_scene as jax_compile
from qaray_tpu.scene.xml_parser import load_scene as jax_load
from qaray_tpu_torch.integrators import engine
from qaray_tpu_torch.ops import megakernel, mesh_stream, mesh_sweep, tiles
from qaray_tpu_torch.ops.mesh_tiles import (
    TiledMesh,
    build_tiles,
    coherence_order,
    tiled_sweep,
)
from qaray_tpu_torch.scene.convert import from_numpy_arrays
from qaray_tpu_torch.scene.procedural import icosphere, with_mesh

BIG = 1e30


def _soup(num_tris=3000, num_rays=2048, seed=1):
    """A triangle cloud and rays from above aimed at it
    (tests/test_pallas_tiles.py::_scene at a smaller size)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-10, 10, (num_tris, 3)).astype(np.float32)
    v = c[:, None, :] + rng.uniform(-0.5, 0.5, (num_tris, 3, 3)).astype(
        np.float32)
    p = np.tile(np.array([[0.0, 0.0, 30.0]], np.float32), (num_rays, 1))
    p += rng.uniform(-2, 2, (num_rays, 3)).astype(np.float32)
    d = rng.normal(size=(num_rays, 3)).astype(np.float32)
    d[:, 2] -= 1.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = rng.uniform(5, 60, num_rays).astype(np.float32)
    return v, p, d, t_max


def _rows_bars(want, got):
    """(t, row, row2) of the reference vs the port."""
    t_x, r_x, r2_x = (np.asarray(a) for a in want)
    t_p, r_p, r2_p = (np.asarray(a) for a in got)
    assert (r_x == r_p).mean() > 0.999, (r_x != r_p).mean()
    hit = (r_x >= 0) & (r_x == r_p)
    np.testing.assert_allclose(t_p[hit], t_x[hit], rtol=1e-5, atol=1e-5)
    agree = (r_x == r_p) & (r2_x >= 0) & (r2_p >= 0)
    assert (r2_x[agree] == r2_p[agree]).mean() > 0.99


def _tiled(tri_v):
    want = jmt.build_tiles(tri_v)
    got = build_tiles(tri_v)
    return want, got


def _tree(tm):
    return tiles.cluster_tree(tm.cbounds)


def test_host_tables_match_jax():
    v, *_ = _soup(num_tris=1000)
    rng = np.random.default_rng(2)
    n = rng.normal(size=v.shape).astype(np.float32)
    mtl = rng.integers(0, 3, v.shape[0]).astype(np.int32)
    js, ts = jms.build_stream(v), mesh_stream.build_stream(v)
    for a, b in zip(js, ts):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert np.array_equal(jax_pack16(js.coeff, js.const),
                          mesh_sweep.pack_coeff16(ts.coeff, ts.const))
    jt, tt = _tiled(v)
    for f, a, b in zip(TiledMesh._fields, jt, tt):
        assert np.array_equal(np.asarray(a), b.numpy()), f
    assert np.array_equal(jax_packT(jt.coeff, jt.const),
                          tiles.pack_coeffT(tt.coeff, tt.const))
    for a, b in zip(jax_mega_mesh(v, n, mtl),
                    megakernel.build_mega_mesh(v, n, mtl)):
        assert np.array_equal(a, b)


def test_stream_plain_matches_jax():
    v, p, d, t_max = _soup()
    js, ts = jms.build_stream(v), mesh_stream.build_stream(v)
    tp, td = torch.tensor(p), torch.tensor(d)
    t_cur = np.full(p.shape[0], BIG, np.float32)
    want = jms.stream_closest(jnp.asarray(p), jnp.asarray(d),
                              jnp.asarray(t_cur), js)
    got = mesh_stream.stream_closest(tp, td, torch.tensor(t_cur), ts)
    _rows_bars(want, got)
    occ_x = np.asarray(jms.stream_any_hit(jnp.asarray(p), jnp.asarray(d),
                                          jnp.asarray(t_max), js))
    occ_p = mesh_stream.stream_any_hit(tp, td, torch.tensor(t_max), ts)
    assert np.array_equal(occ_x, occ_p.numpy())
    gid = np.asarray(want[1])
    ew_x = jms.exact_winner(jnp.asarray(p), jnp.asarray(d), jnp.asarray(gid),
                            jnp.asarray(v))
    ew_p = mesh_stream.exact_winner(tp, td, torch.tensor(gid),
                                    torch.tensor(v))
    assert np.array_equal(np.asarray(ew_x[3]), ew_p[3].numpy())
    ok = ew_p[3].numpy()
    np.testing.assert_allclose(ew_p[0].numpy()[ok], np.asarray(ew_x[0])[ok],
                               rtol=1e-5)
    # Barycentrics are ratios of small 2D areas, rounded differently by
    # XLA's fused CPU code: absolute 1e-4 of a weight in [0, 1].
    np.testing.assert_allclose(ew_p[1].numpy()[ok], np.asarray(ew_x[1])[ok],
                               atol=1e-4)
    assert np.array_equal(ew_p[2].numpy()[ok], np.asarray(ew_x[2])[ok])


def test_tiled_plain_matches_jax():
    v, p, d, t_max = _soup()
    jt, tt = _tiled(v)
    tp, td = torch.tensor(p), torch.tensor(d)
    t_cur = np.full(p.shape[0], BIG, np.float32)
    kw = dict(packet=512)
    want = jmt.tiled_sweep(jnp.asarray(p), jnp.asarray(d), jnp.asarray(t_cur),
                           jt, **kw)
    got = tiled_sweep(tp, td, torch.tensor(t_cur), tt, **kw)
    _rows_bars(want, got)
    occ_x = jmt.tiled_sweep(jnp.asarray(p), jnp.asarray(d),
                            jnp.asarray(t_max), jt, any_hit=True, **kw)
    occ_p = tiled_sweep(tp, td, torch.tensor(t_max), tt, any_hit=True, **kw)
    assert np.array_equal(np.asarray(occ_x), occ_p.numpy())
    lo, hi = v.reshape(-1, 3).min(0), v.reshape(-1, 3).max(0)
    perm_x = jmt.coherence_order(jnp.asarray(p), jnp.asarray(d),
                                 jnp.asarray(lo), jnp.asarray(hi))
    perm_p = coherence_order(tp, td, torch.tensor(lo), torch.tensor(hi))
    assert np.array_equal(np.asarray(perm_x), perm_p.numpy())


def _row2_bar(want, got):
    """The walk's runner-up is exact below t_cur: on the rays where the
    reference has a winner and a runner-up, the same runner-up on > 99 %."""
    r_x, r2_x = np.asarray(want[1]), np.asarray(want[2])
    has = (r_x >= 0) & (r2_x >= 0)
    assert has.mean() > 0.01
    assert (np.asarray(got[2])[has] == r2_x[has]).mean() > 0.99


def test_k4_plain_matches_jax_tiled_sweep():
    """walk_plain (tiled_sweep_kernel on CPU tensors) against the JAX
    package's tiled_sweep, with t_cur unbounded and at finite budgets:
    winners at the _rows_bars, the runner-up at _row2_bar, any hit equal on
    every ray."""
    v, p, d, t_max = _soup()
    jt, tt = _tiled(v)
    tcT = torch.tensor(jax_packT(jt.coeff, jt.const))
    tp, td = torch.tensor(p), torch.tensor(d)
    for t_cur in (np.full(p.shape[0], BIG, np.float32), t_max):
        want = jmt.tiled_sweep(jnp.asarray(p), jnp.asarray(d),
                               jnp.asarray(t_cur), jt, packet=512)
        got = tiles.tiled_sweep_kernel(tp, td, torch.tensor(t_cur), tt, tcT,
                                       tree=_tree(tt))
        _rows_bars(want, got[:3])
        _row2_bar(want, got)
        assert bool(got[3].all())
    occ_x = jmt.tiled_sweep(jnp.asarray(p), jnp.asarray(d),
                            jnp.asarray(t_max), jt, any_hit=True, packet=512)
    occ_p = tiles.tiled_sweep_kernel(tp, td, torch.tensor(t_max), tt, tcT,
                                     tree=_tree(tt), any_hit=True)
    assert np.array_equal(np.asarray(occ_x), occ_p.numpy())


def _rounding_decided(p, d, tm, rows_a, rows_b, ulps=2.0):
    """Per ray, whether two sweeps' top-2 rows (rows_a, rows_b: pairs of
    [B] sorted-row ids) may differ by float32 rounding alone. Witnessed in
    float64 on the same coefficient table: a row that one pair holds and
    the other lacks has a predicate of mesh_stream._chunk_test (a, b or
    1 - a - b) within `ulps` float32 epsilons of its terms' magnitude of
    zero; or both pairs hold the same rows in another order at t values
    that close."""
    eps = ulps * float(np.finfo(np.float32).eps)
    coeff = tm.coeff.numpy().astype(np.float64)
    const = tm.const.numpy().astype(np.float64)
    p, d = p.astype(np.float64), d.astype(np.float64)

    def test(rows):  # (t, t's scale, smallest predicate / its scale)
        r = np.maximum(rows, 0)
        n, av, bv = coeff[r, 0], coeff[r, 1], coeff[r, 2]
        k, a0, b0 = const[r, 0], const[r, 1], const[r, 2]
        pn, dn = (p * n).sum(1), (d * n).sum(1)
        t = (k - pn) / dn
        pa, ta = (p * av).sum(1), t * (d * av).sum(1)
        pb, tb = (p * bv).sum(1), t * (d * bv).sum(1)
        a, b = pa + ta + a0, pb + tb + b0
        sa = np.abs(pa) + np.abs(ta) + np.abs(a0)
        sb = np.abs(pb) + np.abs(tb) + np.abs(b0)
        margin = np.minimum(np.minimum(np.abs(a) / sa, np.abs(b) / sb),
                            np.abs(1.0 - a - b) / (1.0 + sa + sb))
        return t, (np.abs(k) + np.abs(pn)) / np.abs(dn), margin

    near = np.zeros(p.shape[0], bool)
    for mine, other in ((rows_a, rows_b), (rows_b, rows_a)):
        for r in mine:
            lacks = (r >= 0) & (r != other[0]) & (r != other[1])
            near |= lacks & (test(r)[2] < eps)
    swapped = (rows_a[0] == rows_b[1]) & (rows_a[1] == rows_b[0])
    ta, scale, _ = test(rows_a[0])
    tb = test(rows_b[0])[0]
    return near | (swapped & (np.abs(ta - tb) < eps * scale))


def test_k4_vertex_rays_open_no_hole():
    """Rays aimed at ico4's vertices (jittered by 1e-4), where the exact
    re-test rejects some sweep winners and ops/trace._fallback takes the
    runner-up. A walk that stops at its winner's reach loses runner-ups and
    opens holes through the closed mesh; this one, after the fallback,
    gives the (t, gid) of mesh_tiles.tiled_sweep on every ray but exact
    ties in t. Against the JAX package's tiled_sweep + fallback, every ray
    whose rows differ is one where float32 rounding decides the sweep's
    test (XLA rounds the coefficient test otherwise than torch: 30 of
    16,384 rays, each with a disputed row on a triangle's edge to within
    an epsilon), so each hole that JAX's rows would close is witnessed."""
    from qaray_tpu_torch.ops.mesh_stream import _chunk_test
    from qaray_tpu_torch.ops.mesh_tiles import exact_winner_rows
    from qaray_tpu_torch.ops.trace import _fallback

    v, f = icosphere(4)
    tri = v[f].astype(np.float32)
    rng = np.random.default_rng(4)
    n = 1 << 14
    u = rng.normal(size=(n, 3))
    p = (3.0 * u / np.linalg.norm(u, axis=1, keepdims=True)).astype(
        np.float32)
    aim = v[rng.integers(0, v.shape[0], n)] + 1e-4 * rng.normal(size=(n, 3))
    d = (aim - p) / np.linalg.norm(aim - p, axis=1, keepdims=True)
    d = d.astype(np.float32)
    t_cur = np.full(n, BIG, np.float32)
    jt, tt = _tiled(tri)
    tcT = torch.tensor(jax_packT(jt.coeff, jt.const))
    tp, td, tc, tv = (torch.tensor(a) for a in (p, d, t_cur, tri))

    def fallback(rows, rows2):
        rows, rows2 = torch.as_tensor(np.array(rows)), torch.as_tensor(
            np.array(rows2))
        t, gid, _, _ = _fallback(tc, exact_winner_rows(tp, td, rows, tt, tv),
                                 exact_winner_rows(tp, td, rows2, tt, tv))
        return t.numpy(), gid.numpy()

    def sweep_t(rows):  # the sweep's own t of each ray's row
        r = torch.as_tensor(np.array(rows)).clamp_min(0).long()
        t = _chunk_test(tp[:, None], td[:, None], tt.coeff[r][:, None],
                        tt.const[r][:, None])[:, 0, 0].numpy()
        return np.where(np.array(rows) >= 0, t, -1.0)

    got = tiles.tiled_closest_twophase(tp, td, tc, tt, tcT, tree=_tree(tt))
    t_g, gid_g = fallback(*got[1:])
    ref = tiled_sweep(tp, td, tc, tt)
    t_r, gid_r = fallback(*ref[1:])
    tie = ((sweep_t(got[1]) == sweep_t(ref[1]))
           & (sweep_t(got[2]) == sweep_t(ref[2])))
    assert np.all(((gid_g == gid_r) & (t_g == t_r)) | tie)
    assert np.all((gid_g >= 0) | (gid_r < 0) | tie)  # no hole
    want = jmt.tiled_sweep(jnp.asarray(p), jnp.asarray(d),
                           jnp.asarray(t_cur), jt)
    rows_x = (np.asarray(want[1]), np.asarray(want[2]))
    rows_g = (got[1].numpy(), got[2].numpy())
    same = (rows_x[0] == rows_g[0]) & (rows_x[1] == rows_g[1])
    assert (rows_x[0] == rows_g[0]).mean() > 0.999 and same.mean() > 0.995
    rounding = _rounding_decided(p, d, tt, rows_x, rows_g)
    assert np.all(same | rounding), np.flatnonzero(~(same | rounding))
    t_x, gid_x = fallback(*rows_x)
    off = (gid_g != gid_x) | (t_g != t_x)
    assert np.all(~off | rounding)
    assert np.all((gid_g >= 0) | (gid_x < 0) | rounding)  # no hole vs JAX
    # The exact re-test rejects some winners here: the fallback is tested.
    assert (fallback(got[1], -np.ones(n))[1] != gid_g).sum() > 0


# -- the engine on the mesh scenes ------------------------------------------

RES = (32, 24)
SPP = 2


def _lanes(res=RES, spp=SPP):
    w, h = res
    ids = np.arange(w * h * spp, dtype=np.int32)
    return ids % w, (ids // w) % h, ids // (w * h)


def _compare(rad_ref, t0_ref, rad, t0, outlier_frac=2e-3):
    """tests/test_megakernel.py::_compare's bars."""
    assert np.allclose(t0_ref, t0, rtol=1e-4, atol=1e-3), (
        np.abs(t0_ref - t0).max())
    rel = (np.abs(rad_ref - rad).max(axis=-1)
           / (1.0 + np.abs(rad_ref).max(axis=-1)))
    assert (rel > 1e-3).mean() < outlier_frac
    assert np.median(rel) < 1e-6
    assert np.abs(rad_ref.mean(axis=0) - rad.mean(axis=0)).max() < 2e-3


@pytest.fixture
def fresh_jit():
    """JAX's trace functions are jitted on the meta and read the route
    variables while tracing: clear its caches around each mode."""
    jax.clear_caches()
    yield
    jax.clear_caches()


def _engine_case(name, integrator, subdiv=None):
    scene = jax_load(f"tests/assets/{name}_scene.xml")
    if subdiv is not None:
        scene = with_mesh(scene, *icosphere(subdiv))
    scene.camera.img_width, scene.camera.img_height = RES
    arrays, meta = jax_compile(scene)
    tarr, tmeta = from_numpy_arrays(jax.tree.map(np.asarray, arrays), meta,
                                    "cpu")
    kw = dict(integrator=integrator, max_bounce=3, shadow_spp=4,
              shadow_spp_max=8)
    px, py, sid = _lanes()
    key = jax.random.key(3, impl="threefry2x32")
    rad_x, t0_x = render_batch_xla(arrays, meta, JaxConfig(**kw),
                                   jnp.asarray(px), jnp.asarray(py),
                                   jnp.asarray(sid), key)
    words = tuple(int(w) for w in np.asarray(jax.random.key_data(key)))
    rad, t0 = engine.render_batch_wavefront(
        tarr, tmeta, engine.IntegratorConfig(**kw), torch.tensor(px),
        torch.tensor(py), torch.tensor(sid), words)
    _compare(np.asarray(rad_x), np.asarray(t0_x), rad.numpy(), t0.numpy())
    return tmeta


@pytest.mark.parametrize("integrator", ["pathtrace", "photonmap"])
@pytest.mark.parametrize("name", ["mesh", "mirror"])
def test_engine_stream_route_matches_jax(name, integrator, monkeypatch,
                                         fresh_jit):
    """The dense-sweep route (K3's plain version on the CPU)."""
    monkeypatch.setenv("QARAY_MESH_PATH", "stream")
    meta = _engine_case(name, integrator)
    assert meta.mesh_stream and not meta.mesh_tiled and meta.mesh_mega


def test_mesh_scene_takes_the_megakernel_route():
    """Renderer defaults send a mesh scene under 64k triangles to K1a/K1c;
    on CPU tensors mega_render runs the wavefront engine."""
    from qaray_tpu_torch.scene.compiler import compile_scene
    from qaray_tpu_torch.scene.xml_parser import load_scene

    scene = load_scene("tests/assets/mesh_scene.xml")
    scene.camera.img_width, scene.camera.img_height = 8, 6
    arr, meta = compile_scene(scene, device="cpu")
    cfg = engine.IntegratorConfig(integrator="photonmap", max_bounce=2)
    assert engine.use_pathtrace_mega(meta, cfg)
    assert arr.kernel.mesh_rows.shape == (512, 16)
    # K1c walks a tree of 64-row leaves: 8 leaves over the 512 rows.
    assert arr.kernel.mesh_tree.shape == (16, 8)
    px, py, sid = (torch.tensor(a) for a in _lanes((8, 6), 1))
    rad, t0 = engine.render_batch(arr, meta, cfg, px, py, sid, (0, 3))
    rad_w, t0_w = engine.render_batch_wavefront(arr, meta, cfg, px, py, sid,
                                                (0, 3))
    assert torch.equal(rad, rad_w) and torch.equal(t0, t0_w)
    assert (t0 < 1e29).any()


def test_mesh_diff_uv_matches_jax(tmp_path, monkeypatch):
    """trace_closest(diff=...) on a UV sphere with a file texture: the 2,048
    camera rays of a 64x32 view; uvw and the triangle footprints duvw0 /
    duvw1 against qaray_tpu on its dense-sweep route. Tolerance as for the
    analytic footprints (tests/test_torch_analytic.py): uvs to 1e-5
    relative + 1e-6 absolute, footprints, which are uv differences times
    RCP_DX = 100, to 1e-5 relative + 1e-4 absolute, on the rays whose
    winners agree."""
    from qaray_tpu.integrators.engine import generate_camera_rays as jax_rays
    from qaray_tpu.ops.trace import trace_closest as jax_trace
    from qaray_tpu_torch.ops.trace import trace_closest
    from test_torch_engine import uv_mesh_scene

    monkeypatch.setenv("QARAY_MESH_PATH", "stream")
    jax.clear_caches()
    scene = jax_load(uv_mesh_scene(tmp_path))
    scene.camera.img_width, scene.camera.img_height = 64, 32
    arrays, meta = jax_compile(scene)
    tarr, tmeta = from_numpy_arrays(jax.tree.map(np.asarray, arrays), meta,
                                    "cpu")
    assert tmeta.num_tris == 192 and bool(tarr.mesh.tri_has_uv.all())
    ids = np.arange(2048, dtype=np.int32)
    px, py, sid = ids % 64, ids // 64, np.zeros_like(ids)
    p, d, _, _, diff = jax_rays(arrays, meta, JaxConfig(), jnp.asarray(px),
                                jnp.asarray(py), jnp.asarray(sid), None)
    want = jax_trace(arrays, meta, p, d, diff=diff)
    jax.clear_caches()
    tp, td, _, _, tdiff = engine.generate_camera_rays(
        tarr, tmeta, torch.tensor(px), torch.tensor(py), torch.tensor(sid),
        None)
    got = trace_closest(tarr, tmeta, tp, td, diff=tdiff)
    hit = np.asarray(want["hit"])
    assert np.array_equal(got["hit"].numpy(), hit)
    same = hit & np.isclose(got["t"].numpy(), np.asarray(want["t"]),
                            rtol=1e-5)
    on_mesh = same & (np.asarray(want["mtl"]) == np.asarray(
        arrays.mesh.tri_mtl)[0])
    assert same.mean() > 0.99 * hit.mean() and on_mesh.mean() > 0.05
    np.testing.assert_allclose(got["uvw"].numpy()[same],
                               np.asarray(want["uvw"])[same], rtol=1e-5,
                               atol=1e-6)
    for k in ("duvw0", "duvw1"):
        ref = np.asarray(want[k])[same]
        err = np.abs(got[k].numpy()[same] - ref)
        assert (err > 1e-4 + 1e-5 * np.abs(ref)).mean() < 0.01, k
        assert np.abs(np.asarray(want[k])[on_mesh]).max() > 1e-3, k
