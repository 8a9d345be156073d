"""The mesh kernels' sources and wrappers: K3 and K4a/K4b against the
Pallas kernels in interpret mode, and csrc/tiles.cu built for the host
against the plain walks, with tests/test_torch_mesh.py's soups and bars
(split from that file so that the test workers share the load).
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qaray_tpu.ops import mesh_stream as jms
from qaray_tpu.ops.pallas_mesh import pack_coeff16 as jax_pack16
from qaray_tpu.ops.pallas_mesh import pallas_sweep_closest
from qaray_tpu.ops.pallas_tiles import pack_coeffT as jax_packT
from qaray_tpu.ops.pallas_tiles import pallas_tiled_sweep
from qaray_tpu.ops.pallas_tiles import \
    tiled_closest_twophase as jax_twophase
from qaray_tpu_torch.ops import mesh_stream, mesh_sweep, tiles
from qaray_tpu_torch.scene.procedural import icosphere

from test_torch_mesh import BIG, _rows_bars, _soup, _tiled, _tree


def test_k3_wrapper_matches_pallas_interpret():
    """sweep_closest / sweep_occluded on CPU tensors (the plain versions on
    the packed table) against the Pallas kernel in interpret mode."""
    v, p, d, t_max = _soup(num_tris=600)
    js = jms.build_stream(v)
    c16 = jax_pack16(js.coeff, js.const)
    t_cur = np.full(p.shape[0], BIG, np.float32)
    want = pallas_sweep_closest(jnp.asarray(p), jnp.asarray(d),
                                jnp.asarray(t_cur), jnp.asarray(c16),
                                interpret=True)
    tc16 = torch.tensor(c16)
    got = mesh_sweep.sweep_closest(torch.tensor(p), torch.tensor(d),
                                   torch.tensor(t_cur), tc16)
    _rows_bars(want, got)
    _, row, _ = pallas_sweep_closest(jnp.asarray(p), jnp.asarray(d),
                                     jnp.asarray(t_max), jnp.asarray(c16),
                                     interpret=True)
    occ = mesh_sweep.sweep_occluded(torch.tensor(p), torch.tensor(d),
                                    torch.tensor(t_max), tc16)
    assert np.array_equal(np.asarray(row) >= 0, occ.numpy())


def test_k4_source_on_the_host_matches_plain():
    """csrc/tiles.cu compiled by g++ and run one ray at a time
    (tiled_sweep_host) against walk_plain: the same t and rows but for
    exact ties in t, runner-ups too; the same occlusion on every ray; under
    a cap of 2 clusters, every ray marked resolved already has its
    unbudgeted top-2, and the cap bites; per-ray work in whole clusters,
    within the clusters visited."""
    v, p, d, t_max = _soup()
    _, tt = _tiled(v)
    tcT = torch.tensor(tiles.pack_coeffT(tt.coeff, tt.const))
    tp, td = torch.tensor(p), torch.tensor(d)
    t_cur = torch.full((p.shape[0],), BIG)
    tree = _tree(tt)
    (t_h, r_h, r2_h, res_h), steps, work = tiles.tiled_sweep_host(
        tp, td, t_cur, tt, tcT, tree=tree)
    t_p, r_p, r2_p, _ = tiles.tiled_sweep_kernel(tp, td, t_cur, tt, tcT,
                                                 tree=tree)
    assert torch.equal(t_h, t_p) and bool(res_h.all())
    assert bool(((r_h == r_p) | (r2_h == r_p)).all())
    assert (r2_h == r2_p).float().mean().item() > 0.999
    assert bool((work % 256 == 0).all() & (work <= 256 * steps).all())
    assert bool((steps[r_h >= 0] > 0).all())
    (t_b, r_b, r2_b, res_b), _, _ = tiles.tiled_sweep_host(
        tp, td, t_cur, tt, tcT, tree=tree, max_steps=2)
    assert 0.0 < res_b.float().mean().item() < 1.0
    assert torch.equal(t_b[res_b], t_h[res_b])
    assert torch.equal(r_b[res_b], r_h[res_b])
    assert torch.equal(r2_b[res_b], r2_h[res_b])
    occ_h, steps, work = tiles.tiled_sweep_host(tp, td, torch.tensor(t_max),
                                                tt, tcT, tree=tree,
                                                any_hit=True)
    occ_p = tiles.tiled_sweep_kernel(tp, td, torch.tensor(t_max), tt, tcT,
                                     tree=tree, any_hit=True)
    assert torch.equal(occ_h, occ_p) and bool(occ_h.any())
    assert torch.equal(work, 256 * steps)


def _vertex_rays(n, seed, jitter):
    """ico4's triangles and n rays from a sphere of radius 3 aimed at its
    vertices, jittered by `jitter`."""
    v, f = icosphere(4)
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, 3))
    p = 3.0 * u / np.linalg.norm(u, axis=1, keepdims=True)
    aim = v[rng.integers(0, v.shape[0], n)] + jitter * rng.normal(
        size=(n, 3))
    d = (aim - p) / np.linalg.norm(aim - p, axis=1, keepdims=True)
    return v[f].astype(np.float32), p.astype(np.float32), d.astype(
        np.float32)


def _k3_case(what):
    """Triangles, rays and t_cur of one of the K3 host test's ray sets."""
    v, p, d, t_max = _soup()
    if what == "soup":
        return v, p, d, np.full(p.shape[0], BIG, np.float32)
    if what == "soup budgets":
        return v, p, d, t_max
    if what == "short":
        rng = np.random.default_rng(5)
        return v, p, d, rng.uniform(1.0, 10.0, p.shape[0]).astype(np.float32)
    vt, pv, dv = _vertex_rays(4096, 6, 0.0)
    return vt, pv, dv, np.full(pv.shape[0], BIG, np.float32)


@pytest.mark.parametrize("what", ["soup", "soup budgets", "short",
                                  "vertices"])
def test_k3_source_on_the_host_matches_plain(what):
    """csrc/tiles.cu's K3 walk compiled by g++ and run one ray at a time
    (mesh_sweep.sweep_host) against the plain dense sweep
    (stream_closest / stream_any_hit on pack_coeff16's table): equal
    (t, row, row2) on every ray and equal occlusion, on a random soup with
    t_cur unbounded and at finite budgets, on rays whose t_cur falls short
    of every hit (the runner-up is then the nearest hit beyond t_cur), and
    on rays aimed at ico4's vertices, where hits tie exactly in t and the
    lower world triangle id must win. The walk's rows are the dense rows
    bit for bit, and every visited cluster count is within the tree."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ for the host build of the kernel source")
    tri, pp, dd, tc = _k3_case(what)
    st = mesh_stream.build_stream(tri)
    c16 = torch.tensor(mesh_sweep.pack_coeff16(st.coeff, st.const))
    walk = mesh_sweep.build_walk(tri)
    g = walk.gid.numpy()
    assert np.array_equal(walk.rows.numpy()[g >= 0], c16.numpy()[g[g >= 0]])
    tp, td, tt = (torch.tensor(a) for a in (pp, dd, tc))
    want = mesh_sweep.sweep_closest(tp, td, tt, c16)
    got, steps = mesh_sweep.sweep_host(tp, td, tt, walk)
    for name, a, b in zip(("t", "row", "row2"), want, got):
        assert torch.equal(a, b), (name, int((a != b).sum()))
    assert int(steps.max()) <= walk.rows.shape[0] // mesh_sweep.WALK_LEAF
    occ, _ = mesh_sweep.sweep_host(tp, td, tt, walk, any_hit=True)
    assert torch.equal(occ, mesh_sweep.sweep_occluded(tp, td, tt, c16))
    if what == "short":
        assert bool((want[1] < 0).all())
        assert int((want[2] >= 0).sum()) > 100
    if what == "vertices":
        # The sweep's own t of each runner-up: ties with the winner's t.
        r2 = want[2].clamp_min(0).long()
        tab = mesh_sweep.unpack_coeff16(c16)
        t2 = mesh_stream._chunk_test(tp[:, None], td[:, None],
                                     tab.coeff[r2][:, None],
                                     tab.const[r2][:, None])
        assert int(((want[1] >= 0) & (want[2] >= 0)
                    & (t2[:, 0, 0] == want[0])).sum()) > 0


def test_k4_wrapper_matches_pallas_interpret():
    """tiled_sweep_kernel's CPU side (walk_plain: the kernels' walk) and
    tiled_closest_twophase against the Pallas kernels in interpret mode,
    packets of 512 rays. The Pallas march resolves whole packets; the walk
    resolves each ray, so its budgeted run is held to its own contract."""
    v, p, d, t_max = _soup()
    jt, tt = _tiled(v)
    cT = jax_packT(jt.coeff, jt.const)
    jp, jd, tp, td = jnp.asarray(p), jnp.asarray(d), torch.tensor(p), \
        torch.tensor(d)
    tcT, tree = torch.tensor(cT), _tree(tt)
    t_cur = np.full(p.shape[0], BIG, np.float32)
    t_x, r_x, r2_x, res_x = pallas_tiled_sweep(
        jp, jd, jnp.asarray(t_cur), jt, jnp.asarray(cT), interpret=True,
        packet_rows=4)
    t_p, r_p, r2_p, res_p = tiles.tiled_sweep_kernel(
        tp, td, torch.tensor(t_cur), tt, tcT, tree=tree)
    _rows_bars((t_x, r_x, r2_x), (t_p, r_p, r2_p))
    assert (np.asarray(res_x) > 0.5).mean() == 1.0 == res_p.numpy().mean()
    occ_x = pallas_tiled_sweep(jp, jd, jnp.asarray(t_max), jt,
                               jnp.asarray(cT), any_hit=True, interpret=True,
                               packet_rows=4)
    occ_p = tiles.tiled_sweep_kernel(tp, td, torch.tensor(t_max), tt, tcT,
                                     tree=tree, any_hit=True)
    assert np.array_equal(np.asarray(occ_x), occ_p.numpy())
    # Budgeted walk: a ray marked resolved already has its unbudgeted
    # top-2, and the budget bites.
    t_b, r_b, r2_b, res_b = tiles.tiled_sweep_kernel(
        tp, td, torch.tensor(t_cur), tt, tcT, tree=tree, max_steps=2)
    res = res_b.numpy()
    assert 0.0 < res.mean() < 1.0
    assert np.array_equal(t_b.numpy()[res], t_p.numpy()[res])
    assert np.array_equal(r_b.numpy()[res], r_p.numpy()[res])
    assert np.array_equal(r2_b.numpy()[res], r2_p.numpy()[res])
    want = jax_twophase(jp, jd, jnp.asarray(t_cur), jt, jnp.asarray(cT),
                        budget=2, interpret=True)
    got = tiles.tiled_closest_twophase(tp, td, torch.tensor(t_cur), tt, tcT,
                                       tree=tree, budget=2)
    _rows_bars(want, got)
    single = tiles.tiled_closest_twophase(tp, td, torch.tensor(t_cur), tt,
                                          tcT, tree=tree, budget=0)
    assert np.array_equal(single[1].numpy(), got[1].numpy())
