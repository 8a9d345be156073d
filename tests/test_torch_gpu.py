"""The port's CUDA kernels against their plain versions, on a card.

Imports neither jax nor qaray_tpu, so it runs on the GPU machine, where JAX
is absent:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

Every case carries the `gpu` marker and skips without a CUDA device.
Bars: tests/test_pallas.py for K2a-K2c, tests/test_megakernel.py::_compare
for K1a against the wavefront engine (which itself runs on K2b/K2c);
tests/test_pallas_tiles.py for K3 and K4a/K4b against their plain versions
(and K3 equal to the dense sweep on every ray),
with K4a's runner-up, exact below t_cur, equal to tiled_sweep's on > 99 %
of the rays where that has one, and no hole where rays aimed at an
icosphere's vertices fall back to it; the wavefront engine on ico6 (K4a,
K4b) against itself on the CPU at tests/test_megakernel.py::_compare's
bars; tests/test_megakernel.py's mesh bars for K1c against the engine;
test_mega_checker_textures_parity's bars for K1b against the engine with
its texture stack. The wavefront route's texture stack and the Whitted
family's integrators are held to the same code on the CPU. K5 against
photon_gather_plain: sums within 1e-5 relative, counts exact, and its
counted launch (gather_apply's) equal to the flagged one; K1c's own mesh
functions (the megakernel's tree walk, qr_mega_mesh_probe) equal to the
in-order fold over the same rows on every ray; K1d against
the engine with its exact gathers: test_mega_photon_gather_parity's and
test_mega_photon_escalation_flags_dense_lanes's bars on caustics_scene
(softdof with a glass middle sphere). K6 against adjoint_render_plain:
tests/test_grad.py's 3e-2 of max|b| per field, and two K6 launches
bit-equal; render_value_and_grad's fast route launches K1a and K6;
render_batch's gradients on the megakernel route equal
render_with_params'. K2c on views at a 4-byte offset equals K2c on their
aligned copies, bit for bit, and so do K2a and K2b on such views and on
the first 1, 31 and 65,537 rays; K2b without the uv equals K2b with it
but for uvw, which is 0; trace_closest asks K2b for the uv only on a
scene with a material texture; on the autograd route K2b's saved t and
prim_idx share no storage with its attributes. W1 (the packed BVH walk)
equals its plain walk bit for bit on a world tree, over transformed
instances and over more instances than a block stages at once, closest
and any hit (with and without rays occluded on entry). Captured execution
(utils/compiled.py) equals the eager run bit for bit, its replays under
torch.cuda.set_sync_debug_mode("error"): render_batch on the megakernel
route, the wavefront route, K3, K4a/K4b, W1 and K1d with escalated lanes
(and their exact re-render), the folds, three fast-route gradient steps
with changing parameters, photon maps; a second render, the later
gradient steps, a second map build and three /orbit frames capture
nothing. The autograd route's step (spot_scene, mesh_scene) over three
steps with changing parameters, and render_batch's gradients under a
caller's autograd (megakernel route, wavefront route, mega_render
itself): losses and radiance equal eager's bit for bit, every gradient
field within two eager runs' spread, eager's launches (on the wavefront
route with the forward its backward step re-runs), later steps capture
nothing, replays under sync debug "error".
G1 (the material gather's backward) at 480,000 lanes on 2 and 3,000 rows
within 1e-4 of each row's sum of |g| of index_put_ and 1e-6 of a float64 sum,
three launches bit for bit; the inverse benchmark cell's autograd step
eager twice, captured and replayed bit for bit, one G1 launch for each
gather on the tape. H1 (the wavefront engine's threefry cipher) equal to
core/krng.py's int64 cipher bit for bit at 480,000 x 256 and 1,048,576 x 1
draws, its folds too; captured equal to eager with eager's launches; the
inverse cell's step captured with H1 equal bit for bit to the step eager
on the int64 twin, with no CUDA tensor reaching krng.cipher2x32 there or
in a wavefront render.
"""

import contextlib
import os

import numpy as np
import pytest
import torch

from qaray_tpu_torch.integrators.engine import (
    IntegratorConfig,
    render_batch_wavefront,
)
from qaray_tpu_torch.ops import analytic, megakernel, mesh_sweep, photon
from qaray_tpu_torch.ops import tiles
from qaray_tpu_torch.ops.mesh_stream import (
    StreamTris,
    stream_any_hit,
    stream_closest,
)
from qaray_tpu_torch.ops.mesh_tiles import TiledMesh, tiled_sweep
from qaray_tpu_torch.scene.compiler import compile_scene
from qaray_tpu_torch.scene.procedural import (
    icosphere,
    with_glass,
    with_mesh,
    with_texture,
)
from qaray_tpu_torch.scene.textures import load_image
from qaray_tpu_torch.scene.xml_parser import load_scene

SCENES = ["tests/assets/spot_scene.xml", "tests/assets/softdof_scene.xml"]

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")


def _t_bars(t_ref, i_ref, t_got, i_got):
    hits = (t_ref < 1e29) & (t_got < 1e29)
    rel = (t_got - t_ref).abs()[hits] / t_ref[hits].clamp_min(1.0)
    assert torch.quantile(rel.double(), 0.99).item() < 1e-5
    assert ((t_ref < 1e29) ^ (t_got < 1e29)).float().mean().item() < 0.005
    assert (i_got == i_ref)[hits].float().mean().item() > 0.995
    return hits & (i_got == i_ref)


@pytest.mark.parametrize("path", SCENES)
def test_analytic_kernels_match_plain(cuda, path):
    arr, _ = compile_scene(load_scene(path), device="cuda")
    rs = np.random.RandomState(3)
    n = 1 << 16
    p = torch.tensor(rs.uniform(-30, 30, (n, 3)).astype(np.float32),
                     device="cuda")
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d = torch.tensor(d / np.linalg.norm(d, axis=1, keepdims=True),
                     device="cuda")
    t_max = torch.tensor(rs.uniform(1, 60, n).astype(np.float32),
                         device="cuda")
    prims = arr.analytic
    _t_bars(*analytic.closest_plain(p, d, prims),
            *analytic.closest(p, d, prims))
    full_k = analytic.closest_full(p, d, prims)
    full_p = analytic.closest_full_plain(p, d, prims)
    agree = _t_bars(full_p["t"], full_p["prim_idx"], full_k["t"],
                    full_k["prim_idx"])
    for k in ("n", "p", "uvw"):
        assert (full_k[k] - full_p[k])[agree].abs().max().item() < 1e-4
    for k in ("front", "mtl"):
        assert bool((full_k[k] == full_p[k])[agree].all())
    occ_k = analytic.shadow(p, d, t_max, prims)
    occ_p = analytic.shadow_plain(p, d, t_max, prims)
    assert (occ_k != occ_p).float().mean().item() < 0.005


@pytest.mark.parametrize("n", [1, 31, 65537, 1000001])
def test_k2c_offset_view_equals_aligned(cuda, n):
    """K2c on p, d and t_max as views at a 4-byte offset (one ray a thread)
    equals K2c on their 16-byte aligned copies, bit for bit, at sizes
    where those take one ray a thread too and at 1,000,001, where they go
    in pairs with a last ray (past 3 rays a thread of the grid on up to
    162 SMs), and both are within the analytic bar of the plain version."""
    arr, _ = compile_scene(load_scene(SCENES[1]), device="cuda")
    rs = np.random.RandomState(11)
    p = rs.uniform(-30, 30, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = rs.uniform(1, 60, n).astype(np.float32)
    flat = [torch.zeros(a.size + 1, device="cuda") for a in (p, d, t_max)]
    for f, a in zip(flat, (p, d, t_max)):
        f[1:].copy_(torch.tensor(a.reshape(-1), device="cuda"))
    po, do, to = flat[0][1:].view(n, 3), flat[1][1:].view(n, 3), flat[2][1:]
    assert po.data_ptr() % 16 == 4
    pa, da, ta = (x.clone() for x in (po, do, to))
    assert pa.data_ptr() % 16 == 0
    prims = arr.analytic
    got = analytic.shadow(po, do, to, prims)
    want = analytic.shadow(pa, da, ta, prims)
    assert torch.equal(got, want)
    assert (want != analytic.shadow_plain(pa, da, ta, prims)).float().mean(
    ).item() < 0.005


def _random_rays(n, seed):
    rs = np.random.RandomState(seed)
    p = rs.uniform(-30, 30, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.tensor(p, device="cuda"), torch.tensor(d, device="cuda"))


@pytest.mark.parametrize("path", SCENES)
def test_k2b_without_uv(cuda, path):
    """K2b with want_uv False against closest_full_plain(want_uv=False) at
    the analytic bars, and equal to K2b with the uv in every output but
    uvw, which is 0 on every lane."""
    arr, _ = compile_scene(load_scene(path), device="cuda")
    prims = arr.analytic
    p, d = _random_rays(1 << 16, 5)
    full_k = analytic.closest_full(p, d, prims, want_uv=False)
    full_p = analytic.closest_full_plain(p, d, prims, want_uv=False)
    agree = _t_bars(full_p["t"], full_p["prim_idx"], full_k["t"],
                    full_k["prim_idx"])
    for k in ("n", "p"):
        assert (full_k[k] - full_p[k])[agree].abs().max().item() < 1e-4
    for k in ("front", "mtl"):
        assert bool((full_k[k] == full_p[k])[agree].all())
    with_uv = analytic.closest_full(p, d, prims)
    assert not full_k["uvw"].any() and with_uv["uvw"].any()
    for k, v in with_uv.items():
        if k != "uvw":
            assert torch.equal(full_k[k], v), k


@pytest.mark.parametrize("n", [1, 31, 65537])
def test_k2_offset_view_equals_aligned(cuda, n):
    """K2a and K2b (with and without the uv) on p and d as views at a
    4-byte offset, and on the first n of 65,537 rays, equal K2a and K2b on
    the aligned rays, bit for bit in every output."""
    arr, _ = compile_scene(load_scene(SCENES[1]), device="cuda")
    prims = arr.analytic
    p, d = _random_rays(65537, 12)
    flat = [torch.zeros(a.numel() + 1, device="cuda") for a in (p, d)]
    for f, a in zip(flat, (p, d)):
        f[1:].copy_(a.reshape(-1))
    po, do = flat[0][1:].view(-1, 3)[:n], flat[1][1:].view(-1, 3)[:n]
    assert po.data_ptr() % 16 == 4

    def outputs(p_, d_):
        t, i = analytic.closest(p_, d_, prims)
        return {"K2a t": t, "K2a prim": i,
                **{f"K2b {k}": v for k, v in
                   analytic.closest_full(p_, d_, prims).items()},
                **{f"K2b no uv {k}": v for k, v in analytic.closest_full(
                    p_, d_, prims, want_uv=False).items()}}

    want = outputs(p, d)
    for got in (outputs(po, do), outputs(p[:n], d[:n])):
        for k, v in want.items():
            assert torch.equal(got[k], v[:n]), k


def test_trace_closest_asks_for_uv_where_textured(cuda, monkeypatch):
    """trace_closest launches K2b with want_uv False on an untextured
    scene (softdof) and True on texture_scene, whose materials have
    checkers."""
    from qaray_tpu_torch.ops.trace import trace_closest

    seen = []
    full = analytic.closest_full

    def record(p, d, prims, want_uv=True, **kw):
        seen.append(want_uv)
        return full(p, d, prims, want_uv=want_uv, **kw)

    monkeypatch.setattr(analytic, "closest_full", record)
    p, d = _random_rays(4096, 13)
    for path, want in ((SCENES[1], False),
                       ("tests/assets/texture_scene.xml", True)):
        arr, meta = compile_scene(load_scene(path), device="cuda")
        before = analytic.launches["K2b"]
        trace_closest(arr, meta, p, d)
        assert analytic.launches["K2b"] == before + 1
        assert seen[-1] is want and meta.has_mtl_textures is want


def test_k2b_gradient_keeps_t_apart(cuda):
    """closest_full with p requiring a gradient (the autograd route) gives
    the outputs of the call without one, bit for bit; the t and prim_idx
    its backward rule saves share no storage with the attributes, so a
    write into an attribute leaves the backward working; and the gradient
    of t equals closest()'s."""
    arr, _ = compile_scene(load_scene(SCENES[1]), device="cuda")
    prims = arr.analytic
    p, d = _random_rays(4096, 14)
    want = analytic.closest_full(p, d, prims)
    pg = p.clone().requires_grad_(True)
    full = analytic.closest_full(pg, d, prims)
    for k, v in want.items():
        assert torch.equal(full[k].detach(), v), k
    t_base = full["t"].untyped_storage().data_ptr()
    assert t_base == full["prim_idx"].untyped_storage().data_ptr()
    assert all(v.untyped_storage().data_ptr() != t_base
               for k, v in full.items() if k not in ("t", "prim_idx"))
    full["n"].mul_(2.0)
    (g,) = torch.autograd.grad(full["t"].sum(), pg)
    pk = p.clone().requires_grad_(True)
    (g_k2a,) = torch.autograd.grad(analytic.closest(pk, d, prims)[0].sum(),
                                   pk)
    assert torch.isfinite(g).all() and g.abs().sum() > 0
    assert torch.equal(g, g_k2a)


def _compare(rad_p, t0_p, rad_k, t0_k):
    assert torch.allclose(t0_p, t0_k, rtol=1e-4, atol=1e-3)
    rad_p, rad_k = rad_p.double(), rad_k.double()
    rel = (rad_p - rad_k).abs().amax(-1) / (1.0 + rad_p.abs().amax(-1))
    assert (rel > 1e-3).double().mean().item() < 2e-3
    assert rel.median().item() < 1e-6
    assert (rad_p.mean(0) - rad_k.mean(0)).abs().max().item() < 2e-3


def _render_both(res, spp, sid0, integrator, max_bounce, words):
    scene = load_scene(SCENES[1])
    scene.camera.img_width, scene.camera.img_height = res
    arr, meta = compile_scene(scene, device="cuda")
    w, h = res
    ids = torch.arange(w * h * spp, device="cuda", dtype=torch.int32)
    px, py, sid = ids % w, (ids // w) % h, sid0 + ids // (w * h)
    cfg = IntegratorConfig(integrator=integrator, max_bounce=max_bounce)
    before = megakernel.launches["K1a"]
    rad_k, t0_k = megakernel.mega_render(arr, meta, cfg, px, py, sid, words)
    assert megakernel.launches["K1a"] == before + 1
    rad_p, t0_p = render_batch_wavefront(arr, meta, cfg, px, py, sid, words)
    _compare(rad_p, t0_p, rad_k, t0_k)


@pytest.mark.parametrize("integrator", ["pathtrace", "photonmap"])
def test_megakernel_matches_engine(cuda, integrator):
    _render_both((200, 150), 2, 0, integrator, 4, (0, 3))


@pytest.mark.parametrize("words", [(0, 3), (0, 0, 0, 0)])
@pytest.mark.parametrize("integrator", ["pathtrace", "photonmap"])
def test_megakernel_matches_engine_at_800x600(cuda, integrator, words):
    """The Renderer's shapes: 800x600 lanes, max_bounce 5, a phase-2 sample
    index. Past pixel 32768 the fold datum rid * 65536 + sid wraps in 32
    bits; a kernel that wrapped otherwise would draw other numbers."""
    _render_both((800, 600), 1, 5, integrator, 5, words)


# -- mesh kernels ------------------------------------------------------------

MESH_SCENE = "tests/assets/mesh_scene.xml"


def _ico_scene(subdiv):
    scene = load_scene(MESH_SCENE)
    if subdiv is not None:
        scene = with_mesh(scene, *icosphere(subdiv))
    return scene


def _mesh_rays(n, seed):
    """Rays around mesh_scene's icosphere (radius 8 at (0, 50, 5.1)): random
    origins in a box three radii wide, half of them aimed at the centre."""
    rs = np.random.RandomState(seed)
    c = np.array([0.0, 50.0, 5.1], np.float32)
    p = (c + rs.uniform(-24, 24, (n, 3))).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    aim = c - p
    aim /= np.linalg.norm(aim, axis=1, keepdims=True)
    d = np.where((np.arange(n) % 2 == 0)[:, None], aim + 0.05 * d, d)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = rs.uniform(1, 40, n).astype(np.float32)
    return (torch.tensor(a, device="cuda") for a in (p, d, t_max))


def _row_bars(want, got):
    """tests/test_pallas_tiles.py:43-49 on (t, row, row2)."""
    t_x, r_x, r2_x = want[:3]
    t_k, r_k, r2_k = got[:3]
    assert (r_x == r_k).float().mean().item() > 0.999
    hit = (r_x >= 0) & (r_x == r_k)
    assert torch.allclose(t_k[hit], t_x[hit], rtol=1e-5, atol=1e-5)
    agree = (r_x == r_k) & (r2_x >= 0) & (r2_k >= 0)
    assert (r2_x[agree] == r2_k[agree]).float().mean().item() > 0.99


def test_k3_matches_plain(cuda):
    arr, meta = compile_scene(_ico_scene(5), device="cuda")
    assert meta.mesh_stream
    m = arr.mesh
    p, d, t_max = _mesh_rays(1 << 16, 5)
    t_cur = torch.full_like(t_max, 1e30)
    plain = StreamTris(m.stream_coeff, m.stream_const)
    walk = mesh_sweep.walk_of(m)
    before = mesh_sweep.launches["K3"]
    got = mesh_sweep.sweep_closest(p, d, t_cur, m.stream_c16, walk=walk)
    _row_bars(stream_closest(p, d, t_cur, plain), got)
    occ = mesh_sweep.sweep_occluded(p, d, t_max, m.stream_c16, walk=walk)
    assert torch.equal(occ, stream_any_hit(p, d, t_max, plain))
    assert mesh_sweep.launches["K3"] == before + 2


def test_k3_equals_plain(cuda):
    """K3's walk against the dense sweep (stream_closest, stream_any_hit)
    on ico4 and ico5: equal (t, row, row2) and occlusion on every ray of
    random rays, of rays whose t_cur falls short of every hit (the runner-up
    beyond t_cur) and of rays aimed at the icosphere's vertices (exact ties
    in t, which go to the lower triangle id)."""
    for subdiv in (4, 5):
        arr, meta = compile_scene(_ico_scene(subdiv), device="cuda")
        m = arr.mesh
        walk = mesh_sweep.walk_of(m)
        plain = StreamTris(m.stream_coeff, m.stream_const)
        p, d, t_max = _mesh_rays(1 << 16, 6)
        corners = m.tri_v.reshape(-1, 3)
        gen = torch.Generator(device="cuda").manual_seed(subdiv)
        u = torch.randn((1 << 16, 3), device="cuda", generator=gen)
        c = torch.tensor([0.0, 50.0, 5.1], device="cuda")
        pv = c + 24.0 * u / u.norm(dim=1, keepdim=True)
        aim = corners[torch.randint(0, corners.shape[0], (1 << 16,),
                                    device="cuda", generator=gen)]
        dv = (aim - pv) / (aim - pv).norm(dim=1, keepdim=True)
        big = torch.full_like(t_max, 1e30)
        short = t_max * 0.1  # t_cur below 4: short of most hits
        for p_, d_, t_ in ((p, d, big), (p, d, short), (pv, dv, big)):
            want = stream_closest(p_, d_, t_, plain)
            got = mesh_sweep.sweep_closest(p_, d_, t_, m.stream_c16,
                                           walk=walk)
            for a, b in zip(want, got):
                assert torch.equal(a, b)
        occ = mesh_sweep.sweep_occluded(p, d, t_max, m.stream_c16, walk=walk)
        assert torch.equal(occ, stream_any_hit(p, d, t_max, plain))


def test_k1c_probe_equals_fold(cuda):
    """K1c's own mesh_closest and mesh_occluded (qr_mega_mesh_probe: the
    megakernel's tree walk) on ico5 (20,480 triangles) against the plain
    in-order fold over the same rows: (t, normal, front, material row,
    occluded) equal on every one of 2^20 rays, half of them random around
    the icosphere and half aimed exactly at its vertices; a third of them
    with an analytic t equal to their mesh hit's, a third with a budget
    equal to it."""
    arr, meta = compile_scene(_ico_scene(5), device="cuda")
    tabs = arr.kernel
    n = 1 << 20
    p, d, t_max = _mesh_rays(n // 2, 11)
    corners = arr.mesh.tri_v.reshape(-1, 3)
    gen = torch.Generator(device="cuda").manual_seed(12)
    u = torch.randn((n // 2, 3), device="cuda", generator=gen)
    c = torch.tensor([0.0, 50.0, 5.1], device="cuda")
    pv = c + 24.0 * u / u.norm(dim=1, keepdim=True)
    aim = corners[torch.randint(0, corners.shape[0], (n // 2,),
                                device="cuda", generator=gen)]
    dv = (aim - pv) / (aim - pv).norm(dim=1, keepdim=True)
    p, d = torch.cat([p, pv]), torch.cat([d, dv])
    big = torch.full((n,), 1e30, device="cuda")
    t_m, row_m, _ = megakernel.mesh_fold_plain(tabs.mesh_rows, p, d, big,
                                               big)
    third = torch.arange(n, device="cuda") % 3
    t_rand = torch.cat([t_max, t_max])
    t_a = torch.where(third == 0, big, torch.where(third == 1, t_rand, t_m))
    t_b = torch.where(third == 0, t_m, torch.where(third == 1, big, t_rand))
    got = megakernel.mesh_probe(tabs, p, d, t_a, t_b)
    want = megakernel.mesh_probe_plain(tabs.mesh_rows, tabs.mesh_attr, p, d,
                                       t_a, t_b)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and torch.equal(w, g)
    assert int(((third == 2) & (row_m >= 0)).sum()) > 10000
    assert 0 < int(got[4].sum()) < n


def _row2_bar(want, got):
    """K4a's runner-up is exact below t_cur: on the rays where the reference
    has a winner and a runner-up, the same runner-up on > 99 %."""
    has = (want[1] >= 0) & (want[2] >= 0)
    assert has.float().mean().item() > 0.01
    assert (got[2][has] == want[2][has]).float().mean().item() > 0.99


def _tiled_ico(subdiv):
    arr, meta = compile_scene(_ico_scene(subdiv), device="cuda")
    assert meta.mesh_tiled
    m = arr.mesh
    return m, TiledMesh(m.tile_coeff, m.tile_const, m.tile_gid,
                        m.tile_cbounds)


def test_k4_matches_plain(cuda):
    m, tm = _tiled_ico(6)
    p, d, t_max = _mesh_rays(1 << 16, 6)
    t_cur = torch.full_like(t_max, 1e30)
    work = torch.zeros_like(t_cur, dtype=torch.int32)
    steps = torch.zeros_like(work)
    before = dict(tiles.launches)
    single = tiles.tiled_sweep_kernel(p, d, t_cur, tm, m.tile_c16T,
                                      steps=steps, work=work,
                                      tree=m.tile_tree)
    want = tiled_sweep(p, d, t_cur, tm)
    _row_bars(want, single)
    _row2_bar(want, single)
    assert bool(single[3].all())
    # Per-ray work: whole clusters within those visited; a hit visited one.
    assert bool((work % 256 == 0).all() & (work <= 256 * steps).all())
    assert bool((steps[single[1] >= 0] > 0).all())
    # The same against the plain version with a finite t_cur.
    plain = tiles.walk_plain(p, d, t_max, m.tile_c16T, m.tile_cbounds)
    got = tiles.tiled_sweep_kernel(p, d, t_max, tm, m.tile_c16T,
                                   tree=m.tile_tree)
    _row_bars(plain, got)
    _row2_bar(plain, got)
    # Under a cap of 2 clusters a ray marked resolved has its top-2.
    capped = tiles.tiled_sweep_kernel(p, d, t_cur, tm, m.tile_c16T,
                                      tree=m.tile_tree, max_steps=2)
    res = capped[3]
    assert 0.0 < res.float().mean().item() < 1.0
    for a, b in zip(capped[:3], single[:3]):
        assert torch.equal(a[res], b[res])
    t_max[::4] = 0.0  # rays without budget need no test
    occ = tiles.tiled_sweep_kernel(p, d, t_max, tm, m.tile_c16T,
                                   tree=m.tile_tree, any_hit=True,
                                   steps=steps, work=work)
    assert torch.equal(occ, tiled_sweep(p, d, t_max, tm, any_hit=True))
    assert bool((work[::4] == 0).all()) and bool((steps[occ] > 0).all())
    assert torch.equal(work, 256 * steps)
    # Two-phase (budget 12) against single-phase (budget 0), both on the
    # coherence-sorted rays: a ray's walk takes the same clusters in the
    # same order in both, so every row is the same.
    t0, r0, s0 = tiles.tiled_closest_twophase(p, d, t_cur, tm, m.tile_c16T,
                                              tree=m.tile_tree, budget=0)
    t1, r1, s1 = tiles.tiled_closest_twophase(p, d, t_cur, tm, m.tile_c16T,
                                              tree=m.tile_tree)
    assert torch.equal(t0, t1) and torch.equal(r0, r1)
    assert torch.equal(s0, s1)
    assert tiles.launches["K4a"] == before["K4a"] + 6
    assert tiles.launches["K4b"] == before["K4b"] + 1


def test_k4_vertex_rays_open_no_hole(cuda, monkeypatch):
    """Rays aimed at ico4's vertices (jittered by 1e-4) through K4a's
    two-phase walk and ops/trace._fallback: the (t, gid) of tiled_sweep and
    the same fallback on every ray but exact ties in t, so no hole."""
    from qaray_tpu_torch.ops.mesh_stream import _chunk_test
    from qaray_tpu_torch.ops.mesh_tiles import exact_winner_rows
    from qaray_tpu_torch.ops.trace import _fallback

    monkeypatch.setenv("QARAY_STREAM_MAX_TRIS", "1")  # the tiled route
    m, tm = _tiled_ico(4)
    corners = m.tri_v.reshape(-1, 3).cpu().numpy()  # world-space vertices
    rs = np.random.RandomState(4)
    n = 1 << 16
    c = np.array([0.0, 50.0, 5.1])  # mesh_scene's icosphere, radius 8
    u = rs.normal(size=(n, 3))
    p = c + 24.0 * u / np.linalg.norm(u, axis=1, keepdims=True)
    aim = corners[rs.randint(0, corners.shape[0], n)] + 1e-4 * rs.normal(
        size=(n, 3))
    d = (aim - p) / np.linalg.norm(aim - p, axis=1, keepdims=True)
    p, d = (torch.tensor(a, dtype=torch.float32, device="cuda")
            for a in (p, d))
    t_cur = torch.full((n,), 1e30, device="cuda")

    def fallback(rows, rows2):
        return _fallback(t_cur,
                         exact_winner_rows(p, d, rows, tm, m.tri_v),
                         exact_winner_rows(p, d, rows2, tm, m.tri_v))[:2]

    def sweep_t(rows):
        r = rows.clamp_min(0).long()
        t = _chunk_test(p[:, None], d[:, None], tm.coeff[r][:, None],
                        tm.const[r][:, None])[:, 0, 0]
        return torch.where(rows >= 0, t, -1.0)

    got = tiles.tiled_closest_twophase(p, d, t_cur, tm, m.tile_c16T,
                                       tree=m.tile_tree)
    ref = tiled_sweep(p, d, t_cur, tm)
    (t_g, gid_g), (t_r, gid_r) = fallback(*got[1:]), fallback(*ref[1:])
    tie = ((sweep_t(got[1]) == sweep_t(ref[1]))
           & (sweep_t(got[2]) == sweep_t(ref[2])))
    assert bool((((gid_g == gid_r) & (t_g == t_r)) | tie).all())
    assert bool(((gid_g >= 0) | (gid_r < 0) | tie).all())
    # The exact re-test rejects some winners: the fallback was taken.
    assert bool((fallback(got[1], torch.full_like(got[1], -1))[1]
                 != gid_g).any())


def test_wavefront_ico6_cuda_matches_cpu(cuda):
    """The wavefront engine on ico6 (81,920 triangles, the tiled route: K4a's
    two-phase walk, K4b) at 200x150 x 1 spp with threefry words, on the card
    and on the CPU (walk_plain), at tests/test_megakernel.py::_compare's
    bars."""
    scene = _ico_scene(6)
    scene.camera.img_width, scene.camera.img_height = 200, 150
    cfg = IntegratorConfig(integrator="pathtrace", max_bounce=3,
                           shadow_spp=4, shadow_spp_max=8)
    outs = []
    before = dict(tiles.launches)
    for device in ("cuda", "cpu"):
        arr, meta = compile_scene(scene, device=device)
        assert meta.mesh_tiled and not meta.mesh_mega
        px, py, sid = _lanes(200, 150, 1, device)
        rad, t0 = render_batch_wavefront(arr, meta, cfg, px, py, sid, (0, 3))
        outs.append((rad.cpu().double(), t0.cpu()))
    assert tiles.launches["K4a"] > before["K4a"]
    assert tiles.launches["K4b"] > before["K4b"]
    (rad_g, t0_g), (rad_c, t0_c) = outs
    assert torch.allclose(t0_c, t0_g, rtol=1e-4, atol=1e-3)
    rel = (rad_c - rad_g).abs().amax(-1) / (1.0 + rad_c.abs().amax(-1))
    assert (rel > 1e-3).double().mean().item() < 2e-3
    assert rel.median().item() < 1e-6
    assert (rad_c.mean(0) - rad_g.mean(0)).abs().max().item() < 2e-3


@pytest.mark.parametrize("path,subdiv,bars", [
    (MESH_SCENE, None, (2e-3, 5e-3, 2e-3)),
    (MESH_SCENE, 5, (5e-3, 1e-2, 2e-3)),
    ("tests/assets/mirror_scene.xml", None, (2e-3, 5e-3, 2e-3)),
], ids=["mesh", "ico5", "mirror"])
@pytest.mark.parametrize("integrator", ["pathtrace", "photonmap"])
def test_k1c_matches_engine(cuda, integrator, path, subdiv, bars):
    """mesh_scene.xml (320 triangles), its ico5 (20,480) and mirror_scene.xml
    (a mirrored icosphere, no analytic primitive) at 200x150 x 2 spp,
    threefry words, max_bounce 3: tests/test_megakernel.py's
    test_mega_parity_mesh and test_mega_streamed_mesh_parity bars (t0 lanes
    off by > 1e-3, radiance lanes above 1e-3 relative, channel means)."""
    scene = load_scene(path)
    if subdiv is not None:
        scene = with_mesh(scene, *icosphere(subdiv))
    scene.camera.img_width, scene.camera.img_height = 200, 150
    arr, meta = compile_scene(scene, device="cuda")
    assert meta.mesh_mega
    ids = torch.arange(200 * 150 * 2, device="cuda", dtype=torch.int32)
    px, py, sid = ids % 200, (ids // 200) % 150, ids // (200 * 150)
    cfg = IntegratorConfig(integrator=integrator, max_bounce=3)
    before = megakernel.launches["K1c"]
    rad_k, t0_k = megakernel.mega_render(arr, meta, cfg, px, py, sid, (0, 5))
    assert megakernel.launches["K1c"] == before + 1
    rad_p, t0_p = render_batch_wavefront(arr, meta, cfg, px, py, sid, (0, 5))
    t_bar, rad_bar, mean_bar = bars
    assert ((t0_p - t0_k).abs() > 1e-3).float().mean().item() < t_bar
    rad_p, rad_k = rad_p.double(), rad_k.double()
    rel = (rad_p - rad_k).abs().amax(-1) / (1.0 + rad_p.abs().amax(-1))
    assert (rel > 1e-3).double().mean().item() < rad_bar
    assert (rad_p.mean(0) - rad_k.mean(0)).abs().max().item() < mean_bar


# -- textures and the other integrators -----------------------------------------

TEXTURE_SCENE = "tests/assets/texture_scene.xml"


def _lanes(w, h, spp, device):
    ids = torch.arange(w * h * spp, device=device, dtype=torch.int32)
    return ids % w, (ids // w) % h, ids // (w * h)


@pytest.mark.parametrize("variant", ["scene", "two-slot"])
@pytest.mark.parametrize("integrator", ["pathtrace", "photonmap"])
def test_k1b_matches_engine(cuda, integrator, variant):
    """texture_scene.xml at 200x150 x 2 spp, threefry words, and a variant
    with a second live slot (specular) under a rotated and translated map:
    under 0.5 % of lanes above 1e-3 relative, channel means within 2e-3
    (test_mega_checker_textures_parity), primary depth as for K1a."""
    scene = load_scene(TEXTURE_SCENE)
    if variant == "two-slot":
        scene = with_texture(scene, ("ballmtl", "specular"),
                             checker=((1.0, 0.2, 0.1), (0.1, 0.3, 1.0)),
                             scale=0.07, angle=30.0,
                             offset=(0.013, 0.027, 0.0))
    arr, meta = compile_scene(scene, device="cuda")
    assert meta.mega_tex_ok and arr.kernel.mtl.shape[1] == 102
    px, py, sid = _lanes(200, 150, 2, "cuda")
    cfg = IntegratorConfig(integrator=integrator, max_bounce=4)
    before = dict(megakernel.launches)
    rad_k, t0_k = megakernel.mega_render(arr, meta, cfg, px, py, sid, (0, 3))
    assert megakernel.launches["K1b"] == before["K1b"] + 1
    assert megakernel.launches["K1a"] == before["K1a"] + 1
    rad_p, t0_p = render_batch_wavefront(arr, meta, cfg, px, py, sid, (0, 3))
    assert torch.allclose(t0_p, t0_k, rtol=1e-4, atol=1e-3)
    rad_p, rad_k = rad_p.double(), rad_k.double()
    rel = (rad_p - rad_k).abs().amax(-1) / (1.0 + rad_p.abs().amax(-1))
    assert (rel > 1e-3).double().mean().item() < 5e-3
    assert (rad_p.mean(0) - rad_k.mean(0)).abs().max().item() < 2e-3


def _cuda_vs_cpu(scene, cfg, res=(200, 150), outliers=2e-3):
    """The wavefront engine on the card (K2b/K2c, K3 and plain torch for the
    texture stack) against the same engine on the CPU: the _compare bars."""
    scene.camera.img_width, scene.camera.img_height = res
    outs = []
    for device in ("cuda", "cpu"):
        arr, meta = compile_scene(scene, device=device)
        px, py, sid = _lanes(*res, 1, device)
        rad, t0 = render_batch_wavefront(arr, meta, cfg, px, py, sid, (0, 3))
        outs.append((rad.cpu().double(), t0.cpu()))
    (rad_g, t0_g), (rad_c, t0_c) = outs
    assert torch.allclose(t0_c, t0_g, rtol=1e-4, atol=1e-3)
    rel = (rad_c - rad_g).abs().amax(-1) / (1.0 + rad_c.abs().amax(-1))
    assert (rel > 1e-3).double().mean().item() < outliers
    assert (rad_c.mean(0) - rad_g.mean(0)).abs().max().item() < 2e-3


def test_file_textures_cuda_matches_cpu(cuda):
    """A file texture on a material, on the background and on the
    environment: the wavefront route's texture stack on the card."""
    image = load_image("tests/assets/colorBuffer.png")
    scene = load_scene("tests/assets/spot_scene.xml")
    scene = with_texture(scene, (scene.materials[0].name, "diffuse"),
                         image=image, color=(1.0, 1.0, 1.0), scale=0.5)
    scene = with_texture(scene, "background", image=image,
                         color=(1.0, 0.9, 0.8))
    scene = with_texture(scene, "environment", image=image,
                         color=(0.8, 0.9, 1.0), scale=0.5, angle=25.0)
    _cuda_vs_cpu(scene, IntegratorConfig(integrator="photonmap",
                                         max_bounce=3))


def test_checker_wavefront_cuda_matches_cpu(cuda):
    """texture_scene.xml on the wavefront route (K2b's uv, ops/texture.py
    on the card); 0.5 % of lanes may flip a checker sample (atan2 and asin
    differ in their last bits between the card and the CPU)."""
    _cuda_vs_cpu(load_scene(TEXTURE_SCENE),
                 IntegratorConfig(integrator="pathtrace", max_bounce=3),
                 outliers=5e-3)


@pytest.mark.parametrize("integrator", ["basic", "whitted", "phong", "mcgi"])
def test_integrators_cuda_match_cpu(cuda, integrator):
    _cuda_vs_cpu(load_scene("tests/assets/spot_scene.xml"),
                 IntegratorConfig(integrator=integrator, max_bounce=3,
                                  shadow_spp=4, shadow_spp_max=8,
                                  mc_samples=4,
                                  inverse_square_falloff=integrator == "mcgi"),
                 res=(80, 60))


def _caustics(res, device="cuda"):
    desc = with_glass(load_scene(SCENES[1]), "mid")
    desc.camera.img_width, desc.camera.img_height = res
    return compile_scene(desc, device=device)


def _small_maps(arr, meta):
    """Maps of tests/test_megakernel.py's _small_photon_maps sizes, built
    on the card (photon tracing on K2b)."""
    from qaray_tpu_torch.photon.build import _build_one_map
    from qaray_tpu_torch.photon.cluster import cluster_photon_map
    from qaray_tpu_torch.renderer import RendererParam

    param = RendererParam()
    gmap = _build_one_map(arr, meta, param, 400, 6, 0.2, caustics=False,
                          seed=1)
    cmap = _build_one_map(arr, meta, param, 120, 6, 1.0, caustics=True,
                          seed=2)
    return cluster_photon_map(gmap), cluster_photon_map(cmap)


@pytest.mark.parametrize("radius", [0.2, 50.0])
def test_k5_matches_plain(cuda, radius):
    arr, meta = _caustics((48, 36))
    gmap, _ = _small_maps(arr, meta)
    gen = torch.Generator(device="cuda").manual_seed(5)
    n = 1 << 15
    near = gmap.pos[torch.randint(0, 400, (n // 2,), device="cuda",
                                  generator=gen)]
    q = torch.cat([near + 0.1 * torch.randn(near.shape, device="cuda",
                                            generator=gen),
                   torch.rand((n // 2, 3), device="cuda", generator=gen)
                   * 40.0 - 20.0])
    act = (torch.arange(n, device="cuda") % 5 != 0).float()
    before = photon.launches["K5"]
    got = photon.photon_gather(gmap.ctable, gmap.cbounds, radius, q, act)
    assert photon.launches["K5"] == before + 1
    want = photon.photon_gather_plain(gmap.ctable, gmap.cbounds, radius, q,
                                      act)
    torch.cuda.synchronize()
    for w, g in zip(want[:2], got[:2]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-7)
    assert torch.equal(want[2], got[2])
    assert (got[2][act == 0] == 0).all()
    if radius > 1.0:
        assert (got[2] > 100).float().mean() > 0.5


@pytest.mark.parametrize("radius", [0.2, 50.0])
def test_k5_count_equals_flags(cuda, radius):
    """K5 launched as gather_apply launches it, on queries with a record
    first and their count in device memory, gives the sums and counts of
    the launch that reads every query's flag, bit for bit, and visits no
    cluster for a query without a record."""
    arr, meta = _caustics((48, 36))
    gmap, _ = _small_maps(arr, meta)
    gen = torch.Generator(device="cuda").manual_seed(6)
    n = 1 << 15
    q = gmap.pos[torch.randint(0, 400, (n,), device="cuda", generator=gen)]
    q = q + 0.1 * torch.randn(q.shape, device="cuda", generator=gen)
    act = (torch.rand(n, device="cuda", generator=gen) > 0.9).float()
    order = torch.argsort((act < 0.5).to(torch.int32), stable=True)
    q, act = q[order].contiguous(), act[order].contiguous()
    count = (act > 0.5).sum(dtype=torch.int32).reshape(1)
    work = torch.full((n,), -1, dtype=torch.int32, device="cuda")
    got = photon.photon_gather(gmap.ctable, gmap.cbounds, radius, q, act,
                               count=count, work=work)
    want = photon.photon_gather(gmap.ctable, gmap.cbounds, radius, q, act)
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    assert (work[act < 0.5] == 0).all() and (work[act > 0.5] > 0).any()


@pytest.mark.parametrize("radius", [0.2, 50.0])
def test_k1d_matches_engine(cuda, radius):
    """caustics_scene at 200x150 x 2 spp, threefry: lanes that are not
    escalated within the bars of test_mega_photon_gather_parity, with its
    share of lanes off cut to 1e-4 and held against a control without the
    caustics map; with the
    radius of both maps at 50 every gather is over the cap: over 0.3 of
    the lanes flagged and no unflagged lane off."""
    from qaray_tpu_torch.photon.cluster import cluster_photon_map

    arr, meta = _caustics((200, 150))
    gmap, cmap = _small_maps(arr, meta)
    if radius > 1.0:
        gmap = gmap._replace(radius=torch.tensor(radius))
        cmap = cmap._replace(radius=torch.tensor(radius))
    cfg = IntegratorConfig(integrator="photonmap", max_bounce=4,
                           shadow_spp=4, shadow_spp_max=8,
                           use_photon_map=True)
    px, py, sid = _lanes(200, 150, 2, "cuda")
    before = dict(megakernel.launches)
    rad_k, t0_k, irr_k, esc = megakernel.mega_render(
        arr, meta, cfg, px, py, sid, (0, 3), photon_maps=(gmap, cmap))
    assert megakernel.launches["K1d"] == before["K1d"] + 1
    rad_p, t0_p, irr_p = render_batch_wavefront(
        arr, meta, cfg, px, py, sid, (0, 3), photon_maps=(gmap, cmap),
        want_aux=True)
    ok = ~esc
    rel = ((rad_p - rad_k).abs().amax(-1)
           / (1.0 + rad_p.abs().amax(-1)))[ok]
    if radius > 1.0:
        assert esc.float().mean().item() > 0.3
        assert (rel > 1e-3).sum().item() == 0
        return
    assert esc.float().mean().item() < 0.01
    assert (rel > 1e-3).float().mean().item() < 1e-4
    # The control: with its caustics map emptied the kernel is off on ten
    # times that share, so the bar sees a skipped caustics gather.
    no_caustics = cluster_photon_map(cmap._replace(
        valid=torch.zeros_like(cmap.valid), ctable=None, cbounds=None))
    rad_c = megakernel.mega_render(arr, meta, cfg, px, py, sid, (0, 3),
                                   photon_maps=(gmap, no_caustics))[0]
    rel_c = ((rad_p - rad_c).abs().amax(-1)
             / (1.0 + rad_p.abs().amax(-1)))[ok]
    assert (rel_c > 1e-3).float().mean().item() > 1e-3
    mean_err = (rad_p[ok].mean(0) - rad_k[ok].mean(0)).abs().max().item()
    assert mean_err < 2e-3
    assert (irr_p == irr_k).float().mean().item() > 0.999


def test_renderer_photon_render(cuda, tmp_path, monkeypatch):
    """-use-photon-map through the Renderer on the card: K1d and K5
    launched, the maps written into the working directory, the image and
    the irradiance plane filled."""
    from qaray_tpu_torch.renderer import Renderer, RendererParam

    desc = with_glass(load_scene(SCENES[1]), "mid")
    monkeypatch.chdir(tmp_path)
    desc.camera.img_width, desc.camera.img_height = 160, 120
    r = Renderer(RendererParam(use_photon_map=True, photon_map_size=2000,
                               caustics_map_size=300, spp_min=2, spp_max=4),
                 device="cuda")
    r.compute_scene(desc)
    before = (megakernel.launches["K1d"], photon.launches["K5"])
    fb = r.render()
    assert megakernel.launches["K1d"] > before[0]
    assert photon.launches["K5"] > before[1]
    assert np.isfinite(fb.mean).all() and fb.mean.mean() > 0
    assert (fb.count >= 2).all() and (fb.count <= 4).all()
    assert 0 < (fb.irrad > 0).mean() < 1
    assert (tmp_path / "photonmap.dat").stat().st_size == 2000 * 26
    assert (tmp_path / "caustics.dat").stat().st_size == 300 * 26


# -- gradients ---------------------------------------------------------------


def _grad_scene(name, res):
    """spot_scene, mesh_scene or the glass scene (softdof with its depth of
    field 0 and a glass middle sphere) compiled on the card."""
    if name == "glass":
        scene = with_glass(load_scene(SCENES[1]), "mid")
        scene.camera.depth_of_field = 0.0
    else:
        scene = load_scene(f"tests/assets/{name}_scene.xml")
    scene.camera.img_width, scene.camera.img_height = res
    return compile_scene(scene, device="cuda")


def _field_errors(got, want):
    """max|a - b| over max|b| (tests/test_grad.py's measure)."""
    a, b = got.double().cpu(), want.double().cpu()
    scale = b.abs().max().clamp_min(1e-30)
    return ((a - b).abs().max() / scale).item()


@pytest.mark.parametrize("name", ["spot", "mesh", "glass"])
def test_k6_matches_plain(cuda, name):
    """K6 against adjoint_render_plain at 64x48, max_bounce 3, threefry:
    every field within 3e-2 of its max|b|; one launch counted."""
    from qaray_tpu_torch import diff
    from qaray_tpu_torch.ops import adjoint

    arr, meta = _grad_scene(name, (64, 48))
    cfg = IntegratorConfig(integrator="pathtrace", max_bounce=3,
                           shadow_spp=4, shadow_spp_max=8)
    assert adjoint.adjoint_supported(meta, cfg)
    px, py, sid = _lanes(64, 48, 1, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    ct = torch.randn((px.shape[0], 3), device="cuda", generator=gen)
    before = adjoint.launches["K6"]
    got = adjoint.adjoint_render(arr, meta, cfg, px, py, sid, (0, 3), ct)
    assert adjoint.launches["K6"] == before + 1
    want = adjoint.adjoint_render_plain(arr, meta, cfg, px, py, sid, (0, 3),
                                        ct)
    g, w = (diff._unpack_adjoint(x, meta, arr) for x in (got, want))
    for f in diff.DiffParams._fields[:7] + ("background", "environment"):
        gf, wf = getattr(g, f), getattr(w, f)
        if wf.abs().max() == 0:
            assert gf.abs().max() < 1e-6, f
            continue
        assert _field_errors(gf, wf) < 3e-2, f


@pytest.mark.parametrize("name", ["spot", "mesh", "glass"])
def test_k6_twice_same_bits(cuda, name):
    """Two K6 launches on the same inputs give the same bits: its sums
    have a fixed order (800x600 at 65,536 lanes, max_bounce 5)."""
    from qaray_tpu_torch.ops import adjoint

    arr, meta = _grad_scene(name, (800, 600))
    cfg = IntegratorConfig(integrator="pathtrace", max_bounce=5,
                           shadow_spp=16)
    ids = torch.arange(1 << 16, device="cuda", dtype=torch.int32)
    px, py, sid = ids % 800, ids // 800, ids * 0
    gen = torch.Generator(device="cuda").manual_seed(1)
    ct = torch.randn((px.shape[0], 3), device="cuda", generator=gen)
    runs = [adjoint.adjoint_render(arr, meta, cfg, px, py, sid, (0, 3), ct)
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])


def test_render_value_and_grad_launches_k6(cuda, monkeypatch):
    """The fast route on the card is K1a forward and one K6 launch, and
    gives the autograd route's gradients (QARAY_NO_MEGAKERNEL) within 3e-2
    of each field's max|b|."""
    from qaray_tpu_torch import diff
    from qaray_tpu_torch.ops import adjoint

    arr, meta = _grad_scene("spot", (64, 48))
    cfg = IntegratorConfig(integrator="pathtrace", max_bounce=3,
                           shadow_spp=4, shadow_spp_max=8)
    px, py, sid = _lanes(64, 48, 1, "cuda")
    before = (megakernel.launches["K1a"], adjoint.launches["K6"])
    loss, got = diff.render_value_and_grad(arr, meta, cfg, px, py, sid,
                                           (0, 3))
    assert (megakernel.launches["K1a"], adjoint.launches["K6"]) == (
        before[0] + 1, before[1] + 1)
    monkeypatch.setenv("QARAY_NO_MEGAKERNEL", "1")
    loss_a, want = diff.render_value_and_grad(arr, meta, cfg, px, py, sid,
                                              (0, 3))
    assert adjoint.launches["K6"] == before[1] + 1
    torch.testing.assert_close(loss, loss_a, rtol=1e-4, atol=1e-6)
    for f in diff.DiffParams._fields:
        gf, wf = getattr(got, f), getattr(want, f)
        if wf.abs().max() == 0:
            assert gf.abs().max() < 1e-6, f
            continue
        assert _field_errors(gf, wf) < 3e-2, f


def test_render_batch_gradients_on_megakernel_route(cuda):
    """render_batch on the megakernel route (K1a forward) carries
    gradients to the DiffParams leaves: those of render_with_params."""
    from qaray_tpu_torch import diff
    from qaray_tpu_torch.integrators.engine import render_batch

    arr, meta = _grad_scene("spot", (64, 48))
    cfg = IntegratorConfig(integrator="pathtrace", max_bounce=3,
                           shadow_spp=4, shadow_spp_max=8)
    px, py, sid = _lanes(64, 48, 2, "cuda")
    ct = torch.rand((px.shape[0], 3), device="cuda")
    params = diff.DiffParams(*(t.detach().requires_grad_()
                               for t in diff.extract_params(arr)))
    before = megakernel.launches["K1a"]
    rad, _ = render_batch(diff.splice_params(arr, params), meta, cfg, px, py,
                          sid, (0, 3))
    assert megakernel.launches["K1a"] == before + 1
    got = torch.autograd.grad((rad * ct).sum(), params, allow_unused=True)
    rad_w = diff.render_with_params(arr, meta, cfg, params, px, py, sid,
                                    (0, 3))
    want = torch.autograd.grad((rad_w * ct).sum(), params,
                               allow_unused=True)
    for f, g, w in zip(diff.DiffParams._fields, got, want):
        if w is None:
            assert g is None or g.abs().max() == 0, f
            continue
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("scene,world", [("mesh_scene", True),
                                         ("grid_scene", False),
                                         ("mesh_scene", False)])
def test_w1_equals_plain(cuda, scene, world):
    """W1 (csrc/bvh.cu) on mesh_scene's world tree, on grid_scene's 25
    transformed instances and on 300 transformed instances of mesh_scene's
    icosphere, one mirrored (scene.procedural.scatter_instances, more than
    one of the chunks a block stages), against its plain walk, bit for
    bit: closest hits and occlusion, the latter also with a third of the
    rays occluded on entry, on the camera rays of a 200x150 frame (for the
    300 instances, 16,384 rays around them, half aimed at the icosphere's
    centre)."""
    from qaray_tpu_torch.integrators.engine import generate_camera_rays
    from qaray_tpu_torch.ops import bvh_packed
    from qaray_tpu_torch.scene.procedural import scatter_instances

    desc = load_scene(f"tests/assets/{scene}.xml")
    desc.camera.img_width, desc.camera.img_height = 200, 150
    arr, meta = compile_scene(desc, device="cuda", world_bvh=world)
    tabs = ((arr.mesh.pnodes, arr.mesh.ltri, arr.instances.proot[:1], None)
            if world else (arr.mesh.pnodes, arr.mesh.ltri,
                           arr.instances.proot, arr.kernel.inst_xf))
    if scene == "mesh_scene" and not world:
        xf = torch.tensor(scatter_instances(
            arr.kernel.inst_xf[0].cpu().numpy(), 300, 5), device="cuda")
        tabs = (tabs[0], tabs[1], tabs[2][:1].repeat(300).contiguous(), xf)
        gen = torch.Generator(device="cuda").manual_seed(7)
        n = 1 << 14
        c = torch.tensor((0.0, 50.0, 5.1), device="cuda")
        p = c + (torch.rand((n, 3), device="cuda", generator=gen) * 2 - 1
                 ) * 24.0
        d = torch.randn((n, 3), device="cuda", generator=gen)
        aim = torch.where((torch.arange(n, device="cuda") % 2 == 0)[:, None],
                          c - p, d)
        d = (aim / aim.norm(dim=1, keepdim=True)).contiguous()
        p = p.contiguous()
    else:
        p, d, *_ = generate_camera_rays(arr, meta,
                                        *_lanes(200, 150, 1, "cuda"), None)
        p, d = p.contiguous(), d.contiguous()
    n = p.shape[0]
    t = torch.full((n, ), 1e30, device="cuda")
    kw = dict(stack_size=meta.bvh_depth + 2)
    got = bvh_packed.closest(p, d, t, *tabs, **kw)
    want = bvh_packed.closest(p, d, t, *tabs, plain=True, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (got[2] >= 0).any()
    if tabs[3] is not None and tabs[3].shape[0] > bvh_packed.CHUNK:
        assert (got[1] >= bvh_packed.CHUNK).any() and (got[1] == 1).any()
    t_max = torch.full((n, ), 60.0, device="cuda")
    for occ_in in (None, torch.arange(n, device="cuda") % 3 == 0):
        occ = bvh_packed.occluded(p, d, t_max, occ_in, *tabs, **kw)
        assert torch.equal(occ, bvh_packed.occluded(
            p, d, t_max, occ_in, *tabs, plain=True, **kw))
        assert occ.any() and not occ.all()


def test_no_pallas_takes_plain_versions(cuda, monkeypatch):
    """QARAY_NO_PALLAS (and meta.force_xla) send trace_closest and
    trace_shadow to the plain versions on the card: no K2b, K2c, K3 or W1
    launch, the kernels' hits within tests/test_pallas.py's bars and
    occlusion on all but 0.5 % of the rays."""
    from qaray_tpu_torch.ops import bvh_packed, trace

    arr, meta = compile_scene(load_scene("tests/assets/grid_scene.xml"),
                              device="cuda", world_bvh=False)
    gen = torch.Generator(device="cuda").manual_seed(1)
    n = 1 << 14
    p = (arr.camera.pos + 0.1 * torch.randn((n, 3), device="cuda",
                                            generator=gen)).contiguous()
    aim = torch.rand((n, 3), device="cuda", generator=gen) * 8.0 - 4.0
    d = ((aim - p) / (aim - p).norm(dim=1, keepdim=True)).contiguous()
    t_max = torch.full((n, ), 60.0, device="cuda")
    want = trace.trace_closest(arr, meta, p, d)
    want_occ = trace.trace_shadow(arr, meta, p, d, t_max)
    counts = (analytic.launches, bvh_packed.launches)
    before = [dict(c) for c in counts]
    for forced in ("env", "meta"):
        if forced == "env":
            monkeypatch.setenv("QARAY_NO_PALLAS", "1")
            m = meta
        else:
            monkeypatch.delenv("QARAY_NO_PALLAS")
            m = meta._replace(force_xla=True)
        got = trace.trace_closest(arr, m, p, d)
        occ = trace.trace_shadow(arr, m, p, d, t_max)
        assert [dict(c) for c in counts] == before
        assert (occ != want_occ).float().mean().item() < 0.005
        _t_bars(want["t"], want["mtl"], got["t"], got["mtl"])


# -- sharded rendering and gradients -----------------------------------------


@pytest.mark.parametrize("impl", ["rbg", "threefry2x32"])
def test_sharded_render_batch_equals_single(cuda, impl):
    """shard_render_batch over ["cuda:0", "cuda:0"] on softdof's 200x150 x
    2 lanes: every output equal to one render_batch's, bit for bit, with
    K1a launched once a shard."""
    from qaray_tpu_torch.core.rng import key_words
    from qaray_tpu_torch.integrators.engine import render_batch
    from qaray_tpu_torch.parallel.mesh import (
        make_render_mesh,
        shard_render_batch,
    )

    arr, meta = compile_scene(load_scene(SCENES[1]), device="cuda")
    cfg = IntegratorConfig(integrator="pathtrace", max_bounce=5,
                           shadow_spp=16)
    px, py, sid = _lanes(200, 150, 2, "cuda")
    words = key_words(impl, 0)
    want = render_batch(arr, meta, cfg, px, py, sid, words, want_aux=True)
    before = megakernel.launches["K1a"]
    got = shard_render_batch(make_render_mesh(["cuda:0"] * 2))(
        arr, meta, cfg, px, py, sid, words, want_aux=True)
    assert megakernel.launches["K1a"] == before + 2
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_sharded_renderer_equals_single(cuda):
    """Renderer(num_devices=2) on one card (a one-device mesh) and a
    Renderer over ["cuda:0", "cuda:0"] with rank-debug planes give the
    single-device render's planes bit for bit (softdof at 200x150)."""
    from qaray_tpu_torch.parallel.mesh import make_render_mesh
    from qaray_tpu_torch.renderer import Renderer, RendererParam

    desc = load_scene(SCENES[1])
    desc.camera.img_width, desc.camera.img_height = 200, 150
    fbs = []
    for kw, mesh in (({}, None), (dict(num_devices=2), None),
                     (dict(rank_debug=True),
                      make_render_mesh(["cuda:0"] * 2))):
        r = Renderer(RendererParam(**kw), device="cuda", mesh=mesh)
        r.compute_scene(desc)
        fbs.append(r.render())
        if kw.get("num_devices"):
            assert r._mesh.size == min(2, torch.cuda.device_count())
    for fb in fbs[1:]:
        for k in ("mean", "color_std", "count", "zbuffer", "img"):
            assert np.array_equal(getattr(fb, k), getattr(fbs[0], k)), k
    assert np.array_equal(r._rank_mask.cpu().numpy(), fbs[2].count)


def test_sharded_photon_renderer(cuda, tmp_path, monkeypatch):
    """caustics_scene with -use-photon-map over ["cuda:0", "cuda:0"] at
    160x120: K1d and K5 once a shard, counts equal and mean within 1e-5 of
    the unsharded render."""
    from qaray_tpu_torch.parallel.mesh import make_render_mesh
    from qaray_tpu_torch.renderer import Renderer, RendererParam

    desc = with_glass(load_scene(SCENES[1]), "mid")
    desc.camera.img_width, desc.camera.img_height = 160, 120
    monkeypatch.chdir(tmp_path)
    fbs, k1d = [], []
    for mesh in (None, make_render_mesh(["cuda:0"] * 2)):
        r = Renderer(RendererParam(use_photon_map=True), device="cuda",
                     mesh=mesh)
        r.compute_scene(desc)
        before = megakernel.launches["K1d"]
        fbs.append(r.render())
        k1d.append(megakernel.launches["K1d"] - before)
    assert k1d[1] == 2 * k1d[0] > 0
    assert np.array_equal(fbs[0].count, fbs[1].count)
    np.testing.assert_allclose(fbs[0].mean, fbs[1].mean, atol=1e-5)


@pytest.mark.parametrize("route", ["fast", "autograd"])
def test_sharded_gradient_matches_single(cuda, route, monkeypatch):
    """render_value_and_grad over ["cuda:0", "cuda:0"] on spot_scene's
    64x48 lanes against one device: every field within 1e-5 of 1 +
    max|b|; the fast route launches K1a and K6 once a shard."""
    from qaray_tpu_torch import diff
    from qaray_tpu_torch.ops import adjoint
    from qaray_tpu_torch.parallel.mesh import make_render_mesh

    if route == "autograd":
        monkeypatch.setenv("QARAY_NO_MEGAKERNEL", "1")
    arr, meta = _grad_scene("spot", (64, 48))
    cfg = IntegratorConfig(integrator="pathtrace", max_bounce=5,
                           shadow_spp=16)
    px, py, sid = _lanes(64, 48, 1, "cuda")
    loss_1, want = diff.render_value_and_grad(arr, meta, cfg, px, py, sid,
                                              (0, 3))
    before = adjoint.launches["K6"]
    loss_2, got = diff.render_value_and_grad(
        arr, meta, cfg, px, py, sid, (0, 3),
        mesh=make_render_mesh(["cuda:0"] * 2))
    assert adjoint.launches["K6"] - before == (2 if route == "fast" else 0)
    torch.testing.assert_close(loss_2, loss_1, rtol=0, atol=1e-6)
    for f in diff.DiffParams._fields:
        a, b = getattr(got, f).double(), getattr(want, f).double()
        err = (a - b).abs().max() / (1.0 + b.abs().max())
        assert err.item() <= 1e-5, f


def test_two_process_cli_equals_single(cuda, tmp_path):
    """Two ranks of the CLI with -multihost on the card (gloo, both on
    cuda:0) at 200x150 x 2 spp: the primary's colour buffer equal to a
    single-process render's bit for bit, rank 1 writes no colour buffer,
    the rank-debug mask planes sum to the spp."""
    import os
    import socket
    import subprocess
    import sys

    from PIL import Image

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    args = [sys.executable, "-m", "qaray_tpu_torch.cli",
            os.path.join(repo, SCENES[1]), "-res", "200x150", "-spp", "2"]
    env = dict(os.environ, PYTHONPATH=repo)
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    procs = [subprocess.Popen(
        args + ["-multihost", "-coordinator", f"localhost:{port},2,{r}",
                "-rank-debug", "-out", str(tmp_path / f"mh{r}_")],
        env=env, cwd=tmp_path, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out[-3000:]
        assert f"multihost: process {r}/2, 2 devices" in out and "(gloo)" in out
    assert not (tmp_path / "mh1_colorBuffer.png").exists()
    single = subprocess.run(args + ["-out", str(tmp_path / "sp_")], env=env,
                            cwd=tmp_path, capture_output=True, text=True,
                            timeout=300)
    assert single.returncode == 0, single.stdout + single.stderr

    def png(name):
        return np.asarray(Image.open(tmp_path / name)).astype(int)

    assert np.array_equal(png("mh0_colorBuffer.png"), png("sp_colorBuffer.png"))
    assert np.all(png("mh0_rank0_maskBuffer.png")
                  + png("mh1_rank1_maskBuffer.png") == 2)


# -- captured execution (utils/compiled.py) ----------------------------------


def _replay_under_sync_error(fn):
    """fn() with torch.cuda.set_sync_debug_mode("error"): a synchronizing
    call on the replay path raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _captured_equals_eager(call):
    """call() under compiled.eager(), then captured (its first call
    captures) and replayed under sync debug "error": the replay's outputs
    equal the eager ones bit for bit and capture nothing. Returns the
    captures of the first captured call."""
    from qaray_tpu_torch.utils import compiled

    with compiled.eager():
        want = call()
    before = compiled.stats["captures"]
    first = call()
    captured = compiled.stats["captures"] - before
    got = _replay_under_sync_error(call)
    assert compiled.stats["captures"] - before == captured
    for a, b, c in zip(want, first, got):
        assert torch.equal(a, b) and torch.equal(a, c)
    return captured


def _route_case(route, monkeypatch):
    """(scene arrays, meta, config, lanes, photon maps) of a render_batch
    route, its route switches set."""
    maps = None
    cfg = IntegratorConfig(integrator="pathtrace", max_bounce=5,
                           shadow_spp=16)
    if route in ("megakernel", "wavefront"):
        arr, meta = compile_scene(load_scene(SCENES[1]), device="cuda")
        if route == "wavefront":
            monkeypatch.setenv("QARAY_NO_MEGAKERNEL", "1")
    elif route == "k3":
        desc = load_scene("tests/assets/mesh_scene.xml")
        arr, meta = compile_scene(desc, device="cuda")
        monkeypatch.setenv("QARAY_NO_MEGAKERNEL", "1")
        assert meta.mesh_stream
    elif route == "k4":
        monkeypatch.setenv("QARAY_STREAM_MAX_TRIS", "1")
        monkeypatch.setenv("QARAY_NO_MEGAKERNEL", "1")
        arr, meta = compile_scene(_ico_scene(5), device="cuda")
        assert meta.mesh_tiled
    elif route == "w1":
        arr, meta = compile_scene(load_scene("tests/assets/grid_scene.xml"),
                                  device="cuda", world_bvh=False)
    else:  # k1d: caustics_scene, its global radius blown up to escalate
        arr, meta = _caustics((200, 150))
        g, c = _small_maps(arr, meta)
        maps = (g._replace(radius=torch.tensor(50.0)), c)
        cfg = IntegratorConfig(integrator="photonmap", max_bounce=5,
                               shadow_spp=16, use_photon_map=True)
    px, py, sid = _lanes(200, 150, 1, "cuda")
    return arr, meta, cfg, (px % meta.img_width, py % meta.img_height,
                            sid), maps


@pytest.mark.parametrize("route", ["megakernel", "wavefront", "k3", "k4",
                                   "w1", "k1d"])
def test_captured_render_batch_equals_eager(cuda, route, monkeypatch):
    """render_batch on each route (K1a; K2b/K2c on the wavefront engine;
    K3; K4a/K4b; W1 per instance; K1d with K5 and escalated lanes, whose
    exact re-render on the captured wavefront engine equals its eager one
    too) at 200x150 lanes: captured equals eager bit for bit, a replay
    under sync debug "error" captures nothing."""
    from qaray_tpu_torch.integrators.engine import (
        render_batch,
        render_batch_wavefront,
    )

    arr, meta, cfg, lanes, maps = _route_case(route, monkeypatch)
    words = (0, 3)
    assert _captured_equals_eager(lambda: render_batch(
        arr, meta, cfg, *lanes, words, maps, want_aux=True)) >= 1
    if route == "k1d":
        esc = render_batch(arr, meta, cfg, *lanes, words, maps,
                           want_aux=True)[-1]
        assert bool(esc.any())
        idx = torch.nonzero(esc).squeeze(1)
        n = 1 << max(8, (idx.numel() - 1).bit_length())
        pad = n - idx.numel()
        sub = [torch.cat([x[idx], x.new_zeros(pad)]) for x in lanes]
        _captured_equals_eager(lambda: render_batch_wavefront(
            arr, meta, cfg, *sub, words, maps))


def test_captured_folds_equal_eager(cuda):
    """accumulate_round (with skipped lanes, the irradiance plane and dump
    lanes), accumulate_contig and the convergence mask: the same folds on
    two states, eager and captured, give the same planes bit for bit; a
    second pass over new tensors of the same shapes captures nothing."""
    from qaray_tpu_torch.fb import device_accum
    from qaray_tpu_torch.fb.framebuffer import FrameBuffer
    from qaray_tpu_torch.utils import compiled

    w, h = 64, 48
    gen = torch.Generator(device="cuda").manual_seed(0)

    def folds(state):
        for s in range(3):
            ids = torch.randperm(w * h, device="cuda", generator=gen)[:1000]
            ids = torch.cat([ids, torch.full((24,), w * h, device="cuda")])
            colors = torch.rand((1024, 3), device="cuda", generator=gen)
            skip = torch.rand(1024, device="cuda", generator=gen) < 0.1
            irr = torch.rand(1024, device="cuda", generator=gen) < 0.5
            device_accum.accumulate_round(state, ids.int(), colors,
                                          skip=skip, irr=irr)
            device_accum.accumulate_contig(state, 100, colors[:512],
                                           skip=skip[:512], irr=irr[:512])
        return device_accum.unconverged_ids(state, (0.01, 0.01, 0.01), 2)

    gen.manual_seed(0)
    with compiled.eager():
        want = device_accum.init_state(FrameBuffer(w, h), "cuda", True)
        ids_want = folds(want)
    gen.manual_seed(0)
    got = device_accum.init_state(FrameBuffer(w, h), "cuda", True)
    ids_got = folds(got)
    before = compiled.stats["captures"]
    gen.manual_seed(0)
    again = device_accum.init_state(FrameBuffer(w, h), "cuda", True,
                                    into=got)
    folds(again)
    assert compiled.stats["captures"] == before
    assert np.array_equal(ids_want, ids_got)
    for k in want:  # the dump row (the last) takes any of its lanes
        assert torch.equal(want[k][:-1], got[k][:-1]), k


def test_captured_fast_gradients_over_changing_steps(cuda):
    """Three steps of the fast route (K1a + K6) on spot_scene with the
    material and light parameters changed every step: captured equals eager
    bit for bit, the gradients change from step to step, and only the
    first step captures."""
    from qaray_tpu_torch import diff
    from qaray_tpu_torch.utils import compiled

    arr, meta = _grad_scene("spot", (200, 150))
    cfg = IntegratorConfig(integrator="pathtrace", max_bounce=5,
                           shadow_spp=16)
    px, py, sid = _lanes(200, 150, 1, "cuda")
    base = diff.extract_params(arr)

    def steps(mode):
        outs, caps = [], []
        for s in range(3):
            params = diff.DiffParams(*(t * (1.0 + 0.1 * s) for t in base))
            scene = diff.splice_params(arr, params)
            before = compiled.stats["captures"]
            with mode():
                out = diff.render_value_and_grad(scene, meta, cfg, px, py,
                                                 sid + s, (0, 5))
            caps.append(compiled.stats["captures"] - before)
            outs.append(out)
        return outs, caps

    want, _ = steps(compiled.eager)
    got, caps = steps(contextlib.nullcontext)
    assert caps[1:] == [0, 0]
    again, caps_again = steps(contextlib.nullcontext)
    assert caps_again == [0, 0, 0]
    for w_, g_, a_ in zip(want, got, again):
        assert torch.equal(w_[0], g_[0]) and torch.equal(w_[0], a_[0])
        for x, y in zip(w_[1], g_[1]):
            assert torch.equal(x, y)
    assert not torch.equal(want[0][1].mtl_diffuse, want[1][1].mtl_diffuse)


def test_captured_photon_map_equals_eager(cuda):
    """caustics_scene's maps at 200x150 (global and caustics, several batch
    sizes): the captured photon batch gives the eager maps bit for bit; a
    second build captures nothing."""
    from qaray_tpu_torch.utils import compiled

    arr, meta = _caustics((200, 150))
    with compiled.eager():
        want = _small_maps(arr, meta)
    got = _small_maps(arr, meta)
    before = compiled.stats["captures"]
    again = _small_maps(arr, meta)
    assert compiled.stats["captures"] == before
    for a, b, c in zip(want, got, again):
        for f in a._fields:
            x, y, z = getattr(a, f), getattr(b, f), getattr(c, f)
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y.to(x.device)) and torch.equal(
                    x, z.to(x.device)), f


def test_renders_and_orbit_frames_capture_once(cuda, tmp_path, monkeypatch):
    """Renderer.render() twice on mesh_scene, then three frames of the
    preview server's /orbit (each recompiles the scene with a new camera):
    only the first render captures; every orbit frame equals its eager
    render bit for bit."""
    from qaray_tpu_torch.renderer import Renderer, RendererParam
    from qaray_tpu_torch.utils import compiled
    from qaray_tpu_torch.viz.serve import RenderServer

    desc = load_scene(os.path.abspath("tests/assets/mesh_scene.xml"))
    monkeypatch.chdir(tmp_path)
    r = Renderer(RendererParam(spp_min=2, spp_max=4), device="cuda")
    r.compute_scene(desc)
    r.render()
    before = compiled.stats["captures"]
    r.render()
    assert compiled.stats["captures"] == before
    server = RenderServer(r, desc)
    caps = []
    for _ in range(3):
        start = compiled.stats["captures"]
        server.orbit(dyaw=15.0)
        server._worker.join()
        caps.append(compiled.stats["captures"] - start)
        got = server._fb_snapshot
        with compiled.eager():
            e = Renderer(RendererParam(spp_min=2, spp_max=4), device="cuda")
            e.compute_scene(desc)
            want = e.render()
        for k in ("mean", "color_std", "count"):
            assert np.array_equal(getattr(got, k), getattr(want, k)), k
    assert caps == [0, 0, 0], caps


# -- the gradient's autograd route and render_batch under autograd, captured


def _counts():
    """Every launch counter a replay adds to (utils/compiled.py)."""
    from qaray_tpu_torch.utils import compiled

    return compiled._snapshot()


def _moved(before, after):
    return {k: after[k] - v for k, v in before.items() if after[k] != v}


def _within_eager_spread(eager, again, got, what):
    """Each DiffParams field of got no further from eager than the second
    eager run is (bit for bit where the two eager runs agree); returns the
    spreads (max |eager - again|) by field."""
    from qaray_tpu_torch import diff

    spreads = {}
    for f, a, b, c in zip(diff.DiffParams._fields, eager, again, got):
        spread = (a - b).abs().max().item()
        off = (c - a).abs().max().item()
        assert off <= spread, f"{what}: {f} {off:.3g} apart, eager {spread:.3g}"
        spreads[f] = spread
    return spreads


@pytest.mark.parametrize("name", ["spot", "mesh"])
def test_captured_autograd_step_over_changing_steps(cuda, name, monkeypatch):
    """The autograd route's step (QARAY_NO_MEGAKERNEL: K2b/K2c, K3 on
    mesh_scene) at 200x150, max_bounce 5, over three steps with the
    material and light parameters changed every step, eager twice and
    captured twice (a fourth captured call replayed under sync debug
    "error"): the losses equal eager's bit for bit, every field within the
    two eager runs' spread, the same launches as eager; only the first
    captured step captures, and the gradients move between steps."""
    from qaray_tpu_torch import diff
    from qaray_tpu_torch.utils import compiled

    monkeypatch.setenv("QARAY_NO_MEGAKERNEL", "1")
    arr, meta = _grad_scene(name, (200, 150))
    cfg = IntegratorConfig(integrator="pathtrace", max_bounce=5,
                           shadow_spp=16)
    px, py, sid = _lanes(200, 150, 1, "cuda")
    base = diff.extract_params(arr)

    def step(s):
        params = diff.DiffParams(*(t * (1.0 + 0.1 * s) for t in base))
        return diff.render_value_and_grad(diff.splice_params(arr, params),
                                          meta, cfg, px, py, sid + s, (0, 5))

    def steps(mode):
        outs, caps = [], []
        counts = _counts()
        for s in range(3):
            before = compiled.stats["captures"]
            with mode():
                outs.append(step(s))
            caps.append(compiled.stats["captures"] - before)
        torch.cuda.synchronize()
        return outs, caps, _moved(counts, _counts())

    want, _, eager_counts = steps(compiled.eager)
    again, _, _ = steps(compiled.eager)
    got, caps, got_counts = steps(contextlib.nullcontext)
    assert caps[0] >= 1 and caps[1:] == [0, 0], caps
    replay, caps_replay, _ = steps(contextlib.nullcontext)
    assert caps_replay == [0, 0, 0]
    assert got_counts == eager_counts and eager_counts[
        ("qaray_tpu_torch.ops.analytic", "launches", "K2b")] > 0
    if name == "mesh":
        assert eager_counts[("qaray_tpu_torch.ops.mesh_sweep", "launches",
                             "K3")] > 0
    last = _replay_under_sync_error(lambda: step(2))
    for s, (w_, a_, g_, r_) in enumerate(zip(want, again, got, replay)):
        assert torch.equal(w_[0], g_[0]) and torch.equal(w_[0], r_[0]), s
        spread = _within_eager_spread(w_[1], a_[1], g_[1], f"{name} {s}")
        _within_eager_spread(w_[1], a_[1], r_[1], f"{name} {s} again")
        print(f"{name} step {s}: eager against eager {spread}")
    assert torch.equal(last[0], want[2][0])
    _within_eager_spread(want[2][1], again[2][1], last[1], f"{name} sync")
    assert not torch.equal(want[0][1].mtl_diffuse, want[1][1].mtl_diffuse)


@pytest.mark.parametrize("route", ["megakernel", "wavefront", "mega_render"])
def test_captured_render_batch_gradients(cuda, route, monkeypatch):
    """render_batch on spot_scene at 200x150 under its caller's autograd,
    on the megakernel route (K1a's graph forward, the megakernel's
    backward step replayed), the wavefront route (the engine's graph
    forward, the engine re-run under autograd as the backward step) and
    mega_render called directly on lanes of its own (its backward step
    captured on autograd's device thread): radiance equal to eager's bit
    for bit, every gradient field within two eager runs' spread; the
    launches of eager, and on the wavefront route also those of the
    forward its backward step re-runs; a second call captures nothing and
    replays under sync debug "error"."""
    from qaray_tpu_torch import diff
    from qaray_tpu_torch.integrators.engine import render_batch
    from qaray_tpu_torch.utils import compiled

    if route == "wavefront":
        monkeypatch.setenv("QARAY_NO_MEGAKERNEL", "1")
    arr, meta = _grad_scene("spot", (200, 150))
    cfg = IntegratorConfig(integrator="pathtrace", max_bounce=5,
                           shadow_spp=16)
    px, py, sid = _lanes(200, 150, 1, "cuda")
    if route == "mega_render":
        px, py, sid = px[:20000], py[:20000], sid[:20000]
    gen = torch.Generator(device="cuda").manual_seed(3)
    ct = torch.rand((px.shape[0], 3), device="cuda", generator=gen)

    def call():
        params = diff.DiffParams(*(t.detach().requires_grad_()
                                   for t in diff.extract_params(arr)))
        scene = diff.splice_params(arr, params)
        if route == "mega_render":
            rad = megakernel.mega_render(scene, meta, cfg, px, py, sid,
                                         (0, 3))[0]
        else:
            rad = render_batch(scene, meta, cfg, px, py, sid, (0, 3))[0]
        grads = torch.autograd.grad((rad * ct).sum(), params,
                                    allow_unused=True)
        return rad.detach(), [torch.zeros_like(p) if g is None else g
                              for p, g in zip(params, grads)]

    def counted(mode):
        counts = _counts()
        with mode():
            out = call()
        torch.cuda.synchronize()
        return out, _moved(counts, _counts())

    want, eager_counts = counted(compiled.eager)
    again, _ = counted(compiled.eager)
    before = compiled.stats["captures"]
    got, got_counts = counted(contextlib.nullcontext)
    assert compiled.stats["captures"] > before
    before = compiled.stats["captures"]
    last = _replay_under_sync_error(call)
    assert compiled.stats["captures"] == before
    if route == "wavefront":
        counts = _counts()
        with compiled.eager(), torch.no_grad():
            render_batch(arr, meta, cfg, px, py, sid, (0, 3))
        forward = _moved(counts, _counts())
        eager_counts = {k: v + forward.get(k, 0)
                        for k, v in eager_counts.items()}
    assert got_counts == eager_counts, (got_counts, eager_counts)
    k1a = eager_counts.get(("qaray_tpu_torch.ops.megakernel", "launches",
                            "K1a"), 0)
    assert (k1a == 1) == (route != "wavefront")
    for out in (got, last):
        assert torch.equal(out[0], want[0])
        spread = _within_eager_spread(want[1], again[1], out[1], route)
    print(f"{route}: eager against eager {spread}")


# -- G1, the material gather's backward (csrc/mtl_gather.cu)

# tests/test_torch_mtl_gather.py's bars, of each row's sum of |g|: against
# index_put_ (another order of summation) and against a float64 sum (G1's
# longest chain of float32 adds is some 128 terms: typically
# sqrt(128) * 2^-24 = 6.7e-7).
G1_TOL = 1e-4
G1_EXACT_TOL = 1e-6


def _g1_inputs(n, rows, seed):
    """mid [n] in runs along image rows (as a bounce's hits lie) and six
    cotangents on the card."""
    from qaray_tpu_torch.ops import mtl_gather

    rs = np.random.RandomState(seed)
    runs = rs.randint(1, 200, size=n + 1)
    mid = np.repeat(rs.randint(0, rows, size=n + 1), runs)[:n]
    grads = [torch.tensor(rs.standard_normal(
        (n, w) if w > 1 else (n,)).astype(np.float32), device="cuda")
        for w in mtl_gather.WIDTHS]
    return torch.tensor(mid, device="cuda"), grads


@pytest.mark.parametrize("rows", [2, 3000])
def test_g1_matches_plain(cuda, rows):
    """G1 at the inverse cell's 480,000 lanes, on softdof's 2 material rows
    and on 3,000 rows (64 row tiles), against index_put_ (the plain
    version) and a float64 sum, within G1_TOL and G1_EXACT_TOL of the
    row's sum of |g|;
    three launches give the same bits; each counts one launch."""
    from qaray_tpu_torch.ops import mtl_gather

    n = 480_000
    mid, grads = _g1_inputs(n, rows, seed=rows)
    before = mtl_gather.launches["G1"]
    got = [mtl_gather.gather_bwd(mid, grads, rows) for _ in range(3)]
    torch.cuda.synchronize()
    assert mtl_gather.launches["G1"] == before + 3
    want = mtl_gather.gather_bwd_plain(mid, grads, rows)
    exact = mtl_gather.gather_bwd_plain(mid, [g.double() for g in grads],
                                        rows)
    for k, g in enumerate(grads):
        scale = mtl_gather.gather_bwd_plain(
            mid, [g.abs().double()], rows)[0].clamp_min(1e-30)
        a = got[0][k].double()
        off_plain = ((a - want[k].double()).abs() / scale).max().item()
        off_exact = ((a - exact[k]).abs() / scale).max().item()
        plain_exact = ((want[k].double() - exact[k]).abs()
                       / scale).max().item()
        print(f"rows {rows} table {k}: G1 - plain {off_plain:.3g}, "
              f"G1 - exact {off_exact:.3g}, plain - exact {plain_exact:.3g}"
              " of the row's sum of |g|")
        assert off_plain <= G1_TOL and off_exact <= G1_EXACT_TOL, k
        assert torch.equal(got[0][k], got[1][k])
        assert torch.equal(got[0][k], got[2][k])


def test_captured_autograd_step_with_g1_equals_eager(cuda, monkeypatch):
    """The inverse cell's step (softdof 800x600 x 1 spp, pathtrace,
    max_bounce 5, shadow_spp 16..64, threefry keys, an mse loss; depth of
    field takes the autograd route): eager twice and captured twice (the
    second a replay under sync debug "error") give the same loss and
    gradients bit for bit, and G1's launches advance by one for each
    material gather on the tape, eager and replayed."""
    from qaray_tpu_torch import diff
    from qaray_tpu_torch.integrators import common
    from qaray_tpu_torch.ops import mtl_gather
    from qaray_tpu_torch.utils import compiled

    desc = load_scene(SCENES[1])
    desc.camera.img_width, desc.camera.img_height = 800, 600
    arr, meta = compile_scene(desc, device="cuda")
    cfg = IntegratorConfig(integrator="pathtrace", max_bounce=5,
                           shadow_spp=16, shadow_spp_max=64)
    assert not diff._fast_route(meta, cfg)
    px, py, sid = _lanes(800, 600, 1, "cuda")
    target = torch.full((px.shape[0], 3), 0.25, device="cuda")
    taped = []
    gather = common.gather

    def counting(mid, tables):
        taped.append(torch.is_grad_enabled()
                     and any(t.requires_grad for t in tables))
        return gather(mid, tables)

    monkeypatch.setattr(common, "gather", counting)

    def step():
        taped.clear()
        before = mtl_gather.launches["G1"]
        out = diff.render_value_and_grad(arr, meta, cfg, px, py, sid,
                                         (0, 11), target=target)
        return out, mtl_gather.launches["G1"] - before

    with compiled.eager():
        (want, launched) = step()
        gathers = sum(taped)
        again, _ = step()
    assert gathers > 0 and launched == gathers, (launched, gathers)
    first, launched_first = step()
    replay, launched_replay = _replay_under_sync_error(step)
    torch.cuda.synchronize()
    assert launched_first == launched_replay == gathers
    for got in (again, first, replay):
        assert torch.equal(got[0], want[0])
        for f, a, b in zip(diff.DiffParams._fields, got[1], want[1]):
            assert torch.equal(a, b), f
    print(f"{gathers} gathers on the tape, loss {want[0].item():.6g}")


# -- H1, the wavefront engine's threefry cipher (csrc/threefry.cu)


def _h1_keys(lanes, seed):
    """Two [lanes] int64 tensors of uint32 words over the whole range."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randint(0, 2**32, (lanes,), device="cuda",
                               dtype=torch.int64, generator=g)
                 for _ in range(2))


def _h1_twin_draws(k0, k1, n, chunk=65_536):
    """core/krng.py's draws [lanes, n] on the card, chunk lanes at a time
    (the int64 passes hold [chunk, n] temporaries)."""
    from qaray_tpu_torch.core import krng

    f = torch.arange(n, dtype=torch.int64, device=k0.device)
    return torch.cat([krng.draw_at(k0[lo:lo + chunk, None],
                                   k1[lo:lo + chunk, None], f[None, :])
                      for lo in range(0, k0.shape[0], chunk)])


@pytest.mark.parametrize("lanes,n", [(480_000, 256), (1_048_576, 1)])
def test_h1_equals_int64_cipher(cuda, lanes, n):
    """H1 at the inverse cell's soft-shadow draws (480,000 lanes x 256: 64
    samples x 2 x 2 a lane) and at a dispatch's 1,048,576 lanes x 1 against
    core/krng.py on the card, bit for bit: uniform, fold with tensor data,
    with a tag above 2^31 and with scalar base words (ray_keys), one
    launch each, counted."""
    from qaray_tpu_torch.core import krng
    from qaray_tpu_torch.ops import threefry

    k0, k1 = _h1_keys(lanes, seed=n)
    before = dict(threefry.launches), dict(threefry.stats)
    u = threefry.uniform(k0, k1, n)
    folds = [threefry.fold(k0, k1, k1), threefry.fold(k0, k1, 2**31 + 5),
             threefry.fold(0x9E3779B9, 7, k0)]
    torch.cuda.synchronize()
    assert threefry.launches["H1"] == before[0]["H1"] + 4
    assert threefry.stats["draws"] == before[1]["draws"] + lanes * n
    assert threefry.stats["folds"] == before[1]["folds"] + 3 * lanes
    assert u.shape == (lanes, n) and u.dtype == torch.float32
    assert torch.equal(u, _h1_twin_draws(k0, k1, n))
    wants = [krng.fold2(k0, k1, k1),
             krng.fold2(k0, k1, torch.full_like(k0, 2**31 + 5)),
             krng.fold2(0x9E3779B9, 7, k0)]
    for (g0, g1), (w0, w1) in zip(folds, wants):
        assert torch.equal(g0, w0) and torch.equal(g1, w1)


def test_h1_captured_equals_eager(cuda):
    """ray_keys, folds and draws of the shapes the engine asks for, under
    utils/compiled.jit: captured and replayed (under sync debug "error")
    equal eager bit for bit, and a replay counts eager's H1 launches."""
    from qaray_tpu_torch.core import rng
    from qaray_tpu_torch.ops import threefry
    from qaray_tpu_torch.utils import compiled

    def draws(ids, words):
        keys = rng.ray_keys((words[0], words[1]), ids)
        k = rng.fold(rng.fold(keys, 1000), rng.P_SHADOW + 101)
        return (k[0], k[1], rng.uniform(k, (64, 2, 2)),
                rng.uniform(rng.fold(keys, rng.P_DOF), (2,)),
                rng.uniform(rng.fold(keys, rng.P_LOBE_SELECT)))

    jitted = compiled.jit(draws, inputs=("ids",))
    ids = torch.arange(65_536, device="cuda") * 65_536 + 3
    words = torch.tensor([0, 11], dtype=torch.int64, device="cuda")

    def call():
        before = threefry.launches["H1"]
        out = jitted(ids, words)
        return out, threefry.launches["H1"] - before

    with compiled.eager():
        want, launched = call()
    assert launched == 8
    assert _captured_equals_eager(lambda: call()[0]) >= 1
    got, launched_replay = call()
    assert launched_replay == launched
    for a, b in zip(want, got):
        assert torch.equal(a, b)


class _CipherSpy:
    """core/krng.py's cipher2x32, recording the calls that get a CUDA
    tensor."""

    def __init__(self, monkeypatch):
        from qaray_tpu_torch.core import krng

        self.cuda_calls = 0
        self._cipher = krng.cipher2x32
        monkeypatch.setattr(krng, "cipher2x32", self)

    def __call__(self, *args):
        self.cuda_calls += any(isinstance(a, torch.Tensor) and a.is_cuda
                               for a in args)
        return self._cipher(*args)


def _on_int64_twin(monkeypatch):
    """Route ops/threefry's fold and uniform, which core/rng.py calls on
    CUDA tensors, onto core/krng.py's int64 cipher."""
    from qaray_tpu_torch.core import krng
    from qaray_tpu_torch.ops import threefry

    def fold(k0, k1, data):
        if not isinstance(data, torch.Tensor):
            data = torch.full(k0.shape, data, dtype=torch.int64,
                              device=k0.device)
        return krng.fold2(k0, k1, data)

    def uniform(k0, k1, n):
        return _h1_twin_draws(k0, k1, n)

    monkeypatch.setattr(threefry, "fold", fold)
    monkeypatch.setattr(threefry, "uniform", uniform)


def test_autograd_step_with_h1_equals_int64_twin(cuda, monkeypatch):
    """The inverse cell's step (softdof 800x600 x 1 spp, pathtrace,
    max_bounce 5, shadow_spp 16..64, an mse loss; the autograd route),
    captured with H1, equals the same step eager with core.rng on the
    int64 twin, loss and every gradient field bit for bit. The H1 step
    launches H1 and never hands krng.cipher2x32 a CUDA tensor, in its
    warm-up, capture or replay; nor does a captured wavefront render
    (render_batch_wavefront at 200x150)."""
    from qaray_tpu_torch import diff
    from qaray_tpu_torch.ops import threefry
    from qaray_tpu_torch.utils import compiled

    spy = _CipherSpy(monkeypatch)
    desc = load_scene(SCENES[1])
    desc.camera.img_width, desc.camera.img_height = 800, 600
    arr, meta = compile_scene(desc, device="cuda")
    cfg = IntegratorConfig(integrator="pathtrace", max_bounce=5,
                           shadow_spp=16, shadow_spp_max=64)
    assert not diff._fast_route(meta, cfg)
    px, py, sid = _lanes(800, 600, 1, "cuda")
    target = torch.full((px.shape[0], 3), 0.25, device="cuda")

    def step():  # key words of its own: the first call captures
        return diff.render_value_and_grad(arr, meta, cfg, px, py, sid,
                                          (0, 13), target=target)

    before = threefry.launches["H1"], compiled.stats["captures"]
    first = step()
    replay = step()
    torch.cuda.synchronize()
    assert threefry.launches["H1"] > before[0]
    assert compiled.stats["captures"] > before[1]
    assert spy.cuda_calls == 0
    small = compile_scene(load_scene(SCENES[1]), device="cuda")
    lanes = _lanes(200, 150, 1, "cuda")
    render_batch_wavefront(*small, cfg, *lanes, (0, 13))
    render_batch_wavefront(*small, cfg, *lanes, (0, 13))
    torch.cuda.synchronize()
    assert spy.cuda_calls == 0

    _on_int64_twin(monkeypatch)
    before = threefry.launches["H1"]
    with compiled.eager():
        want = step()
    torch.cuda.synchronize()
    assert threefry.launches["H1"] == before and spy.cuda_calls > 0
    for got in (first, replay):
        assert torch.equal(got[0], want[0])
        for f, a, b in zip(diff.DiffParams._fields, got[1], want[1]):
            assert torch.equal(a, b), f
    print(f"loss {want[0].item():.6g}; the twin's step made "
          f"{spy.cuda_calls} int64 cipher calls on the card")
