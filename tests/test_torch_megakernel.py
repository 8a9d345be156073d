"""The port's megakernel entry point against qaray_tpu's Pallas megakernel.

On the CPU, ops.megakernel.mega_render runs the plain version of kernel
K1a (the wavefront engine); here it is held to qaray_tpu's mega_render in
interpret mode under a threefry key, with the bars of
tests/test_megakernel.py::_compare. tests/test_torch_gpu.py holds K1a itself
to the plain version on a card with the same bars. On the checker-textured
scene (K1b) the bars are those of test_mega_checker_textures_parity.
"""

import shutil

import jax
import numpy as np
import pytest
import torch

from qaray_tpu.integrators.engine import IntegratorConfig as JaxConfig
from qaray_tpu.ops.pallas_pathtrace import mega_render as jax_mega_render
from qaray_tpu_torch.integrators.engine import IntegratorConfig
from qaray_tpu_torch.ops import megakernel
from qaray_tpu_torch.integrators import engine
from qaray_tpu_torch.scene.compiler import compile_scene
from qaray_tpu_torch.scene.desc import LightDesc
from qaray_tpu_torch.scene.xml_parser import load_scene
from test_torch_engine import compare, lanes, scenes

KW = dict(integrator="pathtrace", max_bounce=3, shadow_spp=4,
          shadow_spp_max=8)


def test_mega_render_matches_pallas_interpret():
    arrays, meta, tarr, tmeta = scenes("softdof")
    px, py, sid = lanes()
    key = jax.random.key(3, impl="threefry2x32")
    kd = jax.random.key_data(key)
    rad_j, t0_j = jax_mega_render(arrays, meta, JaxConfig(**KW),
                                  "threefry2x32", True, px, py, sid, kd)
    words = tuple(int(w) for w in np.asarray(kd))
    rad, t0 = megakernel.mega_render(tarr, tmeta, IntegratorConfig(**KW),
                                     torch.tensor(px), torch.tensor(py),
                                     torch.tensor(sid), words)
    compare(np.asarray(rad_j), np.asarray(t0_j), rad.numpy(), t0.numpy())


def test_mega_render_textured_is_the_engine_on_the_cpu():
    """texture_scene.xml is served by the megakernel route (K1a + K1b), and
    on CPU tensors mega_render is its plain version, the wavefront engine
    with the texture stack: the same numbers, bit for bit."""
    _, _, tarr, tmeta = scenes("texture")
    cfg = IntegratorConfig(**KW)
    assert engine.use_pathtrace_mega(tmeta, cfg)
    assert tarr.kernel.mtl.shape[1] == 102
    px, py, sid = (torch.tensor(a) for a in lanes())
    rad, t0 = megakernel.mega_render(tarr, tmeta, cfg, px, py, sid, (0, 3))
    rad_e, t0_e = engine.render_batch_wavefront(tarr, tmeta, cfg, px, py,
                                                sid, (0, 3))
    assert torch.equal(rad, rad_e) and torch.equal(t0, t0_e)
    rad_r, _ = engine.render_batch(tarr, tmeta, cfg, px, py, sid, (0, 3))
    assert torch.equal(rad, rad_r)


def test_mega_render_textured_matches_pallas_interpret():
    """The port's engine against the JAX megakernel in interpret mode on
    texture_scene.xml at 80x60 x 1 (the JAX test's resolution; the time
    is the kernel's trace, not its lanes), with the bars of
    test_mega_checker_textures_parity: under 0.5 % of lanes above 1e-3
    relative, channel means within 2e-3. This also bounds what the TPU
    kernel's polynomial atan2 and asin cost against atan2f and asinf. The
    lanes that differ are floor lanes: the two packages' camera rays differ
    in their last bits, the grazing floor hit amplifies that, and one of
    the footprint's 32 samples lands across a cell edge; the coarser the
    image, the more cells a footprint spans and the more such lanes."""
    arrays, meta, tarr, tmeta = scenes("texture", (80, 60))
    assert meta.mega_tex_ok and meta.mega_tex_slots[0]
    px, py, sid = lanes((80, 60), spp=1)
    key = jax.random.key(3, impl="threefry2x32")
    kd = jax.random.key_data(key)
    rad_j, t0_j = jax_mega_render(arrays, meta, JaxConfig(**KW),
                                  "threefry2x32", True, px, py, sid, kd)
    words = tuple(int(w) for w in np.asarray(kd))
    rad, t0 = megakernel.mega_render(tarr, tmeta, IntegratorConfig(**KW),
                                     torch.tensor(px), torch.tensor(py),
                                     torch.tensor(sid), words)
    rad_j, rad = np.asarray(rad_j), rad.numpy()
    rel = np.abs(rad_j - rad).max(-1) / (1.0 + np.abs(rad_j).max(-1))
    assert (rel > 1e-3).mean() < 5e-3, (rel > 1e-3).mean()
    assert np.abs(rad_j.mean(0) - rad.mean(0)).max() < 2e-3
    np.testing.assert_allclose(t0.numpy(), np.asarray(t0_j), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("integrator", ["pathtrace", "photonmap"])
@pytest.mark.parametrize("name", ["softdof", "texture", "mesh"])
def test_kernel_source_on_the_host_matches_engine(name, integrator):
    """csrc/megakernel.cu itself, compiled by g++ against
    csrc/host/cuda_runtime.h and run one lane at a time
    (megakernel.mega_render_host), against the wavefront engine at 64x48 x
    2: K1a on softdof, K1a + K1b on texture_scene (with the work counters:
    32 checker tests a textured primary vertex, 1 a later one), K1a + K1c on
    mesh_scene. Both run on this CPU without FMA contraction, so the bars
    are those the card's kernel is held to: _compare's for softdof,
    test_mega_checker_textures_parity's for texture_scene, the mesh bars of
    tests/test_torch_gpu.py for mesh_scene."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ for the host build of the kernel source")
    _, _, tarr, tmeta = scenes(name, (64, 48))
    cfg = IntegratorConfig(integrator=integrator, max_bounce=4, shadow_spp=4,
                           shadow_spp_max=8)
    px, py, sid = (torch.tensor(a) for a in lanes((64, 48), 2))
    work = torch.zeros((px.shape[0], 8), dtype=torch.int32)
    before = dict(megakernel.launches)
    rad_k, t0_k = megakernel.mega_render_host(tarr, tmeta, cfg, px, py, sid,
                                              (0, 3), work=work)
    assert megakernel.launches == before  # no kernel launch is counted
    rad_p, t0_p = engine.render_batch_wavefront(tarr, tmeta, cfg, px, py,
                                                sid, (0, 3))
    rad_k, t0_k, rad_p, t0_p = (a.numpy() for a in (rad_k, t0_k, rad_p, t0_p))
    rel = np.abs(rad_p - rad_k).max(-1) / (1.0 + np.abs(rad_p).max(-1))
    mean_err = np.abs(rad_p.mean(0) - rad_k.mean(0)).max()
    tests, ciphers, vertices, tri_tests, checkers, *photon, tails = (
        work.sum(0).tolist())
    assert tests > 0 and ciphers > 0 and vertices > 0
    assert photon == [0, 0]  # written only by the gathering kernel (K1d)
    if name == "mesh":
        assert (np.abs(t0_p - t0_k) > 1e-3).mean() < 2e-3
        assert (rel > 1e-3).mean() < 5e-3 and mean_err < 2e-3
        assert tri_tests > 0 and checkers == 0
        return
    assert tri_tests == 0
    if name == "texture":
        np.testing.assert_allclose(t0_k, t0_p, rtol=1e-4, atol=1e-3)
        assert (rel > 1e-3).mean() < 5e-3 and mean_err < 2e-3
        # Every primary hit is textured in one slot: 32 tests there, one at
        # each later vertex.
        primary = int((t0_k < 1e29).sum())
        assert checkers == 32 * primary + (vertices - primary)
    else:
        compare(rad_p, t0_p, rad_k, t0_k)
        assert checkers == 0


@pytest.mark.parametrize("integrator", ["pathtrace", "photonmap"])
@pytest.mark.parametrize("name", ["softdof", "mesh"])
def test_kernel_source_in_blocks_matches_one_thread(name, integrator):
    """csrc/megakernel.cu compiled by g++ and run in blocks of 32 threads,
    one std::thread each with the block's shared memory and barriers
    (mega_render_host(block=32)), against the same source run one thread a
    block: the block pools its soft-shadow samples across its threads, so
    its radiance, t0 and per-lane work counters (the pooled samples counted
    to their lanes) must equal the one-thread run's bit for bit. 32x24 x 2
    spp, shadow_spp 4 -> 8, max_bounce 4: lanes die at different bounces
    and some soft-shadow estimates go on past 4 samples. mesh_scene has no
    soft light of its own: a point light of size 3 is added to it, so that
    the pooled shadow rays sweep the mesh (K1c)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ for the host build of the kernel source")
    desc = load_scene(f"tests/assets/{name}_scene.xml")
    desc.camera.img_width, desc.camera.img_height = 32, 24
    if name == "mesh":
        desc.lights.append(LightDesc(
            "point", "soft", intensity=np.full(3, 900.0),
            position=np.array([10.0, 30.0, 40.0]), size=3.0))
    tarr, tmeta = compile_scene(desc, device="cpu")
    cfg = IntegratorConfig(integrator=integrator, max_bounce=4, shadow_spp=4,
                           shadow_spp_max=8)
    px, py, sid = (torch.tensor(a) for a in lanes((32, 24), 2))
    out = {}
    for block in (1, 32):
        work = torch.zeros((px.shape[0], 8), dtype=torch.int32)
        rad, t0 = megakernel.mega_render_host(tarr, tmeta, cfg, px, py, sid,
                                              (0, 3), work=work, block=block)
        out[block] = (rad, t0, work)
    for a, b in zip(out[1], out[32]):
        assert torch.equal(a, b)
    work = out[32][2]
    vertices, tails = work[:, 2], work[:, 7]
    assert len(torch.unique(vertices)) > 2  # paths end at different bounces
    assert 0 < int(tails.sum()) < int(vertices.sum())
    assert int(work[:, 1].sum()) > 0 and int(work[:, 0].sum()) > 0
    if name == "mesh":
        assert int(work[:, 3].sum()) > 0


def test_kernel_source_without_pool_matches_pooled():
    """The launch sizes the block's soft-shadow pool from the meta's light
    kinds, the kernel picks soft lights from the staged tables. Where the
    meta says no light is soft but the tables hold one, the block has no
    pool: its lanes leave the bounce loop on their own and the soft light
    takes the per-lane loop (light_visibility). Run in blocks of 32 threads
    (g++ build, as test_kernel_source_in_blocks_matches_one_thread), it
    ends and gives the pooled launch's radiance, t0 and work bit for bit."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ for the host build of the kernel source")
    _, _, tarr, tmeta = scenes("softdof", (32, 24))
    assert any(tmeta.light_soft)
    cfg = IntegratorConfig(integrator="pathtrace", max_bounce=4,
                           shadow_spp=4, shadow_spp_max=8)
    px, py, sid = (torch.tensor(a) for a in lanes((32, 24), 2))
    out = []
    for meta in (tmeta, tmeta._replace(light_soft=(0,) * tmeta.num_lights)):
        work = torch.zeros((px.shape[0], 8), dtype=torch.int32)
        rad, t0 = megakernel.mega_render_host(tarr, meta, cfg, px, py, sid,
                                              (0, 3), work=work, block=32)
        out.append((rad, t0, work))
    for a, b in zip(*out):
        assert torch.equal(a, b)
    assert int(out[1][2][:, 7].sum()) > 0


def _probe_rays(tri_v, n, seed):
    """n rays at a mesh tri_v [F, 3, 3] from a sphere of three radii around
    its box (the inner one inside it): half aimed at points of the box,
    half exactly at its vertices, where triangles tie in t."""
    rng = np.random.default_rng(seed)
    corners = tri_v.reshape(-1, 3)
    lo, hi = corners.min(0), corners.max(0)
    c, r = (lo + hi) / 2, np.linalg.norm(hi - lo) / 2
    u = rng.normal(size=(n, 3))
    p = c + (r * rng.choice([0.3, 1.5, 3.0], n))[:, None] * u / np.linalg.norm(
        u, axis=1, keepdims=True)
    aim = np.where((np.arange(n) % 2 == 0)[:, None],
                   rng.uniform(lo, hi, (n, 3)),
                   corners[rng.integers(0, corners.shape[0], n)])
    d = (aim - p) / np.linalg.norm(aim - p, axis=1, keepdims=True)
    return (torch.tensor(p, dtype=torch.float32),
            torch.tensor(d, dtype=torch.float32))


@pytest.mark.parametrize("mesh", ["mesh", "ico3"])
def test_k1c_probe_source_on_the_host_matches_fold(mesh):
    """K1c's own mesh_closest and mesh_occluded (csrc/mega_common.cuh: the
    tree walk), compiled by g++ as the megakernel's qr_mega_mesh_probe
    (megakernel.mesh_probe_host), against the plain in-order fold over
    build_mega_mesh's rows (mesh_probe_plain), on 3,072 rays of mesh_scene
    (320 triangles, 5 leaves of 64 rows) and of its icosphere at ico3
    (1,280, 20 leaves): (t, normal, front, material row, occluded) bit for
    bit. A third of the rays carry an analytic t equal to their mesh hit's,
    which the analytic winner keeps; a third a budget equal to it, which
    that hit does not occlude. The plain fold's winners are JAX's dense
    sweep's over the same rows (qaray_tpu's stream_closest)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ for the host build of the kernel source")
    from qaray_tpu.ops import mesh_stream as jms
    from qaray_tpu_torch.scene.procedural import icosphere, with_mesh

    desc = load_scene("tests/assets/mesh_scene.xml")
    if mesh == "ico3":
        desc = with_mesh(desc, *icosphere(3))
    arr, meta = compile_scene(desc, device="cpu")
    tabs = arr.kernel
    tri_v = arr.mesh.tri_v.numpy()
    p, d = _probe_rays(tri_v, 3072, 7)
    n = p.shape[0]
    big = torch.full((n,), 1e30)
    t_m, row_m, _ = megakernel.mesh_fold_plain(tabs.mesh_rows, p, d, big, big)
    hit = row_m >= 0
    third = torch.arange(n) % 3
    rng = np.random.default_rng(8)
    t_rand = torch.tensor(rng.uniform(0.0, 60.0, n), dtype=torch.float32)
    t_a = torch.where(third == 0, big, torch.where(third == 1, t_rand, t_m))
    t_max = torch.where(third == 0, t_m, torch.where(third == 1, big,
                                                     t_rand))
    want = megakernel.mesh_probe(tabs, p, d, t_a, t_max)  # the plain fold
    work = torch.zeros((n, 2), dtype=torch.int32)
    got = megakernel.mesh_probe_host(tabs, p, d, t_a, t_max, work=work)
    for name, w, g in zip(("t", "normal", "front", "mrow", "occluded"), want,
                          got):
        assert w.dtype == g.dtype and torch.equal(w, g), name
    ties = (third == 2) & hit
    assert int(ties.sum()) > 200 and (got[3][ties] == -1).all()
    assert int(((third == 1) & (got[3] >= 0)).sum()) > 100
    assert 0 < int(got[4].sum()) < n
    # The walk tests a fraction of the sweep's rows.
    rows = tabs.mesh_rows.shape[0]
    assert work[:, 0].double().mean() < 0.6 * rows
    # The winners against the JAX package's dense sweep over the same rows,
    # on the rays aimed into the box (at a vertex XLA's rounding decides
    # which of the triangles that meet there is hit).
    order = megakernel._morton_order(tri_v)
    js = jms.build_stream(tri_v[order], chunk=megakernel.MEGA_CLUSTER)
    t_j, row_j, _ = (np.asarray(a) for a in jms.stream_closest(
        p.numpy(), d.numpy(), big.numpy(), js))
    box = np.arange(n) % 2 == 0
    same = row_j[box] == row_m.numpy()[box]
    hit_box = hit.numpy()[box]
    assert same.mean() > 0.999 and hit_box[same].sum() > 200
    np.testing.assert_allclose(t_j[box][same & hit_box],
                               t_m.numpy()[box][same & hit_box], rtol=1e-5)
