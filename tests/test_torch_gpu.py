"""The port's CUDA kernels against their plain versions, on a card.

Imports neither jax nor qaray_tpu, so it runs on the GPU machine, where JAX
is absent:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

Every case carries the `gpu` marker and skips without a CUDA device.
Bars: tests/test_pallas.py for K2a-K2c, tests/test_megakernel.py::_compare
for K1a against the wavefront engine (which itself runs on K2b/K2c);
tests/test_pallas_tiles.py for K3 and K4a/K4b against their plain versions,
and tests/test_megakernel.py's mesh bars for K1c against the engine;
test_mega_checker_textures_parity's bars for K1b against the engine with
its texture stack. The wavefront route's texture stack and the Whitted
family's integrators are held to the same code on the CPU. K5 against
photon_gather_plain: sums within 1e-5 relative, counts exact; K1d against
the engine with its exact gathers: test_mega_photon_gather_parity's and
test_mega_photon_escalation_flags_dense_lanes's bars on caustics_scene
(softdof with a glass middle sphere). K6 against adjoint_render_plain:
tests/test_grad.py's 3e-2 of max|b| per field; render_value_and_grad's
fast route launches K1a and K6; render_batch's gradients on the
megakernel route equal render_with_params'.
"""

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
    before = mesh_sweep.launches["K3"]
    got = mesh_sweep.sweep_closest(p, d, t_cur, m.stream_c16)
    _row_bars(stream_closest(p, d, t_cur, plain), got)
    occ = mesh_sweep.sweep_occluded(p, d, t_max, m.stream_c16)
    assert torch.equal(occ, stream_any_hit(p, d, t_max, plain))
    assert mesh_sweep.launches["K3"] == before + 2


def test_k4_matches_plain(cuda):
    arr, meta = compile_scene(_ico_scene(6), device="cuda")
    assert meta.mesh_tiled
    m = arr.mesh
    tm = TiledMesh(m.tile_coeff, m.tile_const, m.tile_gid, m.tile_cbounds)
    p, d, t_max = _mesh_rays(1 << 16, 6)
    t_cur = torch.full_like(t_max, 1e30)
    work = torch.zeros_like(t_cur, dtype=torch.int32)
    single = tiles.tiled_sweep_kernel(p, d, t_cur, tm, m.tile_c16T, work=work)
    _row_bars(tiled_sweep(p, d, t_cur, tm), single)
    # Per-ray work: whole clusters, and at least the winner's for a hit.
    assert bool((work % 256 == 0).all())
    assert bool((work[single[1] >= 0] > 0).all())
    t_max[::4] = 0.0  # rays without budget need no test
    occ = tiles.tiled_sweep_kernel(p, d, t_max, tm, m.tile_c16T,
                                   any_hit=True, work=work)
    assert torch.equal(occ, tiled_sweep(p, d, t_max, tm, any_hit=True))
    assert bool((work[::4] == 0).all()) and bool((work[occ] > 0).all())
    # Two-phase (budget 12) against single-phase (budget 0), both on the
    # coherence-sorted rays: the same winners. Rows may differ only where
    # two triangles tie exactly in t (an edge shared by both), because the
    # repacked phase-2 packets visit clusters in another order.
    t0, r0, _ = tiles.tiled_closest_twophase(p, d, t_cur, tm, m.tile_c16T,
                                             budget=0)
    t1, r1, _ = tiles.tiled_closest_twophase(p, d, t_cur, tm, m.tile_c16T)
    assert bool(((r0 == r1) | (t0 == t1)).all())
    assert (r0 == r1).float().mean().item() > 0.9999


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
