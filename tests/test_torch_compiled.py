"""Captured execution (qaray_tpu_torch/utils/compiled.py, the counterpart
of jax.jit) and what it needs from the code it captures, on the CPU:

- the engine's full-lane photon gather (_gather_lanes) against the form
  that gathered only the selected lanes, bit for bit, and against the JAX
  engine's gather on caustics_scene;
- the Renderer's dispatches padded to power-of-two buckets with dump
  lanes: the image bits of the unpadded loop, and the JAX Renderer's lane
  lists;
- the wrapper's key, and its direct call on CPU tensors;
- photon maps on a mesh scene through the K3 and K4a routes' plain
  versions against the JAX package (ROADMAP C2).
The captures themselves run on a card: tests/test_torch_gpu.py.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qaray_tpu.integrators.engine as jax_engine
import qaray_tpu.photon.build as jbuild
from qaray_tpu.renderer import Renderer as JaxRenderer
from qaray_tpu.renderer import RendererParam as JaxParam
from qaray_tpu.scene.compiler import compile_scene as jax_compile
from qaray_tpu.scene.xml_parser import load_scene as jax_load
from qaray_tpu_torch.integrators import engine
from qaray_tpu_torch.integrators.engine import IntegratorConfig
from qaray_tpu_torch.ops import megakernel, trace
from qaray_tpu_torch.photon import build as tbuild
from qaray_tpu_torch.photon.gather import PhotonMapData, gather_blinn
from qaray_tpu_torch import renderer
from qaray_tpu_torch.renderer import Renderer, RendererParam, _pad_to_bucket
from qaray_tpu_torch.scene.compiler import compile_scene
from qaray_tpu_torch.scene.convert import from_numpy_arrays
from qaray_tpu_torch.scene.procedural import with_glass
from qaray_tpu_torch.scene.xml_parser import load_scene
from qaray_tpu_torch.utils import compiled
from test_torch_photon_render import scene_and_maps  # noqa: F401

ASSETS = os.path.join(os.path.dirname(__file__), "assets")
PLANES = ("mean", "color_std", "count", "zbuffer", "irrad")


class _Mtl:
    def __init__(self, diffuse, specular, glossiness):
        self.diffuse, self.specular, self.glossiness = (diffuse, specular,
                                                        glossiness)


def _gather_selected(pmap, do, p, n, v, mtl):
    """The engine's former _gather_lanes: gather_blinn on the selected
    lanes only (a host read of the selection), zero elsewhere."""
    out = torch.zeros_like(p)
    idx = torch.nonzero(do)[:, 0]
    if idx.numel():
        out[idx] = gather_blinn(pmap, p[idx], n[idx], v[idx],
                                mtl.diffuse[idx], mtl.specular[idx],
                                mtl.glossiness[idx])
    return out


def _queries(seed, num):
    rs = np.random.RandomState(seed)
    p = rs.uniform(-1.0, 1.0, (num, 3)).astype(np.float32)
    n = rs.normal(size=(num, 3)).astype(np.float32)
    v = rs.normal(size=(num, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    mtl = (rs.uniform(0, 1, (num, 3)).astype(np.float32),
           rs.uniform(0, 1, (num, 3)).astype(np.float32),
           rs.uniform(1, 50, num).astype(np.float32))
    do = rs.uniform(size=num) < 0.3
    return p, n, v, mtl, do


@pytest.mark.parametrize("photons", [300, 40000], ids=["one-shot", "stream"])
def test_gather_lanes_full_equals_selected(photons):
    """Every lane gathered and the selected ones kept (the JAX engine's
    form) gives the selected lanes the bits of a gather of those lanes
    alone, on the one-shot top-k gather and on the streamed one (maps above
    32,768 photons), zeros elsewhere."""
    rs = np.random.RandomState(1)
    pos = rs.uniform(-1.0, 1.0, (photons, 3)).astype(np.float32)
    power = rs.uniform(0, 1e-3, (photons, 3)).astype(np.float32)
    dirs = rs.normal(size=(photons, 3)).astype(np.float32)
    pmap = PhotonMapData(
        pos=torch.tensor(pos), power=torch.tensor(power),
        max_power=torch.tensor(power.max(axis=1)),
        direction=torch.tensor(dirs),
        radius=torch.tensor(0.3 if photons < 1000 else 0.05),
        valid=torch.tensor(rs.uniform(size=photons) < 0.95))
    p, n, v, mtl, do = _queries(2, 700)
    p, n, v, do = (torch.tensor(x) for x in (p, n, v, do))
    mtl = _Mtl(*(torch.tensor(x) for x in mtl))
    want = _gather_selected(pmap, do, p, n, v, mtl)
    got = engine._gather_lanes(pmap, do, p, n, v, mtl)
    assert torch.equal(got, want)
    assert bool((got[do] != 0).any()) and bool((got[~do] == 0).all())


def test_gather_lanes_matches_jax_engine(scene_and_maps):  # noqa: F811
    """The full-lane gather of caustics_scene's global and caustics maps
    (the JAX package's small maps, carried across) at the first hits of its
    camera rays against the JAX engine's gather_blinn and select
    (qaray_tpu/integrators/engine.py:161-167): within 1e-4 of max(1,
    |value|) on every lane, on lanes both gathered and zeroed."""
    from qaray_tpu.photon.gather import gather_blinn as jax_gather
    from qaray_tpu_torch.integrators import common as C

    arrays, meta, jmaps, tarr, tmeta, tmaps = scene_and_maps
    w, h = tmeta.img_width, tmeta.img_height
    ids = torch.arange(w * h)
    keys = engine.RNG.ray_keys((0, 5), ids)
    p0, d, *_ = engine.generate_camera_rays(tarr, tmeta, ids % w, ids // w,
                                            torch.zeros_like(ids), keys)
    hits = trace.trace_closest(tarr, tmeta, p0, d)
    mtl = C.gather_materials(tarr, hits["mtl"], hits["uvw"],
                             hits["has_texture"])
    do = hits["hit"] & (torch.arange(w * h) % 3 != 0)
    for jmap, tmap in zip(jmaps, tmaps):
        got = engine._gather_lanes(tmap, do, hits["p"], hits["n"], -d, mtl)
        args = [jnp.asarray(x.numpy()) for x in (
            hits["p"], hits["n"], -d, mtl.diffuse, mtl.specular,
            mtl.glossiness)]
        want = np.asarray(jnp.where(jnp.asarray(do.numpy())[:, None],
                                    jax_gather(jmap, *args), 0.0))
        err = np.abs(got.numpy() - want) / np.maximum(1.0, np.abs(want))
        assert err.max() < 1e-4
        assert (got.numpy()[~do.numpy()] == 0).all()
    assert bool(got.abs().sum() > 0)


# -- the Renderer padded to buckets ------------------------------------------


def _render(case, pipelined, padded, monkeypatch):
    desc = load_scene(os.path.join(ASSETS, "softdof_scene.xml"))
    desc.camera.img_width, desc.camera.img_height = 40, 30
    kw = dict(spp_min=2, spp_max=5, round_spp=1, batch_pixels=500,
              max_bounce=3, shadow_spp=2, shadow_spp_max=4)
    if case == "caustics":
        monkeypatch.setattr(megakernel, "mega_render",
                            megakernel.mega_render_host)
        desc = with_glass(desc, "mid")
        kw.update(spp_min=2, spp_max=4, batch_pixels=1 << 20,
                  use_photon_map=True, photon_map_size=400,
                  caustics_map_size=120, photon_map_bounce=6,
                  caustics_map_bounce=6)
    monkeypatch.setattr(renderer, "_pad_to_bucket",
                        _pad_to_bucket if padded else lambda n: n)
    r = Renderer(RendererParam(**kw), device="cpu")
    r._pipelined = pipelined
    r.compute_scene(desc)
    escalated = []
    if case == "caustics":
        g, c = r.photon_maps
        r.photon_maps = (g._replace(radius=torch.tensor(50.0)), c)
        inner = r._render_escalated

        def counted(*args):
            fixed = inner(*args)
            escalated.append(0 if fixed is None else fixed[0].size)
            return fixed

        r._render_escalated = counted
    return r.render(), sum(escalated)


@pytest.mark.parametrize("pipelined", [True, False], ids=["pipe", "sync"])
@pytest.mark.parametrize("case", ["softdof", "caustics"])
def test_padded_renderer_equals_unpadded(case, pipelined, monkeypatch,
                                         tmp_path):
    """softdof (phase 1 in chunks of 500 lanes, phase 2's unconverged sets)
    and caustics_scene on the megakernel's escalation route (its source on
    the CPU, the global radius blown up to 50), on the pipelined and the
    synchronous loop: the Renderer with every dispatch, the escalated
    lanes' included, padded to its bucket with dump lanes gives the planes
    of the unpadded one bit for bit."""
    if case == "caustics" and shutil.which("g++") is None:
        pytest.skip("needs g++ for the host build of the kernel source")
    monkeypatch.chdir(tmp_path)
    want, n_want = _render(case, pipelined, False, monkeypatch)
    got, n_got = _render(case, pipelined, True, monkeypatch)
    for k in PLANES:
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
    assert n_got == n_want
    assert want.count.max() > want.count.min()
    if case == "caustics":
        assert n_got > 0


def test_padded_lane_lists_equal_jax(monkeypatch):
    """Both Renderers on a stand-in dispatch (spot_scene at 24x18, phase 1
    in chunks of 300 lanes, phase 2 on the unconverged right half, a fifth
    of the lanes escalating): the sequence of dispatched lane lists (pixel
    x, y and sample of every lane, the padding lanes included) and of the
    escalated lanes' renders are equal."""
    w, h = 24, 18
    kw = dict(spp_min=2, spp_max=5, round_spp=1, batch_pixels=300,
              rng_impl="threefry2x32")
    logs = {}
    for pkg in ("jax", "port"):
        log = logs[pkg] = []
        for eng in (jax_engine, engine):
            monkeypatch.setattr(eng, "use_pathtrace_mega", lambda *a: True)
        path = os.path.join(ASSETS, "spot_scene.xml")
        if pkg == "jax":
            desc = jax_load(path)
            desc.camera.img_width, desc.camera.img_height = w, h
            r = JaxRenderer(JaxParam(**kw))
        else:
            desc = load_scene(path)
            desc.camera.img_width, desc.camera.img_height = w, h
            r = Renderer(RendererParam(**kw), device="cpu")
        r.compute_scene(desc)
        r.param.use_photon_map = True

        def lanes(kind, px, py, sid):
            px, py, sid = (np.asarray(x) for x in (px, py, sid))
            log.append((kind, px.tolist(), py.tolist(), sid.tolist()))
            right = px >= w // 2
            rad = np.stack([np.where(right, 1.0 + 0.01 * sid, 0.5), px, py],
                           axis=1).astype(np.float32)
            esc = ((px * 7 + py * 13 + sid * 3) % 5 == 0) & (py < h) & right
            return rad, esc

        if pkg == "jax":
            def dispatch(scene, meta, cfg, px, py, sid, key, maps,
                         want_aux=False):
                rad, esc = lanes("main", px, py, sid)
                n = rad.shape[0]
                return (jnp.asarray(rad), jnp.zeros(n), jnp.zeros(n, bool),
                        jnp.asarray(esc))

            def exact(scene, meta, cfg, px, py, sid, key, maps):
                rad, _ = lanes("exact", px, py, sid)
                return jnp.asarray(rad), jnp.zeros(rad.shape[0])

            r._render_fn = dispatch
            monkeypatch.setattr(jax_engine, "render_batch_xla", exact)
        else:
            def dispatch(scene, meta, cfg, px, py, sid, words, maps,
                         want_aux=False):
                rad, esc = lanes("main", px, py, sid)
                n = rad.shape[0]
                return (torch.tensor(rad), torch.zeros(n),
                        torch.zeros(n, dtype=torch.bool), torch.tensor(esc))

            def exact(scene, meta, cfg, px, py, sid, words, maps):
                rad, _ = lanes("exact", px, py, sid)
                return torch.tensor(rad), torch.zeros(rad.shape[0])

            r._render_fn = dispatch
            monkeypatch.setattr(engine, "render_batch_wavefront", exact)
        r.render()
    assert logs["port"] == logs["jax"]
    sizes = [len(x[1]) for x in logs["port"]]
    assert all(s >= 256 and s & (s - 1) == 0 for s in sizes)
    assert {x[0] for x in logs["port"]} == {"main", "exact"}
    # Phase 2 dispatched fewer pixels than the image, padded.
    assert any(w * h in [y * w + x for x, y in zip(e[1], e[2])]
               for e in logs["port"])


# -- the wrapper ---------------------------------------------------------------


def _meta_scene(name="softdof"):
    desc = load_scene(os.path.join(ASSETS, f"{name}_scene.xml"))
    desc.camera.img_width, desc.camera.img_height = 16, 12
    return compile_scene(desc, device="cpu")


def _on_meta(tree):
    from torch.utils import _pytree as pytree

    return pytree.tree_map(
        lambda x: x.to("meta") if isinstance(x, torch.Tensor) else x, tree)


def test_key_hits_on_same_shapes_and_misses_on_what_is_baked(monkeypatch):
    """render_batch's key on tensors of the meta device (which stand for a
    card's): equal for a call with other tensors of the same shapes (a new
    camera table, new lanes); different for another static argument, route
    switch, key word (a host value baked in), photon radius (a CPU tensor,
    keyed by value) or lane count."""
    monkeypatch.delenv("QARAY_NO_MEGAKERNEL", raising=False)
    monkeypatch.delenv("QARAY_EAGER", raising=False)
    arr, meta = _meta_scene()
    cfg = IntegratorConfig(integrator="pathtrace")
    scene = _on_meta(arr)

    def lanes(n):
        return tuple(torch.zeros(n, dtype=torch.int32, device="meta")
                     for _ in range(3))

    key = engine.render_batch.key_of(scene, meta, cfg, *lanes(256), (0, 7))
    assert key is not None
    cam = scene.camera._replace(pos=torch.empty(3, device="meta"))
    same = engine.render_batch.key_of(scene._replace(camera=cam), meta, cfg,
                                      *lanes(256), (0, 7))
    assert same == key
    misses = [
        engine.render_batch.key_of(scene, meta, cfg._replace(max_bounce=3),
                                   *lanes(256), (0, 7)),
        engine.render_batch.key_of(scene, meta, cfg, *lanes(512), (0, 7)),
        engine.render_batch.key_of(scene, meta, cfg, *lanes(256), (0, 8)),
        engine.render_batch.key_of(scene, meta, cfg, *lanes(256), (0, 7),
                                   want_aux=True),
    ]
    monkeypatch.setenv("QARAY_NO_MEGAKERNEL", "1")
    misses.append(engine.render_batch.key_of(scene, meta, cfg, *lanes(256),
                                             (0, 7)))
    monkeypatch.delenv("QARAY_NO_MEGAKERNEL")
    for radius in (0.2, 0.3):
        pm = PhotonMapData(*(torch.empty((8, 3), device="meta")
                             for _ in range(4)),
                           radius=torch.tensor(radius),
                           valid=torch.empty(8, dtype=torch.bool,
                                             device="meta"))
        misses.append(engine.render_batch.key_of(
            scene, meta, cfg, *lanes(256), (0, 7), photon_maps=(pm, pm)))
    assert len(set(misses + [key])) == len(misses) + 1
    # Under the explicit switch, with the plain versions asked for or on
    # the CPU the call runs the function directly: no key.
    with compiled.eager():
        assert engine.render_batch.key_of(scene, meta, cfg, *lanes(256),
                                          (0, 7)) is None
    monkeypatch.setenv("QARAY_NO_PALLAS", "1")
    assert engine.render_batch.key_of(scene, meta, cfg, *lanes(256),
                                      (0, 7)) is None
    monkeypatch.delenv("QARAY_NO_PALLAS")
    assert engine.render_batch.key_of(arr, meta, cfg, *(
        torch.zeros(256, dtype=torch.int32) for _ in range(3)),
        (0, 7)) is None


def test_wrapper_calls_the_function_directly_on_cpu():
    """On CPU tensors a wrapped function is called as it is (its own
    outputs come back, nothing is captured); render_batch on the CPU gives
    the unwrapped function's bits."""
    calls = []

    def fn(x, scale: float, meta=None):
        calls.append(x)
        return x * scale

    wrapped = compiled.jit(fn, static_argnames=("meta",), inputs=("x",))
    x = torch.arange(4.0)
    before = (compiled.stats["captures"], compiled.graph_count())
    out = wrapped(x, 2.0)
    assert torch.equal(out, x * 2.0) and calls == [x]
    assert (compiled.stats["captures"], compiled.graph_count()) == before
    arr, meta = _meta_scene()
    cfg = IntegratorConfig(integrator="pathtrace", max_bounce=2,
                           shadow_spp=2, shadow_spp_max=4)
    ids = torch.arange(64, dtype=torch.int32)
    args = (arr, meta, cfg, ids % 16, ids // 16, torch.zeros_like(ids),
            (0, 3))
    for a, b in zip(engine.render_batch(*args), engine._render_batch(*args)):
        assert torch.equal(a, b)
    assert (compiled.stats["captures"], compiled.graph_count()) == before


# -- ROADMAP C2: photon maps on a mesh scene ------------------------------------


@pytest.fixture(scope="module")
def mesh_photon_scene():
    """mesh_scene (320 triangles) at 48x36 with a point light 20 units
    over its icosphere, compiled by the JAX package, and the per-batch
    store masks of the JAX package's _build_one_map of its global map (400
    photons, 6 bounces, radius 0.2, seed 1)."""
    from qaray_tpu.scene.desc import LightDesc as JaxLight

    desc = jax_load(os.path.join(ASSETS, "mesh_scene.xml"))
    desc.camera.img_width, desc.camera.img_height = 48, 36
    desc.lights.append(JaxLight("point", "photons",
                                intensity=np.full(3, 900.0),
                                position=np.array([0.0, 50.0, 25.0])))
    jax.clear_caches()
    arrays, meta = jax_compile(desc)
    masks = []
    inner = jbuild.trace_photon_paths

    def trace_paths(*args, **kw):
        out = inner(*args, **kw)
        masks.append(np.asarray(out[0]))
        return out

    jbuild.trace_photon_paths = trace_paths
    try:
        jbuild._build_one_map(arrays, meta, JaxParam(), 400, 6, 0.2,
                              caustics=False, seed=1)
    finally:
        jbuild.trace_photon_paths = inner
        jax.clear_caches()
    return desc, masks


@pytest.mark.parametrize("route", ["stream", "tiles"], ids=["k3", "k4a"])
def test_mesh_photon_map_store_masks_match_jax(route, monkeypatch,
                                               mesh_photon_scene):
    """_build_one_map on mesh_scene with a point light added, the port on
    the JAX package's compiled tables (the JAX build on its default route),
    its trace on K3's route (the dense
    sweep) or K4a's (the tiled walk), in their plain versions. A float32
    rounding may store a photon in one package and not in the other and
    shift every later row (ROADMAP C2), so the bar is the per-batch store
    masks, path for path: at most 5e-5 of their entries disagree (C2
    measured 24 of 786,432, 3.1e-5; with this scene's light 20 units over
    the icosphere 4 of 417,792, and 10 units off it at (10, 30, 40) 59 of
    1,597,440, 3.7e-5), over the same batches."""
    desc, want = mesh_photon_scene
    if route == "tiles":
        monkeypatch.setenv("QARAY_STREAM_MAX_TRIS", "1")
    monkeypatch.setenv("QARAY_MESH_PATH", route)
    arrays, meta = jax_compile(desc)
    tarr, tmeta = from_numpy_arrays(jax.tree.map(np.asarray, arrays), meta,
                                    "cpu")
    assert trace.mesh_route(tmeta) == route
    got = []
    inner = tbuild.trace_photon_paths

    def trace_paths(*args, **kw):
        out = inner(*args, **kw)
        got.append(out[0].numpy())
        return out

    monkeypatch.setattr(tbuild, "trace_photon_paths", trace_paths)
    tbuild._build_one_map(tarr, tmeta, RendererParam(), 400, 6, 0.2,
                          caustics=False, seed=1)
    assert len(got) == len(want) >= 2
    total = sum(m.size for m in got)
    off = sum(int((a != b).sum()) for a, b in zip(got, want))
    assert off <= 5e-5 * total, (off, total)
    assert sum(int(m.sum()) for m in got) >= 400
