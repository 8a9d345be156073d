"""Per-instance object-space meshes (scene/compiler.py's
_build_mesh_arrays, ops/trace.py's instance route on W1's plain version)
against the JAX package's compile_scene(world_bvh=False) and its
per-instance trace, and against the port's own world route.

Bars: tables equal bit for bit; hit records against JAX with t within
1e-5 relative, bary-derived normals and uvs within 1e-4 and footprints
within 1e-3 of 1 + |value| (the JAX loop moves the rays with XLA's
matmul(precision="highest"), the port with products summed in a fixed
order), material, front and hit flags equal, occlusion equal; renders
through the two routes as in tests/test_world_bvh.py: identity
instancing bit for bit, transformed and mirrored instances under 0.5 % of
pixels differing by more than 2/255."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qaray_tpu.ops import trace as jtrace
from qaray_tpu.scene.compiler import compile_scene as jax_compile
from qaray_tpu.scene.xml_parser import load_scene as jax_load
from qaray_tpu_torch.ops import trace
from qaray_tpu_torch.renderer import Renderer, RendererParam
from qaray_tpu_torch.scene.compiler import compile_scene
from qaray_tpu_torch.scene.convert import from_numpy_arrays
from qaray_tpu_torch.scene.xml_parser import load_scene

ASSETS = os.path.join(os.path.dirname(__file__), "assets")


def bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def test_compile_modes_match_jax(monkeypatch):
    """grid_scene: 25 instances of one 320-triangle mesh. world_bvh=False
    (and QARAY_NO_WORLD_BVH) gives JAX's meta and, field by field, its mesh
    and instance tables; convert.from_numpy_arrays carries JAX's scene
    across to the same tables and W1's transform rows."""
    path = os.path.join(ASSETS, "grid_scene.xml")
    ja, jm = jax_compile(jax_load(path), world_bvh=False)
    ta, tm = compile_scene(load_scene(path), device="cpu", world_bvh=False)
    monkeypatch.setenv("QARAY_NO_WORLD_BVH", "1")
    _, em = compile_scene(load_scene(path), device="cpu")
    assert tm._asdict() == jm._asdict() == em._asdict()
    assert not tm.world_bvh and tm.num_mesh_instances == 25
    assert tm.num_tris == 320
    ca, cm = from_numpy_arrays(jax.tree.map(np.asarray, ja), jm,
                               device="cpu")
    assert cm == tm
    for group in ("mesh", "instances"):
        for f in getattr(ta, group)._fields:
            mine = getattr(getattr(ta, group), f)
            if mine is None:
                assert getattr(getattr(ja, group), f, None) is None, f
                continue
            want = bits(getattr(getattr(ja, group), f))
            for got in (mine, getattr(getattr(ca, group), f)):
                np.testing.assert_array_equal(bits(got.numpy()), want,
                                              err_msg=f"{group}.{f}")
    assert torch.equal(ca.kernel.inst_xf, ta.kernel.inst_xf)
    assert ta.kernel.inst_xf.shape == (25, 12)


def aimed_rays(arrays, n, seed):
    """n rays from around the camera, three quarters aimed into the mesh's
    world bound box, with differential rays one hundredth of a pixel off."""
    rs = np.random.RandomState(seed)
    inst = arrays.instances
    lo, hi = [], []
    for i in range(inst.m_w2o.shape[0]):
        m_o2w = np.linalg.inv(inst.m_w2o[i].numpy())
        box = inst.obj_bbox[i].numpy()
        corners = np.array([[box[a], box[b + 1], box[c + 2]]
                            for a in (0, 3) for b in (0, 3) for c in (0, 3)])
        w = corners @ m_o2w.T + inst.t_o2w[i].numpy()
        lo.append(w.min(0))
        hi.append(w.max(0))
    lo, hi = np.min(lo, 0), np.max(hi, 0)
    cam = arrays.camera.pos.numpy()
    p = (cam + rs.normal(0, 0.05, (n, 3))).astype(np.float32)
    tgt = rs.uniform(lo, hi, (n, 3))
    tgt[: n // 4] = rs.uniform(-5, 5, (n // 4, 3))
    d = (tgt - p).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    off = rs.normal(0, 1e-2, (2, n, 3)).astype(np.float32)
    dx, dy = d + off[0], d + off[1]
    return p, d, (p, dx, p, dy)


def test_per_instance_trace_matches_jax():
    """mesh_scene (one scaled, translated instance), 1,024 rays:
    trace_closest with footprints and trace_shadow on the per-instance
    route against JAX's on the same tables."""
    path = os.path.join(ASSETS, "mesh_scene.xml")
    ja, jm = jax_compile(jax_load(path), world_bvh=False)
    ta, tm = from_numpy_arrays(jax.tree.map(np.asarray, ja), jm,
                               device="cpu")
    assert trace.mesh_route(tm) == "bvh"
    p, d, diff = aimed_rays(ta, 1024, 0)
    jh = jtrace.trace_closest(ja, jm, jnp.asarray(p), jnp.asarray(d),
                              diff=tuple(jnp.asarray(x) for x in diff))
    th = trace.trace_closest(ta, tm, torch.tensor(p), torch.tensor(d),
                             diff=tuple(torch.tensor(x) for x in diff))
    hit = np.asarray(jh["hit"])
    np.testing.assert_array_equal(th["hit"].numpy(), hit)
    assert 200 < hit.sum() < 1000
    np.testing.assert_allclose(th["t"].numpy(), np.asarray(jh["t"]),
                               rtol=1e-5)
    for k in ("mtl", "front", "has_texture"):
        np.testing.assert_array_equal(th[k].numpy()[hit],
                                      np.asarray(jh[k])[hit], err_msg=k)
    for k, tol in (("n", 1e-4), ("uvw", 1e-4), ("p", 1e-4),
                   ("duvw0", 1e-3), ("duvw1", 1e-3)):
        want = np.asarray(jh[k])[hit]
        np.testing.assert_allclose(th[k].numpy()[hit], want, rtol=tol,
                                   atol=tol, err_msg=k)
    t_max = np.full(1024, 60.0, np.float32)
    t_max[::3] = 5.0
    js = jtrace.trace_shadow(ja, jm, jnp.asarray(p), jnp.asarray(d),
                             jnp.asarray(t_max))
    ts = trace.trace_shadow(ta, tm, torch.tensor(p), torch.tensor(d),
                            torch.tensor(t_max))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert 0 < ts.sum() < 1024


def render(path, world, **env):
    desc = load_scene(path)
    desc.camera.img_width, desc.camera.img_height = 40, 30
    r = Renderer(RendererParam(spp_min=2, spp_max=2), device="cpu")
    r.compute_scene(desc, world_bvh=world)
    assert r.meta.world_bvh == world
    fb = r.render()
    return fb, np.asarray(fb.img, np.float32) / 255.0


@pytest.fixture
def wavefront(monkeypatch):
    """Both routes on the wavefront engine, as the JAX package renders both
    on the CPU (the world route would take the megakernel here)."""
    monkeypatch.setenv("QARAY_NO_MEGAKERNEL", "1")


def test_identity_instance_renders_bit_for_bit(tmp_path, wavefront):
    """mesh_scene with its instance's transform removed: the per-instance
    route (W1's plain version in object space) and the world route (the
    dense sweep's walk) give the same planes bit for bit."""
    xml = open(os.path.join(ASSETS, "mesh_scene.xml")).read()
    start = xml.index("<object type=\"obj\"")
    end = xml.index("</object>", start)
    body = xml[start:end]
    inner = body[body.index(">") + 1:]
    xml = xml[:start] + body[:body.index(">") + 1] + "\n" + "".join(
        line for line in inner.splitlines(True)
        if not line.strip().startswith(("<scale", "<translate",
                                         "<rotate"))) + xml[end:]
    shutil.copy(os.path.join(ASSETS, "icosphere.obj"), tmp_path)
    path = tmp_path / "identity_scene.xml"
    path.write_text(xml)
    fa, a = render(str(path), True)
    fb_, b = render(str(path), False)
    assert np.array_equal(fa.mean, fb_.mean)
    assert np.array_equal(a, b) and a.mean() > 0.01


def test_transformed_instances_render_like_world(wavefront):
    """grid_scene's 25 scaled and translated instances."""
    path = os.path.join(ASSETS, "grid_scene.xml")
    _, a = render(path, True)
    _, b = render(path, False)
    frac = (np.abs(a - b).max(axis=-1) > 2 / 255.0).mean()
    assert frac < 0.005, f"{frac:.4%} of pixels differ"
    assert a.mean() > 0.01


MIRROR = """\
<xml><scene>
<object type="obj" name="icosphere.obj" material="m">
  <scale x="-1" y="1" z="1"/>
</object>
<material type="blinn" name="m"><diffuse r="0.7" g="0.3" b="0.2"/></material>
<light type="point" name="l"><intensity value="40"/><position x="3" y="-4" z="6"/></light>
</scene>
<camera><position x="0" y="-6" z="0"/><target x="0" y="0" z="0"/>
<up x="0" y="0" z="1"/><fov value="40"/>
<width value="64"/><height value="48"/></camera></xml>
"""


def test_mirrored_instance_keeps_front_faces(tmp_path, wavefront):
    """tests/test_world_bvh.py's mirrored icosphere: the world route swaps
    corners at compile time, the per-instance route walks the mesh as it
    is in object space; both shade the front faces."""
    shutil.copy(os.path.join(ASSETS, "icosphere.obj"), tmp_path)
    path = tmp_path / "mirror_scene.xml"
    path.write_text(MIRROR)
    _, a = render(str(path), True)
    _, b = render(str(path), False)
    frac = (np.abs(a - b).max(axis=-1) > 2 / 255.0).mean()
    assert frac < 0.005, f"{frac:.4%} of pixels differ"
    assert a.mean() > 0.01


@pytest.mark.parametrize("world", [False, True])
def test_stacked_walk_matches_packed_walk(monkeypatch, world):
    """QARAY_BVH_WALK=stacked (the stacked walk under the same instance
    loop) against the packed walk, on grid_scene's 25 instances and on its
    world tree (QARAY_MESH_PATH=bvh): hit records and occlusion bit for
    bit, 256 rays."""
    monkeypatch.setenv("QARAY_MESH_PATH", "bvh")
    path = os.path.join(ASSETS, "grid_scene.xml")
    ta, tm = compile_scene(load_scene(path), device="cpu", world_bvh=world)
    assert tm.world_bvh == world
    p, d, _ = aimed_rays(ta, 256, 1)
    p, d = torch.tensor(p), torch.tensor(d)
    t_max = torch.full((256, ), 60.0)
    t_max[::3] = 5.0
    packed = trace.trace_closest(ta, tm, p, d)
    occ = trace.trace_shadow(ta, tm, p, d, t_max)
    monkeypatch.setenv("QARAY_BVH_WALK", "stacked")
    stacked = trace.trace_closest(ta, tm, p, d)
    for k, v in packed.items():
        assert np.array_equal(bits(stacked[k].numpy()), bits(v.numpy())), k
    assert 50 < int(packed["hit"].sum()) < 256
    s_occ = trace.trace_shadow(ta, tm, p, d, t_max)
    assert torch.equal(s_occ, occ) and 0 < int(occ.sum()) < 256


@pytest.mark.parametrize("world", [False, True])
def test_compile_checks_w1_stack(monkeypatch, world):
    """A mesh compiled for the card, per instance or world, is held to W1's
    stack when it is compiled, not when a render first walks it: here a
    cap of 3 refs against grid_scene's deeper trees."""
    from qaray_tpu_torch.ops import bvh_packed

    monkeypatch.setattr(bvh_packed, "STACK_CAP", 3)
    path = os.path.join(ASSETS, "grid_scene.xml")
    with pytest.raises(ValueError, match="QR_BVH_STACK"):
        compile_scene(load_scene(path), device="cuda", world_bvh=world)
