"""The instanced mesh field of the benchmark's grid configuration
(portbench/scenes): the per-instance route's render against the
configuration's own plain reference (portbench/reference_grid), that
reference's walk against a test of every triangle of every instance, and
the committed scene against its generator and the program's route."""

import os

import numpy as np
import pytest
import torch

from portbench import check
from portbench.reference_grid import render as RG
from portbench.reference_grid import trace as RT
from portbench.reference.intersect import intersect_triangles
from portbench.scenes import make_grid as G
from qaray_tpu_torch.renderer import Renderer, RendererParam
from qaray_tpu_torch.scene.compiler import compile_scene
from qaray_tpu_torch.scene.xml_parser import load_scene

SCENES = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                      "portbench", "scenes")
# The grid configuration's renderer (portbench/configs/grid.json).
RENDERER = dict(integrator="photonmap", max_bounce=5, shadow_spp=16,
                shadow_spp_max=64, use_photon_map=False, use_srgb=True,
                rng_impl="threefry2x32")
# grid.instances' limits (portbench/workloads/grid.instances.json).
LIMITS = {"count_mismatch_share": 1e-3, "mean_rel_gap": 1e-4,
          "bad_pixel_share": 1e-3}


@pytest.fixture(scope="module")
def field(tmp_path_factory):
    """A 3 x 3 patch of the field (its middle rows and columns), of the
    generator's rock at subdivision 2 (320 triangles)."""
    out = tmp_path_factory.mktemp("grid")
    v, f = G.rock(2)
    (out / "rock2.obj").write_text(G.obj_text(v, f))
    rocks = [r for k, r in enumerate(G.placements())
             if k // G.GRID in (5, 6, 7) and k % G.GRID in (4, 5, 6)]
    path = out / "grid3.xml"
    path.write_text(G.scene_xml("rock2.obj", rocks))
    return str(path)


@pytest.mark.parametrize("seed", [2**40 + 7, 91, 2**33 + 3])
def test_per_instance_render_matches_reference(field, seed):
    """The wavefront render of the per-instance route (W1's plain walk)
    at 32 x 24, 2 spp, against reference_grid within the cell's limits;
    the CPU route rounds as the reference does, so the gap is rounding."""
    desc = load_scene(field)
    desc.camera.img_width, desc.camera.img_height = 32, 24
    r = Renderer(RendererParam(spp_min=2, spp_max=2, seed=seed, **RENDERER),
                 device="cpu")
    r.compute_scene(desc, world_bvh=False)
    assert not r.meta.world_bvh and r.meta.num_mesh_instances == 9
    fb = r.render()
    arr, meta = RG.load(field, 32, 24, "cpu")
    cfg = RG.IntegratorConfig(integrator="photonmap", max_bounce=5)
    mean, count = RG.render_image(arr, meta, cfg,
                                  RG.key_words("threefry2x32", seed), 2, 2,
                                  (0.005, 0.001, 0.005))
    numbers = check.image_summary([check.image_numbers(
        torch.as_tensor(fb.mean).reshape(-1, 3),
        torch.as_tensor(fb.count).reshape(-1), mean, count)])
    ok, compared = check.judge(numbers, LIMITS)
    assert ok, compared
    assert float(mean.mean()) > 0.01


def test_reference_walk_equals_every_triangle(field):
    """reference_grid's closest hits over the 9 instances against a test
    of every triangle of every instance, on 4,096 seeded rays from above
    the field towards it: the same t, and the same instance and triangle
    wherever the least t is not shared."""
    arr, _ = RG.load(field, 32, 24, "cpu")
    fld = arr.mesh
    g = torch.Generator().manual_seed(20)
    n = 4096
    p = torch.rand((n, 3), generator=g) * torch.tensor([12.0, 12.0, 4.0]) \
        + torch.tensor([-9.0, -5.0, 1.0])
    aim = torch.rand((n, 3), generator=g) * torch.tensor([8.0, 8.0, 2.0]) \
        + torch.tensor([-6.0, -2.0, -1.0])
    d = torch.nn.functional.normalize(aim - p, dim=1)
    t_cur = torch.full((n,), 1e30)
    t, inst, tri = RT.mesh_closest(fld, p, d, t_cur)
    n_inst, m = fld.m_w2o.shape[0], fld.tri_v.shape[0]
    all_t = torch.full((n, n_inst, m), torch.inf)
    for i in range(n_inst):
        po, do = RT._to_object(fld, p, d, torch.full((n,), i))
        ti, _, _, hit = intersect_triangles(
            po.repeat_interleave(m, 0), do.repeat_interleave(m, 0),
            fld.tri_v[:, 0].repeat(n, 1), fld.tri_v[:, 1].repeat(n, 1),
            fld.tri_v[:, 2].repeat(n, 1), t_cur.repeat_interleave(m))
        all_t[:, i] = torch.where(hit, ti, torch.inf).reshape(n, m)
    flat = all_t.reshape(n, -1)
    want_t, at = flat.min(dim=1)
    found = torch.isfinite(want_t)
    assert 0.2 < found.float().mean() < 0.95
    assert torch.equal(tri >= 0, found)
    assert torch.equal(t[found], want_t[found])
    unique = found & ((flat == want_t[:, None]).sum(dim=1) == 1)
    assert unique.sum() > 0.95 * found.sum()
    assert torch.equal(inst[unique], at[unique] // m)
    assert torch.equal(tri[unique], at[unique] % m)


def test_generator_reproduces_the_committed_scene(tmp_path):
    """make_grid.py rewrites rock6.obj and grid_scene.xml byte for byte;
    the parsed scene holds 144 nodes sharing one 81,920-face mesh, and
    the compiler keeps it per instance (11.8M world triangles)."""
    G.main(["--out", str(tmp_path)])
    for name in (G.OBJ_NAME, G.XML_NAME):
        with open(os.path.join(SCENES, name), "rb") as a, \
                open(tmp_path / name, "rb") as b:
            assert a.read() == b.read(), name
    desc = load_scene(os.path.join(SCENES, G.XML_NAME))
    nodes = [c for c in desc.root.children if c.mesh is not None]
    assert len(nodes) == 144
    assert all(c.mesh is nodes[0].mesh for c in nodes)
    assert nodes[0].mesh.faces.shape == (81920, 3)
    assert nodes[0].mesh.vertices.shape == (40962, 3)
    arr, meta = compile_scene(desc, device="cpu")
    assert not meta.world_bvh
    assert meta.num_mesh_instances == 144
    assert arr.mesh.ltri.shape[0] == 81920
    assert np.isfinite(arr.instances.m_w2o.numpy()).all()
