"""The wavefront engine on the port's mesh routes against qaray_tpu's:
grid_scene on the dense route (K3's plain version) and the tiled route
(K4a/K4b's), with tests/test_torch_engine.py's inputs and bars (split
from that file so that the test workers share the load).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qaray_tpu.integrators.engine import IntegratorConfig as JaxConfig
from qaray_tpu.integrators.engine import render_batch_xla
from qaray_tpu.scene.compiler import compile_scene
from qaray_tpu.scene.xml_parser import load_scene
from qaray_tpu_torch.integrators import engine
from qaray_tpu_torch.scene.convert import from_numpy_arrays

from test_torch_engine import RES, compare, lanes


@pytest.fixture
def fresh_jit():
    """JAX's trace functions are jitted on the meta and read the route
    variables (QARAY_MESH_PATH) while tracing: clear its caches around each
    mode."""
    jax.clear_caches()
    yield
    jax.clear_caches()


def _mesh_case(name, integrator, subdiv=None):
    from qaray_tpu_torch.scene.procedural import icosphere, with_mesh

    scene = load_scene(f"tests/assets/{name}_scene.xml")
    if subdiv is not None:
        scene = with_mesh(scene, *icosphere(subdiv))
    scene.camera.img_width, scene.camera.img_height = RES
    arrays, meta = compile_scene(scene)
    tarr, tmeta = from_numpy_arrays(jax.tree.map(np.asarray, arrays), meta,
                                    "cpu")
    kw = dict(integrator=integrator, max_bounce=3, shadow_spp=4,
              shadow_spp_max=8)
    px, py, sid = lanes()
    key = jax.random.key(3, impl="threefry2x32")
    rad_x, t0_x = render_batch_xla(arrays, meta, JaxConfig(**kw),
                                   jnp.asarray(px), jnp.asarray(py),
                                   jnp.asarray(sid), key)
    words = tuple(int(w) for w in np.asarray(jax.random.key_data(key)))
    rad, t0 = engine.render_batch_wavefront(
        tarr, tmeta, engine.IntegratorConfig(**kw), torch.tensor(px),
        torch.tensor(py), torch.tensor(sid), words)
    compare(np.asarray(rad_x), np.asarray(t0_x), rad.numpy(), t0.numpy())
    return tmeta


def test_engine_grid_stream_route_matches_jax(monkeypatch, fresh_jit):
    """25 mesh instances baked into one 8,000-triangle world mesh, on the
    dense-sweep route (K3's plain version)."""
    monkeypatch.setenv("QARAY_MESH_PATH", "stream")
    meta = _mesh_case("grid", "pathtrace")
    assert meta.mesh_stream and meta.num_tris == 8000


@pytest.mark.parametrize("integrator", ["pathtrace", "photonmap"])
def test_engine_tiled_route_matches_jax(integrator, monkeypatch, fresh_jit):
    """An ico3 (1,280 triangles, 5 clusters) forced onto the tiled route:
    the two-phase march of K4a and K4b's any hit in their plain version on
    the port's side, the XLA tiled sweep on JAX's."""
    monkeypatch.setenv("QARAY_STREAM_MAX_TRIS", "1")
    monkeypatch.setenv("QARAY_MESH_PATH", "tiles")
    meta = _mesh_case("mesh", integrator, subdiv=3)
    assert meta.mesh_tiled and not meta.mesh_stream and meta.num_tris == 1280
