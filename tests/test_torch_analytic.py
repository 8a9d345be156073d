"""The port's analytic intersection (plain versions of kernels K2a-K2c)
against qaray_tpu.ops.intersect and the Pallas kernels of
qaray_tpu/ops/pallas_analytic.py in interpret mode, on random rays against
the primitives of the in-repo scenes. Bars of tests/test_pallas.py: 99th
percentile relative t error < 1e-5, < 0.5 % hit/miss flips, > 99.5 % same
primitive, attributes equal (atol 1e-4) on agreeing lanes, < 0.5 % shadow
disagreements. The CUDA kernels are held to the same bars on the card by
tests/test_torch_gpu.py and chip_smoke.py.
"""

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
