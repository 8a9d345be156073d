"""qaray_tpu_torch.core against qaray_tpu.core and jax.random.

The threefry primitives must reproduce jax.random bit for bit (the
megakernel's and the wavefront engine's draws rest on them); Halton and the
warps agree to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qaray_tpu.core import halton as jhalton
from qaray_tpu.core import warps as jwarps
from qaray_tpu_torch.core import halton as thalton
from qaray_tpu_torch.core import krng, rng
from qaray_tpu_torch.core import warps as twarps

# The ids of tests/test_megakernel.py, including the int32 edges.
IDS = np.array([0, 1, 65536, -5, 2**31 - 1, -(2**31), 123456789], np.int32)


def _key_words(key):
    kd = np.asarray(jax.random.key_data(key)).astype(np.int64)
    return int(kd[0]), int(kd[1])


@pytest.mark.parametrize("seed", [0, 7, 2**32 - 1])
def test_fold2_bit_exact(seed):
    base = jax.random.key(seed, impl="threefry2x32")
    keys = jax.vmap(lambda i: jax.random.fold_in(base, i))(jnp.asarray(IDS))
    want = np.asarray(jax.vmap(jax.random.key_data)(keys)).astype(np.int64)
    b0, b1 = _key_words(base)
    g0, g1 = krng.fold2(b0, b1, torch.tensor(IDS))
    assert np.array_equal(g0.numpy(), want[:, 0])
    assert np.array_equal(g1.numpy(), want[:, 1])


def test_draw_at_and_uniform_bit_exact():
    base = jax.random.key(7, impl="threefry2x32")
    keys = jax.vmap(lambda i: jax.random.fold_in(base, i))(jnp.asarray(IDS))
    keys2 = jax.vmap(lambda k: jax.random.fold_in(k, 1003))(keys)
    t_keys = rng.fold(rng.ray_keys(_key_words(base), torch.tensor(IDS)),
                      1003)

    one = jax.vmap(lambda k: jax.random.uniform(k, (), jnp.float32))(keys2)
    got = krng.draw_at(t_keys[0], t_keys[1], 0)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(one))

    for shape in [(2,), (3, 2, 2), (4, 4, 2), (64, 2, 2)]:
        want = jax.vmap(lambda k: jax.random.uniform(k, shape, jnp.float32))(
            keys2)
        assert np.array_equal(rng.uniform(t_keys, shape).numpy(),
                              np.asarray(want)), shape


def test_fold_words():
    assert rng.fold_words((0, 5)) == (0, 5)
    # jax 'rbg' key data is [0, s, 0, s]: the xor-fold gives (0, 0).
    kd = np.asarray(jax.random.key_data(jax.random.key(5, impl="rbg")))
    assert rng.fold_words(kd.tolist()) == (0, 0)


def test_halton_matches():
    idx = np.array([0, 1, 2, 3, 7, 64, 1000, 65535, 2**31 - 1], np.int32)
    for base in (2, 3, 11, 13):
        want = np.asarray(jhalton.halton(jnp.asarray(idx), base))
        got = thalton.halton(torch.tensor(idx), base).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        np.testing.assert_array_equal(thalton.halton_np(idx, base),
                                      jhalton.halton_np(idx, base))


def test_warps_match():
    rs = np.random.RandomState(0)
    u2 = rs.uniform(size=(256, 2)).astype(np.float32)
    u3 = rs.uniform(size=(256, 3)).astype(np.float32)
    ua = rs.uniform(size=(256, 4, 2)).astype(np.float32)
    rad = rs.uniform(0.1, 2.0, size=(256,)).astype(np.float32)
    cases = [
        ("uniform_sphere", (u2,)),
        ("uniform_hemisphere", (u2,)),
        ("cos_weighted_hemisphere", (u2,)),
        ("cos_lobe_weighted_hemisphere", (u2, 20.0)),
        ("uniform_ball", (u3, rad)),
        ("uniform_ball_ref", (ua, rad)),
        ("concentric_disc", (u2, 0.8)),
    ]
    for name, args in cases:
        want = getattr(jwarps, name)(*(
            jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args))
        got = getattr(twarps, name)(*(
            torch.tensor(a) if isinstance(a, np.ndarray) else a
            for a in args))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=0, err_msg=name)
