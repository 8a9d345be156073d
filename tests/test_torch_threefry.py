"""The wavefront engine's random draws on the card (kernel H1,
csrc/threefry.cu) without a card.

ops/threefry.fold_host and uniform_host compile the kernel's source with
g++ against csrc/host/cuda_runtime.h and run it on CPU tensors; each case
holds it to core/krng.py's int64 cipher (fold2, draw_at), the plain
version the CPU path runs, bit for bit. Keys and data span the 32-bit
range, data at and above 2^31 included. A draw's output holds fewer than
2^31 floats, so its flat index has a high word of 0, and the wrapper
refuses a larger one. tests/test_torch_gpu.py holds the kernel itself to
the same code on a card, at the main path's shapes.
"""

import shutil

import pytest
import torch

from qaray_tpu_torch.core import krng, rng
from qaray_tpu_torch.integrators.engine import lane_fold_data
from qaray_tpu_torch.ops import threefry

LANES = 1000
EDGES = (0, 1, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 1)


def needs_gxx():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ for the host build of the kernel source")


def _words(n, seed):
    """n uint32 words in int64, the edges of the range first."""
    g = torch.Generator().manual_seed(seed)
    w = torch.randint(0, 2**32, (n,), generator=g, dtype=torch.int64)
    w[:len(EDGES)] = torch.tensor(EDGES)
    return w


def _keys(seed=0):
    return _words(LANES, seed), _words(LANES, seed + 1).flip(0)


def _lane_data():
    """lane_fold_data at 800x600, 4 samples a pixel: rid * 65536 + sid
    wrapped to 32 bits (rid * 65536 passes 2^31 past the first 32,768
    pixels), over the frame's first and last pixels and a spread between."""
    rid = torch.cat([torch.arange(300), torch.arange(32_700, 32_900),
                     torch.arange(480_000 - 500, 480_000)])
    px, py = rid % 800, rid // 800
    sid = torch.arange(rid.shape[0]) % 4
    data = lane_fold_data(px.int(), py.int(), sid.int(), 800)
    assert int(data.max()) >= 2**31
    return data


def _fold_case(name):
    """(got, want) pairs of the fold cases."""
    k0, k1 = _keys()
    if name == "tensor_data":
        d = _words(LANES, 7)
        return threefry.fold_host(k0, k1, d), krng.fold2(k0, k1, d)
    if name == "scalar_tag":
        tag = rng.P_SHADOW + 101 * 3
        return (threefry.fold_host(k0, k1, tag),
                krng.fold2(k0, k1, torch.full_like(k0, tag)))
    if name == "tag_above_2^31":
        tag = 2**32 - 5
        return (threefry.fold_host(k0, k1, tag),
                krng.fold2(k0, k1, torch.full_like(k0, tag)))
    if name == "scalar_keys":  # ray_keys: base words, one id a lane
        d = _lane_data()
        return (threefry.fold_host(0x9E3779B9, 2**32 - 1, d),
                krng.fold2(0x9E3779B9, 2**32 - 1, d))
    if name == "one_element_keys":  # the photon batch's words on the device
        d = _words(LANES, 9)
        b0, b1 = torch.tensor(2**31 + 3), torch.tensor(17)
        return threefry.fold_host(b0, b1, d), krng.fold2(b0, b1, d)
    raise ValueError(name)


FOLDS = ["tensor_data", "scalar_tag", "tag_above_2^31", "scalar_keys",
         "one_element_keys"]
DRAWS = [1, 2, 8, 256, 7]


@pytest.mark.parametrize("case", [("fold", name) for name in FOLDS]
                         + [("uniform", n) for n in DRAWS],
                         ids=lambda c: "-".join(map(str, c)))
def test_h1_source_equals_int64_cipher(case):
    """H1's source under g++ against core/krng.py, bit for bit: fold with
    tensor data, with a scalar tag (below and above 2^31), with scalar base
    words over lane_fold_data's wrapped values at 800x600 and with
    one-element key tensors; uniform with n = 1, 2, 7, 8 and 256 draws a
    lane."""
    needs_gxx()
    if case[0] == "fold":
        (g0, g1), (w0, w1) = _fold_case(case[1])
        assert g0.dtype == g1.dtype == torch.int64
        assert torch.equal(g0, w0) and torch.equal(g1, w1)
        return
    n = case[1]
    k0, k1 = _keys(seed=n)
    got = threefry.uniform_host(k0, k1, n)
    f = torch.arange(n, dtype=torch.int64)
    want = krng.draw_at(k0[:, None], k1[:, None], f[None, :])
    assert got.shape == (LANES, n) and got.dtype == torch.float32
    assert torch.equal(got, want)
    # rng.uniform's CPU path is the same draws
    assert torch.equal(rng.uniform((k0, k1), (n,)), got)


@pytest.mark.parametrize("lanes,n", [(2, 2**30), (1, 2**31)])
def test_h1_uniform_refuses_2_31_floats(lanes, n):
    """An output of 2^31 floats or more, whose flat indices would pass the
    kernel's 31 bits, is refused before anything is allocated or built."""
    k0, k1 = _keys()
    with pytest.raises(ValueError, match="2\\^31"):
        threefry.uniform_host(k0[:lanes], k1[:lanes], n)
