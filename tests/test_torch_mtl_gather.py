"""The material gather's backward (kernel G1, csrc/mtl_gather.cu) without a
card.

gather_bwd_host compiles the kernel's source with g++ against
csrc/host/cuda_runtime.h and runs it in host blocks of 256 threads, over a
grid of a few blocks (so that pass 2 folds several partials), against the
plain version, gather_bwd_plain (index_put_ with accumulate=True, which is
autograd's backward of table[mid]). The two sum each row's lanes in
different orders, so they agree to rounding, not bit for bit: the bar is
TOL of the row's sum of |g|, a few times the typical rounding of a float32
sum of 1e5 terms in any order (sqrt(1e5) * 2^-24 = 1.9e-5) and far below
what one lane left out or sent to the wrong row moves (1 / lanes of the
row, 1e-3 and more here); and EXACT_TOL of it of a float64 sum.
tests/test_torch_gpu.py holds the kernel itself to the plain version on a
card, at the same bars.
"""

import shutil

import numpy as np
import pytest
import torch

from qaray_tpu_torch.integrators.common import gather_materials
from qaray_tpu_torch.ops import mtl_gather
from qaray_tpu_torch.scene.compiler import compile_scene
from qaray_tpu_torch.scene.xml_parser import load_scene

TOL = 1e-4
# G1 against a float64 sum, of the row's sum of |g|: its longest chain of
# float32 adds here is a thread's lanes (up to 2,000 / 16), the 16 slices
# and the 16 fold slices, typically sqrt(160) * 2^-24 = 7.5e-7.
EXACT_TOL = 1e-6
SOFTDOF_ROWS = 2  # tests/assets/softdof_scene.xml's materials


def needs_gxx():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ for the host build of the kernel source")


def _inputs(n, rows, seed, absent=(), one_row=None):
    """mid [n] (every lane in row one_row where given, else random rows in
    runs of random length, as image rows hit surfaces) and the six
    cotangents, None at the indices in absent."""
    rs = np.random.RandomState(seed)
    if one_row is not None:
        mid = np.full(n, one_row, np.int64)
    else:
        runs = rs.randint(1, 40, size=n + 1)
        mid = np.repeat(rs.randint(0, rows, size=n + 1), runs)[:n]
    grads = [None if k in absent else torch.tensor(
        rs.standard_normal((n, w) if w > 1 else (n,)).astype(np.float32))
        for k, w in enumerate(mtl_gather.WIDTHS)]
    return torch.tensor(mid), grads


def assert_close_rows(got, want, mid, grads, rows, what):
    """Each gradient within TOL of its row's sum of |g| of the plain one
    and EXACT_TOL of a float64 sum; returns the largest ratio to the plain
    one."""
    worst = 0.0
    for k, (a, b, g) in enumerate(zip(got, want, grads)):
        if g is None:
            assert a is None and b is None, (what, k)
            continue
        scale = mtl_gather.gather_bwd_plain(mid, [g.abs()], rows)[0]
        off = (a - b).abs()
        assert torch.all(off <= TOL * scale), (what, k, off.max().item())
        exact = mtl_gather.gather_bwd_plain(mid, [g.double()], rows)[0]
        off_exact = (a.double() - exact).abs()
        assert torch.all(off_exact <= EXACT_TOL * scale.double()), (
            what, k, off_exact.max().item())
        ratio = (off / scale.clamp_min(1e-30)).max().item()
        worst = max(worst, ratio)
    return worst


@pytest.mark.parametrize("rows,n,absent,one_row", [
    (1, 3001, (), None),                      # M = 1
    (SOFTDOF_ROWS, 5000, (), None),           # softdof's M
    (101, 6000, (), None),  # three tiles of the source's 47 rows
    (SOFTDOF_ROWS, 0, (), None),              # no lanes: zeros
    (5, 1000, (1, 5), None),                  # absent cotangents
    (5, 4099, (), 3),                         # every lane in one row
])
def test_g1_source_matches_plain(rows, n, absent, one_row):
    """G1's source under g++ against index_put_, within TOL of each row's
    sum of |g|; twice the same bits; B = 0 gives zeros; an absent
    cotangent gives None."""
    needs_gxx()
    mid, grads = _inputs(n, rows, seed=rows + n, absent=absent,
                         one_row=one_row)
    want = mtl_gather.gather_bwd_plain(mid, grads, rows)
    got = mtl_gather.gather_bwd_host(mid, grads, rows)
    worst = assert_close_rows(got, want, mid, grads, rows, (rows, n))
    print(f"rows {rows} lanes {n}: largest gap {worst:.3g} of the row's "
          "sum of |g|")
    again = mtl_gather.gather_bwd_host(mid, grads, rows)
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b)
    if n == 0:
        assert all(a is None or not a.any() for a in got)


@pytest.mark.parametrize("n,want", [
    (480_000, (mtl_gather.MAX_BLOCKS, 455)),  # the inverse cell's lanes
    (100_000, (391, 256)),
    (2_000, (8, 250)),
    (100, (1, 100)),
    (0, (1, 0)),
])
def test_g1_grid_fills_the_card(n, want):
    """Pass 1 takes MAX_BLOCKS blocks (8 an SM of the H100) where the lanes
    give each at least MIN_CHUNK, fewer below; every grid covers its
    lanes."""
    blocks, chunk = mtl_gather.grid(n, mtl_gather.MAX_BLOCKS)
    assert (blocks, chunk) == want and blocks * chunk >= n


def _tables(rows, seed):
    rs = np.random.RandomState(seed)
    return [torch.tensor(rs.uniform(0.1, 1.0, (rows, w) if w > 1 else
                                    (rows,)).astype(np.float32))
            for w in mtl_gather.WIDTHS]


@pytest.mark.parametrize("need", [(True,) * 6,
                                  (True, False, True, False, False, True)])
def test_cpu_function_equals_plain_autograd(need):
    """On CPU tensors the gather's gradients equal autograd through
    table[mid] bit for bit (tables that need no gradient get none), the
    backward counts one call and no launch."""
    rows, n = 5, 3000
    mid, _ = _inputs(n, rows, seed=7)
    base = _tables(rows, seed=8)

    def grads(fn):
        leaves = [t.clone().requires_grad_(w) for t, w in zip(base, need)]
        outs = fn(leaves)
        loss = sum(((o * (k + 1.5)) ** 2).sum() for k, o in enumerate(outs)
                   if k != 3)
        wrt = [t for t in leaves if t.requires_grad]
        return torch.autograd.grad(loss, wrt, allow_unused=True)

    want = grads(lambda ts: [t[mid] for t in ts])
    calls, kernel = dict(mtl_gather.stats), dict(mtl_gather.launches)
    got = grads(lambda ts: mtl_gather.gather(mid, ts))
    assert mtl_gather.stats["bwd_calls"] == calls["bwd_calls"] + 1
    assert mtl_gather.stats["bwd_kernel"] == calls["bwd_kernel"]
    assert mtl_gather.launches == kernel
    assert len(got) == len(want) == sum(need)
    for a, b in zip(got, want):
        if b is None:  # the loss leaves out table 3
            assert a is None
        else:
            assert torch.equal(a, b)


def test_gather_off_a_tape_is_plain_indexing():
    """Under no_grad, and where no table requires grad, gather_materials
    runs plain indexing: no _Gather node, no backward call."""
    desc = load_scene("tests/assets/softdof_scene.xml")
    desc.camera.img_width, desc.camera.img_height = 16, 12
    arr, _ = compile_scene(desc, "cpu")
    assert arr.materials.diffuse.shape[0] == SOFTDOF_ROWS
    mt = arr.materials
    n = 64
    mtl_id = torch.arange(n, dtype=torch.int32) % SOFTDOF_ROWS - (
        torch.arange(n) % 7 == 0).int()  # some lanes missed: id -1
    uvw = torch.zeros(n, 3)
    has_tex = torch.zeros(n, dtype=torch.bool)
    before = dict(mtl_gather.stats)
    leaf = mt.diffuse.clone().requires_grad_()
    taped = arr._replace(materials=mt._replace(diffuse=leaf))
    with torch.no_grad():
        s = gather_materials(taped, mtl_id, uvw, has_tex, textured=False)
    assert s.diffuse.grad_fn is None
    s = gather_materials(arr, mtl_id, uvw, has_tex, textured=False)
    assert s.diffuse.grad_fn is None
    mid = torch.clamp_min(mtl_id, 0).long()
    assert torch.equal(s.diffuse, mt.diffuse[mid])
    assert torch.equal(s.glossiness, mt.glossiness[mid])
    assert mtl_gather.stats == before
    s = gather_materials(taped, mtl_id, uvw, has_tex, textured=False)
    assert type(s.diffuse.grad_fn).__name__ == "_GatherBackward"
    assert torch.equal(s.diffuse, mt.diffuse[mid])
    s.diffuse.sum().backward()
    assert mtl_gather.stats["bwd_calls"] == before["bwd_calls"] + 1
    assert torch.equal(leaf.grad, torch.zeros_like(leaf).index_put_(
        (mid,), torch.ones(n, 3), accumulate=True))
