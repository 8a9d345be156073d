"""The port's BVH walks (ops/bvh_traverse.py, ops/bvh_packed.py) against
the JAX package's, and W1's source (csrc/bvh.cu) built for the host
against the plain packed walk.

The rays and soups are tests/test_bvh.py's. Bars: against JAX, t within
1e-5 relative (test_bvh's) and bary within 5e-5 (XLA rounds a few
operations of the triangle test differently, and the weights are ratios
of areas that cancel: 1.2e-5 on a centroid-aimed ray), the triangle and
the front flag equal, any hit equal; the port's packed walk against its stacked walk and W1 against
the plain packed walk, bit for bit (the same operations in the same
order), W1 also with its work counters and in host blocks of 32 and 128
threads that share its staged instances and barriers."""

import functools
import re
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qaray_tpu.ops.bvh_packed import traverse_bvh_packed as jax_packed
from qaray_tpu.ops.bvh_traverse import traverse_bvh as jax_stacked
from qaray_tpu.scene.arrays import MeshArrays as JaxMesh
from qaray_tpu_torch.core.constants import BIGFLOAT
from qaray_tpu_torch.ops import bvh_packed, bvh_traverse
from qaray_tpu_torch.scene import bvh as tbvh
from qaray_tpu_torch.scene.arrays import MeshArrays


def soup(n_tris, seed):
    rs = np.random.RandomState(seed)
    centers = rs.uniform(-2, 2, (n_tris, 1, 3))
    return (centers + rs.uniform(-0.4, 0.4, (n_tris, 3, 3))).astype(
        np.float32)


def rays(n, seed):
    rs = np.random.RandomState(seed)
    p = rs.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return p, d


def tables(tri_v):
    """(port MeshArrays, JAX MeshArrays, pnodes, ltri, root ref, depth) of
    one soup's SAH tree."""
    b = tbvh.build_bvh(tri_v, 4)
    pnodes, ltri, ref = tbvh.pack_bvh(b.bounds, b.left, b.right, b.count,
                                      b.elems, tri_v)
    f = tri_v.shape[0]
    soa = dict(tri_v=tri_v, tri_n=np.zeros_like(tri_v),
               tri_uv=np.zeros((f, 3, 2), np.float32),
               tri_has_uv=np.zeros(f, bool), tri_mtl=np.zeros(f, np.int32),
               bvh_bounds=b.bounds, bvh_left=b.left, bvh_right=b.right,
               bvh_count=b.count, bvh_elems=b.elems)
    tm = MeshArrays(**{k: torch.tensor(v) for k, v in soa.items()})
    jm = JaxMesh(**{k: jnp.asarray(v) for k, v in soa.items()})
    return tm, jm, pnodes, ltri, int(ref[0]), tbvh.bvh_depth(b)


def close_to_jax(jax_out, port_out):
    jt, jtri, jbary, jfront = (np.asarray(x) for x in jax_out)
    t, tri, bary, front = (x.numpy() for x in port_out)
    np.testing.assert_array_equal(tri, jtri)
    np.testing.assert_array_equal(front, jfront)
    np.testing.assert_allclose(t, jt, rtol=1e-5)
    np.testing.assert_allclose(bary, jbary, atol=5e-5)


@pytest.mark.parametrize("any_hit", [False, True])
def test_walks_match_jax(any_hit):
    """300 triangles, 512 rays (test_bvh's packed-against-stacked case):
    closest, or any hit below t 5. Both port walks against both JAX walks;
    the port's packed walk bit for bit its stacked walk."""
    tri_v = soup(300, 7)
    p, d = rays(512, 8)
    tm, jm, pnodes, ltri, root, depth = tables(tri_v)
    t0 = np.full(512, 5.0 if any_hit else BIGFLOAT, np.float32)
    kw = dict(stack_size=depth + 2, any_hit=any_hit)
    jp = jax_packed(jnp.asarray(p), jnp.asarray(d),
                    jnp.full(512, root, jnp.int32), jnp.asarray(t0),
                    jnp.asarray(pnodes), jnp.asarray(ltri), **kw)
    js = jax_stacked(jnp.asarray(p), jnp.asarray(d),
                     jnp.zeros(512, jnp.int32), jnp.asarray(t0), jm, **kw)
    tp = bvh_packed.traverse_bvh_packed(
        torch.tensor(p), torch.tensor(d), torch.full((512, ), root,
                                                     dtype=torch.int32),
        torch.tensor(t0), torch.tensor(pnodes), torch.tensor(ltri), **kw)
    ts = bvh_traverse.traverse_bvh(torch.tensor(p), torch.tensor(d),
                                   torch.zeros(512, dtype=torch.int32),
                                   torch.tensor(t0), tm, **kw)
    if any_hit:
        occ = [np.asarray((o[1] >= 0) & (o[0] < t0)) for o in (jp, js)]
        occ += [((o[1] >= 0) & (o[0] < torch.tensor(t0))).numpy()
                for o in (tp, ts)]
        for o in occ[1:]:
            np.testing.assert_array_equal(o, occ[0])
        assert 0 < occ[0].sum() < 512
        return
    close_to_jax(jp, tp)
    close_to_jax(js, ts)
    for a, b in zip(tp, ts):
        assert torch.equal(a, b)
    assert 0 < (tp[1] >= 0).sum() < 512


def test_packed_single_leaf_root():
    """Three triangles: the root is a leaf ref, popped as the first step's
    slot-0 work. Half the rays aim at a triangle's centroid."""
    tri_v = soup(3, 5)
    p, d = rays(64, 6)
    aim = tri_v.mean(axis=1)[np.arange(32) % 3] - p[:32]
    d[:32] = aim / np.linalg.norm(aim, axis=1, keepdims=True)
    _, _, pnodes, ltri, root, _ = tables(tri_v)
    assert root < 0
    jt = jax_packed(jnp.asarray(p), jnp.asarray(d),
                    jnp.full(64, root, jnp.int32), jnp.full(64, BIGFLOAT),
                    jnp.asarray(pnodes), jnp.asarray(ltri), stack_size=4)
    tt = bvh_packed.traverse_bvh_packed(
        torch.tensor(p), torch.tensor(d),
        torch.full((64, ), root, dtype=torch.int32),
        torch.full((64, ), BIGFLOAT), torch.tensor(pnodes),
        torch.tensor(ltri), stack_size=4)
    close_to_jax(jt, tt)
    assert (tt[1] >= 0).any()


def instance_table(n_inst, seed):
    """n_inst affine instances, the third mirrored: [n_inst, 12] rows of
    M_w2o (row-major) and t_o2w."""
    rs = np.random.RandomState(seed)
    rows = []
    for i in range(n_inst):
        m_o2w = rs.normal(size=(3, 3)) * 0.3 + np.eye(3)
        if i == 2:
            m_o2w[:, 0] *= -1
        rows.append(np.concatenate([np.linalg.inv(m_o2w).reshape(9),
                                    rs.uniform(-1.5, 1.5, 3)]))
    return torch.tensor(np.stack(rows).astype(np.float32))


def lopsided(n_tris, seed):
    """A soup with its first triangle made three times larger and moved 6
    away on every axis: the root's children are a leaf (that triangle) and
    an inner node."""
    tri_v = soup(n_tris, seed)
    c = tri_v[0].mean(axis=0)
    tri_v[0] = (tri_v[0] - c) * np.float32(3.0) + c + np.float32(6.0)
    return tri_v


def through_lone_triangle(p, d, tri_v, seed):
    """The first half of the rays from beyond the lopsided soup's lone
    triangle through it towards the rest: their root step hits the leaf
    child first, and its t decides whether the inner child is pushed."""
    rs = np.random.RandomState(seed)
    m = p.shape[0] // 2
    p[:m] = 2 * tri_v[0].mean(axis=0) + rs.normal(size=(m, 3)) * 0.5
    aim = rs.normal(size=(m, 3)) * 0.5 - p[:m]
    d[:m] = aim / np.linalg.norm(aim, axis=1, keepdims=True)


SOUPS = {"soup": lambda: soup(300, 7), "lopsided": lambda: lopsided(100, 7),
         "three": lambda: soup(3, 5)}


@functools.lru_cache(maxsize=None)
def plain_walks(instances, n, kind="soup"):
    """The plain loop's results on n of the rays over the tree of SOUPS's
    `kind` (300 triangles; 100 whose root has a leaf child; 3 in a leaf
    root) (instances 0: as a world tree): the tables, closest from
    BIGFLOAT with and without work counts, and the occlusion below t 3
    with a third of the rays occluded on entry, with and without work
    counts. Cached: the host block sizes of one case compare with the same
    plain walks, whose instances are walked one at a time where work is
    counted."""
    tri_v = SOUPS[kind]()
    p, d = rays(n, 8)
    if kind == "lopsided":
        through_lone_triangle(p, d, tri_v, 9)
    _, _, pnodes, ltri, root, depth = tables(tri_v)
    pt, dt = torch.tensor(p), torch.tensor(d)
    tabs = (torch.tensor(pnodes), torch.tensor(ltri),
            torch.full((max(instances, 1), ), root, dtype=torch.int32),
            instance_table(instances, 3) if instances else None)
    kw = dict(stack_size=depth + 2)
    t0 = torch.full((n, ), BIGFLOAT)
    work = torch.zeros((n, 2), dtype=torch.int32)
    closest = bvh_packed.closest(pt, dt, t0, *tabs, work=work, **kw)
    batched = bvh_packed.closest(pt, dt, t0, *tabs, **kw)
    t_max = torch.full((n, ), 3.0)
    occ_in = torch.arange(n) % 3 == 0
    occ_work = torch.zeros_like(work)
    occ = bvh_packed.occluded(pt, dt, t_max, occ_in, *tabs, work=occ_work,
                              **kw)
    occ_batched = bvh_packed.occluded(pt, dt, t_max, occ_in, *tabs, **kw)
    return dict(rays=(pt, dt), tabs=tabs, kw=kw, t0=t0, closest=closest,
                work=work, batched=batched, t_max=t_max, occ_in=occ_in,
                occ=occ, occ_work=occ_work, occ_batched=occ_batched)


def w1_host_matches_plain(instances, n, block=1, kind="soup"):
    """csrc/bvh.cu under g++ in host blocks of `block` threads against the
    plain loop (plain_walks) bit for bit: closest (t, instance, triangle,
    bary, front, work counts) and the occlusion (the flags, work counts).
    The plain loop without work counts walks instances together, for the
    same bits. Returns the closest hits' instances."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ for the host build of the kernel source")
    w = plain_walks(instances, n, kind)
    pt, dt = w["rays"]
    before = bvh_packed.launches["W1"]
    got, work = bvh_packed.walk_host(pt, dt, w["t0"], *w["tabs"],
                                     block=block, **w["kw"])
    for a, b, c in zip(w["closest"], got, w["batched"]):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(work, w["work"])
    assert (work[:, 0] > 0).all() if kind != "three" else (
        (work[:, 0] == 0).all() and (work[:, 1] > 0).all())
    occ_in = w["occ_in"]
    occ, work = bvh_packed.walk_host(pt, dt, w["t_max"], *w["tabs"],
                                     any_hit=True, occ_in=occ_in,
                                     block=block, **w["kw"])
    assert torch.equal(w["occ"], occ) and torch.equal(work, w["occ_work"])
    assert torch.equal(w["occ_batched"], occ)
    assert (occ & ~occ_in).any() and not (occ | occ_in).all()
    assert (work[occ_in] == 0).all()
    assert bvh_packed.launches["W1"] == before
    return got[1]


@pytest.mark.parametrize("instances", [0, 5])
def test_w1_source_on_the_host_matches_plain(instances):
    """csrc/bvh.cu compiled by g++ (one thread a block) against the plain
    loop, bit for bit (w1_host_matches_plain, 512 rays); the plain loop
    without work counts walks instances together, for the same bits.
    instances 0 walks the soup's tree as a world tree (no transform); 5
    walks it as five transformed instances, one of them mirrored, each of
    which wins some ray."""
    inst = w1_host_matches_plain(instances, 512)
    if instances:
        assert len(set(inst[inst >= 0].tolist())) == instances


def staging_chunk():
    """kChunk of csrc/bvh.cu, the instances a block stages at once, and
    bvh_packed.CHUNK (its copy for the shared-memory size) equal to it."""
    src = (Path(bvh_packed.__file__).parent.parent / "csrc" /
           "bvh.cu").read_text()
    chunk = int(re.search(r"constexpr int kChunk = (\d+);", src).group(1))
    assert chunk == bvh_packed.CHUNK
    return chunk


@pytest.mark.parametrize("block", [32, 128])
@pytest.mark.parametrize("case", ["world", "5 instances", "chunk+3",
                                  "lopsided world", "lopsided",
                                  "leaf root"])
def test_w1_blocks_on_the_host_match_plain(case, block):
    """csrc/bvh.cu in host blocks of 32 and 128 threads (fibers sharing the
    staged instances and the stack's shared memory, and its barriers)
    against the plain loop, bit for bit (w1_host_matches_plain): 500 rays,
    a multiple of neither block, over the 300-triangle soup's tree as a
    world tree and as five instances, over a tree whose root has a leaf
    child (its triangle tested in the root step; half the rays through it)
    as a world tree and as five instances, and over five instances of a
    tree that is one leaf; 512 rays over three instances more than one
    staging chunk of the soup, so that a block stages twice and the second
    chunk's instances win rays."""
    chunk = staging_chunk()
    if case == "chunk+3":
        inst = w1_host_matches_plain(chunk + 3, 512, block)
        assert (inst >= chunk).any() and (inst[inst >= 0] < chunk).any()
        return
    instances, kind = {"world": (0, "soup"), "5 instances": (5, "soup"),
                       "lopsided world": (0, "lopsided"),
                       "lopsided": (5, "lopsided"),
                       "leaf root": (5, "three")}[case]
    inst = w1_host_matches_plain(instances, 500, block, kind)
    assert (inst >= 0).any()


def test_w1_refuses_a_deep_stack():
    """A tree deeper than W1's stack raises, naming the cap."""
    with pytest.raises(ValueError, match="QR_BVH_STACK"):
        bvh_packed.check_stack(bvh_packed.STACK_CAP + 1)
