"""The fused adjoint (kernel K6, csrc/adjoint.cu) without a card.

adjoint_render_host compiles the kernel source with g++ against
csrc/host/cuda_runtime.h and runs it one lane at a time, or in blocks of
128 threads as the card does (then two runs must give the same bits); it
is held to the
plain version, adjoint_render_plain (autograd through the wavefront
engine), and both to the JAX package's Pallas adjoint in interpret mode,
with tests/test_grad.py's bar of 3e-2 of max|b| per field (printed: the
measured figures are far below it). tests/test_torch_gpu.py holds the
kernel itself to the plain version on a card.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qaray_tpu.integrators.engine import IntegratorConfig as JaxConfig
from qaray_tpu.ops.pallas_adjoint import adjoint_render as jax_adjoint
from qaray_tpu_torch import diff
from qaray_tpu_torch.integrators.engine import IntegratorConfig
from qaray_tpu_torch.ops import adjoint
from test_torch_engine import lanes
from test_torch_grad import KW, cotangent, grad_scene, words


def needs_gxx():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ for the host build of the kernel source")


def field_errors(got, want, meta, scene):
    """Per DiffParams field of the flat layout (diff._unpack_adjoint):
    max|a - b| / max|b| (max|a| where b is 0 everywhere)."""
    a, b = (diff._unpack_adjoint(torch.as_tensor(np.array(x)), meta, scene)
            for x in (got, want))
    out = {}
    for f in diff.DiffParams._fields[:7] + ("background", "environment"):
        x, y = getattr(a, f).double(), getattr(b, f).double()
        scale = y.abs().max().item()
        err = (x - y).abs().max().item()
        out[f] = err / scale if scale > 0 else x.abs().max().item()
    return out


def check(got, want, meta, scene, what, bar=3e-2):
    errs = field_errors(got, want, meta, scene)
    print(f"{what}: " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    for k, v in errs.items():
        assert v <= bar, f"{what}: {k} off by {v:.3g} of max|b|"
    return max(errs.values())


def test_kernel_source_matches_plain_and_pallas_interpret():
    """spot_scene 16x12, max_bounce 2: the K6 source on the host, its plain
    version and the JAX package's adjoint_render(interpret=True), all at
    the same numpy cotangent and threefry key; the source also fills its
    work counters."""
    needs_gxx()
    arrays, meta, tarr, tmeta, res = grad_scene("spot")
    cfg = IntegratorConfig(**KW)
    assert adjoint.adjoint_supported(tmeta, cfg)
    px, py, sid = lanes(res, 1)
    ct = cotangent(px.shape[0])
    kd = jax.random.key_data(jax.random.key(3, impl="threefry2x32"))
    want = jax_adjoint(arrays, meta, JaxConfig(**KW), jnp.asarray(px),
                       jnp.asarray(py), jnp.asarray(sid), kd,
                       jnp.asarray(ct), True)
    tpx, tpy, tsid, tct = (torch.tensor(a) for a in (px, py, sid, ct))
    plain = adjoint.adjoint_render_plain(tarr, tmeta, cfg, tpx, tpy, tsid,
                                         words(), tct)
    work = torch.zeros((px.shape[0], 4), dtype=torch.int32)
    before = dict(adjoint.launches)
    host = adjoint.adjoint_render_host(tarr, tmeta, cfg, tpx, tpy, tsid,
                                       words(), tct, work=work)
    assert adjoint.launches == before  # no kernel launch is counted
    want = np.asarray(want)
    assert want.shape == plain.shape == host.shape
    assert np.abs(want).max() > 0.0
    check(host, plain, tmeta, tarr, "source vs plain")
    check(host, want, tmeta, tarr, "source vs Pallas interpret")
    check(plain, want, tmeta, tarr, "plain vs Pallas interpret")
    tests, ciphers, vertices, tri_tests = work.sum(0).tolist()
    assert tests > 0 and ciphers > 0 and vertices > 0 and tri_tests == 0


@pytest.mark.parametrize("name,words_of", [("mesh", "threefry"),
                                           ("glass", "threefry"),
                                           ("spot", "rbg")])
def test_kernel_source_matches_plain(name, words_of):
    """The K6 source on the host against its plain version on mesh_scene
    (K1c's mesh sweep in the replay), the glass scene (refraction and the
    soft light) and spot_scene under rbg key words (folded as the
    megakernel folds them), max_bounce 3."""
    needs_gxx()
    _, _, tarr, tmeta, res = grad_scene(name)
    cfg = IntegratorConfig(**dict(KW, max_bounce=3))
    assert adjoint.adjoint_supported(tmeta, cfg)
    px, py, sid = (torch.tensor(a) for a in lanes(res, 1))
    ct = torch.tensor(cotangent(px.shape[0], seed=4))
    kw = words() if words_of == "threefry" else (0, 7, 0, 7)
    work = torch.zeros((px.shape[0], 4), dtype=torch.int32)
    host = adjoint.adjoint_render_host(tarr, tmeta, cfg, px, py, sid, kw, ct,
                                       work=work)
    plain = adjoint.adjoint_render_plain(tarr, tmeta, cfg, px, py, sid, kw,
                                         ct)
    check(host, plain, tmeta, tarr, f"{name} source vs plain")
    assert (work.sum(0)[3] > 0) == (name == "mesh")


@pytest.mark.parametrize("name", ["spot", "glass"])
def test_kernel_source_in_blocks_of_128_is_deterministic(name):
    """The K6 source on the host in blocks of 128 threads, the card's
    block (each thread's column of sums and the fixed-order fold over the
    block's columns): two runs give the same bits, and they are within
    3e-2 of each field's max|b| of the plain version (spot_scene and the
    glass scene, max_bounce 3)."""
    needs_gxx()
    _, _, tarr, tmeta, res = grad_scene(name)
    cfg = IntegratorConfig(**dict(KW, max_bounce=3))
    px, py, sid = (torch.tensor(a) for a in lanes(res, 1))
    ct = torch.tensor(cotangent(px.shape[0], seed=6))
    runs = [adjoint.adjoint_render_host(tarr, tmeta, cfg, px, py, sid,
                                        words(), ct, block=128)
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    plain = adjoint.adjoint_render_plain(tarr, tmeta, cfg, px, py, sid,
                                         words(), ct)
    check(runs[0], plain, tmeta, tarr, f"{name} source in blocks of 128 "
          "vs plain")


def test_gate_keeps_k6_within_shared_memory():
    """adjoint_supported takes a scene while a K6 block's shared memory
    fits SMEM_LIMIT and refuses it one primitive beyond (at 8 material rows
    and 8 lights 2,683 primitives fit), so that such a scene takes the
    autograd route; block_smem_bytes is the kernel source's own count
    (qr_adjoint_smem_bytes of its host build)."""
    needs_gxx()
    _, _, _, tmeta, _ = grad_scene("spot")
    cfg = IntegratorConfig(**KW)

    def meta_of(n):
        return tmeta._replace(num_materials=8, num_lights=8, num_analytic=n,
                              analytic_kinds=(0,) * n)

    fits = 2683
    assert adjoint.block_smem_bytes(fits, 8, 8) <= adjoint.SMEM_LIMIT
    assert adjoint.block_smem_bytes(fits + 1, 8, 8) > adjoint.SMEM_LIMIT
    assert adjoint.adjoint_supported(meta_of(fits), cfg)
    assert not adjoint.adjoint_supported(meta_of(fits + 1), cfg)
    adjoint._kernel(host=True)
    kernel_count = adjoint._fns["host_smem"]
    for counts in ((fits, 8, 8), (fits + 1, 8, 8), (1, 1, 0),
                   (tmeta.num_analytic, tmeta.num_materials,
                    tmeta.num_lights)):
        assert kernel_count(*counts) == adjoint.block_smem_bytes(*counts)


def test_adjoint_render_on_the_cpu_is_the_plain_version():
    """On CPU tensors adjoint_render is adjoint_render_plain and counts no
    launch; it refuses a configuration outside adjoint_supported."""
    _, _, tarr, tmeta, res = grad_scene("spot")
    cfg = IntegratorConfig(**KW)
    px, py, sid = (torch.tensor(a) for a in lanes(res, 1))
    ct = torch.tensor(cotangent(px.shape[0]))
    before = dict(adjoint.launches)
    got = adjoint.adjoint_render(tarr, tmeta, cfg, px, py, sid, words(), ct)
    assert adjoint.launches == before
    assert torch.equal(got, adjoint.adjoint_render_plain(
        tarr, tmeta, cfg, px, py, sid, words(), ct))
    photon = IntegratorConfig(**dict(KW, integrator="photonmap"))
    assert not adjoint.adjoint_supported(tmeta, photon)
    if shutil.which("g++") is not None:
        with pytest.raises(NotImplementedError):
            adjoint.adjoint_render_host(tarr, tmeta, photon, px, py, sid,
                                        words(), ct)
