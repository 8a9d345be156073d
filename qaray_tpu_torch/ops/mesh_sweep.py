"""Dense triangle sweep kernel (K3, csrc/mesh.cu) beside its plain version.

Counterpart of qaray_tpu/ops/pallas_mesh.py (pallas_sweep_closest ->
_sweep_kernel): every ray against every triangle of the world mesh, with
the linear-in-t predicate of ops/mesh_stream.py, folding each ray's
closest triangle row and its runner-up. With t_cur set to a shadow ray's
budget the same sweep is the any-hit test (ops/trace.py, as the JAX
package's trace_shadow does on the TPU).

The wrappers take the [Fp, 16] coefficient table of pack_coeff16. For
tensors on the CPU they run the plain versions, stream_closest and
stream_any_hit (ops/mesh_stream.py), on the same coefficients; for CUDA
tensors they launch the kernel, never falling back from one to the
other. `launches` counts kernel launches.
"""

import numpy as np
import torch

from qaray_tpu_torch.ops.mesh_stream import (
    StreamTris,
    stream_any_hit,
    stream_closest,
)

# The compiler's route limit for the dense sweep (the JAX package's VMEM
# budget of its coefficient table): above it a world mesh takes the tiled
# route. Kept so that the compiled meta equals the JAX package's.
PALLAS_MESH_MAX_TRIS = 65536
ROW_ALIGN = 128  # pack_coeff16 pads rows to a multiple of this

launches = {"K3": 0}

_fn = []


def _kernel():
    if not _fn:
        from qaray_tpu_torch.ops import _build

        lib = _build.load("mesh")
        _fn.append(_build.bind(lib, "qr_mesh_sweep", "ppppiiipppp"))
    return _fn[0]


def pack_coeff16(stream_coeff, stream_const) -> np.ndarray:
    """Sweep coefficients -> the [Fp, 16] table the kernels read.

    cols: 0-2 n, 3-5 A, 6-8 B, 9 k, 10 a0, 11 b0, 12 |n|, 13-15 zero. Rows
    pad to a multiple of 128 with zeros, which never hit."""
    coeff = np.asarray(stream_coeff, np.float32)  # [F,3,3]
    const = np.asarray(stream_const, np.float32)  # [F,4]
    f = coeff.shape[0]
    out = np.zeros((f, 16), np.float32)
    out[:, 0:9] = coeff.reshape(f, 9)
    out[:, 9:13] = const
    pad = (-f) % ROW_ALIGN
    if pad:
        out = np.concatenate([out, np.zeros((pad, 16), np.float32)])
    return out


def unpack_coeff16(coeff16) -> StreamTris:
    """The [Fp, 16] table as the plain versions' StreamTris (views)."""
    return StreamTris(coeff16[:, 0:9].reshape(-1, 3, 3), coeff16[:, 9:13])


def _check(p, d, t_cur, coeff16):
    dev = p.device
    for t in (d, t_cur, coeff16):
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
    for t in (p, d):
        if t.dtype != torch.float32 or t.ndim != 2 or t.shape[1] != 3:
            raise ValueError(f"rays must be float32 [B, 3], got {t.dtype} "
                             f"{tuple(t.shape)}")
    if d.shape != p.shape:
        raise ValueError("p and d differ in shape")
    if t_cur.dtype != torch.float32 or t_cur.shape != p.shape[:1]:
        raise ValueError("t_cur must be float32 [B]")
    if (coeff16.dtype != torch.float32 or coeff16.ndim != 2
            or coeff16.shape[1] != 16 or coeff16.shape[0] % ROW_ALIGN
            or not coeff16.is_contiguous()):
        raise ValueError("coeff16 must be contiguous float32 [Fp, 16] with "
                         "Fp a multiple of 128 (pack_coeff16)")


def _plain_chunk(coeff16):
    return 256 if coeff16.shape[0] % 256 == 0 else ROW_ALIGN


def _launch(p, d, t_cur, coeff16, any_hit):
    n = p.shape[0]
    dev = p.device
    t = torch.empty(n, dtype=torch.float32, device=dev)
    row = torch.empty(n, dtype=torch.int32, device=dev)
    row2 = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        from qaray_tpu_torch.ops import _build

        p, d, t_cur = p.contiguous(), d.contiguous(), t_cur.contiguous()
        rc = _kernel()(p.data_ptr(), d.data_ptr(), t_cur.data_ptr(),
                       coeff16.data_ptr(), coeff16.shape[0], n,
                       int(any_hit), t.data_ptr(), row.data_ptr(),
                       row2.data_ptr(),
                       torch.cuda.current_stream().cuda_stream)
        _build.check(rc, "K3 mesh sweep")
        launches["K3"] += 1
    return t, row, row2


def sweep_closest(p, d, t_cur, coeff16):
    """Closest triangle below t_cur per ray: (t [B], row [B] or -1, row2
    [B] runner-up or -1). Rows index coeff16 (the world triangle ids of the
    dense route)."""
    _check(p, d, t_cur, coeff16)
    if p.device.type == "cpu":
        return stream_closest(p, d, t_cur, unpack_coeff16(coeff16),
                              chunk=_plain_chunk(coeff16))
    return _launch(p, d, t_cur, coeff16, any_hit=False)


def sweep_occluded(p, d, t_max, coeff16):
    """Occluded [B] bool: some triangle has BIAS < t < t_max. On the card,
    K3 seeded with t_max that stops a block once all its rays are
    occluded."""
    _check(p, d, t_max, coeff16)
    if p.device.type == "cpu":
        return stream_any_hit(p, d, t_max, unpack_coeff16(coeff16),
                              chunk=_plain_chunk(coeff16))
    return _launch(p, d, t_max, coeff16, any_hit=True)[1] >= 0
