"""The material gather and its backward (kernel G1, csrc/mtl_gather.cu).

gather(mid, tables) gives table[mid] for the five colour tables [M, 3]
and the glossiness [M] that diff.DiffParams differentiates
(integrators/common.gather_materials). Off a tape it is that indexing and
nothing else. On a tape (grad enabled and a table requiring grad) it goes
through _Gather, whose forward is the same indexing, so its bits do not
change, and whose backward sums each cotangent into its table's rows:

- for CUDA tensors G1, sort-free, deterministic, in two passes (the
  source says how); the JAX package leaves this to XLA's scatter-add
  under jax.grad, PyTorch's own backward sorts the lanes' rows first;
- for CPU tensors the plain version, gather_bwd_plain:
  zeros.index_put_((mid,), g, accumulate=True), which is autograd's own
  backward of table[mid] bit for bit.

It never falls back from one to the other. gather_bwd_host runs the
kernel's source on the CPU under g++, for tests. `launches` counts G1's
launches; `stats` the backward calls (bwd_calls) and those that launched
G1 (bwd_kernel).
"""

import torch

launches = {"G1": 0}
stats = {"bwd_calls": 0, "bwd_kernel": 0}

# The tables' widths: five colour slots, then the glossiness.
WIDTHS = (3, 3, 3, 3, 3, 1)
THREADS = 256  # threads a block (csrc/mtl_gather.cu kThreads)
# Pass 1's grid over the lanes (times the row tiles): at most MAX_BLOCKS
# blocks (8 blocks of 256 threads fill each of the H100's 132 SMs), each
# taking at least MIN_CHUNK lanes.
MAX_BLOCKS = 132 * 8
MIN_CHUNK = 256
HOST_MAX_BLOCKS = 3  # gather_bwd_host's grid, a few blocks to fold

_fns = {}


def _kernel(host: bool = False):
    """qr_mtl_gather_bwd of the CUDA library, or with host=True of the same
    source built for the CPU (_build.load_host; tests only)."""
    if host not in _fns:
        from qaray_tpu_torch.ops import _build

        lib = (_build.load_host if host else _build.load)("mtl_gather")
        _fns[host] = _build.bind(lib, "qr_mtl_gather_bwd",
                                 "pi" + "p" * 6 + "iiip" + "p" * 6 + "p")
        if host:
            _fns["host_block"] = _build.bind(lib, "qr_host_set_block", "i")
    return _fns[host]


def gather(mid, tables):
    """table[mid] for each of the six tables (WIDTHS), through _Gather where
    a tape records it."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tables):
        return _Gather.apply(mid, *tables)
    return tuple(t[mid] for t in tables)


class _Gather(torch.autograd.Function):
    """table[mid] for six tables; the backward sums each cotangent into its
    table's rows (G1 on a card)."""

    @staticmethod
    def forward(ctx, mid, *tables):
        ctx.save_for_backward(mid)
        ctx.rows = tables[0].shape[0]
        ctx.set_materialize_grads(False)
        return tuple(t[mid] for t in tables)

    @staticmethod
    def backward(ctx, *grads):
        (mid,) = ctx.saved_tensors
        want = ctx.needs_input_grad[1:]
        grads = tuple(g if w else None for g, w in zip(grads, want))
        stats["bwd_calls"] += 1
        if mid.device.type == "cpu":
            out = gather_bwd_plain(mid, grads, ctx.rows)
        else:
            out = gather_bwd(mid, grads, ctx.rows)
        return (None, *out)


def gather_bwd_plain(mid, grads, rows):
    """The plain version: each cotangent [B, w] (or None) summed into a
    zero table [rows, w] at mid by index_put_(accumulate=True)."""
    return tuple(
        None if g is None else g.new_zeros((rows,) + g.shape[1:]).index_put_(
            (mid,), g, accumulate=True)
        for g in grads)


def gather_bwd(mid, grads, rows):
    """G1 on the current stream: the tables' gradients [rows, w], None where
    the cotangent is None (no launch where all are)."""
    if all(g is None for g in grads):
        return (None,) * len(WIDTHS)
    out = _launch(_kernel(), torch.cuda.current_stream().cuda_stream, mid,
                  grads, rows, MAX_BLOCKS)
    launches["G1"] += 1
    stats["bwd_kernel"] += 1
    return out


def gather_bwd_host(mid, grads, rows, max_blocks=HOST_MAX_BLOCKS):
    """G1's source run on the CPU on CPU tensors (_build.load_host), in host
    blocks of THREADS threads. For tests without a card: no entry point
    calls it and it counts no launch."""
    if mid.device.type != "cpu":
        raise ValueError("gather_bwd_host takes CPU tensors")
    fn = _kernel(host=True)
    from qaray_tpu_torch.ops import _build

    _build.check(_fns["host_block"](THREADS), "host block size")
    try:
        return _launch(fn, None, mid, grads, rows, max_blocks)
    finally:
        _fns["host_block"](1)


def grid(n: int, max_blocks: int) -> tuple:
    """(blocks, lanes a block) of pass 1 over n lanes: as many blocks of at
    least MIN_CHUNK lanes as max_blocks allows, at least one."""
    blocks = max(1, min(-(-n // MIN_CHUNK), max_blocks))
    return blocks, -(-n // blocks)


def _launch(fn, stream, mid, grads, rows, max_blocks):
    """Check the arguments and call qr_mtl_gather_bwd `fn` on `stream`."""
    dev = mid.device
    n = mid.shape[0]
    if mid.dtype != torch.int64 or mid.ndim != 1:
        raise ValueError(f"mid must be int64 [B], got {mid.dtype} "
                         f"{tuple(mid.shape)}")
    if len(grads) != len(WIDTHS) or rows < 1:
        raise ValueError(f"G1 takes {len(WIDTHS)} cotangents and rows >= 1")
    for g, w in zip(grads, WIDTHS):
        if g is not None and (g.device != dev or g.dtype != torch.float32
                              or g.shape != ((n, w) if w > 1 else (n,))):
            raise ValueError(f"cotangents must be float32 [B, {w}] on {dev}"
                             f", got {g.dtype} {tuple(g.shape)}")
    grads = [None if g is None else g.contiguous() for g in grads]
    out = [None if g is None else torch.empty(
        (rows, w) if w > 1 else (rows,), dtype=torch.float32, device=dev)
        for g, w in zip(grads, WIDTHS)]
    blocks, chunk = grid(n, max_blocks)
    part = torch.empty((blocks, rows, 16), dtype=torch.float32, device=dev)
    from qaray_tpu_torch.ops import _build

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = fn(mid.contiguous().data_ptr(), n, *map(ptr, grads), rows, blocks,
            chunk, part.data_ptr(), *map(ptr, out), stream)
    _build.check(rc, "G1 material-gather backward")
    return tuple(out)
