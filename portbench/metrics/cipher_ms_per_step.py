"""cipher_ms_per_step: device milliseconds a gradient step of the profiled
stretch in the wavefront engine's threefry cipher. On a program with the
kernel H1 these are its records, whose names hold `threefry`
(`threefry_fold_kernel`, `threefry_uniform_kernel`). A program without H1
runs the cipher as PyTorch's int64 elementwise passes, each uint32 word in
an int64 tensor: the bitwise and, xor and or, the shifts and the adds on
`long`, which this reads there. Those passes are told apart by functor
and type alone, so the reading also holds the few int64 passes of the
rays' fold data (`engine.lane_fold_data`: an add and an and on 480,000
lanes a step, some hundredths of a ms), on a program with H1 too."""

from portbench import devtrace

LAYER, SOURCE, MOVES = "wavefront", "device_trace", "grad_paths_per_s"

# Functors of PyTorch's elementwise kernels that the int64 cipher
# (core/krng.py) launches, each with `long` operands.
INT64_CIPHER_FUNCTORS = ("BitwiseAndFunctor<long>", "BitwiseXorFunctor<long>",
                         "BitwiseOrFunctor<long>", "CUDAFunctor_add<long>",
                         "CUDAFunctorOnSelf_add<long>")
INT64_SHIFTS = ("lshift_kernel_cuda", "rshift_kernel_cuda")


def is_cipher(name: str) -> bool:
    """Whether a device record is the cipher's: H1, or an int64 pass."""
    if "threefry" in name:
        return True
    if "elementwise_kernel" not in name:
        return False
    return (any(f in name for f in INT64_CIPHER_FUNCTORS)
            or ("<long" in name and any(s in name for s in INT64_SHIFTS)))


def read(rec, ctx):
    tr = rec["trace"]
    us = devtrace.device_us_where(tr["trace"],
                                  lambda name, span: is_cipher(name))
    return us / 1e3 / tr["steps"]
