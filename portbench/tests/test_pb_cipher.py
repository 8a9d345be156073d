"""cipher_ms_per_step's choice of device records, on names as the H100's
profiler gives them: H1's kernels and the int64 cipher's elementwise
passes count; float32 passes, int64 passes of other functors and other
kernels do not."""

import pytest

from portbench.metrics import cipher_ms_per_step as M

EW = "void at::native::vectorized_elementwise_kernel<2, "
CIPHER = [
    "threefry_uniform_kernel(UniformParams)",
    "threefry_fold_kernel(FoldParams)",
    EW + "at::native::AUnaryFunctor<long, long, long, at::native::"
    "BitwiseAndFunctor<long> >, std::array<char*, 2ul> >(int, ...)",
    EW + "at::native::BinaryFunctor<long, long, long, at::native::"
    "BitwiseXorFunctor<long> >, std::array<char*, 3ul> >(int, ...)",
    EW + "at::native::BinaryFunctor<long, long, long, at::native::"
    "BitwiseOrFunctor<long> >, std::array<char*, 3ul> >(int, ...)",
    EW + "at::native::CUDAFunctor_add<long>, std::array<char*, 3ul> >(int, "
    "at::native::CUDAFunctor_add<long>, std::array<char*, 3ul>)",
    EW + "at::native::CUDAFunctorOnSelf_add<long>, std::array<char*, 2ul> >"
    "(int, ...)",
    EW + "at::native::BUnaryFunctor<long, long, long, at::native::"
    "rshift_kernel_cuda(at::TensorIteratorBase&)::{lambda()#1}::operator()"
    "() const::{lambda()#4}::o",
    EW + "at::native::BUnaryFunctor<long, long, long, at::native::"
    "lshift_kernel_cuda(at::TensorIteratorBase&)::{lambda()#1}::operator()"
    "() const::{lambda()#4}::o",
    "void at::native::elementwise_kernel<128, 2, at::native::"
    "gpu_kernel_impl_nocast<at::native::CUDAFunctor_add<long> >(at::"
    "TensorIteratorBase&, at::native::CUDAFunctor_add<long> const&)::"
    "{lambda(int)#1}>(",
]
OTHER = [
    "void at::native::elementwise_kernel<128, 2, at::native::"
    "gpu_kernel_impl_nocast<at::native::BinaryFunctor<float, float, float, "
    "at::native::binary_internal::MulFunctor<float> > >(at::",
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "CUDAFunctor_add<float>, std::array<char*, 3ul> >(int, ...)",
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "BinaryFunctor<int, int, int, at::native::BitwiseAndFunctor<int> >, "
    "std::array<char*, 3ul> >(int, ...)",
    "void at::native::(anonymous namespace)::CatArrayBatchedCopy_alignedK_"
    "contig<at::native::(anonymous namespace)::OpaqueType<4u>, unsigned "
    "int, 4, 128, 1, 16>(at::native::(anonymous namespace)::OpaqueTyp",
    "mtl_gather_bwd_kernel(Params)",
    "mega_kernel(MegaParams)",
]


@pytest.mark.parametrize("name,counted", [(n, True) for n in CIPHER]
                         + [(n, False) for n in OTHER])
def test_cipher_records(name, counted):
    assert M.is_cipher(name) is counted


def test_cipher_ms_a_step():
    kernels = [(n, 0.0, 1000.0, "step") for n in CIPHER + OTHER]
    rec = {"trace": {"trace": {"kernels": kernels}, "steps": 2}}
    assert M.read(rec, {}) == pytest.approx(len(CIPHER) * 1000 / 1e3 / 2)
