// The wavefront engine's random draws (H1): threefry-2x32-20 over a batch
// of keys in one launch, on csrc/threefry.cuh's uint32 cipher.
//
//   fold    (threefry_fold_kernel):    out[i] = fold2((k0[i], k1[i]), d[i])
//   uniform (threefry_uniform_kernel): out[b, j] = draw_at((k0[b], k1[b]), j)
//
// equal bit for bit to core/krng.py's fold2 and draw_at, which keep each
// uint32 word in an int64 tensor and run the cipher as some 175 elementwise
// passes (20 rounds of add, rotate, xor, each add and rotate masked back to
// 32 bits, five key injections, u01). Replaces no Pallas kernel: the JAX
// package leaves the cipher to XLA's fused elementwise ops
// (qaray_tpu/core/krng.py).
//
// What bounds it on the H100: integer operations. A draw is one cipher and
// u01, at least 71 integer instructions (chip_smoke.py H1_INT_OPS_A_DRAW),
// and writes 4 B: at 1.673e13 integer operations/s against 3.35e12 B/s the
// operations take some 3.5 times the bytes' time. A fold reads 24 B and
// writes 16 B a lane for one cipher, and is bound by bytes. The design:
// - one thread an output element, 256 threads a block, no shared memory,
//   no atomics: every element is a pure function of its key and index;
// - uniform: thread i of a launch draws element i of the row-major
//   [lanes, n] output, so a warp's float32 stores are one contiguous run
//   along n; its lane b = i / n by a multiply and a shift (the divisor's
//   magic number set once a launch), and the lane's two key words are
//   loaded through the read-only cache, which broadcasts them to the
//   threads of a lane;
// - rotations are funnel shifts: nvcc compiles threefry.cuh's rotl32,
//   (x << r) | (x >> (32 - r)) with r a constant once unrolled, to one
//   SHF.L.W each (chip_smoke.py phase 3h counts them in the SASS), so the
//   header, which K1a and K6 share, is left as it is.
// An output holds fewer than 2^31 elements (the magic division's range),
// so a draw's flat index j < 2^31 has a high word of 0, the cipher's first
// word, as in draw_at.
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

// Launch through the macro csrc/host/cuda_runtime.h redefines for the CPU
// tests (ops/_build.load_host).
#ifndef QR_LAUNCH
#define QR_LAUNCH(kernel, blocks, threads, smem, stream, arg) \
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(arg)
#endif

namespace {

constexpr int kThreads = 256;
// Elements the uniform kernel covers at most.
constexpr long long kMaxElements = (1ll << 31) - 1;

// One operand of a fold: an int64 tensor read at i * step (step 1: one
// value a lane; step 0: one value for all), or `value` where src is null.
struct Operand {
  const long long* src;
  long long step;
  uint32_t value;
};

struct FoldParams {
  Operand k0, k1, data;
  long long n;
  long long* out0;  // [n] the folded key's words, as uint32 in int64
  long long* out1;
};

struct UniformParams {
  const long long* k0;  // [lanes] key words, as uint32 in int64
  const long long* k1;
  uint32_t n;           // draws a lane
  uint32_t total;       // lanes * n, < 2^31
  uint32_t mul, shr;    // i / n == __umulhi(i, mul) >> shr (n > 1)
  float* out;           // [lanes, n]
};

__device__ __forceinline__ uint32_t word(const Operand& o, long long i) {
  return o.src != nullptr ? (uint32_t)__ldg(o.src + i * o.step) : o.value;
}

__global__ void __launch_bounds__(kThreads)
    threefry_fold_kernel(const FoldParams P) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P.n) return;
  const Key k = fold2(Key{word(P.k0, i), word(P.k1, i)}, word(P.data, i));
  P.out0[i] = (long long)k.k0;
  P.out1[i] = (long long)k.k1;
}

__global__ void __launch_bounds__(kThreads)
    threefry_uniform_kernel(const UniformParams P) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P.total) return;
  const uint32_t b = P.n == 1 ? i : __umulhi(i, P.mul) >> P.shr;
  const Key k{(uint32_t)__ldg(P.k0 + b), (uint32_t)__ldg(P.k1 + b)};
  P.out[i] = draw_at(k, i - b * P.n);
}

// (mul, shr) with i / d == __umulhi(i, mul) >> shr for 0 <= i < 2^31 and
// d >= 2: l = ceil(log2 d), mul = ceil(2^(31 + l) / d) (Granlund and
// Montgomery's round-up method, as CUTLASS's FastDivmod).
void magic(uint32_t d, uint32_t& mul, uint32_t& shr) {
  uint32_t l = 0;
  while ((1ull << l) < d) ++l;
  mul = (uint32_t)(((1ull << (31 + l)) + d - 1) / d);
  shr = l - 1;
}

}  // namespace

// C entry points (bound with ctypes), on `stream`, returning
// cudaGetLastError().
//
// qr_threefry_fold: n lanes; each of k0, k1 and data is a pointer to int64
// read at i * step (step 0 or 1), or, where the pointer is null, the
// uint32 value given beside it. out0, out1: [n] int64.
extern "C" int qr_threefry_fold(const long long* k0, long long k0_step,
                                uint32_t k0_value, const long long* k1,
                                long long k1_step, uint32_t k1_value,
                                const long long* data, long long data_step,
                                uint32_t data_value, long long n,
                                long long* out0, long long* out1,
                                void* stream) {
  if (n < 0 || (k0_step | k1_step | data_step) & ~1ll)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const FoldParams P{{k0, k0_step, k0_value},
                     {k1, k1_step, k1_value},
                     {data, data_step, data_value},
                     n, out0, out1};
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  QR_LAUNCH(threefry_fold_kernel, (unsigned)blocks, kThreads, 0, stream, P);
  return (int)cudaGetLastError();
}

// qr_threefry_uniform: out [lanes, n] float32 with out[b, j] the flat
// element j of jax.random.uniform under key (k0[b], k1[b]), in one launch;
// lanes * n < 2^31.
extern "C" int qr_threefry_uniform(const long long* k0, const long long* k1,
                                   long long lanes, long long n, float* out,
                                   void* stream) {
  if (lanes < 0 || n < 1 || lanes > kMaxElements / n)
    return (int)cudaErrorInvalidValue;
  if (lanes == 0) return (int)cudaSuccess;
  UniformParams P{k0, k1, (uint32_t)n, (uint32_t)(lanes * n), 0, 0, out};
  if (n > 1) magic((uint32_t)n, P.mul, P.shr);
  QR_LAUNCH(threefry_uniform_kernel, (P.total + kThreads - 1) / kThreads,
            kThreads, 0, stream, P);
  return (int)cudaGetLastError();
}
