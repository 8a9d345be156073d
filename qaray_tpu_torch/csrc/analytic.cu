// Analytic closest-hit and shadow kernels (K2a, K2b, K2c).
//
// Replace the Pallas TPU kernels of qaray_tpu/ops/pallas_analytic.py:
//   K2a  _closest_analytic_pallas_raw / _kernel       closest (t, prim)
//   K2b  _closest_full_raw / _kernel_full             closest hit + attributes
//   K2c  shadow_analytic_pallas / _shadow_kernel      any hit below t_max
//
// Each ray reads 24 bytes (p, d; K2c also t_max) and writes 1 to 50 bytes,
// against some 60 flops per primitive. Without FMA contraction a sphere
// test is 94 instructions with its IEEE division and square root, a chain
// a thread waits on, so K2a and K2c are bound by the instructions they
// issue more than by their bytes; K2b, with 49 bytes of outputs a ray
// (and has_texture's constant byte), by its bytes at a million rays.
// All keep the TPU kernel's one pass (rays stream through once, only the
// winner is written) but drop its [rows, 128] lane layout and f32 masks:
// one thread per ray, the primitive table staged once per block in shared
// memory, the per-primitive branch on the table's kind (uniform across a
// warp).
//
// K2a and K2b. The TPU kernel evaluates every attribute of every primitive
// and selects with jnp.where, which is what a TPU's lanes want. A thread
// wants the argmin first: the primitive loop keeps only (t, prim), reading
// each row as three float4 (closest_rows), and a lane with a hit evaluates
// its winner's attributes once after the loop (winner_hit: obj_ray again
// on that row, then closest_hit's block in its order of operations, so
// the outputs are closest_hit's bits). With the attribute block
// (normalisations, atan2f and asinf) out of the loop K2b holds 40
// registers, not 49, and an SM 6 blocks, not 4. The uv is a template
// flag, as want_uv is a static argument of _kernel_full: without material
// textures it is not computed and uvw is 0. K2b also writes has_texture
// (all true), so its wrapper makes no launch of its own.
// tools/k2_layout.py times the table read from shared memory against the
// table in the kernel's parameter space, and K2a's departures from the
// parent's kernel one at a time.
//
// K2c, the wavefront routes' most launched kernel (a batch's soft-shadow
// rays, 29 bytes a ray): staging rays through shared memory (bulk copies,
// cp.async) only adds instructions. The design: a launch of up to a few
// rays a thread of a persistent grid of 8 blocks an SM takes one ray a
// thread, a block per 256 rays, as the other kernels do (a persistent grid
// or pairs lost to it there). Past that, aligned rays go in pairs on that
// grid, in an instantiation of its own (its registers would cost the
// one-ray code blocks an SM): each block stages the table once, and a
// thread's two consecutive rays arrive as 7 float2 loads straight into
// registers, are tested together against each primitive (its row read
// once as three float4, two independent chains) and leave as one 2-byte
// store. Views at a 4-byte offset go one ray a thread; nothing is read
// past n.
// tools/k2c_layout.py times these choices.
#include <cuda_runtime.h>
#include <stdint.h>

#include "analytic.cuh"

// The launches and their shared memory go through macros that
// csrc/host/cuda_runtime.h defines otherwise, so that the CPU tests can
// compile this source with g++ and run its kernels on the CPU
// (ops/analytic.closest_host, closest_full_host, shadow_host).
#ifndef QR_LAUNCH
#define QR_SHARED_FLOATS(name) extern __shared__ __align__(16) float name[]
#define QR_LAUNCH(kernel, blocks, threads, smem, stream, arg) \
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(arg)
#endif

namespace {

constexpr int kThreads = 256;

// Stage the [P, 12] primitive table and the [P] kinds in shared memory.
__device__ __forceinline__ void stage_prims(const float* prim, const int* kinds,
                                            int num_prims, float* s_prim,
                                            int* s_kind) {
  for (int i = threadIdx.x; i < num_prims * QR_PRIM_COLS; i += blockDim.x)
    s_prim[i] = prim[i];
  for (int i = threadIdx.x; i < num_prims; i += blockDim.x)
    s_kind[i] = kinds[i];
  __syncthreads();
}

// K2a and K2b. Outputs [n] or [n, 3], contiguous; K2a fills t and idx.
struct ClosestParams {
  const float* p;
  const float* d;
  int n;
  const float* prim;
  const int* kinds;
  const int* prim_mtl;
  int num_prims;
  float* t;
  int* idx;
  float* nrm;
  float* uvw;
  uint8_t* front;
  int* mtl;
  float* hp;
  uint8_t* has_texture;
};

// Ray i's outputs for its winner (t, k) of closest_rows over `rows`: for
// K2a t and k; for K2b the winner's attributes, evaluated once, and miss
// lanes with closest_hit's constants (t QR_BIGFLOAT, prim 0, n (0, 0, 1),
// uv 0, front true).
template <bool kFull, bool kWantUv>
__device__ __forceinline__ void store_closest(const ClosestParams& P,
                                              const float4* rows,
                                              const int* kinds, int i, V3 p,
                                              V3 d, float t, int k) {
  if constexpr (!kFull) {
    P.t[i] = t;
    P.idx[i] = k;
  } else {
    Hit h{QR_BIGFLOAT, 0, V3{0.0f, 0.0f, 1.0f}, true, 0.0f, 0.0f};
    if (t < QR_BIGFLOAT) h = winner_hit<kWantUv>(rows, kinds, k, p, d, t);
    P.t[i] = h.t;
    P.idx[i] = h.prim;
    P.nrm[3 * (size_t)i + 0] = h.n.x;
    P.nrm[3 * (size_t)i + 1] = h.n.y;
    P.nrm[3 * (size_t)i + 2] = h.n.z;
    P.uvw[3 * (size_t)i + 0] = h.u;
    P.uvw[3 * (size_t)i + 1] = h.v;
    P.uvw[3 * (size_t)i + 2] = 0.0f;
    P.front[i] = h.front ? 1 : 0;
    P.has_texture[i] = 1;
    P.mtl[i] = P.prim_mtl[h.prim];
    // World hit point at a benign t on miss lanes (ops/trace.py NaN guard).
    const float te = h.t < QR_BIGFLOAT ? h.t : 1.0f;
    P.hp[3 * (size_t)i + 0] = p.x + te * d.x;
    P.hp[3 * (size_t)i + 1] = p.y + te * d.y;
    P.hp[3 * (size_t)i + 2] = p.z + te * d.z;
  }
}

// One ray a thread over the table staged in shared memory.
template <bool kFull, bool kWantUv>
__device__ __forceinline__ void closest_ray(const ClosestParams& P) {
  QR_SHARED_FLOATS(tab);
  int* s_kind = reinterpret_cast<int*>(tab + P.num_prims * QR_PRIM_COLS);
  stage_prims(P.prim, P.kinds, P.num_prims, tab, s_kind);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P.n) return;
  const float4* rows = reinterpret_cast<const float4*>(tab);
  const V3 p = load3(P.p + 3 * (size_t)i), d = load3(P.d + 3 * (size_t)i);
  int k;
  const float t = closest_rows(rows, s_kind, P.num_prims, p, d, k);
  store_closest<kFull, kWantUv>(P, rows, s_kind, i, p, d, t, k);
}

__global__ void __launch_bounds__(kThreads)
    closest_kernel(const ClosestParams P) {
  closest_ray<false, false>(P);
}

template <bool kWantUv>
__global__ void __launch_bounds__(kThreads)
    closest_full_kernel(const ClosestParams P) {
  closest_ray<true, kWantUv>(P);
}

// K2c.
constexpr int kBlocksPerSM = 8;  // the pairs' persistent grid
// Aligned rays go in pairs once there are more than kPairsFrom rays a
// thread of that grid (tools/k2c_layout.py).
constexpr int kPairsFrom = 3;

struct ShadowParams {
  const float* p;
  const float* d;
  const float* t_max;
  int n;
  const float* prim;
  const int* kinds;
  int num_prims;
  uint8_t* occ;
};

// occluded() for two rays at once, over the table staged by stage_prims,
// whose 12-float rows are read as three float4 once for both rays: their
// tests of a primitive are independent, so they interleave. A ray's answer
// is occluded()'s (some primitive has t < t_max), by the same arithmetic;
// the rays go on together until both are occluded or the table ends.
// Returns byte j of the result for ray j.
__device__ __forceinline__ uint16_t occluded_pair(const float4* rows,
                                                  const int* kinds,
                                                  int num_prims,
                                                  const float* pf,
                                                  const float* df,
                                                  const float* tf) {
  bool occ[2] = {false, false};
  for (int k = 0; k < num_prims; ++k) {
    const float4 a = rows[3 * k], b = rows[3 * k + 1], c = rows[3 * k + 2];
    const float pr[QR_PRIM_COLS] = {a.x, a.y, a.z, a.w, b.x, b.y,
                                    b.z, b.w, c.x, c.y, c.z, c.w};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      V3 po, dobj;
      obj_ray(pr, V3{pf[3 * j], pf[3 * j + 1], pf[3 * j + 2]},
              V3{df[3 * j], df[3 * j + 1], df[3 * j + 2]}, po, dobj);
      occ[j] = occ[j] | (prim_t(kinds[k], po, dobj) < tf[j]);
    }
    if (occ[0] && occ[1]) break;
  }
  return (uint16_t)((occ[0] ? 1u : 0u) | (occ[1] ? 256u : 0u));
}

// kPairs: a persistent grid whose threads take the rays in pairs (p, d,
// t_max aligned for float2, occ for 2 bytes: 7 float2 loads and one 2-byte
// store a pair), thread 0 the last ray of an odd count. Else one ray a
// thread, a block per 256 rays, as the other kernels take them (the pairs'
// registers would cost this code blocks an SM).
template <bool kPairs>
__global__ void __launch_bounds__(kThreads)
    shadow_kernel(const ShadowParams P) {
  QR_SHARED_FLOATS(tab);
  int* s_kind = reinterpret_cast<int*>(tab + P.num_prims * QR_PRIM_COLS);
  stage_prims(P.prim, P.kinds, P.num_prims, tab, s_kind);
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  int tests = 0;
  if constexpr (kPairs) {
    const float4* rows = reinterpret_cast<const float4*>(tab);
    const float2* pv = reinterpret_cast<const float2*>(P.p);
    const float2* dv = reinterpret_cast<const float2*>(P.d);
    const float2* tv = reinterpret_cast<const float2*>(P.t_max);
    const int pairs = P.n / 2;
    for (int g = first; g < pairs; g += gridDim.x * blockDim.x) {
      float pf[6], df[6];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float2 pj = pv[3 * (size_t)g + j], dj = dv[3 * (size_t)g + j];
        pf[2 * j] = pj.x;
        pf[2 * j + 1] = pj.y;
        df[2 * j] = dj.x;
        df[2 * j + 1] = dj.y;
      }
      const float2 t2 = tv[g];
      const float tf[2] = {t2.x, t2.y};
      reinterpret_cast<uint16_t*>(P.occ)[g] =
          occluded_pair(rows, s_kind, P.num_prims, pf, df, tf);
    }
    const int last = P.n - 1;
    if (first == 0 && (P.n & 1))
      P.occ[last] = occluded(tab, s_kind, P.num_prims,
                             load3(P.p + 3 * (size_t)last),
                             load3(P.d + 3 * (size_t)last), P.t_max[last],
                             &tests)
                        ? 1
                        : 0;
  } else if (first < P.n) {
    P.occ[first] = occluded(tab, s_kind, P.num_prims, load3(P.p + 3 * first),
                            load3(P.d + 3 * first), P.t_max[first], &tests)
                       ? 1
                       : 0;
  }
}

template <typename K>
int launch_config(K kernel, int num_prims, size_t* smem) {
  *smem = (size_t)num_prims * (QR_PRIM_COLS + 1) * 4;
  if (*smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  return 0;
}

}  // namespace

// C entry points (bound with ctypes). Each launches on `stream` and returns
// cudaGetLastError(); n > 0 is the caller's job.
// K2a and K2b: one ray a thread, a block per 256 rays; p and d [n, 3]
// contiguous at any 4-byte alignment.
template <typename K>
int launch_closest(K kernel, const ClosestParams& P, void* stream) {
  size_t smem;
  const int rc = launch_config(kernel, P.num_prims, &smem);
  if (rc) return rc;
  QR_LAUNCH(kernel, (P.n + kThreads - 1) / kThreads, kThreads, smem, stream,
            P);
  return (int)cudaGetLastError();
}

extern "C" int qr_closest(const float* p, const float* d, int n,
                          const float* prim, const int* kinds, int num_prims,
                          float* t_out, int* idx_out, void* stream) {
  const ClosestParams P{p,       d,       n,       prim,    kinds,
                        nullptr, num_prims, t_out, idx_out, nullptr,
                        nullptr, nullptr, nullptr, nullptr, nullptr};
  return launch_closest(closest_kernel, P, stream);
}

// K2b; want_uv 0 leaves uvw 0 (_kernel_full's static want_uv).
extern "C" int qr_closest_full(const float* p, const float* d, int n,
                               const float* prim, const int* kinds,
                               const int* prim_mtl, int num_prims,
                               float* t_out, int* idx_out, float* n_out,
                               float* uvw_out, uint8_t* front_out,
                               int* mtl_out, float* hp_out,
                               uint8_t* has_texture_out, int want_uv,
                               void* stream) {
  const ClosestParams P{p,      d,         n,       prim,   kinds,
                        prim_mtl, num_prims, t_out,  idx_out, n_out,
                        uvw_out, front_out, mtl_out, hp_out, has_texture_out};
  return want_uv ? launch_closest(closest_full_kernel<true>, P, stream)
                 : launch_closest(closest_full_kernel<false>, P, stream);
}

// K2c: one ray a thread, or past kPairsFrom rays a thread of a grid of
// kBlocksPerSM blocks of 256 threads an SM aligned rays in pairs on that
// grid. p and d [n, 3], t_max [n] and occ_out [n] are contiguous at any
// 4-byte alignment.
extern "C" int qr_shadow(const float* p, const float* d, const float* t_max,
                         int n, const float* prim, const int* kinds,
                         int num_prims, uint8_t* occ_out, void* stream) {
  int dev = 0, sms = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (!rc)
    rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
  if (rc) return rc;
  auto aligned = [](const void* q, unsigned b) {
    return ((uintptr_t)q & (b - 1)) == 0;
  };
  const int grid = sms * kBlocksPerSM;
  const bool pairs = (size_t)n > (size_t)kPairsFrom * grid * kThreads &&
                     aligned(p, 8) && aligned(d, 8) && aligned(t_max, 8) &&
                     aligned(occ_out, 2);
  const int blocks = pairs ? grid : (n + kThreads - 1) / kThreads;
  const ShadowParams P{p, d, t_max, n, prim, kinds, num_prims, occ_out};
  void (*const kernel)(const ShadowParams) =
      pairs ? shadow_kernel<true> : shadow_kernel<false>;
  size_t smem;
  rc = launch_config(kernel, num_prims, &smem);
  if (rc) return rc;
  QR_LAUNCH(kernel, blocks, kThreads, smem, stream, P);
  return (int)cudaGetLastError();
}
