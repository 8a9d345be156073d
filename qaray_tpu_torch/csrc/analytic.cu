// Analytic closest-hit and shadow kernels (K2a, K2b, K2c).
//
// Replace the Pallas TPU kernels of qaray_tpu/ops/pallas_analytic.py:
//   K2a  _closest_analytic_pallas_raw / _kernel       closest (t, prim)
//   K2b  _closest_full_raw / _kernel_full             closest hit + attributes
//   K2c  shadow_analytic_pallas / _shadow_kernel      any hit below t_max
//
// What bounds them on the H100: memory. Each ray reads 24 bytes (p, d; K2c
// also t_max) and writes 5 to 49 bytes, against some 60 flops per
// primitive, and scenes on this path hold a handful of primitives, so the
// work per byte is far below the card's balance point. The design keeps the
// TPU kernel's one-pass structure (rays stream through once, only the
// winner is written) but drops its [rows, 128] lane layout and f32 masks:
// one thread per ray, the primitive table staged once per block in shared
// memory, the per-primitive branch on the table's kind (uniform across a
// warp), and the shadow test stops at the first occluder.
#include <cuda_runtime.h>
#include <stdint.h>

#include "analytic.cuh"

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

__global__ void closest_kernel(const float* __restrict__ p,
                               const float* __restrict__ d, int n,
                               const float* __restrict__ prim,
                               const int* __restrict__ kinds, int num_prims,
                               float* __restrict__ t_out,
                               int* __restrict__ idx_out) {
  extern __shared__ float smem[];
  float* s_prim = smem;
  int* s_kind = reinterpret_cast<int*>(smem + num_prims * QR_PRIM_COLS);
  stage_prims(prim, kinds, num_prims, s_prim, s_kind);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int idx;
  t_out[i] = closest_t(s_prim, s_kind, num_prims, load3(p + 3 * i),
                       load3(d + 3 * i), idx);
  idx_out[i] = idx;
}

__global__ void closest_full_kernel(
    const float* __restrict__ p, const float* __restrict__ d, int n,
    const float* __restrict__ prim, const int* __restrict__ kinds,
    const int* __restrict__ prim_mtl, int num_prims,
    float* __restrict__ t_out, int* __restrict__ idx_out,
    float* __restrict__ n_out, float* __restrict__ uvw_out,
    uint8_t* __restrict__ front_out, int* __restrict__ mtl_out,
    float* __restrict__ hp_out) {
  extern __shared__ float smem[];
  float* s_prim = smem;
  int* s_kind = reinterpret_cast<int*>(smem + num_prims * QR_PRIM_COLS);
  stage_prims(prim, kinds, num_prims, s_prim, s_kind);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const V3 pi = load3(p + 3 * i), di = load3(d + 3 * i);
  const Hit h = closest_hit<true>(s_prim, s_kind, num_prims, pi, di);
  t_out[i] = h.t;
  idx_out[i] = h.prim;
  n_out[3 * i + 0] = h.n.x;
  n_out[3 * i + 1] = h.n.y;
  n_out[3 * i + 2] = h.n.z;
  uvw_out[3 * i + 0] = h.u;
  uvw_out[3 * i + 1] = h.v;
  uvw_out[3 * i + 2] = 0.0f;
  front_out[i] = h.front ? 1 : 0;
  mtl_out[i] = prim_mtl[h.prim];
  // World hit point at a benign t on miss lanes (ops/trace.py NaN guard).
  const float te = h.t < QR_BIGFLOAT ? h.t : 1.0f;
  hp_out[3 * i + 0] = pi.x + te * di.x;
  hp_out[3 * i + 1] = pi.y + te * di.y;
  hp_out[3 * i + 2] = pi.z + te * di.z;
}

__global__ void shadow_kernel(const float* __restrict__ p,
                              const float* __restrict__ d,
                              const float* __restrict__ t_max, int n,
                              const float* __restrict__ prim,
                              const int* __restrict__ kinds, int num_prims,
                              uint8_t* __restrict__ occ_out) {
  extern __shared__ float smem[];
  float* s_prim = smem;
  int* s_kind = reinterpret_cast<int*>(smem + num_prims * QR_PRIM_COLS);
  stage_prims(prim, kinds, num_prims, s_prim, s_kind);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int tests = 0;
  occ_out[i] = occluded(s_prim, s_kind, num_prims, load3(p + 3 * i),
                        load3(d + 3 * i), t_max[i], &tests)
                   ? 1
                   : 0;
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
extern "C" int qr_closest(const float* p, const float* d, int n,
                          const float* prim, const int* kinds, int num_prims,
                          float* t_out, int* idx_out, void* stream) {
  size_t smem;
  int rc = launch_config(closest_kernel, num_prims, &smem);
  if (rc) return rc;
  closest_kernel<<<(n + kThreads - 1) / kThreads, kThreads, smem,
                   (cudaStream_t)stream>>>(p, d, n, prim, kinds, num_prims,
                                           t_out, idx_out);
  return (int)cudaGetLastError();
}

extern "C" int qr_closest_full(const float* p, const float* d, int n,
                               const float* prim, const int* kinds,
                               const int* prim_mtl, int num_prims,
                               float* t_out, int* idx_out, float* n_out,
                               float* uvw_out, uint8_t* front_out,
                               int* mtl_out, float* hp_out, void* stream) {
  size_t smem;
  int rc = launch_config(closest_full_kernel, num_prims, &smem);
  if (rc) return rc;
  closest_full_kernel<<<(n + kThreads - 1) / kThreads, kThreads, smem,
                        (cudaStream_t)stream>>>(p, d, n, prim, kinds,
                                                prim_mtl, num_prims, t_out,
                                                idx_out, n_out, uvw_out,
                                                front_out, mtl_out, hp_out);
  return (int)cudaGetLastError();
}

extern "C" int qr_shadow(const float* p, const float* d, const float* t_max,
                         int n, const float* prim, const int* kinds,
                         int num_prims, uint8_t* occ_out, void* stream) {
  size_t smem;
  int rc = launch_config(shadow_kernel, num_prims, &smem);
  if (rc) return rc;
  shadow_kernel<<<(n + kThreads - 1) / kThreads, kThreads, smem,
                  (cudaStream_t)stream>>>(p, d, t_max, n, prim, kinds,
                                          num_prims, occ_out);
  return (int)cudaGetLastError();
}
