// Cluster-culled photon gather (K5): per query point, the filtered power
// sum (3), the weighted direction sum (3) and the in-radius count over a
// clustered photon map.
//
// Replaces the Pallas TPU kernel qaray_tpu/ops/pallas_photon.py
// ::_standalone_kernel (dispatched by pallas_gather), whose sweep is
// photon.cuh here. The caller (ops/photon.gather_apply) sorts the queries
// in Morton order, so a block of neighbouring threads holds neighbouring
// points.
//
// One thread a query, 128 to a block. The block reduces its active
// queries' box (warp shuffles, then shared memory; no active query gives an
// inverted box) and walks the clusters in order. The cull test reads the
// same box for every thread, so a whole block skips a cluster or visits
// it. A visited cluster's 128 rows (columns 0-8) are staged in shared
// memory, one row a thread, and every active thread then sweeps them in
// row order from there (broadcast reads). What bounds it on the H100:
// operations, about 20 a photon test (the distance 8, the weight 2, seven
// multiply-adds 14, the compare) for every query of every visited cluster,
// against 16 bytes read and 28 written a query. The block size changes no
// result: the cull is exact.
#include <cuda_runtime.h>

#include "photon.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowFloats = 9;

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(kThreads)
    gather_kernel(const float* __restrict__ p, const float* __restrict__ act,
                  const float4* __restrict__ tab,
                  const float* __restrict__ cb, int n_clusters, float r2,
                  int n, float* __restrict__ out) {
  __shared__ float rows[QR_PHOTON_CLUSTER * kRowFloats];
  __shared__ float part[6][kWarps];
  __shared__ float box[6];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < n && act[i] > 0.5f;
  V3 q = V3{0.0f, 0.0f, 0.0f};
  if (i < n) q = V3{p[3 * i], p[3 * i + 1], p[3 * i + 2]};

  // The box of the block's active queries.
  const float qv[3] = {q.x, q.y, q.z};
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int k = 0; k < 3; ++k) {
    const float lo = warp_min(active ? qv[k] : QR_BIGFLOAT);
    const float hi = warp_max(active ? qv[k] : -QR_BIGFLOAT);
    if (lane == 0) {
      part[k][warp] = lo;
      part[3 + k][warp] = hi;
    }
  }
  __syncthreads();
  if (threadIdx.x < 6) {
    const int k = threadIdx.x;
    float v = part[k][0];
    for (int w = 1; w < kWarps; ++w)
      v = k < 3 ? fminf(v, part[k][w]) : fmaxf(v, part[k][w]);
    box[k] = v;
  }
  __syncthreads();
  const V3 lo = V3{box[0], box[1], box[2]};
  const V3 hi = V3{box[3], box[4], box[5]};

  const float r = sqrtf(r2);
  const float inv_r2 = 1.0f / r2;
  PhotonSums s = photon_zero();
  for (int c = 0; c < n_clusters; ++c) {
    if (!photon_cluster_near(cb + 8 * c, lo, hi, r)) continue;  // uniform
    __syncthreads();  // the previous cluster's rows are no longer read
    {
      const int row = c * QR_PHOTON_CLUSTER + threadIdx.x;
      const float4 a = tab[4 * row], b = tab[4 * row + 1],
                   e = tab[4 * row + 2];
      float* dst = rows + kRowFloats * threadIdx.x;
      dst[0] = a.x;
      dst[1] = a.y;
      dst[2] = a.z;
      dst[3] = a.w;
      dst[4] = b.x;
      dst[5] = b.y;
      dst[6] = b.z;
      dst[7] = b.w;
      dst[8] = e.x;
    }
    __syncthreads();
    if (active)
      for (int j = 0; j < QR_PHOTON_CLUSTER; ++j)
        photon_add(s, q, r2, inv_r2, rows + kRowFloats * j);
  }
  if (i < n) {
    float* o = out + 7 * i;
    if (!active) s = photon_zero();
    o[0] = s.ir;
    o[1] = s.ig;
    o[2] = s.ib;
    o[3] = s.dx;
    o[4] = s.dy;
    o[5] = s.dz;
    o[6] = s.cnt;
  }
}

}  // namespace

// C entry point (bound with ctypes): launches on `stream`, returns
// cudaGetLastError(). p [n, 3], act [n] (active where > 0.5), tab
// [n_clusters * 128, 16], cb [n_clusters, 8], out [n, 7]: irradiance sums
// (3), direction sums (3), count. n > 0 is the caller's job.
extern "C" int qr_photon_gather(const float* p, const float* act,
                                const float* tab, const float* cb,
                                int n_clusters, float r2, int n, float* out,
                                void* stream) {
  gather_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                  (cudaStream_t)stream>>>(
      p, act, reinterpret_cast<const float4*>(tab), cb, n_clusters, r2, n,
      out);
  return (int)cudaGetLastError();
}
