// Cluster-culled photon gather (K5): per query point, the filtered power
// sum (3), the weighted direction sum (3) and the in-radius count over a
// clustered photon map.
//
// Replaces the Pallas TPU kernel qaray_tpu/ops/pallas_photon.py
// ::_standalone_kernel (dispatched by pallas_gather), whose sums are
// photon.cuh's photon_add here. The TPU kernel sweeps a block of queries
// against every cluster the block's box may reach. Here one warp gathers
// one query, culled against that query alone:
// - The warp tests the map's cluster boxes 32 at a time, a box a lane
//   (photon_cluster_near with the query's own point as its box, as the
//   megakernel's per-lane sweep does) and takes the kept clusters in order
//   from the ballot.
// - In a kept cluster each lane tests 4 of its 128 rows (rows lane,
//   lane + 32, ...), and a ballot marks the rows within the radius. The
//   warp then adds those rows' terms in row order, every lane the same
//   terms (the loop is uniform), and lane 0 writes the sums.
// Only in-radius rows are added. A row outside the radius has w = 0 and
// adds an exact zero to each sum, so the sums are bit for bit those of the
// in-order sweep over every row (ops/photon.photon_gather_plain).
//
// The caller (ops/photon.gather_apply) sorts the queries with a record to
// the front and passes their count in device memory, so only those take a
// warp: the grid, at most kMaxBlocks blocks of 4 warps, strides over them,
// and every thread then zeroes the outputs of the queries without one.
// Without a count every query up to n is looked at. What bounds it on the
// H100: the latency of a query's few cluster visits (at r 0.2 a query
// usually keeps one to three clusters of 128 rows and adds no row), not
// bytes: 16 bytes read and 28 written a query, the cluster boxes and the
// kept clusters' positions.
#include <cuda_runtime.h>

#include "photon.cuh"

#ifndef QR_LAUNCH
#define QR_LAUNCH(kernel, blocks, threads, smem, stream, arg) \
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(arg)
#endif

namespace {

constexpr int kWarps = 4;  // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsALane = QR_PHOTON_CLUSTER / 32;
constexpr unsigned kAll = 0xffffffffu;

struct GatherParams {
  const float* p;       // [n, 3] query points
  const float* act;     // [n] active where > 0.5
  const float4* tab;    // [n_clusters * 128, 16] photon rows
  const float* cb;      // [n_clusters, 8] cluster boxes
  int n_clusters;
  float r2;
  int n;
  const int* count;  // optional: only queries below *count are active
  int warps;         // warps in the grid
  float* out;        // [n, 7]
  int* work;         // optional [n]: clusters a query visited
};

__global__ void __launch_bounds__(kThreads)
    gather_kernel(const GatherParams P) {
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x % 32;
  const int limit = P.count ? min(*P.count, P.n) : P.n;
  const float r = sqrtf(P.r2);
  const float inv_r2 = 1.0f / P.r2;
  // A warp a query; i is the same over the warp, so every branch on it
  // and every loop below is uniform.
  for (int i = gtid / 32; i < limit; i += P.warps) {
    if (!(P.act[i] > 0.5f)) continue;
    const V3 q = V3{P.p[3 * i], P.p[3 * i + 1], P.p[3 * i + 2]};
    PhotonSums s = photon_zero();
    int visited = 0;
    for (int c0 = 0; c0 < P.n_clusters; c0 += 32) {
      bool near = false;
      if (c0 + lane < P.n_clusters) {
        float box[6];
#pragma unroll
        for (int k = 0; k < 6; ++k) box[k] = __ldg(P.cb + 8 * (c0 + lane) + k);
        near = photon_cluster_near(box, q, q, r);
      }
      for (unsigned kept = __ballot_sync(kAll, near); kept;
           kept &= kept - 1) {
        const int base = (c0 + __ffs(kept) - 1) * QR_PHOTON_CLUSTER;
        ++visited;
        unsigned inr[kRowsALane];
#pragma unroll
        for (int k = 0; k < kRowsALane; ++k) {
          const float4 a = __ldg(P.tab + 4 * (base + 32 * k + lane));
          const float ex = q.x - a.x, ey = q.y - a.y, ez = q.z - a.z;
          inr[k] = __ballot_sync(kAll, ex * ex + ey * ey + ez * ez < P.r2);
        }
        // The rows within the radius, in row order.
        for (int k = 0; k < kRowsALane; ++k) {
          for (unsigned m = inr[k]; m; m &= m - 1) {
            const int row = base + 32 * k + __ffs(m) - 1;
            const float4 a = __ldg(P.tab + 4 * row);
            const float4 b = __ldg(P.tab + 4 * row + 1);
            const float4 e = __ldg(P.tab + 4 * row + 2);
            const float vals[9] = {a.x, a.y, a.z, a.w, b.x,
                                   b.y, b.z, b.w, e.x};
            photon_add(s, q, P.r2, inv_r2, vals);
          }
        }
      }
    }
    if (lane == 0) {
      float* o = P.out + 7 * i;
      o[0] = s.ir;
      o[1] = s.ig;
      o[2] = s.ib;
      o[3] = s.dx;
      o[4] = s.dy;
      o[5] = s.dz;
      o[6] = s.cnt;
      if (P.work) P.work[i] = visited;
    }
  }
  // Zeros for every query without a record.
  for (int j = gtid; j < P.n; j += 32 * P.warps) {
    if (j < limit && P.act[j] > 0.5f) continue;
    float* o = P.out + 7 * j;
    for (int k = 0; k < 7; ++k) o[k] = 0.0f;
    if (P.work) P.work[j] = 0;
  }
}

}  // namespace

// C entry point (bound with ctypes): launches `blocks` blocks of 4 warps
// on `stream`, returns cudaGetLastError(). p [n, 3], act [n] (active where
// > 0.5), tab [n_clusters * 128, 16], cb [n_clusters, 8], out [n, 7]:
// irradiance sums (3), direction sums (3), count. count, if not NULL, is
// a device int: the active queries are among the first *count, none
// after. work, if not NULL, is [n]: clusters each query visited. n > 0 and
// blocks > 0 are the caller's job.
extern "C" int qr_photon_gather(const float* p, const float* act,
                                const float* tab, const float* cb,
                                int n_clusters, float r2, int n,
                                const int* count, int blocks, float* out,
                                int* work, void* stream) {
  const GatherParams P{p, act, reinterpret_cast<const float4*>(tab), cb,
                       n_clusters, r2, n, count, blocks * kWarps, out, work};
  QR_LAUNCH(gather_kernel, blocks, kThreads, 0, stream, P);
  return (int)cudaGetLastError();
}
