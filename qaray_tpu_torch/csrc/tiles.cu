// Tiled cluster march: closest hit (K4a) and any hit (K4b) over a
// Morton-clustered world mesh.
//
// Replaces the Pallas TPU kernels qaray_tpu/ops/pallas_tiles.py
// ::_closest_kernel and ::_anyhit_kernel (dispatched by
// pallas_tiled_sweep). One block per packet of up to 2048 consecutive
// rays (256 threads, up to 8 rays each); the torch glue (ops/tiles.py)
// has culled every cluster per packet and sorted the survivors front to
// back by their entry bound. The block walks its list: it stages the
// cluster's 256 coefficient rows in shared memory (16 KB, float4 loads)
// and every thread sweeps them against its rays with the predicate of
// mesh.cuh, folding per-ray top-2 as K3 does.
//
// What bounds it on the H100: operations (about 40 a triangle test); a
// cluster's 16 KB is read once per packet. The design answers with the
// front-to-back early exit: before each cluster the block decides with one
// __syncthreads_or whether any of its rays can still improve, i.e. whether
// the cluster's entry bound is <= min(best t, root-box exit) of some lane
// (closest), or whether some lane with budget is open and can reach it
// (any hit). max_steps caps the march (phase 1 of tiled_closest_twophase),
// and `resolved` marks lanes that no unvisited cluster can improve, as in
// the Pallas kernel. Rows are sorted-row ids; ops/mesh_tiles.py maps them.
#include <cuda_runtime.h>

#include "mesh.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRays = 8;  // rays per thread: packets of up to 2048 rays

struct MarchParams {
  const float* p;
  const float* d;
  const float* tcur;  // closest: seed t; any hit: budget t_max
  const float* cap;   // root-box exit per ray
  const float4* rows;
  const int* order;    // [G, C] cluster ids, front to back
  const float* entry;  // [G, C] entry bounds, ascending
  const int* count;    // [G] clusters the cull kept
  int n, g, n_clusters, packet, max_steps;
  float* t;
  int* row;
  int* row2;
  bool* flag;  // resolved (closest) or occluded (any hit)
  int* steps;  // optional [G]: clusters visited
  int* work;   // optional [n]: triangle tests the lane needed
};

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads) march_kernel(const MarchParams P) {
  __shared__ float4 tile[QR_CLUSTER * 4];
  const int gi = blockIdx.x;
  const int* order = P.order + (size_t)gi * P.n_clusters;
  const float* entry = P.entry + (size_t)gi * P.n_clusters;
  const int count = P.count[gi];

  V3 rp[kRays], rd[kRays];
  float t_in[kRays], tb[kRays], t2[kRays], cap[kRays];
  int rb[kRays], r2[kRays];
  bool valid[kRays], occ[kRays];
  int need_tests[kRays];
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const int li = threadIdx.x + k * kThreads;
    const int i = gi * P.packet + li;
    valid[k] = li < P.packet && i < P.n;
    rp[k] = V3{0.f, 0.f, 0.f};
    rd[k] = V3{0.f, 0.f, 1.f};
    t_in[k] = 0.f;
    cap[k] = 0.f;
    if (valid[k]) {
      rp[k] = V3{P.p[3 * i], P.p[3 * i + 1], P.p[3 * i + 2]};
      rd[k] = V3{P.d[3 * i], P.d[3 * i + 1], P.d[3 * i + 2]};
      t_in[k] = P.tcur[i];
      cap[k] = P.cap[i];
    }
    tb[k] = t_in[k];
    t2[k] = QR_BIGFLOAT;
    rb[k] = r2[k] = -1;
    occ[k] = false;
    need_tests[k] = 0;
  }

  int j = 0;
  for (;; ++j) {
    bool live = j < count;
    if (!kAnyHit && P.max_steps) live = live && j < P.max_steps;
    if (!live) break;  // uniform across the block
    const float ent = entry[j];
    bool mine = false;
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      if (!valid[k]) continue;
      bool need;
      if (kAnyHit) {
        const float open = occ[k] ? 0.0f : fminf(t_in[k], cap[k]);
        need = open > QR_BIAS && ent <= open;
      } else {
        need = ent <= fminf(tb[k], cap[k]);
      }
      mine = mine || need;
      // The lane's own share of the cluster, for the roofline bound: the
      // other lanes of a visited cluster are tested but need no test.
      need_tests[k] += need ? QR_CLUSTER : 0;
    }
    // Also the barrier between the last cluster's reads and this staging.
    if (!__syncthreads_or(mine)) break;
    const int base = order[j] * QR_CLUSTER;
    for (int q = threadIdx.x; q < QR_CLUSTER * 4; q += kThreads)
      tile[q] = P.rows[4 * base + q];
    __syncthreads();
    for (int r = 0; r < QR_CLUSTER; ++r) {
      const TriRow c = load_row(tile, r);
#pragma unroll
      for (int k = 0; k < kRays; ++k) {
        if (!valid[k] || (kAnyHit && occ[k])) continue;
        float t, a, b, dn;
        if (!tri_hit(c, rp[k], rd[k], t, a, b, dn)) continue;
        if (kAnyHit) {
          occ[k] = t < t_in[k];
        } else if (t < tb[k]) {
          t2[k] = tb[k];
          r2[k] = rb[k];
          tb[k] = t;
          rb[k] = base + r;
        } else if (t < t2[k]) {
          t2[k] = t;
          r2[k] = base + r;
        }
      }
    }
  }

  const float ent_next = entry[min(j, P.n_clusters - 1)];
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    if (!valid[k]) continue;
    const int i = gi * P.packet + threadIdx.x + k * kThreads;
    if (P.work) P.work[i] = need_tests[k];
    if (kAnyHit) {
      P.flag[i] = occ[k];
    } else {
      P.t[i] = tb[k];
      P.row[i] = tb[k] < t_in[k] ? rb[k] : -1;
      P.row2[i] = t2[k] < QR_BIGFLOAT ? r2[k] : -1;
      P.flag[i] = j >= count || ent_next > fminf(tb[k], cap[k]);
    }
  }
  if (P.steps && threadIdx.x == 0) P.steps[gi] = j;
}

}  // namespace

// C entry point (bound with ctypes): one block per packet, launched on
// `stream`; returns cudaGetLastError(). n > 0, packet <= 2048 and
// coeff16 rows of a whole number of clusters are the caller's job.
extern "C" int qr_tiles_march(const float* p, const float* d,
                              const float* tcur, const float* cap,
                              const float* coeff16, const int* order,
                              const float* entry, const int* count, int n,
                              int g, int n_clusters, int packet, int any_hit,
                              int max_steps, float* t, int* row, int* row2,
                              bool* flag, int* steps, int* work,
                              void* stream) {
  if (packet > kThreads * kRays) return (int)cudaErrorInvalidValue;
  const MarchParams P{p, d, tcur, cap,
                      reinterpret_cast<const float4*>(coeff16), order, entry,
                      count, n, g, n_clusters, packet, max_steps, t, row,
                      row2, flag, steps, work};
  if (any_hit) {
    march_kernel<true><<<g, kThreads, 0, (cudaStream_t)stream>>>(P);
  } else {
    march_kernel<false><<<g, kThreads, 0, (cudaStream_t)stream>>>(P);
  }
  return (int)cudaGetLastError();
}
