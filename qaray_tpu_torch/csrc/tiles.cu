// Tiled cluster walk: closest hit (K4a) and any hit (K4b) over a
// Morton-clustered world mesh.
//
// Replaces the Pallas TPU kernels qaray_tpu/ops/pallas_tiles.py
// ::_closest_kernel (:111) and ::_anyhit_kernel (:213), dispatched by
// pallas_tiled_sweep at :385 and :374. The TPU kernel marches packets of
// 2048 rays through the clusters a packet-wide interval cull kept, so a
// packet runs as long as its slowest ray and bounce rays, whose directions
// span every axis, keep nearly every cluster. Here one thread walks one
// ray, 128 threads a block, over a binary tree of the cluster boxes
// (ops/tiles.cluster_tree: heap order, node 1 the root, node k's children
// 2k and 2k+1, leaf L + c cluster c). The walk descends nearest child
// first with a per-thread stack and tests nodes with mesh.cuh's widened
// one-ray slab test (box_entry), which over-accepts and never drops a
// grazing hit. A node is pruned when its entry bound is not below the
// ray's reach: the runner-up's t (at most t_cur) for the closest hit, the
// budget for the any hit. A leaf sweeps its cluster's 256 coefficient rows
// with tri_hit, read through the read-only cache (neighbouring rays of the
// coherence-sorted batch read the same rows; at 81,920 triangles the whole
// table is 5.2 MB and stays in L2), and folds the top-2 below t_cur. So
// each ray ends with its exact closest hit and runner-up below t_cur
// (exact ties aside) and stops on its own; the any hit stops at its first
// occluder. The top of the tree (32 KB, 1,024 nodes) is staged in shared
// memory. Rows are sorted-row ids; ops/mesh_tiles.py maps them.
//
// What bounds it on the H100: operations (about 40 a triangle test, 256
// tests a visited cluster) by count, but a long walk is a chain of
// dependent row loads and tests, so a leaf loads and tests 8 rows at a
// time and keeps their loads in flight together (about 138 registers). A
// warp's rays diverge only where their walks do. max_steps caps the clusters each ray visits
// (phase 1 of tiled_closest_twophase); `resolved` says the walk ended
// before the cap.
#include <cuda_runtime.h>

#include "mesh.cuh"

#ifndef QR_LAUNCH
#define QR_SHARED_FLOATS(name) extern __shared__ float name[]
#define QR_LAUNCH(kernel, blocks, threads, smem, stream, arg) \
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(arg)
#endif

namespace {

constexpr int kThreads = 128;
constexpr int kNodeCols = 8;  // min xyz, max xyz, 2 pad
constexpr int kSharedNodes = 1024;
constexpr int kStack = 16;  // one pending sibling a level: 2^16 leaves
// Rows loaded and tested together: their loads are in flight at once.
constexpr int kRowsAStep = 8;

struct WalkParams {
  const float* p;
  const float* d;
  const float* tcur;  // closest: t_cur; any hit: budget t_max
  const float4* rows;
  const float* nodes;  // [2L, 8]
  int n, n_leaves, shared_nodes, max_steps;
  float* t;
  int* row;
  int* row2;
  bool* flag;  // resolved (closest) or occluded (any hit)
  int* steps;  // optional [n]: clusters visited
  int* work;   // optional [n]: triangle tests within the winner's reach
};

// The nearest pending node still within reach, or 0 when none is left.
__device__ __forceinline__ int pop(const int* stack_node,
                                   const float* stack_ent, int& sp,
                                   float reach, float& ent) {
  while (sp > 0) {
    --sp;
    if (stack_ent[sp] < reach) {
      ent = stack_ent[sp];
      return stack_node[sp];
    }
  }
  return 0;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads) walk_kernel(const WalkParams P) {
  QR_SHARED_FLOATS(top);
  for (int q = threadIdx.x; q < P.shared_nodes * kNodeCols; q += blockDim.x)
    top[q] = P.nodes[q];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P.n) return;
  const V3 rp{P.p[3 * i], P.p[3 * i + 1], P.p[3 * i + 2]};
  const V3 rd{P.d[3 * i], P.d[3 * i + 1], P.d[3 * i + 2]};
  const float t_in = P.tcur[i];
  const RaySlab s = ray_slab(rp, rd);
  auto box = [&](int k) {
    return k < P.shared_nodes ? top + kNodeCols * k
                              : P.nodes + kNodeCols * k;
  };

  // Top-2 below t_in: t2 is also the closest walk's reach.
  float tb = t_in, t2 = t_in;
  int rb = -1, r2 = -1;
  bool occ = false, capped = false;
  int visited = 0, need = 0;
  int stack_node[kStack];
  float stack_ent[kStack];
  int sp = 0;
  float ent = 0.0f;
  int node = t_in > QR_BIAS && box_entry(box(1), s, t_in, ent) ? 1 : 0;
  while (node) {
    // Descend to the nearest leaf within reach.
    while (node && node < P.n_leaves) {
      const float reach = kAnyHit ? t_in : t2;
      const int c = 2 * node;
      float e0, e1;
      const bool h0 = box_entry(box(c), s, reach, e0);
      const bool h1 = box_entry(box(c + 1), s, reach, e1);
      if (h0 && h1) {
        const bool near0 = e0 <= e1;
        stack_node[sp] = near0 ? c + 1 : c;
        stack_ent[sp] = near0 ? e1 : e0;
        ++sp;
        node = near0 ? c : c + 1;
        ent = near0 ? e0 : e1;
      } else if (h0 || h1) {
        node = h0 ? c : c + 1;
        ent = h0 ? e0 : e1;
      } else {
        node = pop(stack_node, stack_ent, sp, reach, ent);
      }
    }
    if (!node) break;
    if (!kAnyHit && P.max_steps && visited == P.max_steps) {
      capped = true;
      break;
    }
    ++visited;
    if (kAnyHit || ent < tb) need += QR_CLUSTER;
    const int base = (node - P.n_leaves) * QR_CLUSTER;
    for (int r = base; r < base + QR_CLUSTER; r += kRowsAStep) {
      TriRow c[kRowsAStep];
#pragma unroll
      for (int k = 0; k < kRowsAStep; ++k) c[k] = load_row_ldg(P.rows, r + k);
      float t[kRowsAStep];
      bool hit[kRowsAStep];
#pragma unroll
      for (int k = 0; k < kRowsAStep; ++k) {
        float a, b, dn;
        hit[k] = tri_hit(c[k], rp, rd, t[k], a, b, dn);
      }
      // Folded in row order, as one row at a time would fold them.
#pragma unroll
      for (int k = 0; k < kRowsAStep; ++k) {
        if (!hit[k]) continue;
        if (kAnyHit) {
          occ = occ || t[k] < t_in;
        } else if (t[k] < tb) {
          t2 = tb;
          r2 = rb;
          tb = t[k];
          rb = r + k;
        } else if (t[k] < t2) {
          t2 = t[k];
          r2 = r + k;
        }
      }
      if (occ) break;
    }
    if (occ) break;
    node = pop(stack_node, stack_ent, sp, kAnyHit ? t_in : t2, ent);
  }

  if (P.steps) P.steps[i] = visited;
  if (P.work) P.work[i] = need;
  if (kAnyHit) {
    P.flag[i] = occ;
  } else {
    P.t[i] = tb;
    P.row[i] = rb;
    P.row2[i] = r2;
    P.flag[i] = !capped;
  }
}

}  // namespace

// C entry point (bound with ctypes): one thread a ray, launched on
// `stream`; returns cudaGetLastError(). n > 0, a tree of 2 * n_leaves rows
// with n_leaves a power of two up to 2^16, and coeff16 rows for every
// cluster are the caller's job.
extern "C" int qr_tiles_walk(const float* p, const float* d,
                             const float* tcur, const float* coeff16,
                             const float* nodes, int n, int n_leaves,
                             int any_hit, int max_steps, float* t, int* row,
                             int* row2, bool* flag, int* steps, int* work,
                             void* stream) {
  if (n_leaves < 1 || n_leaves > (1 << kStack) ||
      (n_leaves & (n_leaves - 1)))
    return (int)cudaErrorInvalidValue;
  const int shared_nodes =
      2 * n_leaves < kSharedNodes ? 2 * n_leaves : kSharedNodes;
  const WalkParams P{p, d, tcur, reinterpret_cast<const float4*>(coeff16),
                     nodes, n, n_leaves, shared_nodes, max_steps, t, row,
                     row2, flag, steps, work};
  const int blocks = (n + kThreads - 1) / kThreads;
  const size_t smem = sizeof(float) * kNodeCols * shared_nodes;
  if (any_hit) {
    QR_LAUNCH(walk_kernel<true>, blocks, kThreads, smem, stream, P);
  } else {
    QR_LAUNCH(walk_kernel<false>, blocks, kThreads, smem, stream, P);
  }
  return (int)cudaGetLastError();
}
