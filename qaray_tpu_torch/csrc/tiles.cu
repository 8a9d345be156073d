// Per-ray cluster walks over a Morton-clustered world mesh: the tiled
// closest hit (K4a) and any hit (K4b), and the closest hit of the dense
// route (K3), one template.
//
// Replaces the Pallas TPU kernels qaray_tpu/ops/pallas_tiles.py
// ::_closest_kernel (:111) and ::_anyhit_kernel (:213), dispatched by
// pallas_tiled_sweep at :385 and :374, and qaray_tpu/ops/pallas_mesh.py
// ::_sweep_kernel (:41), dispatched by pallas_sweep_closest at :143. The
// TPU kernels march packets of 2048 rays through the clusters a
// packet-wide interval cull kept (K4), or sweep every ray against every
// triangle row because per-lane gathers are slow there (K3), so a packet
// runs as long as its slowest ray and a dense sweep does all of its work.
// Here one thread walks one ray, 128 threads a block, over a binary tree
// of the cluster boxes (ops/tiles.cluster_tree: heap order, node 1 the
// root, node k's children 2k and 2k+1, leaf L + c cluster c). The walk
// (walk.cuh's tree_walk, which the megakernel's K1c shares) descends
// nearest child first without a stack and tests nodes with mesh.cuh's
// widened one-ray slab test (box_entry), which
// over-accepts and never drops a grazing hit. A node is pruned when its
// entry bound lies beyond the ray's reach; a leaf sweeps its cluster's
// coefficient rows with tri_hit, read through the read-only cache
// (neighbouring rays read the same rows; at 81,920 triangles the whole
// table is 5.2 MB and stays in L2). The top of the tree (32 KB, 1,024
// nodes) is staged in shared memory.
//
// The three modes differ in their fold and their reach:
// - kTiled (K4a): the top-2 below t_cur in sorted-row ids, reach the
//   runner-up's t (at most t_cur), ties to the first row visited.
//   max_steps caps the clusters a ray visits; `resolved` says the walk
//   ended before the cap.
// - kAnyHit (K4b, and K3's any hit): occluded iff some row has
//   BIAS < t < budget; a ray stops at its first occluder.
// - kDense (K3): the dense sweep's function exactly. Of the set
//   {(t_cur, -1)} and every hit (t, gid), ordered by (t, gid), the first
//   element's t, its gid where it lies below t_cur, and the second
//   element's gid where its t is below BIGFLOAT. The fold compares
//   (t, gid) lexicographically, so ties go to the lower world triangle id
//   as in the dense fold, and the reach is the second element's t, which
//   starts at BIGFLOAT: where no hit beats t_cur the runner-up is the
//   nearest hit at or beyond it. Nodes are kept while their entry bound is
//   at or below the reach, since a tie at the reach may still enter.
// Rows' coefficients are the dense table's numbers in another order, so
// every t is bit for bit the dense sweep's.
//
// What bounds it on the H100: operations (about 40 a triangle test, a
// leaf's rows a visited cluster) by count, but a long walk is a chain of
// dependent row loads and tests, so a leaf loads and tests 8 rows at a
// time and keeps their loads in flight together. A warp's rays diverge
// only where their walks do. The leaf size is the caller's: 256 rows on
// the tiled route (the JAX package's clusters), 64 on the dense route,
// whose meshes are small (ops/mesh_sweep.py).
#include <cuda_runtime.h>

#include "walk.cuh"

#ifndef QR_LAUNCH
#define QR_SHARED_FLOATS(name) extern __shared__ float name[]
#define QR_LAUNCH(kernel, blocks, threads, smem, stream, arg) \
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(arg)
#endif

namespace {

constexpr int kThreads = 128;
constexpr int kNodeCols = 8;  // min xyz, max xyz, 2 pad
constexpr int kSharedNodes = 1024;
constexpr int kMaxLeaves = 1 << 16;

enum Mode { kTiled = 0, kAnyHit = 1, kDense = 2 };

struct WalkParams {
  const float* p;
  const float* d;
  const float* tcur;  // closest: t_cur; any hit: budget t_max
  const float4* rows;
  const int* gid;      // kDense: [rows] world triangle id of each row
  const float* nodes;  // [2L, 8]
  int n, n_leaves, leaf_rows, shared_nodes, max_steps;
  float* t;
  int* row;
  int* row2;
  bool* flag;  // resolved (closest) or occluded (any hit)
  int* steps;  // optional [n]: clusters visited
  int* work;   // optional [n]: triangle tests within the winner's reach
};

template <int kMode>
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
  auto enter = [&](int k, float& e) {
    return box_entry(k < P.shared_nodes ? top + kNodeCols * k
                                        : P.nodes + kNodeCols * k,
                     s, INFINITY, e);
  };

  // The top-2: rb, r2 are sorted rows (kTiled) or gids (kDense). t2 is
  // the closest walks' reach, t_in the any hit's.
  float tb = t_in, t2 = kMode == kDense ? QR_BIGFLOAT : t_in;
  int rb = -1, r2 = -1;
  bool occ = false, capped = false;
  int visited = 0, need = 0;
  const float t_any = t_in;
  const float& reach = kMode == kAnyHit ? t_any : t2;
  auto visit = [&](int leaf, float ent) {
    if (kMode == kTiled && P.max_steps && visited == P.max_steps) {
      capped = true;
      return true;
    }
    ++visited;
    if (kMode != kTiled || ent < tb) need += P.leaf_rows;
    const int base = leaf * P.leaf_rows;
    for (int r = base; r < base + P.leaf_rows; r += QR_ROWS_A_STEP) {
      float t[QR_ROWS_A_STEP];
      bool hit[QR_ROWS_A_STEP];
      test_rows(P.rows, r, rp, rd, t, hit);
      // Folded in row order, as one row at a time would fold them.
#pragma unroll
      for (int k = 0; k < QR_ROWS_A_STEP; ++k) {
        if (!hit[k]) continue;
        if (kMode == kAnyHit) {
          occ = occ || t[k] < t_in;
        } else if (kMode == kTiled) {
          if (t[k] < tb) {
            t2 = tb;
            r2 = rb;
            tb = t[k];
            rb = r + k;
          } else if (t[k] < t2) {
            t2 = t[k];
            r2 = r + k;
          }
        } else if (t[k] <= t2) {
          // (t, gid) against the top-2, lexicographically.
          const int g = __ldg(P.gid + r + k);
          if (t[k] < tb || (t[k] == tb && g < rb)) {
            t2 = tb;
            r2 = rb;
            tb = t[k];
            rb = g;
          } else if (t[k] < t2 || g < r2) {
            t2 = t[k];
            r2 = g;
          }
        }
      }
      if (occ) return true;
    }
    return false;
  };
  if (kMode == kDense || t_in > QR_BIAS)
    tree_walk<kMode == kDense>(P.n_leaves, reach, enter, visit);

  if (P.steps) P.steps[i] = visited;
  if (P.work) P.work[i] = need;
  if (kMode == kAnyHit) {
    P.flag[i] = occ;
  } else if (kMode == kTiled) {
    P.t[i] = tb;
    P.row[i] = rb;
    P.row2[i] = r2;
    P.flag[i] = !capped;
  } else {
    P.t[i] = tb;
    P.row[i] = tb < t_in ? rb : -1;
    P.row2[i] = t2 < QR_BIGFLOAT ? r2 : -1;
  }
}

template <int kMode>
int launch(const WalkParams& P, void* stream) {
  const int blocks = (P.n + kThreads - 1) / kThreads;
  const size_t smem = sizeof(float) * kNodeCols * P.shared_nodes;
  QR_LAUNCH(walk_kernel<kMode>, blocks, kThreads, smem, stream, P);
  return (int)cudaGetLastError();
}

bool bad_tree(int n_leaves, int leaf_rows) {
  return n_leaves < 1 || n_leaves > kMaxLeaves ||
         (n_leaves & (n_leaves - 1)) || leaf_rows < QR_ROWS_A_STEP ||
         leaf_rows % QR_ROWS_A_STEP;
}

int shared_nodes(int n_leaves) {
  return 2 * n_leaves < kSharedNodes ? 2 * n_leaves : kSharedNodes;
}

}  // namespace

// C entry points (bound with ctypes): one thread a ray, launched on
// `stream`; return cudaGetLastError(). n > 0, a tree of 2 * n_leaves rows
// with n_leaves a power of two up to 2^16, and coefficient rows for every
// cluster are the caller's job.
//
// The tiled route (K4a, or K4b with any_hit): clusters of 256 rows.
extern "C" int qr_tiles_walk(const float* p, const float* d,
                             const float* tcur, const float* coeff16,
                             const float* nodes, int n, int n_leaves,
                             int any_hit, int max_steps, float* t, int* row,
                             int* row2, bool* flag, int* steps, int* work,
                             void* stream) {
  if (bad_tree(n_leaves, QR_CLUSTER)) return (int)cudaErrorInvalidValue;
  const WalkParams P{p, d, tcur, reinterpret_cast<const float4*>(coeff16),
                     nullptr, nodes, n, n_leaves, QR_CLUSTER,
                     shared_nodes(n_leaves), max_steps, t, row, row2, flag,
                     steps, work};
  return any_hit ? launch<kAnyHit>(P, stream) : launch<kTiled>(P, stream);
}

// The dense route (K3, or its any hit): clusters of leaf_rows rows (a
// multiple of 8) whose world triangle ids are gid; the closest hit writes
// gids and no flag.
extern "C" int qr_mesh_walk(const float* p, const float* d, const float* tcur,
                            const float* coeff16, const int* gid,
                            const float* nodes, int n, int n_leaves,
                            int leaf_rows, int any_hit, float* t, int* row,
                            int* row2, bool* flag, int* steps, int* work,
                            void* stream) {
  if (bad_tree(n_leaves, leaf_rows)) return (int)cudaErrorInvalidValue;
  const WalkParams P{p, d, tcur, reinterpret_cast<const float4*>(coeff16),
                     gid, nodes, n, n_leaves, leaf_rows,
                     shared_nodes(n_leaves), 0, t, row, row2, flag, steps,
                     work};
  return any_hit ? launch<kAnyHit>(P, stream) : launch<kDense>(P, stream);
}
