// W1: the packed BVH walk, closest and any hit, over mesh instances.
//
// Replaces qaray_tpu/ops/bvh_packed.py::traverse_bvh_packed (:126), which
// is XLA code: a lax.while_loop in which every lane of a megabatch pops one
// fat node a step, behind masks, until the whole batch has drained, and the
// per-instance loops of qaray_tpu/ops/trace.py (_mesh_closest :281-301,
// trace_shadow :555-566), one such walk for each instance, one after
// another. The plain version is ops/bvh_packed.py (traverse_bvh_packed and
// the instance loops around it).
//
// Here one thread walks one ray. Its stack of packed refs lives in local
// memory, stack_size (the tree's depth + 2, as in the JAX package) of at
// most QR_BVH_STACK entries; a deeper tree is refused by the wrapper and
// by the scene compiler. A step pops a ref; an inner node's fat row (64
// bytes: both children's boxes and refs) is read once, both children are
// slab-tested against the ray's t at the step's start, the triangles of a
// hit leaf child are tested at once (consecutive 48-byte rows of ltri,
// whose column 9 carries the bit-cast world triangle id), and the hit
// inner children are pushed far child first, each only while its entry
// lies below the t the leaves left. A popped leaf ref (only a tree whose
// root is a leaf) is tested as the step's first leaf. With instances, one
// launch walks every instance for each ray: the ray is moved to the
// instance's object space (p_obj = M_w2o (p - t_o2w), products summed in a
// fixed order), the walk starts at the instance's root ref with the best
// t so far, and a hit replaces the best where tri >= 0 and t < best t, as
// the JAX loop takes it. The any hit stops a ray's walk at its first
// occluder and skips the instances after one.
//
// Every operation is the plain version's, in its order, and the build
// has no FMA contraction (ops/_build.py), so t, the triangle, the
// barycentrics and the front flag are the plain walk's bits; ties in t go
// to the triangle visited first in the same visit order.
//
// What bounds it on the H100: operations (two slab tests an inner node,
// about 50 a triangle test), by the work counter's count, but a ray's walk
// is a chain of dependent loads (a node's row decides the next), so the
// latency of those loads and the divergence of a warp's rays decide the
// time; nothing is shared among rays but the read-only cache, through
// which every row is read.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef QR_LAUNCH
#define QR_LAUNCH(kernel, blocks, threads, smem, stream, arg) \
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(arg)
#endif

#define QR_BVH_STACK 64
#define QR_BVH_BIAS 0.005f
#define QR_BVH_BIG 1.0e30f

namespace {

constexpr int kThreads = 128;

struct BvhParams {
  const float* p;      // [n, 3] world ray origins
  const float* d;      // [n, 3] world ray directions
  const float* tcur;   // [n] t to beat (closest) or t_max (any hit)
  const bool* occ_in;  // [n] already occluded (any hit), or null
  const float* pnodes;  // [Ni, 16] fat inner nodes
  const float* ltri;    // [F, 12] leaf-ordered triangles
  const int* roots;     // [n_inst] packed root refs
  const float* xf;      // [n_inst, 12] M_w2o row-major, t_o2w; null: world
  int n, n_inst, stack_size, max_leaf;
  float* t;       // [n] closest: t (tcur where no hit)
  int* tri;       // [n] closest: world triangle id or -1
  int* inst;      // [n] closest: instance or -1
  float* bary;    // [n, 3] closest
  bool* front;    // [n] closest
  bool* occ;      // [n] any hit
  int* work;      // [n, 2] inner nodes popped, triangles tested; or null
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float comp(const V3& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : v.z);
}

// The 2D area of ops/intersect.intersect_triangles on axes (i, j).
__device__ __forceinline__ float area(int i, int j, const V3& a, const V3& b,
                                      const V3& c) {
  return (comp(b, i) - comp(a, i)) * (comp(c, j) - comp(a, j)) -
         (comp(c, i) - comp(a, i)) * (comp(b, j) - comp(a, j));
}

// ops/intersect.intersect_triangles for one ray and one ltri row.
__device__ __forceinline__ bool tri_test(const float* row, const V3& p,
                                         const V3& d, float t_max, float& t,
                                         float& a, float& b, float& c,
                                         bool& front) {
  const float4 r0 = __ldg(reinterpret_cast<const float4*>(row));
  const float4 r1 = __ldg(reinterpret_cast<const float4*>(row) + 1);
  const float4 r2 = __ldg(reinterpret_cast<const float4*>(row) + 2);
  const V3 v0{r0.x, r0.y, r0.z}, v1{r0.w, r1.x, r1.y}, v2{r1.z, r1.w, r2.x};
  const V3 e1{v1.x - v0.x, v1.y - v0.y, v1.z - v0.z};
  const V3 e2{v2.x - v0.x, v2.y - v0.y, v2.z - v0.z};
  const V3 n{e1.y * e2.z - e1.z * e2.y, e1.z * e2.x - e1.x * e2.z,
             e1.x * e2.y - e1.y * e2.x};
  const float dz = d.x * n.x + d.y * n.y + d.z * n.z;
  const V3 pv{p.x - v0.x, p.y - v0.y, p.z - v0.z};
  const float pz = pv.x * n.x + pv.y * n.y + pv.z * n.z;
  const float safe = fabsf(dz) < 1e-30f ? 1e-30f : dz;
  t = -pz / safe;
  const float n_len = sqrtf(fmaxf(n.x * n.x + n.y * n.y + n.z * n.z, 1e-30f));
  const bool parallel = fabsf(dz) / n_len < 1e-7f;
  const V3 hp{p.x + t * d.x, p.y + t * d.y, p.z + t * d.z};
  const float ax = fabsf(n.x), ay = fabsf(n.y), az = fabsf(n.z);
  const bool axis0 = ax > ay && ax > az;
  const bool axis1 = !axis0 && ay > az;
  const int i = axis0 ? 1 : 0;
  const int j = (axis0 || axis1) ? 2 : 1;
  float s = area(i, j, v0, v1, v2);
  s = fabsf(s) < 1e-30f ? 1e-30f : s;
  a = area(i, j, hp, v1, v2) / s;
  b = area(i, j, hp, v2, v0) / s;
  c = 1.0f - a - b;
  front = dz <= 0.0f;
  return !parallel && t > QR_BVH_BIAS && t < t_max && a >= 0.0f &&
         b >= 0.0f && c >= 0.0f;
}

// The slab test of ops/bvh_traverse.slab_test: (hit, entry) of box[0:6].
__device__ __forceinline__ bool slab(const float* box, const V3& p,
                                     const V3& rcp, const bool* small,
                                     float t_best, float& entry) {
  float t0[3], t1[3];
  const float pc[3] = {p.x, p.y, p.z}, rc[3] = {rcp.x, rcp.y, rcp.z};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float lo = (box[k] - pc[k]) * rc[k];
    const float hi = (box[3 + k] - pc[k]) * rc[k];
    t0[k] = small[k] ? -QR_BVH_BIG : fminf(lo, hi);
    t1[k] = small[k] ? QR_BVH_BIG : fmaxf(lo, hi);
  }
  entry = fmaxf(fmaxf(t0[0], t0[1]), t0[2]);
  const float exit_ = fminf(fminf(t1[0], t1[1]), t1[2]);
  return entry < t_best && entry < exit_ && exit_ > QR_BVH_BIAS;
}

struct Hit {
  float t, a, b, c;
  int tri;
  bool front;
};

// One ray's walk from `root` below best.t (traverse_bvh_packed's body, a
// step per iteration). Updates best where a triangle beats it.
template <bool kAnyHit>
__device__ void walk(const BvhParams& P, const V3& p, const V3& d, int root,
                     Hit& best, int* work) {
  const bool small[3] = {fabsf(d.x) < 1e-7f, fabsf(d.y) < 1e-7f,
                         fabsf(d.z) < 1e-7f};
  const V3 rcp{small[0] ? 1.0f : 1.0f / d.x, small[1] ? 1.0f : 1.0f / d.y,
               small[2] ? 1.0f : 1.0f / d.z};
  int stack[QR_BVH_STACK];
  stack[0] = root;
  int sp = 1;
  const int top = P.stack_size - 1;
  int inner = 0, tested = 0;
  while (sp > 0) {
    const int sp_pop = sp - 1;
    const int ref = stack[sp_pop];
    const float t_step = best.t;
    int offs[2] = {0, 0}, cnts[2] = {0, 0};
    bool push0 = false, push1 = false;
    float entry0 = 0.0f, entry1 = 0.0f;
    int ref0 = 0, ref1 = 0;
    if (ref < 0) {  // a popped leaf: the root of a one-leaf tree
      const int e = -ref - 1;
      offs[0] = e >> 3;
      cnts[0] = e & 7;
    } else {
      ++inner;
      float row[16];
      const float4* r4 = reinterpret_cast<const float4*>(P.pnodes) + 4 * ref;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v = __ldg(r4 + q);
        row[4 * q] = v.x;
        row[4 * q + 1] = v.y;
        row[4 * q + 2] = v.z;
        row[4 * q + 3] = v.w;
      }
      ref0 = __float_as_int(row[12]);
      ref1 = __float_as_int(row[13]);
      const bool hit0 = slab(row, p, rcp, small, t_step, entry0);
      const bool hit1 = slab(row + 6, p, rcp, small, t_step, entry1);
      if (hit0 && ref0 < 0) {
        const int e = -ref0 - 1;
        offs[0] = e >> 3;
        cnts[0] = e & 7;
      }
      if (hit1 && ref1 < 0) {
        const int e = -ref1 - 1;
        offs[1] = e >> 3;
        cnts[1] = e & 7;
      }
      push0 = hit0 && ref0 >= 0;
      push1 = hit1 && ref1 >= 0;
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int cnt = cnts[s] < P.max_leaf ? cnts[s] : P.max_leaf;
      for (int k = 0; k < cnt; ++k) {
        const float* row = P.ltri + 12 * (size_t)(offs[s] + k);
        float t, a, b, c;
        bool fr;
        ++tested;
        if (tri_test(row, p, d, best.t, t, a, b, c, fr) && t < best.t) {
          best.t = t;
          best.a = a;
          best.b = b;
          best.c = c;
          best.front = fr;
          best.tri = __float_as_int(__ldg(row + 9));
        }
      }
    }
    push0 = push0 && entry0 < best.t;
    push1 = push1 && entry1 < best.t;
    const bool both = push0 && push1;
    const bool near0 = entry0 < entry1;
    const int first = both ? (near0 ? ref1 : ref0) : (push0 ? ref0 : ref1);
    const int second = near0 ? ref0 : ref1;
    int sp1 = sp_pop;
    if (push0 || push1) {
      stack[sp1 < top ? sp1 : top] = first;
      ++sp1;
    }
    if (both) {
      stack[sp1 < top ? sp1 : top] = second;
      ++sp1;
    }
    sp = sp1;
    if (kAnyHit && best.tri >= 0) sp = 0;
  }
  if (work) {
    work[0] += inner;
    work[1] += tested;
  }
}

// The ray in instance i's object space: M_w2o (p - t_o2w), M_w2o d, each
// row's products summed left to right (ops/intersect._apply).
__device__ __forceinline__ void to_object(const float* xf, const V3& p,
                                          const V3& d, V3& po, V3& dob) {
  const V3 r{p.x - xf[9], p.y - xf[10], p.z - xf[11]};
  po = V3{xf[0] * r.x + xf[1] * r.y + xf[2] * r.z,
          xf[3] * r.x + xf[4] * r.y + xf[5] * r.z,
          xf[6] * r.x + xf[7] * r.y + xf[8] * r.z};
  dob = V3{xf[0] * d.x + xf[1] * d.y + xf[2] * d.z,
           xf[3] * d.x + xf[4] * d.y + xf[5] * d.z,
           xf[6] * d.x + xf[7] * d.y + xf[8] * d.z};
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
    bvh_kernel(const BvhParams P) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= P.n) return;
  const V3 p{P.p[3 * r], P.p[3 * r + 1], P.p[3 * r + 2]};
  const V3 d{P.d[3 * r], P.d[3 * r + 1], P.d[3 * r + 2]};
  const float tcur = P.tcur[r];
  int wk[2] = {0, 0};
  int* work = P.work ? wk : nullptr;
  if (kAnyHit) {
    bool occ = P.occ_in ? P.occ_in[r] : false;
    for (int i = 0; i < P.n_inst && !occ; ++i) {
      V3 po = p, dob = d;
      if (P.xf) to_object(P.xf + 12 * i, p, d, po, dob);
      Hit h{tcur, 0.0f, 0.0f, 0.0f, -1, false};
      walk<true>(P, po, dob, P.roots[i], h, work);
      occ = h.tri >= 0 && h.t < tcur;
    }
    P.occ[r] = occ;
  } else {
    Hit best{tcur, 0.0f, 0.0f, 0.0f, -1, false};
    int best_inst = -1;
    for (int i = 0; i < P.n_inst; ++i) {
      V3 po = p, dob = d;
      if (P.xf) to_object(P.xf + 12 * i, p, d, po, dob);
      Hit h{best.t, 0.0f, 0.0f, 0.0f, -1, false};
      walk<false>(P, po, dob, P.roots[i], h, work);
      if (h.tri >= 0 && h.t < best.t) {
        best = h;
        best_inst = i;
      }
    }
    P.t[r] = best.t;
    P.tri[r] = best.tri;
    P.inst[r] = best_inst;
    P.bary[3 * r] = best.a;
    P.bary[3 * r + 1] = best.b;
    P.bary[3 * r + 2] = best.c;
    P.front[r] = best.front;
  }
  if (P.work) {
    P.work[2 * r] = wk[0];
    P.work[2 * r + 1] = wk[1];
  }
}

}  // namespace

extern "C" int qr_bvh_stack_cap() { return QR_BVH_STACK; }

// The walk over n rays and n_inst instances, on `stream`; returns
// cudaGetLastError(). xf null: one world-space tree (n_inst 1, no
// transform, inst 0 where hit). any_hit: writes occ (occ_in optional);
// else t, tri, inst, bary, front. work optional. stack_size must lie in
// [1, QR_BVH_STACK].
extern "C" int qr_bvh_walk(const float* p, const float* d, const float* tcur,
                           const bool* occ_in, const float* pnodes,
                           const float* ltri, const int* roots,
                           const float* xf, int n, int n_inst,
                           int stack_size, int max_leaf, int any_hit,
                           float* t, int* tri, int* inst, float* bary,
                           bool* front, bool* occ, int* work, void* stream) {
  if (n <= 0 || n_inst <= 0 || stack_size < 1 || stack_size > QR_BVH_STACK)
    return (int)cudaErrorInvalidValue;
  const BvhParams P{p,    d,     tcur, occ_in, pnodes, ltri,  roots,
                    xf,   n,     n_inst, stack_size, max_leaf, t,
                    tri,  inst,  bary, front, occ,   work};
  const int blocks = (n + kThreads - 1) / kThreads;
  if (any_hit)
    QR_LAUNCH(bvh_kernel<true>, blocks, kThreads, 0, stream, P);
  else
    QR_LAUNCH(bvh_kernel<false>, blocks, kThreads, 0, stream, P);
  return (int)cudaGetLastError();
}
