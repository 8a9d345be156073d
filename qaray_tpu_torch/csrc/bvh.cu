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
// Here one thread walks one ray over every instance, in instance order,
// with the best t so far. For each instance the ray is moved to its object
// space (p_obj = M_w2o (p - t_o2w), products summed in a fixed order) and
// its walk starts at the instance's root. A step takes an inner node's fat
// row (64 bytes: both children's boxes and refs), slab-tests both children
// against the ray's t at the step's start, tests the triangles of a hit
// leaf child at once (consecutive 48-byte rows of ltri, whose column 9
// carries the bit-cast world triangle id), and takes the hit inner
// children whose entry lies below the t the leaves left, near child first.
// A leaf root (a tree of one leaf) is tested as the step's first leaf. A
// hit replaces the best where t < best t, as the JAX loop takes it. The
// any hit stops a ray at its first occluder and skips the instances after
// one.
//
// Every operation is the plain version's, in its order, and the build
// has no FMA contraction (ops/_build.py), so t, the triangle, the
// barycentrics, the front flag and the work counts are the plain walk's
// bits; ties in t go to the triangle visited first in the same visit order.
//
// What bounds it on the H100. By its work counters it is bound by
// operations (two slab tests an inner node, about 50 a triangle test), but
// a closest-hit launch lasts as long as its slowest rays' walks, each a
// chain of dependent steps on one thread: rays that graze a mesh, or lie
// within 1e-7 of parallel to an axis (whose slab the test then leaves
// unbounded, so that they enter every box their other two axes cross),
// walk hundreds to thousands of nodes. On grid_scene's 5x5 grid of ico5
// instances one ray walks 10,515 steps, and the launch without its
// slowest 1 % of rays takes a sixteenth of its time (tools/w1_layout.py).
// Only a shorter step shortens such a walk. What the design does about it:
// - The next step's node stays in registers: of two hit inner children the
//   near one is walked next and only the far one goes on the stack (as
//   pushing far then near and popping gives), so a step stores and loads
//   the stack only where it pops. The stack, stack_size refs of at most
//   QR_BVH_STACK, is a thread's own (local memory, cached in L1).
// - A leaf's triangle rows are loaded one ahead: the next row is in flight
//   while the current one is tested.
// - The instance table is warp-uniform, so each block stages it in shared
//   memory kChunk instances at a time (coalesced 16-byte loads): each
//   instance's transform, its root's fat row and its root ref. A walk
//   starts from there, with no load of the root's ref and then of its row
//   from device memory. Every thread walks the chunk, then the block
//   stages the next; every thread reaches every barrier (a thread past n,
//   an occluded shadow ray or one whose walk is done walks no instance).
// - No floor on blocks an SM: __launch_bounds__ gives the compiler the
//   registers the walk wants (held to 64, it spilled and ran slower).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The launches and their shared memory go through macros that
// csrc/host/cuda_runtime.h defines otherwise, so that the CPU tests can
// compile this source with g++ and run it on the CPU
// (ops/bvh_packed.walk_host).
#ifndef QR_LAUNCH
#define QR_SHARED_FLOATS(name) extern __shared__ __align__(16) float name[]
#define QR_LAUNCH(kernel, blocks, threads, smem, stream, arg) \
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(arg)
#endif

#define QR_BVH_STACK 64
#define QR_BVH_BIAS 0.005f
#define QR_BVH_BIG 1.0e30f

namespace {

constexpr int kThreads = 128;
// Instances staged at once, and the floats of one staged instance: M_w2o
// and t_o2w (0-11), its root's two child boxes (12-23) and refs (24-25,
// bit-cast), the root's own ref (26, bit-cast), one pad: 7 KB a block.
constexpr int kChunk = 64;
constexpr int kRec = 28;

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
// The row is (r0, r1, r2): the vertices in columns 0-8.
__device__ __forceinline__ bool tri_test(const float4& r0, const float4& r1,
                                         const float4& r2, const V3& p,
                                         const V3& d, float t_max, float& t,
                                         float& a, float& b, float& c,
                                         bool& front) {
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
  int tri, inst;
  bool front;
};

// The triangles of a leaf ref's decoded (off, cnt), in order, below best.t;
// a hit that beats best.t becomes the best, of instance `inst`. Each row is
// loaded while the one before it is tested.
__device__ __forceinline__ void test_leaf(const BvhParams& P, int off,
                                          int cnt, const V3& p, const V3& d,
                                          int inst, Hit& best, int& tested) {
  cnt = cnt < P.max_leaf ? cnt : P.max_leaf;
  if (cnt <= 0) return;
  const float4* rows = reinterpret_cast<const float4*>(P.ltri) + 3 * off;
  float4 r0 = __ldg(rows), r1 = __ldg(rows + 1), r2 = __ldg(rows + 2);
  for (int k = 0; k < cnt; ++k) {
    const float4 q0 = r0, q1 = r1, q2 = r2;
    if (k + 1 < cnt) {
      rows += 3;
      r0 = __ldg(rows);
      r1 = __ldg(rows + 1);
      r2 = __ldg(rows + 2);
    }
    float t, a, b, c;
    bool fr;
    ++tested;
    if (tri_test(q0, q1, q2, p, d, best.t, t, a, b, c, fr) && t < best.t) {
      best.t = t;
      best.a = a;
      best.b = b;
      best.c = c;
      best.front = fr;
      best.tri = __float_as_int(q2.y);  // column 9: the world triangle id
      best.inst = inst;
    }
  }
}

// The ray in a staged instance's object space: M_w2o (p - t_o2w), M_w2o d,
// each row's products summed left to right (ops/intersect._apply). rec: a
// staged instance (kRec floats, 16-byte aligned).
__device__ __forceinline__ void to_object(const float* rec, const V3& p,
                                          const V3& d, V3& po, V3& dob) {
  const float4* r4 = reinterpret_cast<const float4*>(rec);
  const float4 m0 = r4[0], m1 = r4[1], m2 = r4[2];
  const V3 r{p.x - m2.y, p.y - m2.z, p.z - m2.w};
  po = V3{m0.x * r.x + m0.y * r.y + m0.z * r.z,
          m0.w * r.x + m1.x * r.y + m1.y * r.z,
          m1.z * r.x + m1.w * r.y + m2.x * r.z};
  dob = V3{m0.x * d.x + m0.y * d.y + m0.z * d.z,
           m0.w * d.x + m1.x * d.y + m1.y * d.z,
           m1.z * d.x + m1.w * d.y + m2.x * d.z};
}

// Stage instances [c0, c0 + cn) as kRec-float records: the transforms as
// float4 (xf rows are 48 bytes, 16-byte aligned), then each root's ref and,
// for an inner root, its fat row's boxes and child refs.
__device__ __forceinline__ void stage(const BvhParams& P, int c0, int cn,
                                      float* s_inst) {
  if (P.xf) {
    const float4* src = reinterpret_cast<const float4*>(P.xf) + 3 * c0;
    for (int j = threadIdx.x; j < 3 * cn; j += blockDim.x)
      reinterpret_cast<float4*>(s_inst + kRec * (j / 3))[j % 3] =
          __ldg(src + j);
  }
  const float4* nodes = reinterpret_cast<const float4*>(P.pnodes);
  for (int j = threadIdx.x; j < 4 * cn; j += blockDim.x) {
    const int k = j >> 2, q = j & 3;
    const int root = __ldg(P.roots + c0 + k);
    float4 v = root >= 0 ? __ldg(nodes + 4 * (size_t)root + q)
                         : float4{0.0f, 0.0f, 0.0f, 0.0f};
    if (q == 3) v.z = __int_as_float(root);
    reinterpret_cast<float4*>(s_inst + kRec * k + 12)[q] = v;
  }
}

// Instance `inst`'s walk from its staged record: the ray moved to its
// object space, then one inner node a step (traverse_bvh_packed's body),
// the root's row from shared memory and every other row from pnodes. A
// step slab-tests both children against the t at its start, tests the
// triangles of the hit leaf children (child 0 first), then takes the hit
// inner children whose entry lies below the t the leaves left: the near
// one is the next step's node and the far one goes on the stack, as
// pushing far then near and popping gives; with none, the next node is
// popped. A leaf root (a tree of one leaf) is tested as a step's first
// leaf.
template <bool kAnyHit>
__device__ __forceinline__ void walk_instance(const BvhParams& P,
                                              const float* rec, const V3& p,
                                              const V3& d, int inst,
                                              int* stack, Hit& best,
                                              int& inner, int& tested) {
  V3 po = p, dob = d;
  if (P.xf) to_object(rec, p, d, po, dob);
  const bool small[3] = {fabsf(dob.x) < 1e-7f, fabsf(dob.y) < 1e-7f,
                         fabsf(dob.z) < 1e-7f};
  const V3 rcp{small[0] ? 1.0f : 1.0f / dob.x,
               small[1] ? 1.0f : 1.0f / dob.y,
               small[2] ? 1.0f : 1.0f / dob.z};
  const float4* r4 = reinterpret_cast<const float4*>(rec + 12);
  float4 a = r4[0], b = r4[1], c = r4[2], e = r4[3];
  const int root = __float_as_int(e.z);
  if (root < 0) {
    const int lf = -root - 1;
    test_leaf(P, lf >> 3, lf & 7, po, dob, inst, best, tested);
    return;
  }
  const float4* nodes = reinterpret_cast<const float4*>(P.pnodes);
  const int top = P.stack_size - 1;
  int sp = 0;  // refs on the stack under the node in hand
  while (true) {
    ++inner;
    const float t_step = best.t;
    const float row[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                           b.z, b.w, c.x, c.y, c.z, c.w};
    const int ref0 = __float_as_int(e.x), ref1 = __float_as_int(e.y);
    float entry0, entry1;
    const bool hit0 = slab(row, po, rcp, small, t_step, entry0);
    const bool hit1 = slab(row + 6, po, rcp, small, t_step, entry1);
    if (hit0 && ref0 < 0) {
      const int lf = -ref0 - 1;
      test_leaf(P, lf >> 3, lf & 7, po, dob, inst, best, tested);
    }
    if (hit1 && ref1 < 0) {
      const int lf = -ref1 - 1;
      test_leaf(P, lf >> 3, lf & 7, po, dob, inst, best, tested);
    }
    if (kAnyHit && best.tri >= 0) return;
    const bool push0 = hit0 && ref0 >= 0 && entry0 < best.t;
    const bool push1 = hit1 && ref1 >= 0 && entry1 < best.t;
    int next;
    if (push0 && push1) {
      const bool near0 = entry0 < entry1;
      stack[sp < top ? sp : top] = near0 ? ref1 : ref0;
      ++sp;
      next = near0 ? ref0 : ref1;
    } else if (push0 || push1) {
      next = push0 ? ref0 : ref1;
    } else {
      if (sp == 0) return;
      --sp;
      next = stack[sp < top ? sp : top];
    }
    a = __ldg(nodes + 4 * (size_t)next);
    b = __ldg(nodes + 4 * (size_t)next + 1);
    c = __ldg(nodes + 4 * (size_t)next + 2);
    e = __ldg(nodes + 4 * (size_t)next + 3);
  }
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads) bvh_kernel(const BvhParams P) {
  QR_SHARED_FLOATS(smem);
  float* s_inst = smem;
  int stack[QR_BVH_STACK];
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = r < P.n;
  V3 p{0.0f, 0.0f, 0.0f}, d{0.0f, 0.0f, 0.0f};
  float tcur = 0.0f;
  bool open = live;  // instances still to walk
  if (live) {
    p = V3{P.p[3 * r], P.p[3 * r + 1], P.p[3 * r + 2]};
    d = V3{P.d[3 * r], P.d[3 * r + 1], P.d[3 * r + 2]};
    tcur = P.tcur[r];
    if (kAnyHit && P.occ_in) open = !P.occ_in[r];
  }
  const bool occ_in = live && !open;
  Hit best{tcur, 0.0f, 0.0f, 0.0f, -1, -1, false};
  int inner = 0, tested = 0;
  for (int c0 = 0; c0 < P.n_inst; c0 += kChunk) {
    // Every thread arrives here once a chunk: the last chunk's reads are
    // done before its records are overwritten, and a block with no ray
    // left open stops.
    if (c0 > 0 && !__syncthreads_or(open)) break;
    const int cn = P.n_inst - c0 < kChunk ? P.n_inst - c0 : kChunk;
    stage(P, c0, cn, s_inst);
    __syncthreads();
    for (int i = 0; i < cn && open; ++i) {
      walk_instance<kAnyHit>(P, s_inst + kRec * i, p, d, c0 + i, stack,
                             best, inner, tested);
      if (kAnyHit && best.tri >= 0) open = false;
    }
  }
  if (!live) return;
  if (kAnyHit) {
    P.occ[r] = occ_in || best.tri >= 0;
  } else {
    P.t[r] = best.t;
    P.tri[r] = best.tri;
    P.inst[r] = best.inst;
    P.bary[3 * r] = best.a;
    P.bary[3 * r + 1] = best.b;
    P.bary[3 * r + 2] = best.c;
    P.front[r] = best.front;
  }
  if (P.work) {
    P.work[2 * r] = inner;
    P.work[2 * r + 1] = tested;
  }
}

}  // namespace

extern "C" int qr_bvh_stack_cap() { return QR_BVH_STACK; }

// The walk over n rays and n_inst instances, on `stream`; returns
// cudaGetLastError(). xf null: one world-space tree (n_inst 1, no
// transform, inst 0 where hit). any_hit: writes occ (occ_in optional);
// else t, tri, inst, bary, front. work optional. stack_size must lie in
// [1, QR_BVH_STACK]; pnodes, ltri and xf 16-byte aligned.
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
  const int chunk = n_inst < kChunk ? n_inst : kChunk;
  const size_t smem = sizeof(float) * (size_t)kRec * chunk;
  if (any_hit)
    QR_LAUNCH(bvh_kernel<true>, blocks, kThreads, smem, stream, P);
  else
    QR_LAUNCH(bvh_kernel<false>, blocks, kThreads, smem, stream, P);
  return (int)cudaGetLastError();
}
