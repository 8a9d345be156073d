// Path-trace megakernel (K1a, with K1b, K1c and K1d): one whole pathtrace or
// photonmap sample per thread, camera ray to radiance, in one launch.
//
// Replaces the Pallas TPU kernel qaray_tpu/ops/pallas_pathtrace.py
// ::_make_kernel (dispatched by _mega_raw), with its helpers _closest_hit,
// _shadow_occluded, _illuminate, _blinn_direct, _glossy_jitter, _halton and
// the in-kernel threefry of core/krng.py (K1a), and its world-mesh sweep
// _mesh_tri_test / _cluster_overlaps / _bundle_bounds (K1c), and its checker
// textures: the winner's uv and primary-hit footprints of _closest_hit and
// _apply_checker_textures (K1b), and its photon outputs: the in-kernel
// caustics gather (photon_sweep), the irr0 and escalation planes and the
// global-map gather records (K1d).
//
// What bounds it on the H100: operations. A lane reads 12 bytes and
// writes 16, but does per bounce a closest-hit sweep over the primitives,
// a threefry cipher per random draw (about 120 32-bit integer operations
// each, which run at a quarter of the float32 rate), and for every soft
// light 16 to 64 shadow rays, each 2 to 4 ciphers plus a sweep: at the
// Renderer's defaults that loop is most of a vertex's work. With one
// thread a lane a warp pays for its slowest lane: it runs all 64 samples
// whenever one of its 32 lanes lies in a penumbra, and lanes whose path
// has ended idle until the warp's longest path ends. So each vertex's
// soft-shadow work is a task pool of the block. In a scene with a soft
// light the bounce loop is uniform over the block (it runs while some lane
// is alive; without one a lane leaves it when its path ends and the block
// takes no barrier, since nothing is pooled); at each soft light the
// block writes its alive lanes' shadow requests (hit point, key) to
// shared memory, every thread, alive or not, takes (lane, sample) tasks
// by index and writes the sample's occlusion and falloff, and each
// asking lane then folds its own samples in order (pooled_visibility);
// the lanes whose estimate went fractional in the first s_min samples
// have their s_min..s_max-1 samples pooled the same way. The fold sees the
// same samples in the same order as the per-lane loop, so the radiance is
// bit for bit what one thread a lane gives, and a sample's work is counted
// to its lane. The rest of a vertex keeps one thread a lane with scalar
// control flow: shadow rays stop at their first occluder and only the lobe
// a path takes computes its direction. The scene tables (12 floats a
// primitive, 22 a material, 12 a light, 25 for the camera) are staged in
// shared memory once per block, the pool after them (about 37 KB at 128
// threads and 64 samples a window). Specialisation on scene facts is by
// per-primitive and per-light kind tables read at run time, uniform across
// a warp; the sum over lights keeps blinn_direct's order.
//
// K1c, the mesh hit: world-baked triangles in Morton order
// (scene/compiler.py, build_mega_mesh), their runs of leaf_rows rows the
// leaves of a box tree (build_mega_tree). Inside the bounce loop each
// thread walks its own ray over the tree, nearest child first, without a
// stack (walk.cuh, the walk of K3 and K4; the Pallas kernel culls 256-row
// clusters in order for a whole ray block), prunes at its best t and tests
// a leaf's rows with the predicate K3 uses, folding (t, row) in the
// in-order sweep's order, so the winner, its smooth normal a*n0 + b*n1 +
// c*n2 from the attribute table, the front flag and the material row are
// the sweep's. Shadow rays stop at the first occluder. The tables stay in
// global memory, read through the read-only path: a lane's rows are its
// warp neighbours' (coherent rays walk alike), so they come from L1.
// Bounded by operations too: about 40 per triangle test, counted per lane
// in `work`. The mesh is a flag of the instantiations,
// mega_kernel<kTex, kPhoton, kMesh>: the walk's registers would make the
// kernel spill (ptxas caps it at 128 for 4 blocks an SM), so scenes
// without a mesh run instantiations without its code, as before it was
// written. qr_mega_mesh_probe runs the same two functions on given rays,
// for tests.
//
// K1b, checker textures: a flag of the instantiations, mega_kernel<false,
// ...> for untextured scenes (K1a as it was, no texture code in it) and
// mega_kernel<true, ...> for scenes whose live material textures are all
// procedural checkers. There the material rows carry 16 more columns per
// slot (102 in all, still in shared memory), the closest-hit fold keeps the
// winner's uv (atan2f/asinf, as K2b and the engine compute it), and at the
// primary hit two differential camera rays are intersected with the
// winner's local tangent plane for the footprint duv0, duv1. A textured
// slot's colour is multiplied by w*color1 + (1-w)*color2, w the checker test
// at the transformed uv, or at the primary hit the mean of that test over
// the centre and the 31 elliptic offsets of ops/texture.py, which the
// wrapper uploads to constant memory. The loop over the offsets stays a
// loop (registers). The transform and the sample positions keep the plain
// version's operation order: a checker flips at frac == 0.5, so a last-bit
// difference would change a whole colour. Mesh winners carry no uv; their
// rows have no texture (the compiler refuses such scenes for this route).
// Operations again: 32 checker tests a textured slot at a primary vertex,
// one at a later vertex, counted in `work`.
//
// K1d, photon gathering (photonmap with -use-photon-map): another
// instantiation flag, mega_kernel<kTex, true, kMesh>, so scenes without maps
// run the kernels they ran before. At every diffuse-selected vertex the lane
// sweeps the caustics map for its own hit point (photon.cuh's per-thread
// sweep: lanes are not spatially sorted, so each culls the map's clusters
// against its own point, and reads the rows, 64 KB at the default 1,000
// photons, through the read-only cache), Blinn-combines the estimate with
// gather_blinn's luma gate and adds it, and raises the lane's escalation
// flag where more than GATHER_K (100) photons lay in the radius: there the
// estimate needs the radius cap, which the Renderer gets by rendering the
// lane again on the wavefront engine. A diffuse-selected vertex after a
// diffuse bounce also gathers the global map; the path ends there, so a lane
// has at most one such vertex, and the kernel writes that vertex's 17-field
// record (p, n, v, beta*diffuse, beta*specular, glossiness, valid) straight
// to its output planes instead of sweeping the global map from incoherent
// lanes: the wrapper Morton-sorts the records and gathers them with K5
// (ops/photon.gather_apply). The primary vertex's irr0 flag (a photon
// surface) is the fb debug plane. Output planes are zeroed by the wrapper;
// the kernel writes only the ones a lane sets. Operations again: about 20 a
// photon test, counted with the cluster tests in the last two columns of
// `work`.
//
// Random draws are bit-exact with jax.random (threefry2x32 key words):
// the per-lane key is fold(base, rid * 65536 + sid) in wrapping 32-bit
// arithmetic, then fold(1000 + bounce) and a purpose tag per decision, as
// in the wavefront engine. The device code the fused adjoint (K6,
// adjoint.cu) replays these paths with lives in mega_common.cuh.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mega_common.cuh"
#include "photon.cuh"

// The launch and the block's dynamic shared memory go through two macros,
// so that the CPU tests can compile this source with g++ against
// csrc/host/cuda_runtime.h, which defines them otherwise, and run it one
// lane at a time beside the plain version (ops/_build.load_host).
#ifndef QR_LAUNCH
#define QR_SHARED_FLOATS(name) extern __shared__ float name[]
#define QR_LAUNCH(kernel, blocks, threads, smem, stream, arg) \
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(arg)
#endif

namespace {

// Checker columns (_MT_TEXBASE layout): 16 per slot from column 22, slots
// diffuse, specular, emission, reflection, refraction.
constexpr int MT_TEXBASE = 22, TEX_STRIDE = 16, TEX_HAS = 0, TEX_C1 = 1,
              TEX_C2 = 4, TEX_M0 = 7, TEX_M1 = 10, TEX_T = 13, NUM_SLOTS = 5;
constexpr int TEX_OFFSETS = 31;  // TEXTURE_SAMPLE_COUNT - 1
constexpr float RCP_DIFF = 100.0f;  // RCP_DX = RCP_DY = 1 / 0.01
constexpr float DIFF_D = 0.01f;     // DIFF_DX = DIFF_DY
constexpr float CLT = 0.00001f;  // COLOR_LUMA_THRESHOLD
constexpr float GATHER_K = 100.0f;  // photon/cluster.py
constexpr int NUM_REC = 17;        // fields of a global-map gather record
constexpr int kThreads = 128;
// Four blocks an SM: up to 128 registers a thread, which fill the register
// file. Left to itself ptxas gives this kernel fewer registers and spills
// (PERF.md).
constexpr int kBlocksPerSM = 4;

// The 31 elliptic footprint offsets (ops/texture.elliptic_offsets_np),
// uploaded once by qr_mega_set_tex_offsets.
__constant__ float c_tex_xs[TEX_OFFSETS];
__constant__ float c_tex_ys[TEX_OFFSETS];

struct Params {
  const int* px;
  const int* py;
  const int* sid;
  int n;
  const float* prim;
  const int* kinds;
  const int* prim_mtl;
  int num_prims;
  const float* mtl;
  int num_mtls;
  int mtl_cols;  // 22, or 102 with the checker columns
  int tex_mask;  // bit s: material slot s carries a live checker somewhere
  const float* light;
  const int* lkind;
  const int* lsoft;
  int num_lights;
  float light_norm;  // (1 / num_lights) ^ norm_power
  const float* cam;
  uint32_t key0, key1;
  int width;
  int photonmap;  // 0 pathtrace, 1 photonmap
  int max_bounce;
  int shadow_spp, shadow_spp_max;
  int has_dof, has_glossy;
  const float4* mrows;  // [Fp, 16] mesh sweep coefficients (Morton order)
  const float4* mattr;  // [Fp, 16] corner normals (0-8), material row (9)
  const float* mtree;   // [2 * n_leaves, 8] boxes of the leaves' tree
  int n_leaves;         // 0: no mesh
  int leaf_rows;        // rows a leaf
  float* r;
  float* g;
  float* b;
  float* t0;
  int* work;  // optional [n, 8]: prim tests, ciphers, vertices, tri
              // tests, checker tests; K1d: photon tests, caustics cluster
              // tests; soft-shadow tails
  int pool_w;  // soft-shadow samples a window of the pool; 0: no pool
  // K1d: the clustered caustics map ([Fc, 16] rows, [C, 8] boxes), its
  // squared radius, and the [19, n] outputs (irr0, esc, 17 record planes).
  const float4* ctab;
  const float* ccb;
  int n_cclusters;
  float cr2;
  float* pout;
};

__device__ __forceinline__ float luma3(V3 c) {
  return 0.2126f * c.x + 0.7152f * c.y + 0.0722f * c.z;
}

// One light's term of blinn_direct (skip_ambient) at a vertex, given its
// visibility vis (light_visibility, or the pooled soft estimate): the
// light's intensity (pallas_pathtrace._illuminate) times cos_nl and the
// Blinn lobe.
__device__ __forceinline__ V3 light_term(const Params& P, const Shared& S,
                                         int li, float vis, V3 p, V3 n, V3 v,
                                         V3 diffuse, V3 specular,
                                         float gloss) {
  const int kind = S.lkind[li];
  const float* lt = S.light + li * LIGHT_COLS;
  V3 out = scale3(load3(lt + LT_INT), vis);
  if (kind == LIGHT_SPOT) out = scale3(out, spot_attenuation(lt, p));
  const V3 inten = scale3(out, P.light_norm);
  V3 l_dir;
  if (kind == LIGHT_DIRECT) {
    l_dir = norm3(neg3(load3(lt + LT_DIR)), 1e-30f);
  } else {
    const V3 to_p = norm3(sub3(p, load3(lt + LT_POS)), 1e-30f);
    l_dir = norm3(neg3(to_p), 1e-30f);
  }
  const V3 h = norm3(add3(v, l_dir), 1e-30f);
  const float cos_nl = fmaxf(0.0f, dot3(n, l_dir));
  const float cos_nh = fmaxf(0.0f, dot3(n, h));
  const float spec_w = pow_safe(cos_nh, gloss);
  const V3 spec = scale3(specular, spec_w);
  return V3{inten.x * cos_nl * (diffuse.x + spec.x),
            inten.y * cos_nl * (diffuse.y + spec.y),
            inten.z * cos_nl * (diffuse.z + spec.z)};
}

// The block's pool of soft-shadow samples, after the scene tables in
// dynamic shared memory. B = blockDim.x lanes, W samples a window.
struct Pool {
  float* p;       // [3, B] the asking lanes' hit points
  uint32_t* ks;   // [2, B] their soft-shadow keys
  int* list;      // [B] the lanes whose samples the block runs
  int* count;     // [3] list slots taken, one counter a stage mod 3
  int* work;      // [3, B] tests, ciphers, triangle tests run for a lane
  uint32_t* x;    // [W, B + 1] falloff bits, the sign bit set if occluded
  int w;          // W; 0 where the scene has no soft light
};

constexpr int kPoolWindow = 64;  // samples a window, at most

// Floats of the pool at blockDim `threads` and window w.
inline size_t pool_floats(int threads, int w) {
  return (size_t)9 * threads + 3 + (size_t)w * (threads + 1);
}

// The pool at f; zeroes this thread's work slots (thread 0 the counters).
// The first __syncthreads after it publishes the zeros.
__device__ __forceinline__ Pool pool_at(float* f, int w) {
  const int nb = blockDim.x, tid = threadIdx.x;
  Pool Q;
  Q.p = f;
  Q.ks = reinterpret_cast<uint32_t*>(f + 3 * nb);
  Q.list = reinterpret_cast<int*>(f + 5 * nb);
  Q.work = reinterpret_cast<int*>(f + 6 * nb);
  Q.count = reinterpret_cast<int*>(f + 9 * nb);
  Q.x = reinterpret_cast<uint32_t*>(f + 9 * nb + 3);
  Q.w = w;
  for (int k = 0; k < 3; ++k) Q.work[k * nb + tid] = 0;
  if (tid == 0) Q.count[0] = Q.count[1] = Q.count[2] = 0;
  return Q;
}

// Soft light li's adaptive estimate for every lane of the block that asks
// (want), its samples run by the whole block: each thread, alive or not,
// takes (lane, sample) tasks by index, writes the sample's occlusion and
// falloff to shared memory, and after a barrier each asking lane folds its
// own samples in order with soft_step. First samples 0..s_min-1 of every
// asking lane, then s_min..s_max-1 of those whose estimate went
// fractional. Each lane sees the same samples in the same order as
// light_visibility's loop, so its estimate is bit for bit that loop's, and
// a sample's work is counted to its lane. Every thread of the block must
// call it, with Q.w > 0; `stage` counts the list stages (uniform over the
// block).
template <class PT>
__device__ float pooled_visibility(const PT& P, const Shared& S,
                                   const Pool& Q, int li, bool want, V3 p,
                                   Key kb, int& stage, Work& w) {
  const int nb = blockDim.x, tid = threadIdx.x, stride = nb + 1;
  const float* lt = S.light + li * LIGHT_COLS;
  const int s_min = P.shadow_spp;
  const int s_max = max(P.shadow_spp_max, s_min);
  if (want) {
    const Key ks = soft_key(kb, li, w);
    Q.p[tid] = p.x;
    Q.p[nb + tid] = p.y;
    Q.p[2 * nb + tid] = p.z;
    Q.ks[tid] = ks.k0;
    Q.ks[nb + tid] = ks.k1;
  }
  float in_shadow = 0.0f;
  bool frac = false;
  for (int tail = 0; tail < 2; ++tail) {
    const int lo = tail ? s_min : 0, hi = tail ? s_max : s_min;
    const bool mine = want && hi > lo && (!tail || frac);
    if (mine && tail) ++w.tails;
    // The stage's list: counter stage % 3 was zeroed before the last
    // barrier; the one two stages on is zeroed now, after its last use.
    if (mine) Q.list[atomicAdd(Q.count + stage % 3, 1)] = tid;
    const int lanes = __syncthreads_count(mine);
    if (tid == 0) Q.count[(stage + 2) % 3] = 0;
    ++stage;
    for (int s0 = lo; s0 < hi && lanes > 0; s0 += Q.w) {
      const int n_s = min(Q.w, hi - s0);
      for (int t = tid; t < lanes * n_s; t += nb) {
        const int l = Q.list[t / n_s], k = t % n_s;
        Work wt{};
        bool clear;
        const float fall = soft_sample(
            P, S, lt, V3{Q.p[l], Q.p[nb + l], Q.p[2 * nb + l]},
            Key{Q.ks[l], Q.ks[nb + l]}, s0 + k, wt, clear);
        Q.x[k * stride + l] =
            __float_as_uint(fall) | (clear ? 0u : 0x80000000u);
        if (P.work) {
          atomicAdd(Q.work + l, wt.tests);
          atomicAdd(Q.work + nb + l, wt.ciphers);
          atomicAdd(Q.work + 2 * nb + l, wt.tri_tests);
        }
      }
      __syncthreads();
      if (mine) {
        for (int k = 0; k < n_s; ++k) {
          const uint32_t bits = Q.x[k * stride + tid];
          const float upd = soft_step(in_shadow, !(bits >> 31),
                                      __uint_as_float(bits & 0x7FFFFFFFu),
                                      s0 + k);
          in_shadow = upd;
          if (!tail) frac = frac || (upd > 0.0f && upd < 1.0f);
        }
      }
      __syncthreads();
    }
  }
  return in_shadow;
}

// Glossy rejection jitter (pallas_pathtrace._glossy_jitter): 4 hemisphere
// attempts of a 4-attempt quirk ball, first success wins, centre fallback.
// Attempt (a, i) draws flat elements 8a + 2i and 8a + 2i + 1.
__device__ V3 glossy_jitter(V3 center, V3 y_axis, float gloss, Key k,
                            bool want_up, Work& w) {
  const V3 c = norm3(center, 1e-30f);
  const float radius = 2.0f * gloss;
  for (int a = 0; a < 4; ++a) {
    V3 pick;
    for (int i = 0; i < 4; ++i) {
      const uint32_t f = (uint32_t)(a * 8 + i * 2);
      const float r1 = draw_w(k, f, w) * 2.0f - 1.0f;
      const float r2 = draw_w(k, f + 1, w) * 2.0f - 1.0f;
      pick = V3{r1, r2, r2};
      if (sqrtf(dot3(pick, pick)) <= 1.0f) break;
    }
    const V3 cand = norm3(add3(c, clamp_ball(pick, radius)), 1e-30f);
    const float side = dot3(cand, y_axis);
    if (want_up ? side >= 0.0f : side <= 0.0f) return cand;
  }
  return c;
}

// uv where the differential ray (p, dd) meets the winner's local plane
// through `anchor` with normal n_loc, in the primitive's object space
// (ops/intersect.analytic_diff_uv's offset_uv; objects.cpp:107-135,
// 174-202). Spheres: the asin is corrected by the point's radius.
__device__ __forceinline__ void offset_uv(const float* pr, int kind, V3 p,
                                          V3 dd, V3 n_loc, V3 anchor,
                                          float& uo, float& vo) {
  V3 po, dobj;
  obj_ray(pr, p, dd, po, dobj);
  float den = dot3(dobj, n_loc);
  if (fabsf(den) < 1e-20f) den = 1e-20f;
  const float t_off = -dot3(sub3(po, anchor), n_loc) / den;
  const V3 hpo = add3(po, scale3(dobj, t_off));
  if (kind == QR_KIND_SPHERE) {
    const float r = sqrtf(fmaxf(dot3(hpo, hpo), 1e-30f));
    uo = 0.5f - atan2f(hpo.x, hpo.y) / (float)(2.0 * M_PI);
    vo = 0.5f + asinf(fminf(fmaxf(hpo.z / r, -1.0f), 1.0f)) / (float)M_PI;
  } else {
    uo = (hpo.x + 1.0f) * 0.5f;
    vo = (hpo.y + 1.0f) * 0.5f;
  }
}

// TextureChecker::Sample as a weight: 1 takes color1, 0 color2.
__device__ __forceinline__ float checker01(float u, float v) {
  const float ut = u - floorf(u);
  const float vt = v - floorf(v);
  return ((ut <= 0.5f) == (vt <= 0.5f)) ? 1.0f : 0.0f;
}

// TexturedColor::Sample of one material slot (K1b;
// pallas_pathtrace._apply_checker_textures). tx: the slot's 16 columns;
// (u, v): the winner's texture coordinates; filter: a primary hit, whose
// footprint (du0, dv0), (du1, dv1) is averaged over 32 samples unless zero.
__device__ V3 textured(const float* tx, V3 color, float u, float v,
                       bool filter, float du0, float dv0, float du1,
                       float dv1, Work& w) {
  if (!(tx[TEX_HAS] > 0.5f)) return color;
  const float* m0 = tx + TEX_M0;
  const float* m1 = tx + TEX_M1;
  const float pu = u - tx[TEX_T], pv = v - tx[TEX_T + 1],
              pw = 0.0f - tx[TEX_T + 2];
  const float um = m0[0] * pu + m0[1] * pv + m0[2] * pw;
  const float vm = m1[0] * pu + m1[1] * pv + m1[2] * pw;
  float w1 = checker01(um, vm);
  ++w.checkers;
  if (filter && (du0 * du0 + dv0 * dv0 + du1 * du1 + dv1 * dv1) != 0.0f) {
    const float d0u = m0[0] * du0 + m0[1] * dv0;
    const float d0v = m1[0] * du0 + m1[1] * dv0;
    const float d1u = m0[0] * du1 + m0[1] * dv1;
    const float d1v = m1[0] * du1 + m1[1] * dv1;
    float acc = w1;
#pragma unroll 1
    for (int i = 0; i < TEX_OFFSETS; ++i) {
      const float xs = c_tex_xs[i], ys = c_tex_ys[i];
      acc = acc + checker01(um + xs * d0u + ys * d1u, vm + xs * d0v + ys * d1v);
    }
    w1 = acc * (1.0f / 32.0f);
    w.checkers += TEX_OFFSETS;
  }
  const float w2 = 1.0f - w1;
  return V3{color.x * (w1 * tx[TEX_C1] + w2 * tx[TEX_C2]),
            color.y * (w1 * tx[TEX_C1 + 1] + w2 * tx[TEX_C2 + 1]),
            color.z * (w1 * tx[TEX_C1 + 2] + w2 * tx[TEX_C2 + 2])};
}

// kTex: the scene has checker textures (K1b); material rows are then
// P.mtl_cols wide, MTL_COLS otherwise. kPhoton: photon gathering (K1d).
// With a pool (P.pool_w > 0, the same over the grid) the bounce loop is
// uniform over the block: it runs while some lane of the block is alive, a
// lane whose path has ended (or that lies past P.n) skips its own shading,
// and every thread joins the pooled soft-shadow samples. Without one, as
// in scenes with no soft light, a lane leaves the loop when its path ends
// and no barrier is taken; soft lights, should the tables have one, then
// take light_visibility's per-lane loop.
template <bool kTex, bool kPhoton, bool kMesh>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    mega_kernel(const WithMesh<Params, kMesh> P) {
  QR_SHARED_FLOATS(smem);
  const int mtl_cols = kTex ? P.mtl_cols : MTL_COLS;
  const Pool Q = pool_at(
      smem + table_bytes(P.num_prims, P.num_mtls, mtl_cols, P.num_lights) / 4,
      P.pool_w);
  const Shared S = stage_tables(P, mtl_cols, smem);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  bool alive = lane < P.n;
  Work w{};
  int stage = 0;

  V3 p = V3{0.0f, 0.0f, 0.0f}, d = V3{0.0f, 0.0f, 1.0f};
  Key kr = Key{0u, 0u};
  // Differential camera rays through the screen points DIFF_D pixels right
  // of and below the sample (DiffRay ctor, renderer.cpp:314-326): they give
  // the primary hit's texture footprint.
  V3 dxd = V3{0.0f, 0.0f, 0.0f}, dyd = V3{0.0f, 0.0f, 0.0f};
  if (alive) {
    const int px = P.px[lane], py = P.py[lane], sid = P.sid[lane];
    const uint32_t rid = (uint32_t)py * (uint32_t)P.width + (uint32_t)px;
    kr = fold_w(Key{P.key0, P.key1}, rid * 65536u + (uint32_t)sid, w);

    // Camera ray (renderer.cpp:302-327; Halton 11/13 sub-pixel jitter).
    const float tx = (float)px + halton(sid, 11);
    const float ty = (float)py + halton(sid, 13);
    const V3 ca = load3(S.cam + CAM_A), cu = load3(S.cam + CAM_U),
             cv = load3(S.cam + CAM_V);
    const V3 cpt = V3{ca.x + tx * cu.x + ty * cv.x,
                      ca.y + tx * cu.y + ty * cv.y,
                      ca.z + tx * cu.z + ty * cv.z};
    p = load3(S.cam + CAM_POS);
    if (P.has_dof) {
      const Key kd = fold_w(kr, P_DOF, w);
      const float lr = S.cam[CAM_DOF] * sqrtf(draw_w(kd, 0, w));
      const float lt = TWO_PI * draw_w(kd, 1, w);
      const float lx = lr * cosf(lt), ly = lr * sinf(lt);
      const V3 cx = load3(S.cam + CAM_X), cy = load3(S.cam + CAM_Y);
      p = V3{p.x + lx * cx.x + ly * cy.x, p.y + lx * cx.y + ly * cy.y,
             p.z + lx * cx.z + ly * cy.z};
    }
    d = norm3(sub3(cpt, p));
    if (kTex) {
      const V3 xpt = V3{cpt.x + DIFF_D * cu.x, cpt.y + DIFF_D * cu.y,
                        cpt.z + DIFF_D * cu.z};
      const V3 ypt = V3{cpt.x + DIFF_D * cv.x, cpt.y + DIFF_D * cv.y,
                        cpt.z + DIFF_D * cv.z};
      dxd = norm3(sub3(xpt, p));
      dyd = norm3(sub3(ypt, p));
    }
  }

  V3 radiance = V3{0.0f, 0.0f, 0.0f};
  V3 beta = V3{1.0f, 1.0f, 1.0f};
  float t0 = QR_BIGFLOAT;
  bool has_dh = false;                  // photonmap hasDiffuseHit
  V3 pend = V3{0.0f, 0.0f, 0.0f};       // parent's absorption

  for (int bounce = 0; bounce <= P.max_bounce; ++bounce) {
    if (Q.w > 0 ? !__syncthreads_or(alive) : !alive) break;
    // The vertex's shading inputs, set where the lane is alive.
    V3 hp = p, n = d, v = d, diffuse = d, specular = d, emit = d, t_k = d,
       r_k = d;
    bool front = true;
    int row = 0;
    Key kb = kr;
    if (alive) {
      Hit hit = closest_hit<kTex>(S.prim, S.kinds, P.num_prims, p, d);
      w.tests += P.num_prims;
      int mesh_row = -1;
      if constexpr (kMesh) mesh_closest(P, p, d, hit, &mesh_row, w);
      const bool is_hit = hit.t < QR_BIGFLOAT;
      if (bounce == 0) t0 = is_hit ? hit.t : QR_BIGFLOAT;
      if (!is_hit) {
        const V3 mc = load3(S.cam + (bounce == 0 ? CAM_BG : CAM_ENV));
        radiance = add3(radiance, mul3(beta, mc));
        alive = false;
      } else {
        ++w.vertices;
        if (P.photonmap && !hit.front) {
          // Beer attenuation on back-face continuations with the parent
          // vertex's absorption over the traveled distance.
          beta = V3{beta.x * expf(-pend.x * hit.t),
                    beta.y * expf(-pend.y * hit.t),
                    beta.z * expf(-pend.z * hit.t)};
        }
        row = mesh_row >= 0 ? mesh_row : S.prim_mtl[hit.prim];
        const float* mrow = S.mtl + row * mtl_cols;
        diffuse = load3(mrow + MT_DIFF);
        specular = load3(mrow + MT_SPEC);
        emit = load3(mrow + MT_EMIT);
        t_k = load3(mrow + MT_REFR);
        r_k = load3(mrow + MT_REFL);
        if (kTex) {
          // K1b: the primary hit's footprint from the differential rays, on
          // an analytic winner (mesh rows carry no texture), then the slots.
          const bool primary = bounce == 0;
          float du0 = 0.0f, dv0 = 0.0f, du1 = 0.0f, dv1 = 0.0f;
          if (primary && mesh_row < 0) {
            const float* pr = S.prim + hit.prim * QR_PRIM_COLS;
            const int kind = S.kinds[hit.prim];
            V3 po, dobj;
            obj_ray(pr, p, d, po, dobj);
            const V3 hpo = add3(po, scale3(dobj, hit.t));
            const bool sphere = kind == QR_KIND_SPHERE;
            const V3 n_loc =
                sphere ? norm3(hpo, 1e-30f) : V3{0.0f, 0.0f, 1.0f};
            const V3 anchor = sphere ? hpo : V3{0.0f, 0.0f, 0.0f};
            float uo, vo;
            offset_uv(pr, kind, p, dxd, n_loc, anchor, uo, vo);
            du0 = RCP_DIFF * (uo - hit.u);
            dv0 = RCP_DIFF * (vo - hit.v);
            offset_uv(pr, kind, p, dyd, n_loc, anchor, uo, vo);
            du1 = RCP_DIFF * (uo - hit.u);
            dv1 = RCP_DIFF * (vo - hit.v);
          }
          const float* tx = mrow + MT_TEXBASE;
          if (P.tex_mask & 1)
            diffuse = textured(tx, diffuse, hit.u, hit.v, primary, du0, dv0,
                               du1, dv1, w);
          if (P.tex_mask & 2)
            specular = textured(tx + TEX_STRIDE, specular, hit.u, hit.v,
                                primary, du0, dv0, du1, dv1, w);
          if (P.tex_mask & 4)
            emit = textured(tx + 2 * TEX_STRIDE, emit, hit.u, hit.v, primary,
                            du0, dv0, du1, dv1, w);
          if (P.tex_mask & 8)
            r_k = textured(tx + 3 * TEX_STRIDE, r_k, hit.u, hit.v, primary,
                           du0, dv0, du1, dv1, w);
          if (P.tex_mask & 16)
            t_k = textured(tx + 4 * TEX_STRIDE, t_k, hit.u, hit.v, primary,
                           du0, dv0, du1, dv1, w);
        }
        hp = add3(p, scale3(d, hit.t));
        n = norm3(hit.n, 1e-30f);
        front = hit.front;
        v = neg3(d);
        kb = fold_w(kr, (uint32_t)(1000 + bounce), w);
      }
    }
    const float* mrow = S.mtl + row * mtl_cols;
    const float gloss = mrow[MT_GLOSS];

    // Emission + direct light: blinn_direct, lights summed in table order,
    // soft lights' estimates pooled over the block.
    V3 direct = V3{0.0f, 0.0f, 0.0f};
    for (int li = 0; li < P.num_lights; ++li) {
      if (S.lkind[li] == LIGHT_AMBIENT) continue;
      float vis = 0.0f;
      if (Q.w > 0 && soft_light(S, li))
        vis = pooled_visibility(P, S, Q, li, alive, hp, kb, stage, w);
      else if (alive)
        vis = light_visibility(P, S, li, hp, kb, w);
      if (alive) {
        const V3 term =
            light_term(P, S, li, vis, hp, n, v, diffuse, specular, gloss);
        direct = V3{direct.x + term.x, direct.y + term.y, direct.z + term.z};
      }
    }
    if (!alive) continue;
    radiance = add3(radiance, mul3(beta, add3(emit, direct)));

    const float rgloss = mrow[MT_RGLOSS], tgloss = mrow[MT_TGLOSS],
                ior = mrow[MT_IOR];
    // Fresnel (MtlBlinn_PhotonMap::ComputeFresnel, shared by both models).
    const float cos_nv = dot3(n, v);
    const V3 y = cos_nv > 0.0f ? n : neg3(n);
    const V3 x = norm3(cross3(y, cross3(v, y)), 1e-30f);
    const float n_ior = front ? 1.0f / ior : ior;
    const float cos_i = cos_nv;
    const float sin_i = sqrtf(fmaxf(0.0f, 1.0f - cos_i * cos_i));
    const float sin_o = fminf(fmaxf(sin_i * n_ior, 0.0f), 1.0f);
    const float cos_o = sqrtf(fmaxf(0.0f, 1.0f - sin_o * sin_o));
    const bool total_refl = (n_ior * sin_i) > 1.001f;
    const float c0 =
        (n_ior - 1.0f) * (n_ior - 1.0f) / ((n_ior + 1.0f) * (n_ior + 1.0f));
    const float r_ratio = c0 + (1.0f - c0) * powf(1.0f - fabsf(cos_i), 5.0f);
    const float t_ratio = 1.0f - r_ratio;
    const V3 samp_refr =
        total_refl ? V3{0.0f, 0.0f, 0.0f} : scale3(t_k, t_ratio);
    const V3 samp_refl =
        total_refl ? add3(r_k, t_k) : add3(r_k, scale3(t_k, r_ratio));
    const float select =
        draw_w(fold_w(kb, P_LOBE_SELECT, w), 0, w);

    // Lobe select.
    float c_refr = 0.f, c_refl = 0.f, c_spec = 0.f, c_diff = 0.f;
    bool sel_refr = false, sel_refl = false, sel_spec = false,
         sel_diff = false;
    if (!P.photonmap) {
      // colorMax roulette with pdf division (MtlBlinn_PathTracing.cpp).
      const float coef_refr = max3(samp_refr), coef_refl = max3(samp_refl),
                  coef_spec = max3(specular), coef_diff = max3(diffuse);
      const float coef_sum =
          fmaxf(coef_refr + coef_refl + coef_spec + coef_diff, 1e-20f);
      c_refr = coef_refr / coef_sum;
      c_refl = coef_refl / coef_sum;
      c_spec = coef_spec / coef_sum;
      c_diff = coef_diff / coef_sum;
      const float sum_refl = c_refr + c_refl;
      const float sum_spec = sum_refl + c_spec;
      sel_refr = (select <= c_refr) && (c_refr > 1e-6f);
      sel_refl = !sel_refr && (select < sum_refl) && (c_refl > 1e-6f);
      sel_spec = !sel_refr && !sel_refl && (select < sum_spec) &&
                 (c_spec > 1e-6f);
      sel_diff = !sel_refr && !sel_refl && !sel_spec && (c_diff > 1e-6f);
    } else {
      // Luma roulette with kill = 0.1, probability not divided out
      // (RandomSelectMtl, MtlBlinn_PhotonMap.cpp:107-150).
      const float luma_t = luma3(samp_refr);
      const float luma_r = luma3(samp_refl);
      const float luma_d = luma3(diffuse);
      const float coef_t = luma_t;
      const float coef_r = coef_t + luma_r;
      const float coef_d = coef_r + luma_d;
      const float sel_pt = select * (coef_d + 0.1f);
      sel_refr = (sel_pt < coef_t) && (luma_t > CLT);
      sel_refl = !sel_refr && (sel_pt < coef_r) && (luma_r > CLT);
      sel_diff = !sel_refr && !sel_refl && (sel_pt < coef_d) && (luma_d > CLT);
    }

    if (kPhoton) {
      // K1d (MtlBlinn_PhotonMap.cpp:344-368, 420-458): diffuse-selected
      // vertices gather the caustics map; those after a diffuse bounce also
      // the global map, through their record.
      const size_t np = (size_t)P.n;
      if (bounce == 0 && luma3(diffuse) > 0.0f) P.pout[lane] = 1.0f;
      if (sel_diff) {
        if (has_dh) {
          const float rec[NUM_REC] = {
              hp.x, hp.y, hp.z, n.x, n.y, n.z, v.x, v.y, v.z,
              beta.x * diffuse.x, beta.y * diffuse.y, beta.z * diffuse.z,
              beta.x * specular.x, beta.y * specular.y, beta.z * specular.z,
              gloss, 1.0f};
          for (int k = 0; k < NUM_REC; ++k)
            P.pout[(2 + k) * np + lane] = rec[k];
        }
        const float cr = sqrtf(P.cr2);
        const PhotonSums s =
            photon_sweep_thread(P.ctab, P.ccb, P.n_cclusters, hp, cr, P.cr2,
                                1.0f / P.cr2, &w.pclusters, &w.photons);
        const float inv_area = 1.0f / ((float)(M_PI * 0.5) * P.cr2);
        const V3 irrad = V3{s.ir * inv_area, s.ig * inv_area, s.ib * inv_area};
        // gather_blinn: L = -normalize(dir), H = normalize(V + L),
        // I * cosNL * (diffuse + specular * cosNH^gloss), under the luma gate.
        const V3 l_dir = neg3(norm3(V3{s.dx, s.dy, s.dz}, 1e-30f));
        const V3 hh = norm3(add3(v, l_dir), 1e-30f);
        const float cos_nl = fmaxf(0.0f, dot3(n, l_dir));
        const float cos_nh = fmaxf(0.0f, dot3(n, hh));
        const float spec_w = pow_safe(cos_nh, gloss);
        if (luma3(irrad) > CLT) {
          radiance = V3{
              radiance.x + beta.x * (irrad.x * cos_nl *
                                     (diffuse.x + specular.x * spec_w)),
              radiance.y + beta.y * (irrad.y * cos_nl *
                                     (diffuse.y + specular.y * spec_w)),
              radiance.z + beta.z * (irrad.z * cos_nl *
                                     (diffuse.z + specular.z * spec_w))};
        }
        if (s.cnt > GATHER_K) P.pout[np + lane] = 1.0f;
      }
    }
    if (bounce == P.max_bounce) {
      alive = false;
      continue;
    }

    const V3 t_dir = V3{-x.x * sin_o - y.x * cos_o, -x.y * sin_o - y.y * cos_o,
                        -x.z * sin_o - y.z * cos_o};
    const V3 r_dir = V3{2.0f * n.x * cos_nv - v.x, 2.0f * n.y * cos_nv - v.y,
                        2.0f * n.z * cos_nv - v.z};
    V3 new_dir;
    if (!P.photonmap) {
      // Continuation (MtlBlinn_PathTracing.cpp:176-297).
      const bool go_spec = sel_spec && front;
      const bool go_diff = sel_diff && front;
      if (!(sel_refr || sel_refl || go_spec || go_diff)) {
        alive = false;
        continue;
      }
      const Key kh = fold_w(kb, P_LOBE_SAMPLE, w);
      const float u0 = draw_w(kh, 0, w), u1 = draw_w(kh, 1, w);
      const float ct = sqrtf(u0);
      const float st = sqrtf(fmaxf(0.0f, 1.0f - u0));
      const float phi = TWO_PI * u1;
      const V3 hemi = norm3(V3{st * cosf(phi), st * sinf(phi), ct}, 1e-30f);
      const V3 hemi_world = to_local_frame(y, hemi);
      V3 bxdf;
      float pdf;
      if (sel_refr) {
        const bool glossy = tgloss > 0.0f;
        new_dir = glossy ? neg3(hemi_world) : t_dir;
        bxdf = glossy ? scale3(samp_refr,
                               pow_safe(fmaxf(0.0f, dot3(v, t_dir)), tgloss))
                      : samp_refr;
        pdf = c_refr;
      } else if (sel_refl) {
        const bool glossy = rgloss > 0.0f;
        new_dir = glossy ? hemi_world : r_dir;
        bxdf = glossy ? scale3(samp_refl,
                               pow_safe(fmaxf(0.0f, dot3(v, r_dir)), rgloss))
                      : samp_refl;
        pdf = c_refl;
      } else if (go_spec) {
        const V3 h = norm3(add3(v, norm3(hemi_world, 1e-30f)), 1e-30f);
        new_dir = hemi_world;
        bxdf = scale3(specular, pow_safe(fmaxf(0.0f, dot3(n, h)), gloss));
        pdf = c_spec;
      } else {
        new_dir = hemi_world;
        bxdf = diffuse;
        pdf = c_diff;
      }
      const float inv_pdf = 1.0f / fmaxf(pdf, 1e-20f);
      beta = V3{beta.x * bxdf.x * inv_pdf, beta.y * bxdf.y * inv_pdf,
                beta.z * bxdf.z * inv_pdf};
    } else {
      // Continuation (MtlBlinn_PhotonMap::Sample*BxDF + ComputeSecondaryRay,
      // MtlBlinn_PhotonMap.cpp:152-254).
      const bool go_transmit = sel_refr;
      const bool go_reflect = sel_refl;
      const bool go_diffuse = sel_diff && !has_dh && front;
      if (!(go_reflect || go_transmit || go_diffuse)) {
        alive = false;
        continue;
      }
      const Key ks2 = fold_w(kb, P_LOBE_SAMPLE, w);
      V3 weight;
      if (go_transmit) {
        new_dir = (P.has_glossy && tgloss > 0.0f)
                      ? glossy_jitter(t_dir, y, tgloss, fold_w(ks2, 12, w),
                                      false, w)
                      : t_dir;
        weight = samp_refr;
      } else if (go_diffuse) {
        const Key kd2 = fold_w(ks2, 13, w);
        const float u0 = draw_w(kd2, 0, w), u1 = draw_w(kd2, 1, w);
        const float ct = sqrtf(u0);
        const float st = sqrtf(fmaxf(0.0f, 1.0f - u0));
        const float phi = TWO_PI * u1;
        new_dir = to_local_frame(n, V3{st * cosf(phi), st * sinf(phi), ct});
        const V3 h = norm3(add3(v, norm3(new_dir, 1e-30f)), 1e-30f);
        const float ws = pow_safe(fmaxf(0.0f, dot3(n, h)), gloss);
        weight = add3(diffuse, scale3(specular, ws));
      } else {
        new_dir = (P.has_glossy && rgloss > 0.0f)
                      ? glossy_jitter(r_dir, y, rgloss, fold_w(ks2, 11, w),
                                      true, w)
                      : r_dir;
        weight = samp_refl;
      }
      beta = mul3(beta, weight);
      has_dh = go_diffuse;
      pend = load3(mrow + MT_ABS);
    }
    p = hp;
    d = norm3(new_dir, 1e-30f);
  }

  if (lane >= P.n) return;
  P.r[lane] = radiance.x;
  P.g[lane] = radiance.y;
  P.b[lane] = radiance.z;
  P.t0[lane] = t0;
  if (P.work) {
    // The pooled samples' work, counted to this lane by the threads that
    // ran them.
    const int nb = blockDim.x, tid = threadIdx.x;
    int* row_w = P.work + 8 * lane;
    row_w[0] = w.tests + Q.work[tid];
    row_w[1] = w.ciphers + Q.work[nb + tid];
    row_w[2] = w.vertices;
    row_w[3] = w.tri_tests + Q.work[2 * nb + tid];
    row_w[4] = w.checkers;
    if (kPhoton) {
      row_w[5] = w.photons;
      row_w[6] = w.pclusters;
    }
    row_w[7] = w.tails;
  }
}

}  // namespace

// Uploads the 31 footprint offsets (host pointers) to constant memory.
extern "C" int qr_mega_set_tex_offsets(const float* xs, const float* ys) {
  int rc = (int)cudaMemcpyToSymbol(c_tex_xs, xs, sizeof(float) * TEX_OFFSETS);
  if (rc) return rc;
  return (int)cudaMemcpyToSymbol(c_tex_ys, ys, sizeof(float) * TEX_OFFSETS);
}

namespace {

template <bool kTex, bool kPhoton, bool kMesh>
int launch(const Params& P, size_t smem, void* stream) {
  using PM = WithMesh<Params, kMesh>;
  void (*const kernel)(const PM) = mega_kernel<kTex, kPhoton, kMesh>;
  if (smem > 48 * 1024) {
    int rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc) return rc;
  }
  QR_LAUNCH(kernel, (P.n + kThreads - 1) / kThreads, kThreads, smem, stream,
            PM{P});
  return (int)cudaGetLastError();
}

template <bool kTex, bool kPhoton>
int launch(const Params& P, size_t smem, void* stream) {
  return P.n_leaves > 0 ? launch<kTex, kPhoton, true>(P, smem, stream)
                        : launch<kTex, kPhoton, false>(P, smem, stream);
}

}  // namespace

// C entry point (bound with ctypes): launches on `stream`, returns
// cudaGetLastError(). n > 0 is the caller's job. tex_mask != 0 selects the
// textured kernel (K1b), whose material rows are mtl_cols wide; pout !=
// NULL the photon-gathering one (K1d, photonmap only), whose [19, n]
// outputs the caller has zeroed. work, if not NULL, is [n, 8].
// soft_lights: whether some light is soft; without one the block holds no
// pool and its lanes run apart.
extern "C" int qr_mega_render(
    const int* px, const int* py, const int* sid, int n, const float* prim,
    const int* kinds, const int* prim_mtl, int num_prims, const float* mtl,
    int num_mtls, int mtl_cols, int tex_mask, const float* light,
    const int* lkind, const int* lsoft, int num_lights, float light_norm,
    const float* cam, uint32_t key0, uint32_t key1, int width, int photonmap,
    int max_bounce, int shadow_spp, int shadow_spp_max, int has_dof,
    int has_glossy, const float* mrows, const float* mattr,
    const float* mtree, int n_leaves, int leaf_rows, float* r, float* g,
    float* b, float* t0, int* work,
    int soft_lights, const float* ctab, const float* ccb,
    int n_cclusters, float cr2, float* pout, void* stream) {
  if (tex_mask ? mtl_cols != MT_TEXBASE + TEX_STRIDE * NUM_SLOTS
               : mtl_cols != MTL_COLS)
    return (int)cudaErrorInvalidValue;
  if (pout && !(photonmap && ctab && ccb && n_cclusters > 0 && cr2 > 0.0f))
    return (int)cudaErrorInvalidValue;
  const int s_max = max(shadow_spp_max, shadow_spp);
  const int pool_w = soft_lights ? max(1, min(s_max, kPoolWindow)) : 0;
  Params P{px, py, sid, n, prim, kinds, prim_mtl, num_prims, mtl, num_mtls,
           mtl_cols, tex_mask, light, lkind, lsoft, num_lights, light_norm,
           cam, key0, key1, width, photonmap, max_bounce, shadow_spp,
           shadow_spp_max, has_dof, has_glossy,
           reinterpret_cast<const float4*>(mrows),
           reinterpret_cast<const float4*>(mattr), mtree, n_leaves,
           leaf_rows, r, g, b, t0, work, pool_w,
           reinterpret_cast<const float4*>(ctab), ccb, n_cclusters, cr2,
           pout};
  const size_t smem =
      table_bytes(num_prims, num_mtls, mtl_cols, num_lights) +
      sizeof(float) * pool_floats(kThreads, pool_w);
  if (pout)
    return tex_mask ? launch<true, true>(P, smem, stream)
                    : launch<false, true>(P, smem, stream);
  return tex_mask ? launch<true, false>(P, smem, stream)
                  : launch<false, false>(P, smem, stream);
}

namespace {

// K1c's two functions on given rays (qr_mega_mesh_probe).
struct ProbeParams {
  const float* p;
  const float* d;
  const float* t_a;    // [n] the analytic winner's t (row -1)
  const float* t_max;  // [n] the any hit's budget
  int n;
  const float4* mrows;
  const float4* mattr;
  const float* mtree;
  int n_leaves, leaf_rows;
  float* t;    // [n] the closest hit's t
  float* nrm;  // [n, 3] its normal (the mesh winner's; else 0, 0, 1)
  int* front;  // [n] its front flag
  int* mrow;   // [n] the mesh winner's material row, -1 where none
  int* occ;    // [n] the any hit
  int* work;   // optional [n, 2]: triangle tests, closest and any hit
};

__global__ void __launch_bounds__(kThreads)
    mesh_probe_kernel(const ProbeParams P) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P.n) return;
  const V3 p{P.p[3 * i], P.p[3 * i + 1], P.p[3 * i + 2]};
  const V3 d{P.d[3 * i], P.d[3 * i + 1], P.d[3 * i + 2]};
  Hit h;
  h.t = P.t_a[i];
  h.prim = 0;
  h.n = V3{0.0f, 0.0f, 1.0f};
  h.front = true;
  int mrow = -1;
  Work wc{}, wa{};
  mesh_closest(P, p, d, h, &mrow, wc);
  const bool occ = mesh_occluded(P, p, d, P.t_max[i], wa);
  P.t[i] = h.t;
  P.nrm[3 * i] = h.n.x;
  P.nrm[3 * i + 1] = h.n.y;
  P.nrm[3 * i + 2] = h.n.z;
  P.front[i] = h.front;
  P.mrow[i] = mrow;
  P.occ[i] = occ;
  if (P.work) {
    P.work[2 * i] = wc.tri_tests;
    P.work[2 * i + 1] = wa.tri_tests;
  }
}

}  // namespace

// C entry point (bound with ctypes; tests and measurements, no path calls
// it): K1c's mesh_closest and mesh_occluded, one thread a ray, on the
// megakernel's mesh tables, launched on `stream`; returns
// cudaGetLastError(). n > 0 and n_leaves > 0 are the caller's job.
extern "C" int qr_mega_mesh_probe(const float* p, const float* d,
                                  const float* t_a, const float* t_max,
                                  int n, const float* mrows,
                                  const float* mattr, const float* mtree,
                                  int n_leaves, int leaf_rows, float* t,
                                  float* nrm, int* front, int* mrow, int* occ,
                                  int* work, void* stream) {
  if (n_leaves < 1 || (n_leaves & (n_leaves - 1)) ||
      leaf_rows < QR_ROWS_A_STEP || leaf_rows % QR_ROWS_A_STEP)
    return (int)cudaErrorInvalidValue;
  const ProbeParams P{p, d, t_a, t_max, n,
                      reinterpret_cast<const float4*>(mrows),
                      reinterpret_cast<const float4*>(mattr), mtree, n_leaves,
                      leaf_rows, t, nrm, front, mrow, occ, work};
  QR_LAUNCH(mesh_probe_kernel, (n + kThreads - 1) / kThreads, kThreads, 0,
            stream, P);
  return (int)cudaGetLastError();
}
