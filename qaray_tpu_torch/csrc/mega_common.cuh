// Device code shared by the path-trace megakernel (megakernel.cu: K1a-K1d)
// and the fused adjoint (adjoint.cu: K6): the scene tables' layout and
// their staging in shared memory, the per-lane work counters, the counted
// threefry draws, the Halton jitter, the local frame, the world-mesh hit
// (K1c), shadow rays and the lights' intensities with their soft-shadow
// draws, one soft-shadow sample at a time. The adjoint replays the
// megakernel's paths draw for draw, so both must run this very code.
//
// The functions that read the kernel's launch parameters are templates on
// its Params struct, which has to carry the tables stage_tables copies
// (prim, kinds, prim_mtl, mtl, light, lkind, lsoft, cam and their counts
// num_prims, num_mtls, num_lights), shadow_spp, shadow_spp_max and K1c's
// mrows, mattr, mtree, n_leaves and leaf_rows, and the compile-time flag
// kMesh (WithMesh).
#pragma once
#include <stdint.h>

#include "analytic.cuh"
#include "threefry.cuh"
#include "walk.cuh"

namespace {

// Material table columns (pallas_pathtrace._MT_*).
constexpr int MT_DIFF = 0, MT_SPEC = 3, MT_EMIT = 6, MT_REFL = 9,
              MT_REFR = 12, MT_GLOSS = 15, MT_RGLOSS = 16, MT_TGLOSS = 17,
              MT_IOR = 18, MT_ABS = 19, MTL_COLS = 22;
// Light table columns (_LT_*).
constexpr int LT_INT = 0, LT_POS = 3, LT_DIR = 6, LT_SIZE = 9, LT_INNER = 10,
              LT_OUTER = 11, LIGHT_COLS = 12;
// Camera vector layout (_CAM_*).
constexpr int CAM_POS = 0, CAM_A = 3, CAM_U = 6, CAM_V = 9, CAM_X = 12,
              CAM_Y = 15, CAM_DOF = 18, CAM_BG = 19, CAM_ENV = 22,
              CAM_COLS = 25;

constexpr int LIGHT_AMBIENT = 0, LIGHT_DIRECT = 1, LIGHT_SPOT = 3;
constexpr int P_LOBE_SELECT = 0, P_LOBE_SAMPLE = 1, P_DOF = 2, P_SHADOW = 3;
constexpr float TWO_PI = (float)(2.0 * M_PI);

struct Shared {
  float* prim;
  int* kinds;
  int* prim_mtl;
  float* mtl;
  float* light;
  int* lkind;
  int* lsoft;
  float* cam;
};

// Per-lane work counters; `tails` counts the soft-shadow estimates that
// went on past s_min samples.
struct Work {
  int tests, ciphers, vertices, tri_tests, checkers, photons, pclusters,
      tails;
};

// Stages the scene tables at `f` in shared memory (12 floats a primitive,
// mtl_cols a material, 12 a light, 25 for the camera, then the primitive
// kinds and material rows and the light kinds and soft flags) and waits
// for the block.
template <class PT>
__device__ __forceinline__ Shared stage_tables(const PT& P, int mtl_cols,
                                               float* f) {
  Shared S;
  S.prim = f;
  f += P.num_prims * QR_PRIM_COLS;
  S.mtl = f;
  f += P.num_mtls * mtl_cols;
  S.light = f;
  f += P.num_lights * LIGHT_COLS;
  S.cam = f;
  f += CAM_COLS;
  int* q = reinterpret_cast<int*>(f);
  S.kinds = q;
  q += P.num_prims;
  S.prim_mtl = q;
  q += P.num_prims;
  S.lkind = q;
  q += P.num_lights;
  S.lsoft = q;
  for (int i = threadIdx.x; i < P.num_prims * QR_PRIM_COLS; i += blockDim.x)
    S.prim[i] = P.prim[i];
  for (int i = threadIdx.x; i < P.num_mtls * mtl_cols; i += blockDim.x)
    S.mtl[i] = P.mtl[i];
  for (int i = threadIdx.x; i < P.num_lights * LIGHT_COLS; i += blockDim.x)
    S.light[i] = P.light[i];
  for (int i = threadIdx.x; i < CAM_COLS; i += blockDim.x) S.cam[i] = P.cam[i];
  for (int i = threadIdx.x; i < P.num_prims; i += blockDim.x) {
    S.kinds[i] = P.kinds[i];
    S.prim_mtl[i] = P.prim_mtl[i];
  }
  for (int i = threadIdx.x; i < P.num_lights; i += blockDim.x) {
    S.lkind[i] = P.lkind[i];
    S.lsoft[i] = P.lsoft[i];
  }
  __syncthreads();
  return S;
}

// Bytes of stage_tables' shared memory.
__host__ __device__ inline size_t table_bytes(int num_prims, int num_mtls,
                                              int mtl_cols, int num_lights) {
  return 4 * ((size_t)num_prims * (QR_PRIM_COLS + 2) +
              (size_t)num_mtls * mtl_cols +
              (size_t)num_lights * (LIGHT_COLS + 2) + CAM_COLS);
}

__device__ __forceinline__ float max3(V3 c) {
  return fmaxf(c.x, fmaxf(c.y, c.z));
}
__device__ __forceinline__ float pow_safe(float x, float e) {
  return powf(fmaxf(x, 1e-6f), e);
}

__device__ __forceinline__ Key fold_w(Key k, uint32_t d, Work& w) {
  ++w.ciphers;
  return fold2(k, d);
}
__device__ __forceinline__ float draw_w(Key k, uint32_t f, Work& w) {
  ++w.ciphers;
  return draw_at(k, f);
}

// Radical inverse with the JAX engine's digit count (10 for bases 11, 13).
__device__ __forceinline__ float halton(int i, int base) {
  float r = 0.0f;
  float f = (float)(1.0 / base);
  for (int k = 0; k < 10; ++k) {
    r = r + f * (float)(i % base);
    f = f / (float)base;
    i = i / base;
  }
  return r;
}

// core.vecmath.to_local_frame (math/math.cpp:37-46).
__device__ __forceinline__ V3 to_local_frame(V3 n, V3 s) {
  const bool use_a = fabsf(n.x) > fabsf(n.y);
  const V3 y = norm3(use_a ? V3{n.z, 0.0f, -n.x} : V3{0.0f, -n.z, n.y});
  const V3 x = norm3(cross3(y, n));
  const V3 u = norm3(s);
  return V3{u.x * x.x + u.y * y.x + u.z * n.x,
            u.x * x.y + u.y * y.y + u.z * n.y,
            u.x * x.z + u.y * y.z + u.z * n.z};
}

// K1c, the world-mesh hit: one thread walks its ray over the tree of the
// mesh's leaves (walk.cuh), P.leaf_rows consecutive rows of the
// Morton-ordered table a leaf, and tests a leaf's rows kMeshStep at a
// time. The function is the in-order sweep's over every row (the JAX
// package's _closest_hit mesh fold, `take = t < t_b`, and _shadow_occluded),
// whatever order the walk visits the leaves in.

// Rows a leaf's step tests together (a divisor of QR_ROWS_A_STEP): the
// megakernel holds its whole path's state beside them, and at 8 rows a
// step its registers spill further.
constexpr int kMeshStep = 4;

// A kernel's Params with the world mesh compiled in or out (kMesh): the
// functions here read PT::kMesh, so that an instantiation for scenes
// without a mesh holds none of the walk, whose registers would make the
// megakernel spill.
template <class Base, bool kMeshOn>
struct WithMesh : Base {
  static constexpr bool kMesh = kMeshOn;
};

// Node k's entry bound on the mesh tree, its box read through the
// read-only cache.
template <class PT>
__device__ __forceinline__ bool mesh_enter(const PT& P, const RaySlab& s,
                                           int k, float& e) {
  float box[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) box[j] = __ldg(P.mtree + 8 * k + j);
  return box_entry(box, s, INFINITY, e);
}

// Any hit on the world mesh with BIAS < t < t_max. The answer does not
// depend on the order of the rows, so the walk stops at its first occluder.
template <class PT>
__device__ __forceinline__ bool mesh_occluded(const PT& P, V3 p, V3 d,
                                              float t_max, Work& w) {
  const RaySlab s = ray_slab(p, d);
  bool occ = false;
  tree_walk<false>(
      P.n_leaves, t_max,
      [&](int k, float& e) { return mesh_enter(P, s, k, e); },
      [&](int leaf, float) {
        const int base = leaf * P.leaf_rows;
        for (int r = base; r < base + P.leaf_rows; r += kMeshStep) {
          float t[kMeshStep];
          bool hit[kMeshStep];
          test_rows<kMeshStep>(P.mrows, r, p, d, t, hit);
          w.tri_tests += kMeshStep;
#pragma unroll
          for (int k = 0; k < kMeshStep; ++k)
            occ = occ || (hit[k] && t[k] < t_max);
          if (occ) return true;
        }
        return false;
      });
  return occ;
}

// Closest world-mesh hit folded into h: of the analytic winner, counted as
// row -1, and every mesh row that hits, the first by (t, row). A mesh row
// so replaces the analytic winner only at a strictly smaller t, and of
// mesh rows at equal t the lower one wins, as the in-order sweep with
// `t < h.t` gives. The walk keeps nodes whose entry bound is at or below
// the best t, where a tie may still win on its row. The winner's t, its
// unnormalized smooth normal a*n0 + b*n1 + c*n2 and its front flag come
// from its own row, tested again (not counted); *mrow gets its material
// row.
template <class PT>
__device__ __forceinline__ void mesh_closest(const PT& P, V3 p, V3 d,
                                             Hit& h, int* mrow, Work& w) {
  const RaySlab s = ray_slab(p, d);
  float tb = h.t;
  int rb = -1;
  tree_walk<true>(
      P.n_leaves, tb,
      [&](int k, float& e) { return mesh_enter(P, s, k, e); },
      [&](int leaf, float) {
        const int base = leaf * P.leaf_rows;
        for (int r = base; r < base + P.leaf_rows; r += kMeshStep) {
          float t[kMeshStep];
          bool hit[kMeshStep];
          test_rows<kMeshStep>(P.mrows, r, p, d, t, hit);
          w.tri_tests += kMeshStep;
#pragma unroll
          for (int k = 0; k < kMeshStep; ++k) {
            if (hit[k] && (t[k] < tb || (t[k] == tb && r + k < rb))) {
              tb = t[k];
              rb = r + k;
            }
          }
        }
        return false;
      });
  if (rb < 0) return;
  float t, a, b, dn;
  tri_hit(load_row_ldg(P.mrows, rb), p, d, t, a, b, dn);
  const TriRow at = load_row_ldg(P.mattr, rb);
  const float cc = 1.0f - a - b;
  h.t = t;
  h.n = V3{a * at.q0.x + b * at.q0.w + cc * at.q1.z,
           a * at.q0.y + b * at.q1.x + cc * at.q1.w,
           a * at.q0.z + b * at.q1.y + cc * at.q2.x};
  h.front = dn <= 0.0f;
  *mrow = (int)at.q2.y;
}

template <class PT>
__device__ __forceinline__ bool shadow(const PT& P, const Shared& S, V3 p,
                                       V3 d, float t_max, Work& w) {
  const bool occ =
      occluded(S.prim, S.kinds, P.num_prims, p, d, t_max, &w.tests);
  if constexpr (PT::kMesh) return occ || mesh_occluded(P, p, d, t_max, w);
  return occ;
}

// UniformBall quirk point from attempts (r1, r2, r2): `pick` already chosen,
// radially clamped, scaled by `radius` (core/warps.uniform_ball_ref).
__device__ __forceinline__ V3 clamp_ball(V3 pick, float radius) {
  const float pn = sqrtf(dot3(pick, pick));
  const float scale = pn > 1.0f ? 1.0f / fmaxf(pn, 1e-12f) : 1.0f;
  return scale3(pick, scale * radius);
}

// One sample s of soft light lt's adaptive shadow estimate at p, with the
// estimate's key ks (lights/lights.cpp:50-74): the falloff of the sampled
// point, with `clear` set where its shadow ray is not occluded. Sample s
// draws flat elements 4s..4s+3 of the engine's [s_max, 2, 2] uniform
// block. The megakernel's block-pooled samples (megakernel.cu) and the
// per-lane loop of light_visibility (the adjoint's replay) both run it.
template <class PT>
__device__ __forceinline__ float soft_sample(const PT& P, const Shared& S,
                                             const float* lt, V3 p, Key ks,
                                             int s, Work& w, bool& clear) {
  const uint32_t f = 4u * (uint32_t)s;
  const V3 c0 = V3{draw_w(ks, f, w) * 2.0f - 1.0f,
                   draw_w(ks, f + 1, w) * 2.0f - 1.0f, 0.0f};
  V3 pick = V3{c0.x, c0.y, c0.y};
  if (!(sqrtf(dot3(pick, pick)) <= 1.0f)) {
    const float r1 = draw_w(ks, f + 2, w) * 2.0f - 1.0f;
    const float r2 = draw_w(ks, f + 3, w) * 2.0f - 1.0f;
    pick = V3{r1, r2, r2};
  }
  const V3 target = add3(load3(lt + LT_POS), clamp_ball(pick, lt[LT_SIZE]));
  const V3 vec = sub3(target, p);
  const float d2 = dot3(vec, vec);
  const float dist = sqrtf(fmaxf(d2, 1e-20f));
  clear = !shadow(P, S, p, scale3(vec, 1.0f / dist), dist, w);
  return fminf(1.0f, 1.0f / fmaxf(d2, 1e-20f));
}

// The in-loop falloff recurrence: the estimate after sample s.
__device__ __forceinline__ float soft_step(float in_shadow, bool clear,
                                           float fall, int s) {
  const float x = clear ? 1.0f : 0.0f;
  return in_shadow + (x - in_shadow) * fall / ((float)s + 1.0f);
}

// The soft light's key at a vertex of base key kb.
__device__ __forceinline__ Key soft_key(Key kb, int li, Work& w) {
  return fold_w(kb, (uint32_t)(P_SHADOW + 101 * li), w);
}

// Is light li soft (an adaptive soft-shadow estimate)?
__device__ __forceinline__ bool soft_light(const Shared& S, int li) {
  return S.lkind[li] != LIGHT_DIRECT && S.lkind[li] != LIGHT_AMBIENT &&
         S.lsoft[li];
}

// Visibility times falloff of light li at p, before a spot light's cone
// (pallas_pathtrace._illuminate; pallas_adjoint._light_factor's V without
// the cone; lights/lights.cpp:39-127): 0 or 1 for a direct light,
// vis * min(1, 1/d^2) for a hard point or spot light, the adaptive soft
// shadow estimate for a soft one.
template <class PT>
__device__ float light_visibility(const PT& P, const Shared& S, int li,
                                  V3 p, Key kb, Work& w) {
  const float* lt = S.light + li * LIGHT_COLS;
  if (S.lkind[li] == LIGHT_DIRECT) {
    const V3 dn = norm3(neg3(load3(lt + LT_DIR)));
    return shadow(P, S, p, dn, QR_BIGFLOAT, w) ? 0.0f : 1.0f;
  }
  if (!S.lsoft[li]) {
    const V3 vec = sub3(load3(lt + LT_POS), p);
    const float d2 = dot3(vec, vec);
    const float dist = sqrtf(fmaxf(d2, 1e-20f));
    const bool occ = shadow(P, S, p, scale3(vec, 1.0f / dist), dist, w);
    const float vis = occ ? 0.0f : 1.0f;
    const float fall = fminf(1.0f, 1.0f / fmaxf(d2, 1e-20f));
    return vis * fall;
  }
  // Adaptive 16 -> 64 soft shadows with the in-loop falloff recurrence.
  // Lanes whose estimate never went fractional in the first s_min samples
  // stop there.
  const int s_min = P.shadow_spp;
  const int s_max = max(P.shadow_spp_max, s_min);
  const Key ks = soft_key(kb, li, w);
  float in_shadow = 0.0f;
  bool frac = false;
  for (int s = 0; s < s_max; ++s) {
    if (s == s_min) {
      if (!frac) break;
      ++w.tails;
    }
    bool clear;
    const float fall = soft_sample(P, S, lt, p, ks, s, w, clear);
    const float upd = soft_step(in_shadow, clear, fall, s);
    in_shadow = upd;
    if (s < s_min) frac = frac || (upd > 0.0f && upd < 1.0f);
  }
  return in_shadow;
}

// SpotLight::GetAttenuation (lights/lights.cpp:128-144) of the light whose
// table row is `lt`, at p.
__device__ __forceinline__ float spot_attenuation(const float* lt, V3 p) {
  const V3 ldir = load3(lt + LT_DIR);
  const V3 to_p = norm3(sub3(p, load3(lt + LT_POS)), 1e-30f);
  const float cos_t = dot3(to_p, ldir);
  const float r =
      sqrtf(fmaxf(0.0f, 1.0f - cos_t * cos_t)) / fmaxf(cos_t, 1e-20f);
  const float inner = lt[LT_INNER], outer = lt[LT_OUTER];
  float ring = (outer - r) / fmaxf(outer - inner, 1e-20f);
  ring = ring * ring;
  float att = r < inner ? 1.0f : (r > outer ? 0.0f : ring);
  if (cos_t < 0.0f) att = 0.0f;
  return att;
}

}  // namespace
