// Device code shared by the path-trace megakernel (megakernel.cu: K1a-K1d)
// and the fused adjoint (adjoint.cu: K6): the scene tables' layout and
// their staging in shared memory, the per-lane work counters, the counted
// threefry draws, the Halton jitter, the local frame, the world-mesh sweep
// (K1c), shadow rays and the lights' intensities with their soft-shadow
// draws. The adjoint replays the megakernel's paths draw for draw, so both
// must run this very code.
//
// The functions that read the kernel's launch parameters are templates on
// its Params struct, which has to carry the tables stage_tables copies
// (prim, kinds, prim_mtl, mtl, light, lkind, lsoft, cam and their counts
// num_prims, num_mtls, num_lights), shadow_spp, shadow_spp_max and K1c's
// mrows, mattr, mcb and n_clusters.
#pragma once
#include <stdint.h>

#include "analytic.cuh"
#include "mesh.cuh"
#include "threefry.cuh"

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

struct Work {
  int tests, ciphers, vertices, tri_tests, checkers, photons, pclusters;
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
inline size_t table_bytes(int num_prims, int num_mtls, int mtl_cols,
                          int num_lights) {
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

// Any hit on the world mesh with BIAS < t < t_max (K1c).
template <class PT>
__device__ bool mesh_occluded(const PT& P, V3 p, V3 d, float t_max,
                              Work& w) {
  const RaySlab s = ray_slab(p, d);
  for (int c = 0; c < P.n_clusters; ++c) {
    if (!box_may_hit(P.mcb + 8 * c, s, t_max)) continue;
    for (int j = 0; j < QR_CLUSTER; ++j) {
      float t, a, b, dn;
      ++w.tri_tests;
      if (tri_hit(load_row_ldg(P.mrows, c * QR_CLUSTER + j), p, d, t, a, b,
                  dn) &&
          t < t_max)
        return true;
    }
  }
  return false;
}

// Closest world-mesh hit below h.t folded into h (K1c): t, the unnormalized
// smooth normal, the front flag; *mrow gets the winner's material row.
template <class PT>
__device__ void mesh_closest(const PT& P, V3 p, V3 d, Hit& h, int* mrow,
                             Work& w) {
  const RaySlab s = ray_slab(p, d);
  for (int c = 0; c < P.n_clusters; ++c) {
    if (!box_may_hit(P.mcb + 8 * c, s, h.t)) continue;
    for (int j = 0; j < QR_CLUSTER; ++j) {
      const int row = c * QR_CLUSTER + j;
      float t, a, b, dn;
      ++w.tri_tests;
      if (!tri_hit(load_row_ldg(P.mrows, row), p, d, t, a, b, dn) ||
          !(t < h.t))
        continue;
      const TriRow at = load_row_ldg(P.mattr, row);
      const float cc = 1.0f - a - b;
      h.t = t;
      h.n = V3{a * at.q0.x + b * at.q0.w + cc * at.q1.z,
               a * at.q0.y + b * at.q1.x + cc * at.q1.w,
               a * at.q0.z + b * at.q1.y + cc * at.q2.x};
      h.front = dn <= 0.0f;
      *mrow = (int)at.q2.y;
    }
  }
}

template <class PT>
__device__ __forceinline__ bool shadow(const PT& P, const Shared& S, V3 p,
                                       V3 d, float t_max, Work& w) {
  return occluded(S.prim, S.kinds, P.num_prims, p, d, t_max, &w.tests) ||
         (P.n_clusters > 0 && mesh_occluded(P, p, d, t_max, w));
}

// UniformBall quirk point from attempts (r1, r2, r2): `pick` already chosen,
// radially clamped, scaled by `radius` (core/warps.uniform_ball_ref).
__device__ __forceinline__ V3 clamp_ball(V3 pick, float radius) {
  const float pn = sqrtf(dot3(pick, pick));
  const float scale = pn > 1.0f ? 1.0f / fmaxf(pn, 1e-12f) : 1.0f;
  return scale3(pick, scale * radius);
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
  const V3 pos = load3(lt + LT_POS);
  if (!S.lsoft[li]) {
    const V3 vec = sub3(pos, p);
    const float d2 = dot3(vec, vec);
    const float dist = sqrtf(fmaxf(d2, 1e-20f));
    const bool occ = shadow(P, S, p, scale3(vec, 1.0f / dist), dist, w);
    const float vis = occ ? 0.0f : 1.0f;
    const float fall = fminf(1.0f, 1.0f / fmaxf(d2, 1e-20f));
    return vis * fall;
  }
  // Adaptive 16 -> 64 soft shadows with the in-loop falloff recurrence
  // (lights/lights.cpp:50-74). Sample s draws flat elements 4s..4s+3 of
  // the engine's [s_max, 2, 2] uniform block. Lanes whose estimate never
  // went fractional in the first s_min samples stop there.
  const int s_min = P.shadow_spp;
  const int s_max = max(P.shadow_spp_max, s_min);
  const float size = lt[LT_SIZE];
  const Key ks = fold_w(kb, (uint32_t)(P_SHADOW + 101 * li), w);
  float in_shadow = 0.0f;
  bool frac = false;
  for (int s = 0; s < s_max; ++s) {
    if (s == s_min && !frac) break;
    const uint32_t f = 4u * (uint32_t)s;
    const V3 c0 = V3{draw_w(ks, f, w) * 2.0f - 1.0f,
                     draw_w(ks, f + 1, w) * 2.0f - 1.0f, 0.0f};
    V3 pick = V3{c0.x, c0.y, c0.y};
    if (!(sqrtf(dot3(pick, pick)) <= 1.0f)) {
      const float r1 = draw_w(ks, f + 2, w) * 2.0f - 1.0f;
      const float r2 = draw_w(ks, f + 3, w) * 2.0f - 1.0f;
      pick = V3{r1, r2, r2};
    }
    const V3 target = add3(pos, clamp_ball(pick, size));
    const V3 vec = sub3(target, p);
    const float d2 = dot3(vec, vec);
    const float dist = sqrtf(fmaxf(d2, 1e-20f));
    const bool occ = shadow(P, S, p, scale3(vec, 1.0f / dist), dist, w);
    const float x = occ ? 0.0f : 1.0f;
    const float fall = fminf(1.0f, 1.0f / fmaxf(d2, 1e-20f));
    const float upd = in_shadow + (x - in_shadow) * fall / ((float)s + 1.0f);
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

// Per-lane RGB intensity of light li including shadowing
// (pallas_pathtrace._illuminate; lights/lights.cpp:39-144).
template <class PT>
__device__ V3 illuminate(const PT& P, const Shared& S, int li, V3 p, Key kb,
                         Work& w) {
  const float* lt = S.light + li * LIGHT_COLS;
  V3 out = scale3(load3(lt + LT_INT), light_visibility(P, S, li, p, kb, w));
  if (S.lkind[li] == LIGHT_SPOT) out = scale3(out, spot_attenuation(lt, p));
  return out;
}

}  // namespace
