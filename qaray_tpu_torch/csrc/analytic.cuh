// Analytic ray-primitive tests shared by the analytic kernels (analytic.cu)
// and the path-trace megakernel (megakernel.cu).
//
// Math of qaray_tpu/ops/pallas_analytic.py::_kernel / _kernel_full /
// _shadow_kernel and of pallas_pathtrace.py::_prim_t / _obj_ray
// (reference objects/objects.cpp:55-208): unit sphere and unit-square plane
// in object space, reached through the baked world->object affine.
// Expressions keep the Pallas kernels' operation order; the library is
// built without fast math and without FMA contraction, so each operation
// rounds as the plain PyTorch versions do.
#pragma once
#include <math.h>

#ifndef M_PI
#define M_PI 3.14159265358979323846
#endif

#define QR_BIGFLOAT 1.0e30f
#define QR_BIAS 0.005f
#define QR_PLANE_EPS 1e-7f
#define QR_KIND_SPHERE 0
#define QR_PRIM_COLS 12  // m_w2o row-major (9) + t_o2w (3)

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
  return V3{x, y, z};
}
__device__ __forceinline__ V3 add3(V3 a, V3 b) {
  return V3{a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 sub3(V3 a, V3 b) {
  return V3{a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 mul3(V3 a, V3 b) {
  return V3{a.x * b.x, a.y * b.y, a.z * b.z};
}
__device__ __forceinline__ V3 scale3(V3 a, float s) {
  return V3{a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ V3 neg3(V3 a) { return V3{-a.x, -a.y, -a.z}; }
__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}
// a / |a|; eps > 0 clamps the squared norm from below (normalize(a, eps)).
__device__ __forceinline__ V3 norm3(V3 a, float eps = 0.0f) {
  float n2 = dot3(a, a);
  if (eps > 0.0f) n2 = fmaxf(n2, eps);
  return scale3(a, 1.0f / sqrtf(n2));
}
__device__ __forceinline__ V3 load3(const float* p) {
  return V3{p[0], p[1], p[2]};
}

// World ray -> object space of primitive row `pr` (QR_PRIM_COLS floats).
__device__ __forceinline__ void obj_ray(const float* pr, V3 p, V3 d, V3& po,
                                        V3& dobj) {
  const float rx = p.x - pr[9], ry = p.y - pr[10], rz = p.z - pr[11];
  po = V3{pr[0] * rx + pr[1] * ry + pr[2] * rz,
          pr[3] * rx + pr[4] * ry + pr[5] * rz,
          pr[6] * rx + pr[7] * ry + pr[8] * rz};
  dobj = V3{pr[0] * d.x + pr[1] * d.y + pr[2] * d.z,
            pr[3] * d.x + pr[4] * d.y + pr[5] * d.z,
            pr[6] * d.x + pr[7] * d.y + pr[8] * d.z};
}

// Hit distance vs the unit sphere / unit-square plane, QR_BIGFLOAT on miss.
__device__ __forceinline__ float prim_t(int kind, V3 po, V3 dobj) {
  if (kind == QR_KIND_SPHERE) {
    const float a = dot3(dobj, dobj);
    const float b = 2.0f * dot3(po, dobj);
    const float c = dot3(po, po) - 1.0f;
    const float delta = b * b - 4.0f * a * c;
    const float sq = sqrtf(fmaxf(delta, 0.0f));
    const float rcp2a = 0.5f / a;
    const float t1 = (-b - sq) * rcp2a;
    const float t2 = (-b + sq) * rcp2a;
    const float th = t1 > QR_BIAS ? t1 : (t2 > QR_BIAS ? t2 : QR_BIGFLOAT);
    return delta >= 0.0f ? th : QR_BIGFLOAT;
  }
  const float safe = fabsf(dobj.z) < QR_PLANE_EPS ? INFINITY : dobj.z;
  const float th = -po.z / safe;
  const float hx = po.x + th * dobj.x;
  const float hy = po.y + th * dobj.y;
  const bool ok = fabsf(hx) <= 1.0f && fabsf(hy) <= 1.0f && th > QR_BIAS;
  return ok ? th : QR_BIGFLOAT;
}

// Closest hit plus the winner's attributes (pallas_analytic._kernel_full).
struct Hit {
  float t;    // QR_BIGFLOAT on miss
  int prim;   // 0 on miss
  V3 n;       // world normal, unit; (0,0,1) on miss
  bool front; // true on miss
  float u, v; // texture coordinates (want_uv only)
};

template <bool kWantUv>
__device__ __forceinline__ Hit closest_hit(const float* prims,
                                           const int* kinds, int num_prims,
                                           V3 p, V3 d) {
  Hit h{QR_BIGFLOAT, 0, V3{0.0f, 0.0f, 1.0f}, true, 0.0f, 0.0f};
  for (int k = 0; k < num_prims; ++k) {
    const float* pr = prims + k * QR_PRIM_COLS;
    V3 po, dobj;
    obj_ray(pr, p, d, po, dobj);
    const int kind = kinds[k];
    const float th = prim_t(kind, po, dobj);
    if (!(th < h.t)) continue;
    // Attributes of this prim at its hit (evaluated only for the new
    // winner: a loser's attributes are never read).
    const V3 hp = add3(po, scale3(dobj, th));
    V3 no = V3{0.0f, 0.0f, 1.0f};
    if (kind == QR_KIND_SPHERE) no = norm3(hp, 1e-30f);
    if (kWantUv) {
      if (kind == QR_KIND_SPHERE) {
        // Sphere_TexCoord, in ops/intersect.analytic_hit_attrs' order.
        h.u = 0.5f - atan2f(hp.x, hp.y) / (float)(2.0 * M_PI);
        h.v = 0.5f + asinf(fminf(fmaxf(no.z, -1.0f), 1.0f)) / (float)M_PI;
      } else {
        h.u = (hp.x + 1.0f) * 0.5f;
        h.v = (hp.y + 1.0f) * 0.5f;
      }
    }
    // World normal: normalize(M_w2o^T n_obj) (core/transform.cpp:49-56).
    const V3 nw = V3{pr[0] * no.x + pr[3] * no.y + pr[6] * no.z,
                     pr[1] * no.x + pr[4] * no.y + pr[7] * no.z,
                     pr[2] * no.x + pr[5] * no.y + pr[8] * no.z};
    h.t = th;
    h.prim = k;
    h.n = norm3(nw, 1e-30f);
    h.front = dot3(no, dobj) <= 0.0f;
  }
  return h;
}

// K2a and K2b (analytic.cu): the primitive loop keeps only (t, prim), and
// the winner's attributes are evaluated once after it. (closest_hit, the
// megakernel's and the adjoint's, evaluates them in its loop for each new
// winner; their generated code is left alone.)

// Row k of a [P, 12] table staged as rows of three float4 (48 bytes a row,
// so every row is 16-byte aligned).
__device__ __forceinline__ void table_row(const float4* rows, int k,
                                          float pr[QR_PRIM_COLS]) {
  const float4 a = rows[3 * k], b = rows[3 * k + 1], c = rows[3 * k + 2];
  pr[0] = a.x, pr[1] = a.y, pr[2] = a.z, pr[3] = a.w;
  pr[4] = b.x, pr[5] = b.y, pr[6] = b.z, pr[7] = b.w;
  pr[8] = c.x, pr[9] = c.y, pr[10] = c.z, pr[11] = c.w;
}

// Closest (t, prim) over such a table, each row read in three 16-byte
// loads; ties keep the first index and a miss reports prim 0 (jnp.argmin
// semantics).
__device__ __forceinline__ float closest_rows(const float4* rows,
                                              const int* kinds, int num_prims,
                                              V3 p, V3 d, int& idx) {
  float t_best = QR_BIGFLOAT;
  idx = 0;
  for (int k = 0; k < num_prims; ++k) {
    float pr[QR_PRIM_COLS];
    table_row(rows, k, pr);
    V3 po, dobj;
    obj_ray(pr, p, d, po, dobj);
    const float th = prim_t(kinds[k], po, dobj);
    if (th < t_best) {
      t_best = th;
      idx = k;
    }
  }
  return t_best;
}

// The Hit of row k (table_row) at its distance th: closest_hit's attribute
// block in its order of operations, so that it gives closest_hit's bits
// (obj_ray on the same row and ray gives the sweep's po and dobj). The
// block is written out here and in closest_hit, not shared: as a function
// of their own (by reference, by value, or returning the Hit) it changed
// the adjoint's generated code, one register fewer and other SASS, and
// closest_hit's callers keep theirs (tools/parity_dump.py sass).
template <bool kWantUv>
__device__ __forceinline__ Hit winner_hit(const float4* rows,
                                          const int* kinds, int k, V3 p,
                                          V3 d, float th) {
  float pr[QR_PRIM_COLS];
  table_row(rows, k, pr);
  V3 po, dobj;
  obj_ray(pr, p, d, po, dobj);
  const int kind = kinds[k];
  Hit h{th, k, V3{0.0f, 0.0f, 1.0f}, true, 0.0f, 0.0f};
  const V3 hp = add3(po, scale3(dobj, th));
  V3 no = V3{0.0f, 0.0f, 1.0f};
  if (kind == QR_KIND_SPHERE) no = norm3(hp, 1e-30f);
  if (kWantUv) {
    if (kind == QR_KIND_SPHERE) {
      h.u = 0.5f - atan2f(hp.x, hp.y) / (float)(2.0 * M_PI);
      h.v = 0.5f + asinf(fminf(fmaxf(no.z, -1.0f), 1.0f)) / (float)M_PI;
    } else {
      h.u = (hp.x + 1.0f) * 0.5f;
      h.v = (hp.y + 1.0f) * 0.5f;
    }
  }
  const V3 nw = V3{pr[0] * no.x + pr[3] * no.y + pr[6] * no.z,
                   pr[1] * no.x + pr[4] * no.y + pr[7] * no.z,
                   pr[2] * no.x + pr[5] * no.y + pr[8] * no.z};
  h.n = norm3(nw, 1e-30f);
  h.front = dot3(no, dobj) <= 0.0f;
  return h;
}

// Any hit with QR_BIAS < t < t_max over all primitives (GenLight::Shadow,
// both sides count). Stops at the first occluder; *tests counts the
// primitive tests made.
__device__ __forceinline__ bool occluded(const float* prims, const int* kinds,
                                         int num_prims, V3 p, V3 d,
                                         float t_max, int* tests) {
  for (int k = 0; k < num_prims; ++k) {
    V3 po, dobj;
    obj_ray(prims + k * QR_PRIM_COLS, p, d, po, dobj);
    const float th = prim_t(kinds[k], po, dobj);
    if (th < t_max) {
      *tests += k + 1;
      return true;
    }
  }
  *tests += num_prims;
  return false;
}
