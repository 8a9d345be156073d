// Triangle sweep predicate and cluster cull shared by the mesh kernels:
// the walks K3, K4a and K4b (tiles.cu) and the megakernel's mesh sweep K1c
// (megakernel.cu, adjoint.cu).
//
// The predicate is qaray_tpu/ops/pallas_mesh.py::_sweep_kernel's math
// (the linear-in-t form of the reference triangle test,
// objects/objects.cpp:212-248): one row of the [Fp, 16] table holds
// n (0-2), A (3-5), B (6-8), k (9), a0 (10), b0 (11), |n| (12). Products
// are summed left to right and the library is built without FMA
// contraction, so each operation rounds as the plain PyTorch version
// (ops/mesh_stream._chunk_test) rounds it.
#pragma once
#include <math.h>

#include "analytic.cuh"

#define QR_ROW_COLS 16
#define QR_CLUSTER 256

// A row of the coefficient table, read as four float4.
struct TriRow {
  float4 q0, q1, q2, q3;
};

__device__ __forceinline__ TriRow load_row(const float4* rows, int r) {
  return TriRow{rows[4 * r], rows[4 * r + 1], rows[4 * r + 2],
                rows[4 * r + 3]};
}

__device__ __forceinline__ TriRow load_row_ldg(const float4* rows, int r) {
  return TriRow{__ldg(rows + 4 * r), __ldg(rows + 4 * r + 1),
                __ldg(rows + 4 * r + 2), __ldg(rows + 4 * r + 3)};
}

// Sweep test of one ray against one row: returns whether it hits, with t
// and the barycentric weights a, b (of v0, v1) and dn = d.n (front face
// where dn <= 0).
__device__ __forceinline__ bool tri_hit(const TriRow& c, V3 p, V3 d,
                                        float& t, float& a, float& b,
                                        float& dn) {
  const float nx = c.q0.x, ny = c.q0.y, nz = c.q0.z;
  const float ax = c.q0.w, ay = c.q1.x, az = c.q1.y;
  const float bx = c.q1.z, by = c.q1.w, bz = c.q2.x;
  const float kk = c.q2.y, a0 = c.q2.z, b0 = c.q2.w, nl = c.q3.x;
  const float pn = p.x * nx + p.y * ny + p.z * nz;
  dn = d.x * nx + d.y * ny + d.z * nz;
  const float pa = p.x * ax + p.y * ay + p.z * az;
  const float da = d.x * ax + d.y * ay + d.z * az;
  const float pb = p.x * bx + p.y * by + p.z * bz;
  const float db = d.x * bx + d.y * by + d.z * bz;
  const float safe = fabsf(dn) < 1e-30f ? 1e-30f : dn;
  t = (kk - pn) / safe;
  const bool parallel = fabsf(dn) < 1e-7f * nl;
  a = pa + t * da + a0;
  b = pb + t * db + b0;
  const float cc = 1.0f - a - b;
  return !parallel && t > QR_BIAS && a >= 0.0f && b >= 0.0f && cc >= 0.0f;
}

// One ray's slab setup for the cluster cull: the origin, the reciprocal
// direction and the axes whose direction component is under 1e-7 (those
// never bound the slab, as in ops/mesh_tiles._packet_cull).
struct RaySlab {
  float o[3], r[3];
  bool mixed[3];
};

__device__ __forceinline__ RaySlab ray_slab(V3 p, V3 d) {
  RaySlab s;
  const float dd[3] = {d.x, d.y, d.z};
  s.o[0] = p.x;
  s.o[1] = p.y;
  s.o[2] = p.z;
  for (int k = 0; k < 3; ++k) {
    s.mixed[k] = dd[k] < 1e-7f && dd[k] > -1e-7f;
    s.r[k] = 1.0f / (fabsf(dd[k]) < 1e-7f ? 1e-7f : dd[k]);
  }
  return s;
}

// May the ray hit the box cb (min xyz, max xyz) at some BIAS < t < t_hi?
// The Pallas kernel bounds a whole block of rays by interval arithmetic;
// for one ray that interval is the plain slab test, whose rounding could
// drop a grazing hit on a box face. Both ends are therefore widened by a
// relative 1e-5 (the slab times carry a few ulp of error): the cull may
// over-accept, never drop a cluster that holds the winner. `lo` gets the
// widened entry distance, a lower bound on the t of any hit in the box.
__device__ __forceinline__ bool box_entry(const float* cb, const RaySlab& s,
                                          float t_hi, float& lo) {
  float entry = -QR_BIGFLOAT, exit_ = QR_BIGFLOAT;
  for (int k = 0; k < 3; ++k) {
    if (s.mixed[k]) continue;
    const float t1 = (cb[k] - s.o[k]) * s.r[k];
    const float t2 = (cb[3 + k] - s.o[k]) * s.r[k];
    entry = fmaxf(entry, fminf(t1, t2));
    exit_ = fminf(exit_, fmaxf(t1, t2));
  }
  const bool nonempty = cb[0] <= cb[3] && cb[1] <= cb[4] && cb[2] <= cb[5];
  lo = entry - (1e-5f * fabsf(entry) + 1e-6f);
  const float hi = exit_ + (1e-5f * fabsf(exit_) + 1e-6f);
  return nonempty && lo <= hi && hi > QR_BIAS && lo < t_hi;
}

__device__ __forceinline__ bool box_may_hit(const float* cb, const RaySlab& s,
                                            float t_hi) {
  float lo;
  return box_entry(cb, s, t_hi, lo);
}
