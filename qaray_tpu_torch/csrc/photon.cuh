// Photon gather sweep shared by the standalone gather K5 (photon.cu) and
// the megakernel's caustics gather K1d (megakernel.cu).
//
// The math of qaray_tpu/ops/pallas_photon.py::photon_sweep: for each query
// point q and each photon row of a clustered map (photon/cluster.py: cols
// 0-2 position, 3-5 power, 6-8 max_power * direction, Morton order, 128
// rows a cluster, padding rows at 1e30), in row order,
//     d2 = |q - pos|^2,  w = d2 < r2 ? 1 - d2 * inv_r2 : 0,
//     irr += w * power,  dir += w * wdir,  count += d2 < r2.
// These are the un-normalized sums: divided by pi/2 r^2 they are the exact
// EstimateIrradiance estimate whenever count <= GATHER_K (100). Products
// and sums keep the plain version's order and the libraries are built
// without FMA contraction, so each lane's sums round as
// ops/photon.photon_gather_plain's do.
//
// A cluster is skipped when its box lies farther than r from the queries'
// box on some axis: no photon of it could be in the radius, so the cull
// changes no sum. An inverted box (an empty map's cluster, or the box of
// no active query) fails every test.
#pragma once
#include <math.h>

#include "analytic.cuh"

#define QR_PHOTON_CLUSTER 128

struct PhotonSums {
  float ir, ig, ib, dx, dy, dz, cnt;
};

__device__ __forceinline__ PhotonSums photon_zero() {
  return PhotonSums{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
}

// May the cluster box cb (min xyz, max xyz) hold a photon within r of some
// query in the box [lo, hi]?
__device__ __forceinline__ bool photon_cluster_near(const float* cb, V3 lo,
                                                    V3 hi, float r) {
  return cb[0] <= cb[3] && cb[0] - r <= hi.x && cb[3] + r >= lo.x &&
         cb[1] - r <= hi.y && cb[4] + r >= lo.y && cb[2] - r <= hi.z &&
         cb[5] + r >= lo.z;
}

// One photon row (position, power, weighted direction) into q's sums.
__device__ __forceinline__ void photon_add(PhotonSums& s, V3 q, float r2,
                                           float inv_r2, const float* row) {
  const float ex = q.x - row[0], ey = q.y - row[1], ez = q.z - row[2];
  const float d2 = ex * ex + ey * ey + ez * ez;
  const bool inr = d2 < r2;
  const float w = inr ? 1.0f - d2 * inv_r2 : 0.0f;
  s.ir = s.ir + w * row[3];
  s.ig = s.ig + w * row[4];
  s.ib = s.ib + w * row[5];
  s.dx = s.dx + w * row[6];
  s.dy = s.dy + w * row[7];
  s.dz = s.dz + w * row[8];
  s.cnt = s.cnt + (inr ? 1.0f : 0.0f);
}

// One thread's sweep over a whole map for its own query q, culled against
// q alone (megakernel lanes are not spatially sorted, so a block-wide box
// would cull nothing). Rows come through the read-only cache. Counts the
// cluster tests and the photon rows swept into *clusters and *photons.
__device__ __forceinline__ PhotonSums photon_sweep_thread(
    const float4* tab, const float* cb, int n_clusters, V3 q, float r,
    float r2, float inv_r2, int* clusters, int* photons) {
  PhotonSums s = photon_zero();
  for (int c = 0; c < n_clusters; ++c) {
    float box[6];
    for (int k = 0; k < 6; ++k) box[k] = __ldg(cb + 8 * c + k);
    ++*clusters;
    if (!photon_cluster_near(box, q, q, r)) continue;
    *photons += QR_PHOTON_CLUSTER;
    for (int j = 0; j < QR_PHOTON_CLUSTER; ++j) {
      const int row = c * QR_PHOTON_CLUSTER + j;
      const float4 a = __ldg(tab + 4 * row);
      const float4 b = __ldg(tab + 4 * row + 1);
      const float4 e = __ldg(tab + 4 * row + 2);
      const float vals[9] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, e.x};
      photon_add(s, q, r2, inv_r2, vals);
    }
  }
  return s;
}
