// Dense triangle sweep (K3): every ray against every row of the [Fp, 16]
// coefficient table, folding the closest row and its runner-up.
//
// Replaces the Pallas TPU kernel qaray_tpu/ops/pallas_mesh.py
// ::_sweep_kernel (dispatched by pallas_sweep_closest). One thread per
// ray. What bounds it on the H100: operations. A test is about 40 float
// operations and a division; the table is read once per block of 256 rays,
// so bytes are small against Fp * 40 operations a ray. The design stages
// tiles of 256 rows in shared memory (one float4 load per thread and
// quarter-row), and every thread sweeps the tile against its own ray with
// the rows read as broadcasts, so the inner loop is arithmetic on
// registers. The fold is the Pallas kernel's: strict `<` in ascending row
// order, so ties go to the lower row, as in the plain version.
//
// any_hit: the same sweep seeded with the shadow budget, stopping a ray at
// its first hit and a block once all its rays have stopped
// (ops/trace.py's shadow test on the dense route).
#include <cuda_runtime.h>

#include "mesh.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    sweep_kernel(const float* __restrict__ p, const float* __restrict__ d,
                 const float* __restrict__ tcur,
                 const float4* __restrict__ rows, int fp, int n, int any_hit,
                 float* t_out, int* row_out, int* row2_out) {
  __shared__ float4 tile[QR_CLUSTER * 4];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = i < n;
  V3 rp{0.f, 0.f, 0.f}, rd{0.f, 0.f, 1.f};
  float t_in = 0.f;
  if (valid) {
    rp = V3{p[3 * i], p[3 * i + 1], p[3 * i + 2]};
    rd = V3{d[3 * i], d[3 * i + 1], d[3 * i + 2]};
    t_in = tcur[i];
  }
  float tb = t_in, t2 = QR_BIGFLOAT;
  int rb = -1, r2 = -1;
  bool done = !valid;
  for (int base = 0; base < fp; base += QR_CLUSTER) {
    if (any_hit) {
      if (__syncthreads_and(done)) break;
    } else {
      __syncthreads();
    }
    const int m = min(QR_CLUSTER, fp - base);
    for (int q = threadIdx.x; q < m * 4; q += kThreads)
      tile[q] = rows[4 * base + q];
    __syncthreads();
    if (done) continue;
    for (int j = 0; j < m; ++j) {
      float t, a, b, dn;
      if (!tri_hit(load_row(tile, j), rp, rd, t, a, b, dn)) continue;
      if (t < tb) {
        t2 = tb;
        r2 = rb;
        tb = t;
        rb = base + j;
        if (any_hit) {
          done = true;
          break;
        }
      } else if (t < t2) {
        t2 = t;
        r2 = base + j;
      }
    }
  }
  if (valid) {
    t_out[i] = tb;
    row_out[i] = tb < t_in ? rb : -1;
    row2_out[i] = t2 < QR_BIGFLOAT ? r2 : -1;
  }
}

}  // namespace

// C entry point (bound with ctypes): launches on `stream`, returns
// cudaGetLastError(). n > 0 and fp % 128 == 0 are the caller's job.
extern "C" int qr_mesh_sweep(const float* p, const float* d,
                             const float* tcur, const float* coeff16, int fp,
                             int n, int any_hit, float* t, int* row,
                             int* row2, void* stream) {
  sweep_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                 (cudaStream_t)stream>>>(
      p, d, tcur, reinterpret_cast<const float4*>(coeff16), fp, n, any_hit, t,
      row, row2);
  return (int)cudaGetLastError();
}
