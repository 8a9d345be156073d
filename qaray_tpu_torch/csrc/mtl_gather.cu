// Backward of the material gather (G1): for one row index a lane, mid [n]
// (already clamped to >= 0), and up to six cotangents sharing it (five
// [n, 3] colour slots and one [n] glossiness, any of them absent), the
// per-row sums
//
//     out_k[r] = sum over lanes b with mid[b] = r of g_k[b]
//
// into [rows, 3] x 5 and [rows]: what index_put_(accumulate=True) gives
// (autograd's backward of table[mid]), in another order of summation.
//
// Replaces no Pallas kernel. It stands where the JAX package leaves XLA's
// scatter-add under jax.grad of colors[mid] (qaray_tpu/integrators/
// common.py's gathers). PyTorch's backward for the gather sorts the
// indices and sums each run of equal indices (indexing_backward_kernel_*):
// with a scene's few materials that is a few runs of some 100,000 lanes
// each, and the kernel's parallelism is rows x columns, a few dozen
// threads for the whole card.
//
// What bounds it on the H100: bytes. A lane's index (8 B) and its 16
// cotangent floats (64 B) are read once: 72 B a lane, 34.6 MB or 10.3 us
// at 3.35e12 B/s for 480,000 lanes; the outputs are a few rows. The
// design reads each byte once and keeps every sum on the chip:
// - Pass 1 (mtl_gather_bwd_kernel). A block takes a contiguous range of
//   lanes (blockIdx.x) and a tile of rows (blockIdx.y). Its 256 threads
//   are 16 slices of 16 columns: thread (slice s, column c) reads column c
//   of lanes s, s + 16, s + 32, ... of the range, so a warp's loads cover
//   two neighbouring lanes' contiguous cotangents and one index, and the
//   block together walks its range 16 lanes at a time (the L1 cache holds
//   the lines the neighbouring warps share). Indices are loaded a batch
//   ahead of the cotangents, which are loaded only for rows in the tile.
//   A thread sums its lanes in order, holding the current row's sum in a
//   register while consecutive lanes share a row (image rows do), and
//   adds it to its own cell of the slice's [rows][16] partials in shared
//   memory when the row changes. A slice's partials are rows x 16 floats,
//   one column a thread: no two threads write one address, so the sums
//   need no atomics, and each has a fixed order. Partials a slice rather
//   than a warp or a block: a thread a column lets every thread add with
//   plain adds in its own lane order. Then the block folds its 16 slices
//   in slice order into one [tile rows, 16] partial of the block in
//   device memory.
// - Pass 2 (mtl_gather_bwd_fold_kernel). A block a row: thread (s, c)
//   sums the blocks' partials s, s + 16, ... of column c in order, and
//   the block folds its slices in order into the outputs.
// No float atomics anywhere: the same inputs give the same bits from
// launch to launch, eager or replayed in a CUDA graph.
//
// The table's shape sets the tiling, with no switch: a tile holds at most
// kTileRows rows (16 slices x 47 rows x 16 floats = 48,128 B, under the
// 48 KB a block has without opting in), and a table of more rows is tiled
// over gridDim.y, each tile's blocks summing only the lanes whose row falls
// in it (they all read the indices, the cotangents only of their rows).
// A scene's few materials take one tile; a mesh scene's thousands take
// several.
#include <cuda_runtime.h>
#include <stdint.h>

// Launch and shared memory through the macros csrc/host/cuda_runtime.h
// redefines for the CPU tests (ops/_build.load_host).
#ifndef QR_LAUNCH
#define QR_SHARED_FLOATS(name) extern __shared__ float name[]
#define QR_LAUNCH(kernel, blocks, threads, smem, stream, arg) \
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(arg)
#define QR_LAUNCH_2D(kernel, bx, by, threads, smem, stream, arg) \
  kernel<<<dim3(bx, by), threads, smem, (cudaStream_t)stream>>>(arg)
#endif

namespace {

constexpr int kTables = 6;    // five colour slots [n, 3], glossiness [n]
constexpr int kCols = 16;     // 5 x 3 + 1 floats a lane
constexpr int kSlices = 16;   // lane slices of a block
constexpr int kThreads = kSlices * kCols;
constexpr int kTileRows = 47;  // odd: see tile_stride
constexpr int kBatch = 8;     // lanes a thread loads ahead

struct BwdParams {
  const long long* mid;     // [n] rows, >= 0
  const float* g[kTables];  // cotangents; null where absent
  int n, rows;
  int chunk;                // lanes a block of pass 1
  float* part;              // [gridDim.x, rows, kCols]
};

struct FoldParams {
  const float* part;     // [blocks, rows, kCols]
  int blocks, rows;
  float* out[kTables];   // [rows, 3] x 5, [rows]; null where not wanted
};

// Column c's table and its place in that table's row.
__device__ __forceinline__ int col_table(int c) { return c < 15 ? c / 3 : 5; }
__device__ __forceinline__ int col_width(int c) { return c < 15 ? 3 : 1; }
__device__ __forceinline__ int col_offset(int c) { return c < 15 ? c % 3 : 0; }

// Rows between two slices' partials: odd, so that a warp's two slices
// adding to the same row reach the two halves of the 32 banks.
__device__ __forceinline__ int tile_stride(int rows) { return rows | 1; }

__global__ void __launch_bounds__(kThreads)
    mtl_gather_bwd_kernel(const BwdParams P) {
  QR_SHARED_FLOATS(acc);  // [kSlices][tile_stride][kCols]
  const int c = threadIdx.x % kCols, s = threadIdx.x / kCols;
  const int row0 = blockIdx.y * kTileRows;
  const int rows = min(kTileRows, P.rows - row0);
  const int stride = tile_stride(rows);
  float* mine = acc + s * stride * kCols + c;
  for (int r = 0; r < rows; ++r) mine[r * kCols] = 0.0f;
  const float* g = P.g[col_table(c)];
  if (g != nullptr) {
    g += col_offset(c);
    const int w = col_width(c);
    const int lo = blockIdx.x * P.chunk;
    const int hi = min(lo + P.chunk, P.n);
    int cur = -1;
    float run = 0.0f;
    for (int i0 = lo + s; i0 < hi; i0 += kBatch * kSlices) {
      int r[kBatch];
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kSlices;
        const long long m = i < hi ? __ldg(P.mid + i) - row0 : -1;
        r[u] = m >= 0 && m < rows ? (int)m : -1;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        v[u] = r[u] >= 0 ? __ldg(g + (size_t)(i0 + u * kSlices) * w) : 0.0f;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (r[u] < 0) continue;
        if (r[u] == cur) {
          run += v[u];
        } else {
          if (cur >= 0) mine[cur * kCols] += run;
          cur = r[u];
          run = v[u];
        }
      }
    }
    if (cur >= 0) mine[cur * kCols] += run;
  }
  __syncthreads();
  float* part = P.part + ((size_t)blockIdx.x * P.rows + row0) * kCols;
  for (int e = threadIdx.x; e < rows * kCols; e += kThreads) {
    const int r = e / kCols, cc = e % kCols;
    float sum = acc[r * kCols + cc];
    for (int q = 1; q < kSlices; ++q) sum += acc[(q * stride + r) * kCols + cc];
    part[e] = sum;
  }
}

__global__ void __launch_bounds__(kThreads)
    mtl_gather_bwd_fold_kernel(const FoldParams P) {
  QR_SHARED_FLOATS(red);  // [kSlices][kCols]
  const int c = threadIdx.x % kCols, s = threadIdx.x / kCols;
  const int row = blockIdx.x;
  const float* col = P.part + (size_t)row * kCols + c;
  const size_t step = (size_t)P.rows * kCols;
  float sum = 0.0f;
  for (int b0 = s; b0 < P.blocks; b0 += kBatch * kSlices) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int b = b0 + u * kSlices;
      v[u] = b < P.blocks ? __ldg(col + b * step) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) sum += v[u];
  }
  red[s * kCols + c] = sum;
  __syncthreads();
  if (s == 0) {
    float* out = P.out[col_table(c)];
    if (out != nullptr) {
      float total = red[c];
      for (int q = 1; q < kSlices; ++q) total += red[q * kCols + c];
      out[(size_t)row * col_width(c) + col_offset(c)] = total;
    }
  }
}

}  // namespace

// C entry point (bound with ctypes): both passes on `stream`, returns
// cudaGetLastError(). g0-g5: the cotangents [n, 3] x 5 and [n], contiguous
// float32, null where absent; out0-out5 likewise [rows, 3] x 5 and [rows],
// null where not wanted (a cotangent with no output is not read, an output
// with no cotangent gets zeros);
// part: [blocks, rows, 16] scratch, blocks * chunk >= n. Two launches on
// the same inputs give the same bits.
extern "C" int qr_mtl_gather_bwd(
    const long long* mid, int n, const float* g0, const float* g1,
    const float* g2, const float* g3, const float* g4, const float* g5,
    int rows, int blocks, int chunk, float* part, float* out0, float* out1,
    float* out2, float* out3, float* out4, float* out5, void* stream) {
  if (n < 0 || rows < 1 || blocks < 1 || chunk < 0 ||
      (long long)blocks * chunk < n)
    return (int)cudaErrorInvalidValue;
  float* out[kTables] = {out0, out1, out2, out3, out4, out5};
  const float* g[kTables] = {g0, g1, g2, g3, g4, g5};
  BwdParams P{mid, {}, n, rows, chunk, part};
  FoldParams F{part, blocks, rows, {}};
  for (int k = 0; k < kTables; ++k) {
    P.g[k] = out[k] != nullptr ? g[k] : nullptr;
    F.out[k] = out[k];
  }
  const int tiles = (rows + kTileRows - 1) / kTileRows;
  const int tile_rows = min(rows, kTileRows);
  const size_t smem =
      sizeof(float) * kSlices * (size_t)(tile_rows | 1) * kCols;
  QR_LAUNCH_2D(mtl_gather_bwd_kernel, blocks, tiles, kThreads, smem, stream,
               P);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  QR_LAUNCH(mtl_gather_bwd_fold_kernel, rows, kThreads,
            sizeof(float) * kSlices * kCols, stream, F);
  return (int)cudaGetLastError();
}
