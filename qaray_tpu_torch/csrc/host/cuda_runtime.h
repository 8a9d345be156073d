// Host stand-in for <cuda_runtime.h>: just enough declarations for g++ to
// compile the kernel sources (megakernel.cu, adjoint.cu, tiles.cu,
// photon.cu, analytic.cu) as C++ and run them on the CPU
// (ops/_build.load_host). The CPU tests use it to hold a source's
// arithmetic to the plain PyTorch version where there is no card and no
// nvcc. It says nothing about what nvcc accepts or how fast the kernel is.
//
// A launch runs its grid in host blocks of qr_host_set_block threads (1 by
// default), one block after another. A block of one thread runs on the
// calling thread, and __syncthreads has nothing to wait for. A larger
// block runs each of its threads on a std::thread of its own, with a
// barrier (QrHostBarrier) for __syncthreads, __syncthreads_or and
// __syncthreads_count and the dynamic shared memory shared among them, so
// that code which hands work between a block's threads runs as it does on
// the card. A block of 32 is a warp: __ballot_sync gathers its threads'
// votes at the block's barrier. Not reentrant: the launch geometry lives
// in globals.
#pragma once
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <atomic>
#include <mutex>
#include <thread>
#include <vector>

#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __constant__ static
#define __launch_bounds__(...)

struct float4 {
  float x, y, z, w;
};
struct float2 {
  float x, y;
};
struct dim3 {
  unsigned x, y, z;
};
static thread_local dim3 threadIdx, blockIdx;
static dim3 blockDim, gridDim;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
static int qr_host_error = cudaSuccess;
static unsigned qr_host_block = 1;
// A block's barrier: the last of its threads to arrive opens the next
// phase; the others yield a while, then sleep until it does (a host block
// of 32 threads that ballots as a warp passes a barrier every few
// operations, which a sleep and a wake-up each time would slow tenfold).
struct QrHostBarrier {
  explicit QrHostBarrier(int n) : expected(n) {}
  void arrive(bool drop) {
    std::unique_lock<std::mutex> lk(m);
    const int ph = phase.load();
    if (drop)
      --expected;
    else
      ++arrived;
    if (arrived == expected) {
      arrived = 0;
      phase.store(ph + 1);
      phase.notify_all();
      return;
    }
    lk.unlock();
    if (drop) return;
    for (int k = 0; k < 64 && phase.load() == ph; ++k)
      std::this_thread::yield();
    while (phase.load() == ph) phase.wait(ph);
  }
  void arrive_and_wait() { arrive(false); }
  void arrive_and_drop() { arrive(true); }
  std::mutex m;
  int expected, arrived = 0;
  std::atomic<int> phase{0};
};
static QrHostBarrier* qr_host_bar = nullptr;
// The accumulators of __syncthreads_or, __syncthreads_count and
// __ballot_sync: call k of a block uses slot k % 3, and thread 0 clears
// the slot of call k + 1 before it arrives at call k's barrier, when every
// thread has read that slot's last value (call k - 2).
static std::atomic<int> qr_host_sum[3];
static thread_local unsigned qr_host_sum_calls = 0;

// Threads a host block (tests only).
extern "C" int qr_host_set_block(int threads) {
  if (threads < 1) return cudaErrorInvalidValue;
  qr_host_block = (unsigned)threads;
  return cudaSuccess;
}

// The host is one device of one SM.
enum { cudaDevAttrMultiProcessorCount = 16 };
inline int cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline int cudaDeviceGetAttribute(int* value, int attr, int) {
  if (attr != cudaDevAttrMultiProcessorCount) return cudaErrorInvalidValue;
  *value = 1;
  return cudaSuccess;
}

template <class T>
int cudaFuncSetAttribute(T, int, int) {
  return cudaSuccess;
}
inline int cudaGetLastError() {
  const int e = qr_host_error;
  qr_host_error = cudaSuccess;
  return e;
}
template <class T>
int cudaMemcpyToSymbol(T& dst, const void* src, size_t n) {
  memcpy(&dst, src, n);
  return cudaSuccess;
}
inline void __syncthreads() {
  if (qr_host_bar) qr_host_bar->arrive_and_wait();
}
inline int __syncthreads_count(int pred) {
  if (!qr_host_bar) return pred != 0;
  const unsigned k = qr_host_sum_calls++ % 3;
  if (threadIdx.x == 0) qr_host_sum[(k + 1) % 3].store(0);
  if (pred) qr_host_sum[k].fetch_add(1);
  qr_host_bar->arrive_and_wait();
  return qr_host_sum[k].load();
}
inline int __syncthreads_or(int pred) {
  return __syncthreads_count(pred) > 0;
}
// A warp's vote: bit threadIdx.x % 32 set where pred holds, over the host
// block (which must be the warp, 32 threads, for the card's answer).
inline unsigned __ballot_sync(unsigned, int pred) {
  const int bit = (int)(1u << (threadIdx.x % 32));
  if (!qr_host_bar) return pred ? (unsigned)bit : 0u;
  const unsigned k = qr_host_sum_calls++ % 3;
  if (threadIdx.x == 0) qr_host_sum[(k + 1) % 3].store(0);
  if (pred) qr_host_sum[k].fetch_or(bit);
  qr_host_bar->arrive_and_wait();
  return (unsigned)qr_host_sum[k].load();
}
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
template <class T>
T __ldg(const T* p) {
  return *p;
}
inline float __uint_as_float(unsigned a) {
  float f;
  memcpy(&f, &a, 4);
  return f;
}
inline unsigned __float_as_uint(float f) {
  unsigned a;
  memcpy(&a, &f, 4);
  return a;
}
inline float atomicAdd(float* a, float v) {
  std::atomic_ref<float> r(*a);
  float old = r.load();
  while (!r.compare_exchange_weak(old, old + v)) {
  }
  return old;
}
inline int atomicAdd(int* a, int v) {
  return std::atomic_ref<int>(*a).fetch_add(v);
}
inline int max(int a, int b) { return a > b ? a : b; }
inline int min(int a, int b) { return a < b ? a : b; }

// A block's dynamic shared memory: the card's 227 KB.
#define QR_HOST_SMEM_FLOATS (227 * 256)
#define QR_SHARED_FLOATS(name) alignas(16) static float name[QR_HOST_SMEM_FLOATS]

// Runs kernel(arg) over `blocks` blocks of `threads` card threads, as
// blocks of qr_host_block host threads.
template <class K, class A>
void qr_host_launch(K kernel, unsigned blocks, unsigned threads,
                    size_t smem, const A& arg) {
  if (smem > sizeof(float) * QR_HOST_SMEM_FLOATS) {
    qr_host_error = cudaErrorInvalidValue;
    return;
  }
  const unsigned nb = qr_host_block;
  const unsigned total = blocks * threads;
  blockDim.x = nb;
  gridDim.x = (total + nb - 1) / nb;
  for (unsigned b = 0; b < (total + nb - 1) / nb; ++b) {
    if (nb == 1) {
      blockIdx.x = b;
      threadIdx.x = 0;
      kernel(arg);
      continue;
    }
    QrHostBarrier bar((int)nb);
    qr_host_bar = &bar;
    for (auto& slot : qr_host_sum) slot.store(0);
    std::vector<std::thread> team;
    for (unsigned t = 0; t < nb; ++t)
      team.emplace_back([&, t] {
        blockIdx.x = b;
        threadIdx.x = t;
        qr_host_sum_calls = 0;
        kernel(arg);
        bar.arrive_and_drop();
      });
    for (auto& th : team) th.join();
    qr_host_bar = nullptr;
  }
}

#define QR_LAUNCH(kernel, blocks, threads, smem, stream, arg) \
  qr_host_launch(kernel, (unsigned)(blocks), (unsigned)(threads), \
                 (size_t)(smem), arg)
