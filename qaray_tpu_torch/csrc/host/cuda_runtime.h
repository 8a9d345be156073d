// Host stand-in for <cuda_runtime.h>: just enough declarations for g++ to
// compile the kernel sources (megakernel.cu, adjoint.cu, tiles.cu,
// photon.cu, analytic.cu, bvh.cu, mtl_gather.cu, threefry.cu) as C++ and
// run them on the CPU (ops/_build.load_host). The CPU tests use it to hold
// a source's arithmetic to the plain PyTorch version where there is no card
// and no nvcc. It says nothing about what nvcc accepts or how fast the
// kernel is.
//
// A launch runs its grid in host blocks of qr_host_set_block threads (1 by
// default), one block after another, all on the calling thread. A block of
// one thread runs as a plain call, and __syncthreads has nothing to wait
// for. A larger block runs each of its threads as a fiber (ucontext) with
// a stack of its own, and the dynamic shared memory shared among them:
// the fibers take turns in a fixed order, each running until it reaches a
// barrier (__syncthreads, __syncthreads_or, __syncthreads_count,
// __ballot_sync) or returns, so that code which hands work between a
// block's threads runs as it does on the card, with no OS thread to wake
// and no lock to contend for. A block of 32 is a warp: __ballot_sync
// gathers its threads' votes at the block's barrier. Not reentrant: the
// launch geometry lives in globals.
#pragma once
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <stdlib.h>
#include <ucontext.h>

#include <atomic>
#include <utility>
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
// A block of fibers: the launching thread's context, one context and
// stack for each card thread, and which of them have returned.
struct QrHostFibers {
  ucontext_t host;
  std::vector<ucontext_t> ctx;
  std::vector<char*> stacks;
  std::vector<char> done;
  unsigned current = 0;
};
static QrHostFibers* qr_host_bar = nullptr;
// A fiber's stack: kernels keep their per-thread arrays (walk stacks,
// sample pools) there.
enum { kQrHostStack = 1 << 20 };
// The accumulators of __syncthreads_or, __syncthreads_count and
// __ballot_sync: call k of a block uses slot k % 3, and thread 0 clears
// the slot of call k + 1 before it arrives at call k's barrier, when every
// thread has read that slot's last value (call k - 2).
static std::atomic<int> qr_host_sum[3];
static unsigned qr_host_sum_calls[1024];

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
// A fiber's barrier: hand the turn back to the block's scheduler, which
// resumes this fiber once every thread of the block has arrived.
inline void qr_host_arrive() {
  QrHostFibers* f = qr_host_bar;
  swapcontext(&f->ctx[f->current], &f->host);
}
inline void __syncthreads() {
  if (qr_host_bar) qr_host_arrive();
}
inline int __syncthreads_count(int pred) {
  if (!qr_host_bar) return pred != 0;
  const unsigned k = qr_host_sum_calls[threadIdx.x]++ % 3;
  if (threadIdx.x == 0) qr_host_sum[(k + 1) % 3].store(0);
  if (pred) qr_host_sum[k].fetch_add(1);
  qr_host_arrive();
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
  const unsigned k = qr_host_sum_calls[threadIdx.x]++ % 3;
  if (threadIdx.x == 0) qr_host_sum[(k + 1) % 3].store(0);
  if (pred) qr_host_sum[k].fetch_or(bit);
  qr_host_arrive();
  return (unsigned)qr_host_sum[k].load();
}
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
template <class T>
T __ldg(const T* p) {
  return *p;
}
inline unsigned __umulhi(unsigned a, unsigned b) {
  return (unsigned)(((uint64_t)a * b) >> 32);
}
inline float __uint_as_float(unsigned a) {
  float f;
  memcpy(&f, &a, 4);
  return f;
}
inline float __int_as_float(int a) {
  float f;
  memcpy(&f, &a, 4);
  return f;
}
inline int __float_as_int(float f) {
  int a;
  memcpy(&a, &f, 4);
  return a;
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

// The body a fiber runs: the launch's kernel and argument, and the
// fiber's card thread index (makecontext passes int arguments only).
static void (*qr_host_body)(const void*);
static const void* qr_host_arg;
static void qr_host_fiber(int t) {
  QrHostFibers* f = qr_host_bar;
  qr_host_body(qr_host_arg);
  f->done[t] = 1;
  swapcontext(&f->ctx[t], &f->host);
}
template <class K, class A>
static void qr_host_call(const void* arg) {
  (*static_cast<const std::pair<K, const A*>*>(arg)->first)(
      *static_cast<const std::pair<K, const A*>*>(arg)->second);
}

// Runs kernel(arg) over `blocks` blocks of `threads` card threads, as
// blocks of qr_host_block host threads, as row `row` of a grid of `rows`
// rows (blockIdx.y, gridDim.y). A block of fibers runs in rounds:
// each live fiber in turn, in thread order, until it arrives at a barrier
// or returns; a round ends with every live fiber at the same barrier.
template <class K, class A>
void qr_host_launch(K kernel, unsigned blocks, unsigned threads,
                    size_t smem, const A& arg, unsigned row = 0,
                    unsigned rows = 1) {
  if (smem > sizeof(float) * QR_HOST_SMEM_FLOATS ||
      qr_host_block > sizeof(qr_host_sum_calls) / sizeof(unsigned)) {
    qr_host_error = cudaErrorInvalidValue;
    return;
  }
  const unsigned nb = qr_host_block;
  const unsigned total = blocks * threads;
  blockDim.x = nb;
  gridDim.x = (total + nb - 1) / nb;
  gridDim.y = rows;
  threadIdx.y = threadIdx.z = blockIdx.z = 0;
  blockIdx.y = row;
  if (nb == 1) {
    for (unsigned b = 0; b < gridDim.x; ++b) {
      blockIdx.x = b;
      threadIdx.x = 0;
      kernel(arg);
    }
    return;
  }
  static QrHostFibers fibers;
  fibers.ctx.resize(nb);
  fibers.done.assign(nb, 0);
  while (fibers.stacks.size() < nb)
    fibers.stacks.push_back(static_cast<char*>(malloc(kQrHostStack)));
  const std::pair<K, const A*> call(kernel, &arg);
  qr_host_body = &qr_host_call<K, A>;
  qr_host_arg = &call;
  qr_host_bar = &fibers;
  for (unsigned b = 0; b < gridDim.x; ++b) {
    blockIdx.x = b;
    for (unsigned t = 0; t < nb; ++t) {
      getcontext(&fibers.ctx[t]);
      fibers.ctx[t].uc_stack.ss_sp = fibers.stacks[t];
      fibers.ctx[t].uc_stack.ss_size = kQrHostStack;
      fibers.ctx[t].uc_link = nullptr;
      makecontext(&fibers.ctx[t], (void (*)())qr_host_fiber, 1, (int)t);
      fibers.done[t] = 0;
      qr_host_sum_calls[t] = 0;
    }
    for (auto& slot : qr_host_sum) slot.store(0);
    for (unsigned live = nb; live > 0;) {
      live = 0;
      for (unsigned t = 0; t < nb; ++t) {
        if (fibers.done[t]) continue;
        fibers.current = t;
        threadIdx.x = t;
        swapcontext(&fibers.host, &fibers.ctx[t]);
        live += !fibers.done[t];
      }
    }
  }
  qr_host_bar = nullptr;
}

#define QR_LAUNCH(kernel, blocks, threads, smem, stream, arg) \
  qr_host_launch(kernel, (unsigned)(blocks), (unsigned)(threads), \
                 (size_t)(smem), arg)
// A grid of bx by by blocks: its rows one after another.
#define QR_LAUNCH_2D(kernel, bx, by, threads, smem, stream, arg)           \
  for (unsigned qr_row = 0; qr_row < (unsigned)(by); ++qr_row)            \
  qr_host_launch(kernel, (unsigned)(bx), (unsigned)(threads),             \
                 (size_t)(smem), arg, qr_row, (unsigned)(by))
