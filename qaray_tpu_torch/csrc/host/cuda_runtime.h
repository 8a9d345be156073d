// Host stand-in for <cuda_runtime.h>: just enough declarations for g++ to
// compile csrc/megakernel.cu as C++ and run it one lane at a time on the
// CPU (ops/_build.load_host). The CPU tests use it to hold the kernel
// source's arithmetic to the plain PyTorch version where there is no card
// and no nvcc. It says nothing about what nvcc accepts or how fast the
// kernel is. Not thread-safe: the launch geometry lives in globals.
#pragma once
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __constant__ static
#define __launch_bounds__(x)

struct float4 {
  float x, y, z, w;
};
struct dim3 {
  unsigned x, y, z;
};
static dim3 threadIdx, blockIdx, blockDim;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
static int qr_host_error = cudaSuccess;

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
inline void __syncthreads() {}
template <class T>
T __ldg(const T* p) {
  return *p;
}
inline float __uint_as_float(unsigned a) {
  float f;
  memcpy(&f, &a, 4);
  return f;
}
inline int max(int a, int b) { return a > b ? a : b; }
inline int min(int a, int b) { return a < b ? a : b; }

// A block's dynamic shared memory: the card's 227 KB.
#define QR_HOST_SMEM_FLOATS (227 * 256)
#define QR_SHARED_FLOATS(name) static float name[QR_HOST_SMEM_FLOATS]
// A launch runs every thread of the grid in turn as a block of its own, so
// each stages the tables it reads and __syncthreads has nothing to wait for.
#define QR_LAUNCH(kernel, blocks, threads, smem, stream, arg)           \
  do {                                                                   \
    if ((size_t)(smem) > sizeof(float) * QR_HOST_SMEM_FLOATS) {          \
      qr_host_error = cudaErrorInvalidValue;                             \
      break;                                                             \
    }                                                                    \
    blockDim.x = 1;                                                      \
    threadIdx.x = 0;                                                     \
    for (unsigned b_ = 0; b_ < (unsigned)(blocks) * (threads); ++b_) {   \
      blockIdx.x = b_;                                                   \
      kernel(arg);                                                       \
    }                                                                    \
  } while (0)
