// Threefry-2x32-20 on native uint32: the device counterpart of
// qaray_tpu_torch/core/krng.py (and of qaray_tpu/core/krng.py, which the
// Pallas megakernel inlines). Bit-exact with jax.random under the
// partitionable threefry path:
//   fold2(key, d)    == key_data(jax.random.fold_in(key, d))
//   draw_at(key, f)  == jax.random.uniform(key, shape) flat element f
#pragma once
#include <stdint.h>

struct Key {
  uint32_t k0, k1;
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += k0;
  x1 += k1;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i & 1][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

// jax.random.fold_in: cipher(key, (0, data)).
__device__ __forceinline__ Key fold2(Key k, uint32_t data) {
  uint32_t x0 = 0u, x1 = data;
  threefry2x32(k.k0, k.k1, x0, x1);
  return Key{x0, x1};
}

// uint32 bits -> f32 in [0, 1): jax.random.uniform's mantissa trick.
__device__ __forceinline__ float u01(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// Flat element f (< 2^32) of jax.random.uniform(key, shape).
__device__ __forceinline__ float draw_at(Key k, uint32_t f) {
  uint32_t x0 = 0u, x1 = f;
  threefry2x32(k.k0, k.k1, x0, x1);
  return u01(x0 ^ x1);
}
