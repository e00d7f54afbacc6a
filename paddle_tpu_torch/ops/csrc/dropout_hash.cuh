// Counter-based dropout masks shared by the kernels of this directory.
//
// Both are the murmur3 finaliser over a counter built from the global
// element id, in uint32 wrap-around arithmetic, so one int32 seed gives
// the same mask in every kernel, in the plain PyTorch versions
// (ops/fused_residual.py keep_mask, ops/flash_attention.py
// keep_mask_salted) and in the JAX package, forward and backward,
// whatever the tiling:
//   unsalted  paddle_tpu/ops/pallas_fused_residual.py:_keep
//             x = seed ^ ((row * ncols + col) * 0x85ebca6b)
//   salted    paddle_tpu/ops/pallas_attention.py:_keep_mask
//             x = (bh * 0x9e3779b9 + seed) ^ ((row * t + col) * 0x85ebca6b)
// An element is kept where fin(x) >= thr, thr = min(int(p * 2^32),
// 2^32 - 1), computed by the caller.
#pragma once
#include <stdint.h>

namespace dropout_hash {

__device__ __forceinline__ uint32_t fin(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85ebca6bu;
  x ^= x >> 13;
  x *= 0xc2b2ae35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ bool keep(uint32_t seed, uint32_t row,
                                     uint32_t col, uint32_t ncols,
                                     uint32_t thr) {
  return fin(seed ^ ((row * ncols + col) * 0x85ebca6bu)) >= thr;
}

__device__ __forceinline__ bool keep_salted(uint32_t seed, uint32_t bh,
                                            uint32_t row, uint32_t col,
                                            uint32_t t, uint32_t thr) {
  const uint32_t salt = bh * 0x9e3779b9u + seed;
  return fin(salt ^ ((row * t + col) * 0x85ebca6bu)) >= thr;
}

}  // namespace dropout_hash
