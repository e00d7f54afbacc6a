// Row helpers of the layer-norm kernels (layer_norm.cu,
// fused_residual.cu): one block owns one row of a row-major (R, C)
// matrix and stages it in shared memory as f32 (the `row` route). At the
// end, the frame of the `warp` route that both files share, where one
// warp owns a row and holds it in registers as 16-byte vectors: the
// vector loads and stores, the xor-butterfly sums, the per-lane register
// cap (kLaneElems), the row and slice loaders, the pick of the vectors a
// lane holds (with_nv) and what the route takes (warp_takes).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace row_norm {

constexpr int kMaxCols = 16384;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Four consecutive elements at p + c (c % 4 == 0, p + c 16- or 8-byte
// aligned) as one vector load / store.
__device__ __forceinline__ void load4(const float* p, int c, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p + c);
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, int c,
                                      float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p + c);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  v[0] = __low2float(lo), v[1] = __high2float(lo);
  v[2] = __low2float(hi), v[3] = __high2float(hi);
}
__device__ __forceinline__ void store4(float* p, int c, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p + c) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, int c,
                                       const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  t.x = *reinterpret_cast<const uint32_t*>(&lo);
  t.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p + c) = t;
}

// Calls f(c, v) for every group of four columns (VEC: one vector load
// per group) or f1(c, x) for every column of the row at `p`.
template <bool VEC, typename T, typename F>
__device__ __forceinline__ void for_row(const T* p, int C, F f) {
  if (VEC) {
    for (int c = 4 * threadIdx.x; c < C; c += 4 * blockDim.x) {
      float v[4];
      load4(p, c, v);
#pragma unroll
      for (int i = 0; i < 4; ++i) f(c + i, v[i]);
    }
  } else {
    for (int c = threadIdx.x; c < C; c += blockDim.x) f(c, to_f(p[c]));
  }
}

// Writes g(c) for every column of the row at `p`.
template <bool VEC, typename T, typename G>
__device__ __forceinline__ void write_row(T* p, int C, G g) {
  if (VEC) {
    for (int c = 4 * threadIdx.x; c < C; c += 4 * blockDim.x) {
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = g(c + i);
      store4(p, c, v);
    }
  } else {
    for (int c = threadIdx.x; c < C; c += blockDim.x) p[c] = from_f<T>(g(c));
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum of v over the block, the same bits in every thread: warp
// shuffles, one shared-memory step, then every warp adds the warps'
// partial sums in the same order. `red` holds 32 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // the previous call's partials are no longer read
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const int nw = blockDim.x >> 5;
  return warp_sum(lane < nw ? red[lane] : 0.f);
}

// Threads per row: four columns a thread, between 64 and 512.
inline int threads_for(int C) {
  int t = 64;
  while (t < 512 && 4 * t < C) t *= 2;
  return t;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename K>
inline int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// ---- the warp route: a warp owns a row, held in registers -------------

// Elements of T in one 16-byte vector.
template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);

__device__ __forceinline__ uint4 ld16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void st16(void* p, const uint4& v) {
  *reinterpret_cast<uint4*>(p) = v;
}

// The kVec<T> elements of one 16-byte vector as f32, and back (bf16
// rounded to nearest even, as __float2bfloat16).
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& u, float* v);
template <>
__device__ __forceinline__ void unpack16<float>(const uint4& u, float* v) {
  v[0] = __uint_as_float(u.x), v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z), v[3] = __uint_as_float(u.w);
}
template <>
__device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4& u,
                                                        float* v) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
template <typename T>
__device__ __forceinline__ uint4 pack16(const float* v);
template <>
__device__ __forceinline__ uint4 pack16<float>(const float* v) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
template <>
__device__ __forceinline__ uint4 pack16<__nv_bfloat16>(const float* v) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Two sums over the warp at once, by xor butterfly: every lane ends with
// the same bits (each step adds the same two numbers in every lane).
__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
}

// Elements a lane holds at most (32 in f32 and bf16: C <= 1024), the
// register cap of the warp route, and warps (rows at once) a block.
constexpr int kLaneElems = 32;
constexpr int kMaxWarps = 8;

// Issues the loads of NV vectors of a row from p, lane l taking vectors
// l + 32 i; vectors past the row's nvec read as zeros.
template <typename T, int NV>
__device__ __forceinline__ void issue_row(const T* p, int nvec, int lane,
                                          uint4 (&raw)[NV]) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int vi = lane + 32 * i;
    raw[i] = vi < nvec ? ld16(p + (size_t)vi * kVec<T>)
                       : make_uint4(0u, 0u, 0u, 0u);
  }
}

// issue_row, then the vectors as f32.
template <typename T, int NV>
__device__ __forceinline__ void load_row(const T* p, int nvec, int lane,
                                         float (&v)[NV][kVec<T>]) {
  uint4 raw[NV];
  issue_row<T, NV>(p, nvec, lane, raw);
#pragma unroll
  for (int i = 0; i < NV; ++i) unpack16<T>(raw[i], v[i]);
}

// The lane's slice of a float32 vector of C (scale, bias) laid out as
// load_row lays out a row of T: vector i holds columns (l + 32 i) * VW on.
template <typename T, int NV>
__device__ __forceinline__ void load_slice(const float* p, int nvec,
                                           int lane,
                                           float (&v)[NV][kVec<T>]) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int vi = lane + 32 * i;
#pragma unroll
    for (int j = 0; j < kVec<T>; j += 4)
      unpack16<float>(vi < nvec ? ld16(p + (size_t)vi * kVec<T> + j)
                                : make_uint4(0u, 0u, 0u, 0u),
                      &v[i][j]);
  }
}

// Calls f(std::integral_constant<int, NV>) with the smallest NV of
// {1, 2, 3, 4, 6, 8} (up to the cap of T) that holds `need` vectors a
// lane; cudaErrorInvalidValue past the cap.
template <typename T, typename F>
int with_nv(int need, F f) {
  constexpr int kCap = kLaneElems / kVec<T>;
  if (need <= 1) return f(std::integral_constant<int, 1>{});
  if (need <= 2) return f(std::integral_constant<int, 2>{});
  if (need <= 3) return f(std::integral_constant<int, 3>{});
  if (need <= 4) return f(std::integral_constant<int, 4>{});
  if constexpr (kCap >= 8) {
    if (need <= 6) return f(std::integral_constant<int, 6>{});
    if (need <= 8) return f(std::integral_constant<int, 8>{});
  }
  return (int)cudaErrorInvalidValue;
}

// What the warp route takes: C whole vectors, at most kLaneElems a lane,
// 1..kMaxWarps warps a block, every pointer 16-byte aligned.
template <typename T>
bool warp_takes(int R, int C, int warps, int blocks,
                std::initializer_list<const void*> ptrs) {
  if (R <= 0 || C <= 0 || C % kVec<T> || C > 32 * kLaneElems) return false;
  if (warps < 1 || warps > kMaxWarps || blocks < 1) return false;
  for (const void* p : ptrs)
    if (!aligned16(p)) return false;
  return true;
}

}  // namespace row_norm
