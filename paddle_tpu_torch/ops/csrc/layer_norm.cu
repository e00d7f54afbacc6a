// Row layer norm for Hopper (sm_90a): forward with saved statistics, and
// the backward's dx.
//
// Replaces the two Pallas bodies of paddle_tpu/ops/pallas_layer_norm.py:
//   layer_norm_fwd    <- _fwd_kernel     (launched by _ln_fwd_impl)
//   layer_norm_bwd_dx <- _bwd_dx_kernel  (launched by _ln_bwd)
// on x/y/dy/dx (R, C) row-major in T = float or bfloat16, scale/bias (C,)
// float32, mean/rstd (R,) float32 (the TPU kernel's (R, 128) lane
// broadcast of the statistics is a TPU tiling artefact, not part of the
// function):
//   mean = sum(x) / C                 var = sum((x - mean)^2) / C
//   rstd = rsqrt(var + eps)           y = (x - mean) * rstd * scale + bias
//   a = dy * scale, xhat = (x - mean) * rstd
//   dx = rstd * (a - mean(a) - xhat * mean(a * xhat))
// dscale and dbias are cross-row sums that the caller computes in
// PyTorch, as the reference leaves them to jnp.
//
// Two routes, picked by the wrapper before the launch
// (ops/layer_norm.py ln_route):
//
// The warp route (C a multiple of one 16-byte vector, C <= 1024, every
// tensor 16-byte aligned: BERT's C = 768 in f32 and bf16). One warp owns
// a row and holds it in registers: lane l takes the 16-byte vectors l,
// l + 32, ... of the row (float4 in f32, 8 bf16 in a uint4), NV of them
// at most, NV a template parameter (6 in f32 and 3 in bf16 at C = 768),
// and issues all its loads of the row before it uses any. Its slices of
// scale and bias (forward) or scale (backward) are loaded once and kept
// for every row the warp takes. No shared memory and no __syncthreads:
// the statistics are two-pass over the registers (the mean, then the
// sum of squared differences, not E[x^2] - mean^2, which cancels at
// BERT's eps = 1e-12), each sum an xor butterfly of warp shuffles in a
// fixed order, so every lane holds the same bits and two runs agree.
// Outputs leave as 16-byte stores; lane 0 writes mean and rstd. The
// backward reads mean and rstd as two scalars a row and takes both of
// its sums in one register pass with two interleaved butterflies. A
// block holds `warps` rows at once and the grid walks the rows (the
// wrapper's ln_grid: at 132 SMs, R = 304 takes 2 warps a block, 152
// blocks over every SM; R = 2048 takes 8, 256 blocks in one wave). The
// route's frame (loaders, sums, the register cap kLaneElems, with_nv,
// warp_takes) lives in row_norm.cuh, shared with fused_residual.cu.
//
// The row route (everything else: any R >= 1, 1 <= C <= 16384, any
// alignment; the kernel of the first port, unchanged). One block per
// row stages it in shared memory as f32 with one pass over global memory
// (vector loads of four elements when C % 4 == 0 and the pointers are
// 16-byte aligned), then takes the same two-pass statistics from shared
// memory. Sums are warp shuffles and one shared-memory step in a fixed
// order, so two runs give the same bits. 64 KB of shared memory for the
// forward's row at C = 16384, 128 KB for the backward's two.
//
// Bound on this card (HBM 3.35 TB/s): the forward reads x and writes y,
// the backward reads x and dy and writes dx; at R = 2048, C = 768 in f32
// that is 12.6 MB (3.8 us) and 18.9 MB (5.6 us).
#include "row_norm.cuh"

namespace {

using namespace row_norm;

template <typename T, bool VEC>
__global__ void ln_fwd_kernel(const T* __restrict__ x,
                              const float* __restrict__ scale,
                              const float* __restrict__ bias,
                              T* __restrict__ y, float* __restrict__ mean,
                              float* __restrict__ rstd, int C, float eps) {
  extern __shared__ float smem[];
  __shared__ float red[32];
  float* row = smem;
  const size_t r = blockIdx.x;
  float s = 0.f;
  for_row<VEC>(x + r * C, C, [&](int c, float v) {
    row[c] = v;
    s += v;
  });
  const float mu = block_sum(s, red) / C;  // also orders row[] for all
  float sq = 0.f;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float d = row[c] - mu;
    sq += d * d;
  }
  const float rs = rsqrtf(block_sum(sq, red) / C + eps);
  write_row<VEC>(y + r * C, C, [&](int c) {
    return (row[c] - mu) * rs * scale[c] + bias[c];
  });
  if (threadIdx.x == 0) {
    mean[r] = mu;
    rstd[r] = rs;
  }
}

template <typename T, bool VEC>
__global__ void ln_bwd_dx_kernel(const T* __restrict__ x,
                                 const float* __restrict__ scale,
                                 const float* __restrict__ mean,
                                 const float* __restrict__ rstd,
                                 const T* __restrict__ dy,
                                 T* __restrict__ dx, int C) {
  extern __shared__ float smem[];
  __shared__ float red[32];
  float* xh = smem;      // xhat
  float* a = smem + C;   // dy * scale
  const size_t r = blockIdx.x;
  const float mu = mean[r], rs = rstd[r];
  for_row<VEC>(x + r * C, C, [&](int c, float v) { xh[c] = (v - mu) * rs; });
  float s1 = 0.f, s2 = 0.f;
  // each thread reads back only the xhat entries it wrote itself
  for_row<VEC>(dy + r * C, C, [&](int c, float v) {
    const float av = v * scale[c];
    a[c] = av;
    s1 += av;
    s2 += av * xh[c];
  });
  const float c1 = block_sum(s1, red) / C;
  const float c2 = block_sum(s2, red) / C;
  write_row<VEC>(dx + r * C, C, [&](int c) {
    return rs * (a[c] - c1 - xh[c] * c2);
  });
}

template <typename T>
int fwd_run(const void* x, const float* scale, const float* bias, void* y,
            float* mean, float* rstd, int R, int C, float eps,
            cudaStream_t st) {
  const bool vec = C % 4 == 0 && aligned16(x) && aligned16(y);
  const size_t smem = sizeof(float) * C;
  auto kern = vec ? ln_fwd_kernel<T, true> : ln_fwd_kernel<T, false>;
  if (int e = set_smem(kern, smem)) return e;
  kern<<<R, threads_for(C), smem, st>>>((const T*)x, scale, bias, (T*)y,
                                        mean, rstd, C, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_run(const void* x, const float* scale, const float* mean,
            const float* rstd, const void* dy, void* dx, int R, int C,
            cudaStream_t st) {
  const bool vec =
      C % 4 == 0 && aligned16(x) && aligned16(dy) && aligned16(dx);
  const size_t smem = 2 * sizeof(float) * C;
  auto kern = vec ? ln_bwd_dx_kernel<T, true> : ln_bwd_dx_kernel<T, false>;
  if (int e = set_smem(kern, smem)) return e;
  kern<<<R, threads_for(C), smem, st>>>((const T*)x, scale, mean, rstd,
                                        (const T*)dy, (T*)dx, C);
  return (int)cudaGetLastError();
}

// ---- the warp route ----------------------------------------------------

template <typename T, int NV>
__global__ void __launch_bounds__(32 * kMaxWarps)
    ln_fwd_warp_kernel(const T* __restrict__ x,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias, T* __restrict__ y,
                       float* __restrict__ mean, float* __restrict__ rstd,
                       int R, int C, float eps) {
  constexpr int VW = kVec<T>;
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int nvec = C / VW;
  float sc[NV][VW], bi[NV][VW];
  load_slice<T, NV>(scale, nvec, lane, sc);
  load_slice<T, NV>(bias, nvec, lane, bi);
  for (int r = blockIdx.x * warps + (threadIdx.x >> 5); r < R;
       r += gridDim.x * warps) {
    float v[NV][VW];
    load_row<T, NV>(x + (size_t)r * C, nvec, lane, v);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int j = 0; j < VW; ++j) s += v[i][j];
    const float mu = warp_sum(s) / C;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (lane + 32 * i < nvec)
#pragma unroll
        for (int j = 0; j < VW; ++j) {
          const float d = v[i][j] - mu;
          sq += d * d;
        }
    const float rs = rsqrtf(warp_sum(sq) / C + eps);
    T* yr = y + (size_t)r * C;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int vi = lane + 32 * i;
      if (vi < nvec) {
        float o[VW];
#pragma unroll
        for (int j = 0; j < VW; ++j)
          o[j] = (v[i][j] - mu) * rs * sc[i][j] + bi[i][j];
        st16(yr + (size_t)vi * VW, pack16<T>(o));
      }
    }
    if (lane == 0) {
      mean[r] = mu;
      rstd[r] = rs;
    }
  }
}

template <typename T, int NV>
__global__ void __launch_bounds__(32 * kMaxWarps)
    ln_bwd_dx_warp_kernel(const T* __restrict__ x,
                          const float* __restrict__ scale,
                          const float* __restrict__ mean,
                          const float* __restrict__ rstd,
                          const T* __restrict__ dy, T* __restrict__ dx,
                          int R, int C) {
  constexpr int VW = kVec<T>;
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int nvec = C / VW;
  float sc[NV][VW];
  load_slice<T, NV>(scale, nvec, lane, sc);
  for (int r = blockIdx.x * warps + (threadIdx.x >> 5); r < R;
       r += gridDim.x * warps) {
    float xh[NV][VW], a[NV][VW];
    load_row<T, NV>(x + (size_t)r * C, nvec, lane, xh);
    load_row<T, NV>(dy + (size_t)r * C, nvec, lane, a);
    const float mu = mean[r], rs = rstd[r];
    // past the row dy and scale read as 0, so a and a * xhat add 0
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int j = 0; j < VW; ++j) {
        xh[i][j] = (xh[i][j] - mu) * rs;
        a[i][j] *= sc[i][j];
        s1 += a[i][j];
        s2 += a[i][j] * xh[i][j];
      }
    warp_sum2(s1, s2);
    const float c1 = s1 / C, c2 = s2 / C;
    T* dr = dx + (size_t)r * C;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int vi = lane + 32 * i;
      if (vi < nvec) {
        float o[VW];
#pragma unroll
        for (int j = 0; j < VW; ++j)
          o[j] = rs * (a[i][j] - c1 - xh[i][j] * c2);
        st16(dr + (size_t)vi * VW, pack16<T>(o));
      }
    }
  }
}

template <typename T>
int fwd_warp_run(const void* x, const float* scale, const float* bias,
                 void* y, float* mean, float* rstd, int R, int C, float eps,
                 int warps, int blocks, cudaStream_t st) {
  if (!warp_takes<T>(R, C, warps, blocks, {x, scale, bias, y}))
    return (int)cudaErrorInvalidValue;
  const int need = (C / kVec<T> + 31) / 32;
  return with_nv<T>(need, [&](auto nv) {
    ln_fwd_warp_kernel<T, decltype(nv)::value><<<blocks, 32 * warps, 0, st>>>(
        (const T*)x, scale, bias, (T*)y, mean, rstd, R, C, eps);
    return (int)cudaGetLastError();
  });
}

template <typename T>
int bwd_warp_run(const void* x, const float* scale, const float* mean,
                 const float* rstd, const void* dy, void* dx, int R, int C,
                 int warps, int blocks, cudaStream_t st) {
  if (!warp_takes<T>(R, C, warps, blocks, {x, scale, dy, dx}))
    return (int)cudaErrorInvalidValue;
  const int need = (C / kVec<T> + 31) / 32;
  return with_nv<T>(need, [&](auto nv) {
    ln_bwd_dx_warp_kernel<T, decltype(nv)::value>
        <<<blocks, 32 * warps, 0, st>>>((const T*)x, scale, mean, rstd,
                                        (const T*)dy, (T*)dx, R, C);
    return (int)cudaGetLastError();
  });
}

bool bad_shape(int R, int C) { return R <= 0 || C <= 0 || C > kMaxCols; }

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, y); scale, bias, mean, rstd float32.
extern "C" int layer_norm_fwd_launch(const void* x, const float* scale,
                                     const float* bias, void* y, float* mean,
                                     float* rstd, int R, int C, int dtype,
                                     float eps, void* stream) {
  if (bad_shape(R, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fwd_run<float>(x, scale, bias, y, mean, rstd, R, C, eps, st);
  if (dtype == 1)
    return fwd_run<__nv_bfloat16>(x, scale, bias, y, mean, rstd, R, C, eps,
                                  st);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 float32, 1 bfloat16 (x, dy, dx); scale, mean, rstd float32.
extern "C" int layer_norm_bwd_dx_launch(const void* x, const float* scale,
                                        const float* mean, const float* rstd,
                                        const void* dy, void* dx, int R,
                                        int C, int dtype, void* stream) {
  if (bad_shape(R, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd_run<float>(x, scale, mean, rstd, dy, dx, R, C, st);
  if (dtype == 1)
    return bwd_run<__nv_bfloat16>(x, scale, mean, rstd, dy, dx, R, C, st);
  return (int)cudaErrorInvalidValue;
}

// The warp route (see the header): `warps` rows a block at once,
// `blocks` blocks walking the rows. dtype: 0 float32, 1 bfloat16.
extern "C" int layer_norm_fwd_warp_launch(const void* x, const float* scale,
                                          const float* bias, void* y,
                                          float* mean, float* rstd, int R,
                                          int C, int dtype, float eps,
                                          int warps, int blocks,
                                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fwd_warp_run<float>(x, scale, bias, y, mean, rstd, R, C, eps,
                               warps, blocks, st);
  if (dtype == 1)
    return fwd_warp_run<__nv_bfloat16>(x, scale, bias, y, mean, rstd, R, C,
                                       eps, warps, blocks, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int layer_norm_bwd_dx_warp_launch(const void* x,
                                             const float* scale,
                                             const float* mean,
                                             const float* rstd,
                                             const void* dy, void* dx, int R,
                                             int C, int dtype, int warps,
                                             int blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd_warp_run<float>(x, scale, mean, rstd, dy, dx, R, C, warps,
                               blocks, st);
  if (dtype == 1)
    return bwd_warp_run<__nv_bfloat16>(x, scale, mean, rstd, dy, dx, R, C,
                                       warps, blocks, st);
  return (int)cudaErrorInvalidValue;
}
