// Device helpers shared by the FFN kernels of this directory
// (fused_block.cu's fused_ffn_ln and fused_out_ln, fused_ffn.cu):
// f32 widening of the input types, the register-tiled SIMT tile GEMM of
// a row tile against a column tile of a row-major weight, and the
// activations of paddle_tpu/ops/pallas_ffn.py (_gelu_tanh, _gelu_exact
// over the A&S erf polynomial, relu).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

constexpr int kThreads = 256;
constexpr int BK = 32;  // k depth per shared-memory stage

// Layer norm applied to A on its way into gemm_tile<..., true> (norm
// "pre"): mu/rs per tile row (shared memory), s/b per k (global).
struct RowNorm {
  const float *mu, *rs, *s, *b;
};

// acc[TM][TN] += A[row0:row0+BM, k0:k1] @ B[k0:k1, col0:col0+BN], both
// row-major in global memory, out-of-range entries read as 0. The next
// k stage is prefetched into registers while the current one computes.
// NORM_A is a template parameter so that the plain instantiation keeps no
// pointer of `ln` alive through its k loop.
template <int BM, int BN, int TM, int TN, bool NORM_A = false,
          typename TA, typename TB>
__device__ __forceinline__ void gemm_tile(
    const TA* __restrict__ A, int lda, int M, int row0,
    const TB* __restrict__ B, int ldb, int N, int col0, int k0, int k1,
    float (&acc)[TM][TN], float (*As)[BM], float (*Bs)[BN],
    RowNorm ln = RowNorm{nullptr, nullptr, nullptr, nullptr}) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "thread layout");
  constexpr int A_PER = BM * BK / kThreads;
  constexpr int B_PER = BK * BN / kThreads;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  float ar[A_PER], br[B_PER];

  auto load = [&](int kb) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / BK, kk = e % BK;
      const int row = row0 + r, k = kb + kk;
      ar[i] = (row < M && k < k1) ? to_f(A[(size_t)row * lda + k]) : 0.f;
      // the normalised x is rounded to x's type, as the reference keeps it
      if (NORM_A && row < M && k < k1)
        ar[i] = to_f(from_f<TA>((ar[i] - ln.mu[r]) * ln.rs[r] * ln.s[k] +
                                ln.b[k]));
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int e = tid + i * kThreads;
      const int kk = e / BN, c = e % BN;
      const int k = kb + kk, col = col0 + c;
      br[i] = (k < k1 && col < N) ? to_f(B[(size_t)k * ldb + col]) : 0.f;
    }
  };

  const int nk = (k1 - k0 + BK - 1) / BK;
  if (nk > 0) load(k0);
  for (int t = 0; t < nk; ++t) {
    __syncthreads();  // the previous stage is no longer being read
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int e = tid + i * kThreads;
      As[e % BK][e / BK] = ar[i];
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int e = tid + i * kThreads;
      Bs[e / BN][e % BN] = br[i];
    }
    __syncthreads();
    if (t + 1 < nk) load(k0 + (t + 1) * BK);
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
    }
  }
}

__device__ __forceinline__ float gelu_tanh(float f) {
  // the formula of paddle_tpu/ops/pallas_ffn.py:_gelu_tanh
  const float c = 0.7978845608028654f;  // sqrt(2/pi)
  return 0.5f * f * (1.0f + tanhf(c * (f + 0.044715f * f * f * f)));
}

__device__ __forceinline__ float gelu_erf_poly(float f) {
  // pallas_ffn.py:_gelu_exact over _erf_poly: Abramowitz & Stegun
  // 7.1.26 with the reference's five constants (|err| < 1.5e-7), not
  // erff, so that kernel and plain version compute one function
  const float z = f * 0.7071067811865476f;
  const float a = fabsf(z);
  const float t = 1.0f / (1.0f + 0.3275911f * a);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float erf = copysignf(1.0f - poly * expf(-a * a), z);
  return 0.5f * f * (1.0f + erf);
}

// act: 0 gelu_tanh, 1 gelu (erf polynomial), 2 relu
__device__ __forceinline__ float activate(int act, float v) {
  if (act == 0) return gelu_tanh(v);
  if (act == 1) return gelu_erf_poly(v);
  return fmaxf(v, 0.f);
}

}  // namespace
