// Epilogue-fused decoder sub-blocks for Hopper (sm_90a), f32 or bf16
// inputs with f32 accumulation.
//
// fused_out_ln replaces paddle_tpu/ops/pallas_block.py:_out_ln_kernel
// (launched by _out_ln_pallas):
//     z = res + a @ W + b            a (M, K), W (K, N), res (M, N)
//     h = LN(z) * ln_s + ln_b        over each whole row of z
// fused_ffn_ln replaces pallas_block.py:_ffn_ln_kernel (launched by
// _ffn_ln_pallas) with act gelu_tanh, norm "none", p 0:
//     out = res + gelu_tanh(x @ W1 + b1) @ W2 + b2
//     x (M, H), W1 (H, I), W2 (I, H); the (M, I) intermediate lives only
//     in shared memory.
//
// The constraint both share: the LN epilogue (and the FFN's sum over I)
// needs a whole output row, but at decode M is the slot count (8), so a
// block that owned a row tile and all N (or all I) columns would put the
// whole step on one SM. Instead N, K and I are spread over many blocks
// and the row is finished in the same launch by the LAST block to
// arrive, found with an atomic ticket per tile:
//   * fused_out_ln: grid (N/64, M/32, KS). With KS > 1 (few output
//     tiles, i.e. decode) each block writes a split-K partial; the last
//     block of a tile sums the KS partials in split order and writes z.
//     The last z tile of a row tile then normalises its rows, reading z
//     back from L2 (__ldcg) after a __threadfence.
//   * fused_ffn_ln: grid (I/BI, M/32). Block (ji, mi) computes
//     hid = gelu_tanh(x @ W1[:, ji-chunk] + b1) into shared memory, then
//     its partial hid @ W2[ji-chunk, :] one 128-column chunk at a time
//     (chunks visited in an order rotated by ji, so the chunks' last
//     arrivals fall on different blocks). The last block to deliver a
//     chunk sums the I/BI partials in ji order and adds b2 and res.
// Every sum runs in a fixed order (no float atomics), so results are the
// same from run to run.
//
// Types: a/W/b/res (and x/W1/b1/W2/b2/res) share one input type T, float
// or bfloat16 (the training path's bf16 amp_dtype); ln_s/ln_b are f32.
// Values are widened to f32 on load, shared tiles, partial sums and LN
// statistics stay f32, and the outputs are rounded once at the store: z
// and out in T, h in T. With bf16, z is also kept in an f32 scratch
// (zf) so that the LN runs on the unrounded z, as the reference does;
// with f32 the caller passes z itself as zf.
//
// Bound on this card (f32, CUDA cores, 67 TFLOP/s; HBM 3.35 TB/s):
//   fused_out_ln  M=8,   D=2048: bytes, the 16.8 MB of W: ~5 us.
//                 M=256, D=2048: flops, 2.1 GFLOP: ~32 us.
//   fused_ffn_ln  M=8,   H=2048, I=8192: bytes, 134 MB of W1+W2: ~40 us.
//                 M=256: flops, 17.2 GFLOP: ~257 us.
// At the training shape (bf16, M = 1024 tokens, tensor-core rate 989
// TFLOP/s): fused_out_ln 8.6 GFLOP, ~8.7 us; fused_ffn_ln 68.7 GFLOP,
// ~69 us, and its f32 partials (I/128, M, H) are 537 MB a call.
// This first version is a register-tiled SIMT GEMM (no tensor cores, no
// TMA); at decode it is latency bound per block, so its time sits above
// the bound by the factor recorded in PERF.md.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

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
constexpr int BM = 32;  // rows per tile
constexpr int BK = 32;  // k depth per shared-memory stage

// acc[TM][TN] += A[row0:row0+BM, k0:k1] @ B[k0:k1, col0:col0+BN], both
// row-major in global memory, out-of-range entries read as 0. The next
// k stage is prefetched into registers while the current one computes.
template <int BN, int TM, int TN, typename TA, typename TB>
__device__ __forceinline__ void gemm_tile(
    const TA* __restrict__ A, int lda, int M, int row0,
    const TB* __restrict__ B, int ldb, int N, int col0, int k0, int k1,
    float (&acc)[TM][TN], float (*As)[BM], float (*Bs)[BN]) {
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

// Block-wide "am I the last of `total` arrivals at ticket[idx]?" after
// this block's global writes. Callers return (block-uniformly) if not.
__device__ __forceinline__ bool last_arrival(int* tickets, int idx,
                                             int total, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(&tickets[idx], 1) == total - 1;
  __syncthreads();
  const bool last = *flag;
  if (last) __threadfence();
  __syncthreads();  // *flag may be rewritten by the next call
  return last;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float gelu_tanh(float f) {
  // the formula of paddle_tpu/ops/pallas_ffn.py:_gelu_tanh
  const float c = 0.7978845608028654f;  // sqrt(2/pi)
  return 0.5f * f * (1.0f + tanhf(c * (f + 0.044715f * f * f * f)));
}

// ---------------------------------------------------------------------------
// fused_out_ln
// ---------------------------------------------------------------------------
constexpr int OL_BN = 64, OL_TM = 2, OL_TN = 4;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    out_ln_kernel(const T* __restrict__ a, const T* __restrict__ w,
                  const T* __restrict__ b, const T* __restrict__ res,
                  const float* __restrict__ ln_s,
                  const float* __restrict__ ln_b, T* z, float* zf, T* h,
                  float* part, int* tickets, int M, int K, int N, int kc,
                  float eps) {
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][OL_BN];
  __shared__ int flag;
  const int nt = blockIdx.x, mt = blockIdx.y, ks = blockIdx.z;
  const int n_col = gridDim.x, n_row = gridDim.y, KS = gridDim.z;
  const int row0 = mt * BM, col0 = nt * OL_BN;
  const int tid = threadIdx.x;
  const int tx = tid % (OL_BN / OL_TN), ty = tid / (OL_BN / OL_TN);

  float acc[OL_TM][OL_TN] = {};
  const int k0 = ks * kc, k1 = min(K, k0 + kc);
  gemm_tile<OL_BN, OL_TM, OL_TN>(a, K, M, row0, w, N, N, col0, k0, k1, acc,
                                 As, Bs);

  if (KS > 1) {
#pragma unroll
    for (int i = 0; i < OL_TM; ++i) {
      const int row = row0 + ty * OL_TM + i;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < OL_TN; ++j) {
        const int col = col0 + tx * OL_TN + j;
        if (col < N) part[((size_t)ks * M + row) * N + col] = acc[i][j];
      }
    }
    if (!last_arrival(tickets, mt * n_col + nt, KS, &flag)) return;
#pragma unroll
    for (int i = 0; i < OL_TM; ++i) {
      const int row = row0 + ty * OL_TM + i;
#pragma unroll
      for (int j = 0; j < OL_TN; ++j) {
        const int col = col0 + tx * OL_TN + j;
        float s = 0.f;
        if (row < M && col < N)
          for (int q = 0; q < KS; ++q)
            s += __ldcg(&part[((size_t)q * M + row) * N + col]);
        acc[i][j] = s;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < OL_TM; ++i) {
    const int row = row0 + ty * OL_TM + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < OL_TN; ++j) {
      const int col = col0 + tx * OL_TN + j;
      if (col < N) {
        const size_t e = (size_t)row * N + col;
        const float zv = (acc[i][j] + to_f(b[col])) + to_f(res[e]);
        zf[e] = zv;
        if constexpr (!std::is_same<T, float>::value) z[e] = from_f<T>(zv);
      }
    }
  }

  // the last z tile of this row tile normalises the whole rows
  if (!last_arrival(tickets, n_row * n_col + mt, n_col, &flag)) return;
  const int lane = tid & 31, warp = tid >> 5;
  for (int r = warp; r < BM; r += kThreads / 32) {
    const int row = row0 + r;
    if (row >= M) break;
    const float* zr = zf + (size_t)row * N;
    float s = 0.f;
    for (int c = lane; c < N; c += 32) s += __ldcg(zr + c);
    const float mean = warp_sum(s) / N;
    float sq = 0.f;
    for (int c = lane; c < N; c += 32) {
      const float dv = __ldcg(zr + c) - mean;
      sq += dv * dv;
    }
    const float rstd = 1.0f / sqrtf(warp_sum(sq) / N + eps);
    for (int c = lane; c < N; c += 32)
      h[(size_t)row * N + c] =
          from_f<T>((__ldcg(zr + c) - mean) * rstd * ln_s[c] + ln_b[c]);
  }
}

// ---------------------------------------------------------------------------
// fused_ffn_ln (gelu_tanh, norm "none", p 0)
// ---------------------------------------------------------------------------
constexpr int FF_BN = 128;  // output columns per chunk of the 2nd GEMM
constexpr int FF_TM = 4, FF_TN = 4;

template <typename T, int BI>
__global__ void __launch_bounds__(kThreads)
    ffn_kernel(const T* __restrict__ x, const T* __restrict__ w1,
               const T* __restrict__ b1, const T* __restrict__ w2,
               const T* __restrict__ b2, const T* __restrict__ res,
               T* out, float* part, int* tickets, int M, int H, int I) {
  constexpr int TM1 = BI == 64 ? 2 : 4, TN1 = 4;
  constexpr int WCOLS = BI > FF_BN ? BI : FF_BN;
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][WCOLS];
  __shared__ float hid[BM][BI + 1];
  __shared__ int flag;
  const int ji = blockIdx.x, mt = blockIdx.y;
  const int nI = gridDim.x;
  const int row0 = mt * BM, i0 = ji * BI;
  const int tid = threadIdx.x;

  // hid = gelu_tanh(x[rows] @ W1[:, i0:i0+BI] + b1), kept on chip
  {
    float acc[TM1][TN1] = {};
    gemm_tile<BI, TM1, TN1>(x, H, M, row0, w1, I, I, i0, 0, H, acc, As,
                            reinterpret_cast<float(*)[BI]>(&Bs[0][0]));
    const int tx = tid % (BI / TN1), ty = tid / (BI / TN1);
#pragma unroll
    for (int i = 0; i < TM1; ++i)
#pragma unroll
      for (int j = 0; j < TN1; ++j) {
        const int c = tx * TN1 + j;
        hid[ty * TM1 + i][c] =
            i0 + c < I ? gelu_tanh(acc[i][j] + to_f(b1[i0 + c])) : 0.f;
      }
  }

  const int n_chunks = (H + FF_BN - 1) / FF_BN;
  const int tx = tid % (FF_BN / FF_TN), ty = tid / (FF_BN / FF_TN);
  const int k1 = min(BI, I - i0);
  for (int cc = 0; cc < n_chunks; ++cc) {
    const int chunk = (cc + ji) % n_chunks;
    const int col0 = chunk * FF_BN;
    float acc[FF_TM][FF_TN] = {};
    for (int kb = 0; kb < k1; kb += BK) {
      __syncthreads();  // hid complete / previous stage consumed
      for (int e = tid; e < BK * FF_BN; e += kThreads) {
        const int kk = e / FF_BN, c = e % FF_BN;
        const int k = kb + kk, col = col0 + c;
        Bs[kk][c] = (k < k1 && col < H)
                        ? to_f(w2[(size_t)(i0 + k) * H + col]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float av[FF_TM], bv[FF_TN];
#pragma unroll
        for (int i = 0; i < FF_TM; ++i) av[i] = hid[ty * FF_TM + i][kb + kk];
#pragma unroll
        for (int j = 0; j < FF_TN; ++j) bv[j] = Bs[kk][tx * FF_TN + j];
#pragma unroll
        for (int i = 0; i < FF_TM; ++i)
#pragma unroll
          for (int j = 0; j < FF_TN; ++j) acc[i][j] += av[i] * bv[j];
      }
    }
#pragma unroll
    for (int i = 0; i < FF_TM; ++i) {
      const int row = row0 + ty * FF_TM + i;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < FF_TN; ++j) {
        const int col = col0 + tx * FF_TN + j;
        if (col < H) part[((size_t)ji * M + row) * H + col] = acc[i][j];
      }
    }
    if (!last_arrival(tickets, mt * n_chunks + chunk, nI, &flag)) continue;
#pragma unroll
    for (int i = 0; i < FF_TM; ++i) {
      const int row = row0 + ty * FF_TM + i;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < FF_TN; ++j) {
        const int col = col0 + tx * FF_TN + j;
        if (col >= H) continue;
        float s = 0.f;
        for (int q = 0; q < nI; ++q)
          s += __ldcg(&part[((size_t)q * M + row) * H + col]);
        out[(size_t)row * H + col] = from_f<T>(
            (s + to_f(b2[col])) + to_f(res[(size_t)row * H + col]));
      }
    }
  }
}

template <typename T>
int out_ln_run(const void* a, const void* w, const void* b, const void* res,
               const float* ln_s, const float* ln_b, void* z, float* zf,
               void* h, float* part, int* tickets, int M, int K, int N,
               int kc, float eps, cudaStream_t st) {
  const dim3 grid((N + OL_BN - 1) / OL_BN, (M + BM - 1) / BM,
                  (K + kc - 1) / kc);
  out_ln_kernel<T><<<grid, kThreads, 0, st>>>(
      (const T*)a, (const T*)w, (const T*)b, (const T*)res, ln_s, ln_b,
      (T*)z, zf, (T*)h, part, tickets, M, K, N, kc, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int ffn_run(const void* x, const void* w1, const void* b1, const void* w2,
            const void* b2, const void* res, void* out, float* part,
            int* tickets, int M, int H, int I, int bi, cudaStream_t st) {
  const dim3 grid((I + bi - 1) / bi, (M + BM - 1) / BM);
  if (bi == 64) {
    ffn_kernel<T, 64><<<grid, kThreads, 0, st>>>(
        (const T*)x, (const T*)w1, (const T*)b1, (const T*)w2, (const T*)b2,
        (const T*)res, (T*)out, part, tickets, M, H, I);
  } else if (bi == 128) {
    ffn_kernel<T, 128><<<grid, kThreads, 0, st>>>(
        (const T*)x, (const T*)w1, (const T*)b1, (const T*)w2, (const T*)b2,
        (const T*)res, (T*)out, part, tickets, M, H, I);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (a/w/b/res/z/h); ln_s, ln_b, zf, part f32.
// With float32, zf is z.
extern "C" int fused_out_ln_launch(const void* a, const void* w,
                                   const void* b, const void* res,
                                   const float* ln_s, const float* ln_b,
                                   void* z, float* zf, void* h, float* part,
                                   int* tickets, int M, int K, int N, int kc,
                                   int dtype, float eps, void* stream) {
  if (kc <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return out_ln_run<float>(a, w, b, res, ln_s, ln_b, z, zf, h, part,
                             tickets, M, K, N, kc, eps, st);
  if (dtype == 1)
    return out_ln_run<__nv_bfloat16>(a, w, b, res, ln_s, ln_b, z, zf, h,
                                     part, tickets, M, K, N, kc, eps, st);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 float32, 1 bfloat16 (every tensor but the f32 part buffer).
extern "C" int fused_ffn_ln_launch(const void* x, const void* w1,
                                   const void* b1, const void* w2,
                                   const void* b2, const void* res,
                                   void* out, float* part, int* tickets,
                                   int M, int H, int I, int bi, int dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return ffn_run<float>(x, w1, b1, w2, b2, res, out, part, tickets, M, H,
                          I, bi, st);
  if (dtype == 1)
    return ffn_run<__nv_bfloat16>(x, w1, b1, w2, b2, res, out, part,
                                  tickets, M, H, I, bi, st);
  return (int)cudaErrorInvalidValue;
}
