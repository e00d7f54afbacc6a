// Epilogue-fused decoder sub-blocks for Hopper (sm_90a), f32.
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
// Bound on this card (f32, CUDA cores, 67 TFLOP/s; HBM 3.35 TB/s):
//   fused_out_ln  M=8,   D=2048: bytes, the 16.8 MB of W: ~5 us.
//                 M=256, D=2048: flops, 2.1 GFLOP: ~32 us.
//   fused_ffn_ln  M=8,   H=2048, I=8192: bytes, 134 MB of W1+W2: ~40 us.
//                 M=256: flops, 17.2 GFLOP: ~257 us.
// This first version is a register-tiled SIMT GEMM (no tensor cores, no
// TMA); at decode it is latency bound per block, so its time sits above
// the bound by the factor recorded in PERF.md.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int BM = 32;  // rows per tile
constexpr int BK = 32;  // k depth per shared-memory stage

// acc[TM][TN] += A[row0:row0+BM, k0:k1] @ B[k0:k1, col0:col0+BN], both
// row-major in global memory, out-of-range entries read as 0. The next
// k stage is prefetched into registers while the current one computes.
template <int BN, int TM, int TN>
__device__ __forceinline__ void gemm_tile(
    const float* __restrict__ A, int lda, int M, int row0,
    const float* __restrict__ B, int ldb, int N, int col0, int k0, int k1,
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
      ar[i] = (row < M && k < k1) ? A[(size_t)row * lda + k] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int e = tid + i * kThreads;
      const int kk = e / BN, c = e % BN;
      const int k = kb + kk, col = col0 + c;
      br[i] = (k < k1 && col < N) ? B[(size_t)k * ldb + col] : 0.f;
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

__global__ void __launch_bounds__(kThreads)
    out_ln_kernel(const float* __restrict__ a, const float* __restrict__ w,
                  const float* __restrict__ b, const float* __restrict__ res,
                  const float* __restrict__ ln_s,
                  const float* __restrict__ ln_b, float* z, float* h,
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
      if (col < N)
        z[(size_t)row * N + col] =
            (acc[i][j] + b[col]) + res[(size_t)row * N + col];
    }
  }

  // the last z tile of this row tile normalises the whole rows
  if (!last_arrival(tickets, n_row * n_col + mt, n_col, &flag)) return;
  const int lane = tid & 31, warp = tid >> 5;
  for (int r = warp; r < BM; r += kThreads / 32) {
    const int row = row0 + r;
    if (row >= M) break;
    const float* zr = z + (size_t)row * N;
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
      h[(size_t)row * N + c] = (__ldcg(zr + c) - mean) * rstd * ln_s[c]
                               + ln_b[c];
  }
}

// ---------------------------------------------------------------------------
// fused_ffn_ln (gelu_tanh, norm "none", p 0)
// ---------------------------------------------------------------------------
constexpr int FF_BN = 128;  // output columns per chunk of the 2nd GEMM
constexpr int FF_TM = 4, FF_TN = 4;

template <int BI>
__global__ void __launch_bounds__(kThreads)
    ffn_kernel(const float* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const float* __restrict__ b2, const float* __restrict__ res,
               float* out, float* part, int* tickets, int M, int H, int I) {
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
            i0 + c < I ? gelu_tanh(acc[i][j] + b1[i0 + c]) : 0.f;
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
                        ? w2[(size_t)(i0 + k) * H + col] : 0.f;
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
        out[(size_t)row * H + col] =
            (s + b2[col]) + res[(size_t)row * H + col];
      }
    }
  }
}

}  // namespace

extern "C" int fused_out_ln_launch(const float* a, const float* w,
                                   const float* b, const float* res,
                                   const float* ln_s, const float* ln_b,
                                   float* z, float* h, float* part,
                                   int* tickets, int M, int K, int N, int kc,
                                   float eps, void* stream) {
  if (kc <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + OL_BN - 1) / OL_BN, (M + BM - 1) / BM,
                  (K + kc - 1) / kc);
  out_ln_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, w, b, res, ln_s, ln_b, z, h, part, tickets, M, K, N, kc, eps);
  return (int)cudaGetLastError();
}

extern "C" int fused_ffn_ln_launch(const float* x, const float* w1,
                                   const float* b1, const float* w2,
                                   const float* b2, const float* res,
                                   float* out, float* part, int* tickets,
                                   int M, int H, int I, int bi,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((I + bi - 1) / bi, (M + BM - 1) / BM);
  if (bi == 64) {
    ffn_kernel<64><<<grid, kThreads, 0, st>>>(x, w1, b1, w2, b2, res, out,
                                              part, tickets, M, H, I);
  } else if (bi == 128) {
    ffn_kernel<128><<<grid, kThreads, 0, st>>>(x, w1, b1, w2, b2, res, out,
                                               part, tickets, M, H, I);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
