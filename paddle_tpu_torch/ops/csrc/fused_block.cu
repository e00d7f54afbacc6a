// Epilogue-fused decoder sub-blocks for Hopper (sm_90a), f32 or bf16
// inputs with f32 accumulation.
//
// fused_out_ln replaces paddle_tpu/ops/pallas_block.py:_out_ln_kernel
// (launched by _out_ln_pallas):
//     z = res + dropout_p(a @ W + b) a (M, K), W (K, N), res (M, N)
//     h = LN(z) * ln_s + ln_b        over each whole row of z
// fused_ffn_ln replaces pallas_block.py:_ffn_ln_kernel (launched by
// _ffn_ln_pallas):
//     out = [LN](res + dropout_p(act([LN] x @ W1 + b1) @ W2 + b2))
//     x (M, H), W1 (H, I), W2 (I, H); hid = act(...) is rounded to x's
//     type before the second product, as the reference's is (the
//     identity in float32). act: gelu_tanh, gelu (the reference's erf
//     polynomial) or relu. norm "pre" normalises x on its way into the
//     first GEMM, norm "post" the summed output; both with ln_s/ln_b.
// dropout_p is the unsalted counter hash of dropout_hash.cuh over the
// ids row * N + col of the (M, N) GEMM output, applied before the
// residual add; no mask tensor exists (the composed backward replays it).
//
// The SIMT kernels. The constraint both share: the LN epilogue (and the
// FFN's sum over I) needs a whole output row, but at decode M is the
// slot count (8), so a block that owned a row tile and all N (or all I)
// columns would put the whole step on one SM. Instead N, K and I are
// spread over many blocks and the row is finished in the same launch by
// the LAST block to arrive, found with an atomic ticket per tile:
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
//     With norm "post" the last chunk of a row tile then normalises its
//     rows (a second ticket), as fused_out_ln does. With norm "pre" each
//     block first takes the statistics of its 32 rows of x (a warp a
//     row, two passes) and normalises x as it loads it into the first
//     GEMM's tiles.
// Every sum runs in a fixed order (no float atomics), so results are the
// same from run to run.
//
// Types: a/W/b/res (and x/W1/b1/W2/b2/res) share one input type T, float
// or bfloat16 (the training path's bf16 amp_dtype); ln_s/ln_b are f32.
// Values are widened to f32 on load, shared tiles, partial sums and LN
// statistics stay f32, and the outputs are rounded once at the store: z
// and out in T, h in T. With bf16, z is also kept in an f32 scratch
// (zf) so that the LN runs on the unrounded z, as the reference does;
// with f32 the caller passes z itself as zf. fused_ffn_ln with norm
// "post" does the same with its output.
//
// Bound on this card (f32, CUDA cores, 67 TFLOP/s; HBM 3.35 TB/s):
//   fused_out_ln  M=8,   D=2048: bytes, the 16.8 MB of W: ~5 us.
//                 M=256, D=2048: flops, 2.1 GFLOP: ~32 us.
//   fused_ffn_ln  M=8,   H=2048, I=8192: bytes, 134 MB of W1+W2: ~40 us.
//                 M=256: flops, 17.2 GFLOP: ~257 us.
// At the training shape (bf16, M = 1024 tokens, tensor-core rate 989
// TFLOP/s): fused_out_ln 8.6 GFLOP, ~8.7 us; fused_ffn_ln 68.7 GFLOP,
// ~69 us, and the SIMT kernel's f32 partials (I/128, M, H) are 537 MB
// a call.
//
// Four routes, chosen by the wrapper from the dtype, the row count, the
// widths and the pointers' alignment before the launch
// (ops/fused_block.py tc_route, ffma_route, stream_route). The GEMM cores
// of the FFMA and tensor-core routes, with their epilogues, are
// block_gemm.cuh's, shared with fused_ffn.cu:
//
// SIMT (float32 calls no other route takes: ragged widths, misaligned
// views, and rows between the stream route's limit and 128; any bf16
// call at ragged widths or alignments): the split kernels above,
// launched by fused_out_ln_launch / fused_ffn_ln_launch. f32 stays full
// precision on the CUDA cores (the f32 parity checks forbid TF32).
//
// Stream (float32 from 1 to _STREAM_MAX_ROWS rows, i.e. decode and the
// short prefill buckets, every inner width a multiple of 64, operands
// 16-byte aligned; fused_out_ln_stream_launch /
// fused_ffn_ln_stream_launch): the weight-streaming core of
// stream_gemm.cuh, which at M = 8 is bound by W's bytes. fused_out_ln is
// one launch (MODE 1 with the LN by the last column tile of a row
// tile); fused_ffn_ln is two on one stream, ordered without flags:
//   [pre: xn = LN(x), ln_rows_kernel]
//   hid = act(xn|x @ W1 + b1)                   stream MODE 0
//   out = [LN](res + dropout_p(hid @ W2 + b2))  stream MODE 1
// hid (M, I) f32 (256 KB at M = 8, in L2), the split partials and the
// tickets live in the caller's per-stream workspace: the last block to
// take a ticket sets it back to zero, so no call allocates scratch or
// launches a fill. A single launch would need the SIMT kernel's split-I
// partials (8 MB a call at M = 8) or a grid-wide barrier.
//
// FFMA (float32, M >= 128, every inner width a multiple of 64, operands
// 16-byte aligned; fused_out_ln_ffma_launch / fused_ffn_ln_ffma_launch):
// the launch sequence of the tensor-core route below in f32, its
// products on ffma_tile.cuh's register-tiled core (8 x 8 outputs a
// thread at 128 x 128, cp.async k stages, no split over K) with the
// epilogue fused into the product kernel. At M = 2048 (BERT) the SIMT
// kernel's split-I partials are 151 MB a call; here hid (M, I) f32 is
// written once and read once (25 MB, mostly L2). The tile (128 x 128,
// 128 x 64 or 64 x 64) is chosen per product by the wrapper
// (ffma_tiles): the largest whose grid fills its waves of resident
// blocks: a part-empty last wave leaves SMs idle, which costs more than
// a smaller tile's lower FMA rate.
//
// Tensor cores (bf16, every inner width a multiple of 64, operands
// 16-byte aligned; fused_out_ln_tc_launch / fused_ffn_ln_tc_launch):
// the products run on wgmma fed by TMA (wgmma_tile.cuh), 128 x 128
// output tiles, no split over K, so every output element is summed by
// one warpgroup in one fixed order; one persistent block an SM walks
// the tiles, its producer loading the next tile during the epilogue. At
// the training shape the products are compute bound (68.7 GFLOP for the
// FFN, 989 TFLOP/s); what the design keeps off device memory is the
// split-I partial sums of the SIMT route (537 MB a call at M = 1024), at
// the price of hid's round trip:
//   fused_ffn_ln: [pre: xn = round(LN(x)), ln_rows_kernel]
//                 hid = round(act(xn|x @ W1 + b1))        tc_gemm MODE 0
//                 y = res + dropout_p(hid @ W2 + b2)      tc_gemm MODE 1
//                 [post: out = LN(y) from its f32 copy, ln_rows_kernel]
//     hid (M, I) goes through device memory in bf16, 16 MB at M = 1024
//     (mostly L2), written and read once. The TPU kernel keeps a (bm, H)
//     f32 sum and walks I; a (64, 2048) f32 sum is 512 KB, beyond an
//     SM, and recomputing hid per column tile (fused_ffn.cu's design)
//     multiplies the first product by H / 128. Two launches on one
//     stream order the phases without flags.
//   fused_out_ln: z = res + dropout_p(a @ W + b) (z in bf16 and f32)
//                 h = LN(z) from the f32 copy, ln_rows_kernel
//     The LN is a second launch, a block a row over every SM, rather
//     than the last-arriving tile of a row tile: at M = 1024 the ticket
//     would leave the whole LN (8 MB of f32 rows) to M / 128 = 8 blocks.
// Dropout takes the element's global (row, col) from the accumulator
// fragment (wgmma_tile.cuh), so its mask is the SIMT route's bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "block_gemm.cuh"
#include "ffn_common.cuh"
#include "row_norm.cuh"
#include "stream_gemm.cuh"

namespace {

constexpr int BM = 32;  // rows per tile

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

// LN(zf[row]) * ln_s + ln_b -> h[row] for the BM rows from row0, a warp
// a row, two-pass statistics; zf is read back from L2 (other blocks
// wrote it). h may alias zf: a lane writes only elements it read itself.
template <typename T>
__device__ __forceinline__ void ln_rows(const float* zf, T* h,
                                        const float* __restrict__ ln_s,
                                        const float* __restrict__ ln_b,
                                        int row0, int M, int N, float eps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
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
                  float eps, Drop drop) {
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
  gemm_tile<BM, OL_BN, OL_TM, OL_TN>(a, K, M, row0, w, N, N, col0, k0, k1, acc,
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
        const float zv =
            drop.apply(acc[i][j] + to_f(b[col]), row, col, N) + to_f(res[e]);
        zf[e] = zv;
        if constexpr (!std::is_same<T, float>::value) z[e] = from_f<T>(zv);
      }
    }
  }

  // the last z tile of this row tile normalises the whole rows
  if (!last_arrival(tickets, n_row * n_col + mt, n_col, &flag)) return;
  ln_rows<T>(zf, h, ln_s, ln_b, row0, M, N, eps);
}

// ---------------------------------------------------------------------------
// fused_ffn_ln
// ---------------------------------------------------------------------------
constexpr int FF_BN = 128;  // output columns per chunk of the 2nd GEMM
constexpr int FF_TM = 4, FF_TN = 4;

template <typename T, int BI, bool PRE>
__global__ void __launch_bounds__(kThreads)
    ffn_kernel(const T* __restrict__ x, const T* __restrict__ w1,
               const T* __restrict__ b1, const T* __restrict__ w2,
               const T* __restrict__ b2, const T* __restrict__ res,
               const float* __restrict__ ln_s,
               const float* __restrict__ ln_b, T* out, float* zf,
               float* part, int* tickets, int M, int H, int I, int act,
               int norm, float eps, Drop drop) {
  constexpr int TM1 = BI == 64 ? 2 : 4, TN1 = 4;
  constexpr int WCOLS = BI > FF_BN ? BI : FF_BN;
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][WCOLS];
  __shared__ float hid[BM][BI + 1];
  __shared__ float mu_s[PRE ? BM : 1], rs_s[PRE ? BM : 1];
  __shared__ int flag;
  const int ji = blockIdx.x, mt = blockIdx.y;
  const int nI = gridDim.x, n_row = gridDim.y;
  const int row0 = mt * BM, i0 = ji * BI;
  const int tid = threadIdx.x;

  // norm "pre" (1, PRE): the statistics of this tile's rows of x
  if constexpr (PRE) {
    const int lane = tid & 31, warp = tid >> 5;
    for (int r = warp; r < BM; r += kThreads / 32) {
      const int row = row0 + r;
      float mean = 0.f, rstd = 0.f;
      if (row < M) {
        const T* xr = x + (size_t)row * H;
        float s = 0.f;
        for (int c = lane; c < H; c += 32) s += to_f(xr[c]);
        mean = warp_sum(s) / H;
        float sq = 0.f;
        for (int c = lane; c < H; c += 32) {
          const float dv = to_f(xr[c]) - mean;
          sq += dv * dv;
        }
        rstd = 1.0f / sqrtf(warp_sum(sq) / H + eps);
      }
      if (lane == 0) mu_s[r] = mean, rs_s[r] = rstd;
    }
    __syncthreads();
  }

  // hid = act([LN] x[rows] @ W1[:, i0:i0+BI] + b1), kept on chip
  {
    float acc[TM1][TN1] = {};
    gemm_tile<BM, BI, TM1, TN1, PRE>(
        x, H, M, row0, w1, I, I, i0, 0, H, acc, As,
        reinterpret_cast<float(*)[BI]>(&Bs[0][0]),
        RowNorm{mu_s, rs_s, ln_s, ln_b});
    const int tx = tid % (BI / TN1), ty = tid / (BI / TN1);
#pragma unroll
    for (int i = 0; i < TM1; ++i)
#pragma unroll
      for (int j = 0; j < TN1; ++j) {
        const int c = tx * TN1 + j;
        // rounded to x's type before the second product, as the
        // reference's hid is (the identity for float)
        hid[ty * TM1 + i][c] =
            i0 + c < I ? to_f(from_f<T>(activate(act, acc[i][j] +
                                                  to_f(b1[i0 + c]))))
                       : 0.f;
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
        const size_t e = (size_t)row * H + col;
        const float zv =
            drop.apply(s + to_f(b2[col]), row, col, H) + to_f(res[e]);
        if (norm == 2)
          zf[e] = zv;  // normalised below, by the row tile's last chunk
        else
          out[e] = from_f<T>(zv);
      }
    }
    // norm "post" (2): the last chunk of this row tile normalises it
    if (norm == 2 &&
        last_arrival(tickets, n_row * n_chunks + mt, n_chunks, &flag))
      ln_rows<T>(zf, out, ln_s, ln_b, row0, M, H, eps);
  }
}

template <typename T>
int out_ln_run(const void* a, const void* w, const void* b, const void* res,
               const float* ln_s, const float* ln_b, void* z, float* zf,
               void* h, float* part, int* tickets, int M, int K, int N,
               int kc, float eps, Drop drop, cudaStream_t st) {
  const dim3 grid((N + OL_BN - 1) / OL_BN, (M + BM - 1) / BM,
                  (K + kc - 1) / kc);
  out_ln_kernel<T><<<grid, kThreads, 0, st>>>(
      (const T*)a, (const T*)w, (const T*)b, (const T*)res, ln_s, ln_b,
      (T*)z, zf, (T*)h, part, tickets, M, K, N, kc, eps, drop);
  return (int)cudaGetLastError();
}

template <typename T, int BI, bool PRE>
int ffn_launch(dim3 grid, const void* x, const void* w1, const void* b1,
               const void* w2, const void* b2, const void* res,
               const float* ln_s, const float* ln_b, void* out, float* zf,
               float* part, int* tickets, int M, int H, int I, int act,
               int norm, float eps, Drop drop, cudaStream_t st) {
  ffn_kernel<T, BI, PRE><<<grid, kThreads, 0, st>>>(
      (const T*)x, (const T*)w1, (const T*)b1, (const T*)w2, (const T*)b2,
      (const T*)res, ln_s, ln_b, (T*)out, zf, part, tickets, M, H, I, act,
      norm, eps, drop);
  return (int)cudaGetLastError();
}

template <typename T>
int ffn_run(const void* x, const void* w1, const void* b1, const void* w2,
            const void* b2, const void* res, const float* ln_s,
            const float* ln_b, void* out, float* zf, float* part,
            int* tickets, int M, int H, int I, int bi, int act, int norm,
            float eps, Drop drop, cudaStream_t st) {
  if (bi != 64 && bi != 128) return (int)cudaErrorInvalidValue;
  const dim3 grid((I + bi - 1) / bi, (M + BM - 1) / BM);
  auto launch = bi == 64 ? (norm == 1 ? ffn_launch<T, 64, true>
                                      : ffn_launch<T, 64, false>)
                         : (norm == 1 ? ffn_launch<T, 128, true>
                                      : ffn_launch<T, 128, false>);
  return launch(grid, x, w1, b1, w2, b2, res, ln_s, ln_b, out, zf, part,
                tickets, M, H, I, act, norm, eps, drop, st);
}

// ---------------------------------------------------------------------------
// the tensor-core route (bf16): the LN rows kernel beside block_gemm.cuh's
// tc_gemm
// ---------------------------------------------------------------------------
// out[row] = LN(in[row]) * s + b rounded to TO: a block a row, four
// columns a thread, two-pass statistics in f32 (the reference's _ln_f32)
// summed in block_sum's fixed order; the second and third reads of the
// row hit L1. N % 4 == 0, rows 16-byte aligned.
template <typename TI, typename TO>
__global__ void __launch_bounds__(512)
    ln_rows_kernel(const TI* __restrict__ in, TO* __restrict__ out,
                   const float* __restrict__ s, const float* __restrict__ b,
                   int N, float eps) {
  __shared__ float red[32];
  const TI* p = in + (size_t)blockIdx.x * N;
  const int c0 = 4 * threadIdx.x, step = 4 * blockDim.x;
  float sum = 0.f;
  for (int c = c0; c < N; c += step) {
    float v[4];
    row_norm::load4(p, c, v);
    sum += (v[0] + v[1]) + (v[2] + v[3]);
  }
  const float mean = row_norm::block_sum(sum, red) / N;
  float sq = 0.f;
  for (int c = c0; c < N; c += step) {
    float v[4];
    row_norm::load4(p, c, v);
#pragma unroll
    for (int i = 0; i < 4; ++i) sq += (v[i] - mean) * (v[i] - mean);
  }
  const float rstd = 1.0f / sqrtf(row_norm::block_sum(sq, red) / N + eps);
  TO* q = out + (size_t)blockIdx.x * N;
  for (int c = c0; c < N; c += step) {
    float v[4];
    row_norm::load4(p, c, v);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = (v[i] - mean) * rstd * s[c + i] + b[c + i];
    row_norm::store4(q, c, v);
  }
}

template <typename TI, typename TO>
int ln_rows_run(const TI* in, TO* out, const float* s, const float* b, int M,
                int N, float eps, cudaStream_t st) {
  ln_rows_kernel<TI, TO><<<M, row_norm::threads_for(N), 0, st>>>(
      in, out, s, b, N, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// The tensor-core route, bfloat16 only (a/w/b/res/z/h; ln_s, ln_b, zf
// f32): K and N multiples of 64, a, w, b, res, z, zf, h 16-byte aligned.
// zf: (M, N) f32 scratch. Launches the product with its epilogue, then the
// LN. Returns a cudaError_t, or 10001 / 10002 when the TMA descriptor
// encoder is missing / refuses a matrix.
extern "C" int fused_out_ln_tc_launch(const void* a, const void* w,
                                      const void* b, const void* res,
                                      const float* ln_s, const float* ln_b,
                                      void* z, float* zf, void* h, int M,
                                      int K, int N, int seed, int drop,
                                      unsigned int thr, float keep_div,
                                      float eps, void* stream) {
  if (M < 1 || K % 64 || N % 64 || K < 64 || N < 64)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const TcEpi ep{(const bf16*)b, (const bf16*)res, (bf16*)z, zf, 0,
                 Drop{(uint32_t)seed, thr, drop, keep_div}};
  int err = tc_gemm<1>(a, w, M, N, K, ep, st);
  if (err != 0) return err;
  return ln_rows_run<float>(zf, (bf16*)h, ln_s, ln_b, M, N, eps, st);
}

// The tensor-core route of fused_ffn_ln, bfloat16 only: H and I
// multiples of 64, every pointer 16-byte aligned. Scratch the caller
// allocates: hid (M, I) bf16; xn (M, H) bf16 with norm "pre"; zf (M, H)
// f32 with norm "post" (null otherwise). act, norm as fused_ffn_ln_launch.
extern "C" int fused_ffn_ln_tc_launch(
    const void* x, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* res, const float* ln_s, const float* ln_b,
    void* out, void* xn, void* hid, float* zf, int M, int H, int I, int act,
    int norm, int seed, int drop, unsigned int thr, float keep_div,
    float eps, void* stream) {
  if (act < 0 || act > 2 || norm < 0 || norm > 2 || M < 1 || H % 64 ||
      I % 64 || H < 64 || I < 64 || (norm == 1 && !xn) ||
      (norm == 2 && !zf))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = 0;
  const void* src = x;
  if (norm == 1) {
    err = ln_rows_run<bf16>((const bf16*)x, (bf16*)xn, ln_s, ln_b, M, H,
                            eps, st);
    if (err != 0) return err;
    src = xn;
  }
  const TcEpi up{(const bf16*)b1, nullptr, (bf16*)hid, nullptr, act,
                 Drop{0, 0, 0, 1.f}};
  err = tc_gemm<0>(src, w1, M, I, H, up, st);
  if (err != 0) return err;
  const Drop d{(uint32_t)seed, thr, drop, keep_div};
  const TcEpi down{(const bf16*)b2, (const bf16*)res,
                   norm == 2 ? nullptr : (bf16*)out, norm == 2 ? zf : nullptr,
                   0, d};
  err = tc_gemm<1>(hid, w2, M, H, I, down, st);
  if (err != 0 || norm != 2) return err;
  return ln_rows_run<float>(zf, (bf16*)out, ln_s, ln_b, M, H, eps, st);
}

// The FFMA route, float32 only: M >= 1 (the wrapper sends M >= 128),
// K and N multiples of 64, a, w, b, res, z, h 16-byte aligned. The
// product with its epilogue writes z, then the LN reads z and writes h.
// tile as ffma_gemm. Returns a cudaError_t.
extern "C" int fused_out_ln_ffma_launch(const float* a, const float* w,
                                        const float* b, const float* res,
                                        const float* ln_s, const float* ln_b,
                                        float* z, float* h, int M, int K,
                                        int N, int tile, int seed, int drop,
                                        unsigned int thr, float keep_div,
                                        float eps, void* stream) {
  if (M < 1 || K % 64 || N % 64 || K < 64 || N < 64)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const FfmaEpi ep{b, res, z, 0, Drop{(uint32_t)seed, thr, drop, keep_div}};
  const int err = ffma_gemm<1>(a, w, M, N, K, tile, ep, st);
  if (err != 0) return err;
  return ln_rows_run<float>(z, h, ln_s, ln_b, M, N, eps, st);
}

// The FFMA route of fused_ffn_ln, float32 only: H and I multiples of 64,
// every pointer 16-byte aligned. Scratch the caller allocates: hid
// (M, I); xn (M, H) with norm "pre"; zf (M, H) with norm "post" (null
// otherwise). tile1 / tile2: the tiles of the (M, I) and (M, H)
// products. act, norm as fused_ffn_ln_launch.
extern "C" int fused_ffn_ln_ffma_launch(
    const float* x, const float* w1, const float* b1, const float* w2,
    const float* b2, const float* res, const float* ln_s, const float* ln_b,
    float* out, float* xn, float* hid, float* zf, int M, int H, int I,
    int tile1, int tile2, int act, int norm, int seed, int drop,
    unsigned int thr, float keep_div, float eps, void* stream) {
  if (act < 0 || act > 2 || norm < 0 || norm > 2 || M < 1 || H % 64 ||
      I % 64 || H < 64 || I < 64 || (norm == 1 && !xn) ||
      (norm == 2 && !zf))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = 0;
  const float* src = x;
  if (norm == 1) {
    err = ln_rows_run<float>(x, xn, ln_s, ln_b, M, H, eps, st);
    if (err != 0) return err;
    src = xn;
  }
  const FfmaEpi up{b1, nullptr, hid, act, Drop{0, 0, 0, 1.f}};
  err = ffma_gemm<0>(src, w1, M, I, H, tile1, up, st);
  if (err != 0) return err;
  const FfmaEpi down{b2, res, norm == 2 ? zf : out, 0,
                     Drop{(uint32_t)seed, thr, drop, keep_div}};
  err = ffma_gemm<1>(hid, w2, M, H, I, tile2, down, st);
  if (err != 0 || norm != 2) return err;
  return ln_rows_run<float>(zf, out, ln_s, ln_b, M, H, eps, st);
}

// The stream route, float32 only: K and N multiples of 64, a, w, b, res,
// z, h 16-byte aligned. One launch: z = res + dropout(a @ W + b), then h
// = LN(z) by the last column tile of each row tile. splits: the K splits
// (ops/fused_block.py stream_splits); part, tickets: the per-stream
// workspace of stream_gemm::run. Returns a cudaError_t.
extern "C" int fused_out_ln_stream_launch(
    const float* a, const float* w, const float* b, const float* res,
    const float* ln_s, const float* ln_b, float* z, float* h, float* part,
    int* tickets, int M, int K, int N, int splits, int seed, int drop,
    unsigned int thr, float keep_div, float eps, void* stream) {
  if (!ln_s || !ln_b) return (int)cudaErrorInvalidValue;
  const stream_gemm::Epi ep{b,    res,  z,   h,
                            ln_s, ln_b, 0,   eps,
                            Drop{(uint32_t)seed, thr, drop, keep_div}};
  return stream_gemm::run<1>(a, w, ep, part, tickets, M, K, N, splits,
                             static_cast<cudaStream_t>(stream));
}

// The stream route of fused_ffn_ln, float32 only: H and I multiples of
// 64, every pointer 16-byte aligned. Scratch from the caller's per-stream
// workspace: hid (M, I); xn (M, H) with norm "pre" (null otherwise);
// part, tickets as stream_gemm::run. splits1 / splits2: the K splits of
// the (M, I) and (M, H) products. With norm "post" the output is
// normalised in place. act, norm as fused_ffn_ln_launch.
extern "C" int fused_ffn_ln_stream_launch(
    const float* x, const float* w1, const float* b1, const float* w2,
    const float* b2, const float* res, const float* ln_s, const float* ln_b,
    float* out, float* xn, float* hid, float* part, int* tickets, int M,
    int H, int I, int splits1, int splits2, int act, int norm, int seed,
    int drop, unsigned int thr, float keep_div, float eps, void* stream) {
  if (act < 0 || act > 2 || norm < 0 || norm > 2 || (norm == 1 && !xn) ||
      (norm != 0 && (!ln_s || !ln_b)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = 0;
  const float* src = x;
  if (norm == 1) {
    if (M < 1 || H % 64 || H < 64) return (int)cudaErrorInvalidValue;
    err = ln_rows_run<float>(x, xn, ln_s, ln_b, M, H, eps, st);
    if (err != 0) return err;
    src = xn;
  }
  const stream_gemm::Epi up{b1,      nullptr, hid, nullptr,
                            nullptr, nullptr, act, eps,
                            Drop{0, 0, 0, 1.f}};
  err = stream_gemm::run<0>(src, w1, up, part, tickets, M, H, I, splits1,
                            st);
  if (err != 0) return err;
  const stream_gemm::Epi down{b2,
                              res,
                              out,
                              out,
                              norm == 2 ? ln_s : nullptr,
                              norm == 2 ? ln_b : nullptr,
                              0,
                              eps,
                              Drop{(uint32_t)seed, thr, drop, keep_div}};
  return stream_gemm::run<1>(hid, w2, down, part, tickets, M, I, H, splits2,
                             st);
}

// dtype: 0 float32, 1 bfloat16 (a/w/b/res/z/h); ln_s, ln_b, zf, part f32.
// With float32, zf is z. drop != 0 applies the mask of (seed, thr) to
// a @ W + b and divides the kept elements by keep_div = 1 - p.
extern "C" int fused_out_ln_launch(const void* a, const void* w,
                                   const void* b, const void* res,
                                   const float* ln_s, const float* ln_b,
                                   void* z, float* zf, void* h, float* part,
                                   int* tickets, int M, int K, int N, int kc,
                                   int dtype, int seed, int drop,
                                   unsigned int thr, float keep_div,
                                   float eps, void* stream) {
  if (kc <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Drop d{(uint32_t)seed, thr, drop, keep_div};
  if (dtype == 0)
    return out_ln_run<float>(a, w, b, res, ln_s, ln_b, z, zf, h, part,
                             tickets, M, K, N, kc, eps, d, st);
  if (dtype == 1)
    return out_ln_run<__nv_bfloat16>(a, w, b, res, ln_s, ln_b, z, zf, h,
                                     part, tickets, M, K, N, kc, eps, d, st);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 float32, 1 bfloat16 (x/w1/b1/w2/b2/res/out); ln_s, ln_b, zf,
// part f32. act: 0 gelu_tanh, 1 gelu (erf polynomial), 2 relu. norm: 0
// none (ln_s, ln_b, zf unused), 1 pre, 2 post (zf: (M, H) f32 scratch,
// out itself with float32). tickets: (M/32) * (H/128) + (M/32) zeros.
extern "C" int fused_ffn_ln_launch(
    const void* x, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* res, const float* ln_s, const float* ln_b,
    void* out, float* zf, float* part, int* tickets, int M, int H, int I,
    int bi, int dtype, int act, int norm, int seed, int drop,
    unsigned int thr, float keep_div, float eps, void* stream) {
  if (act < 0 || act > 2 || norm < 0 || norm > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Drop d{(uint32_t)seed, thr, drop, keep_div};
  if (dtype == 0)
    return ffn_run<float>(x, w1, b1, w2, b2, res, ln_s, ln_b, out, zf, part,
                          tickets, M, H, I, bi, act, norm, eps, d, st);
  if (dtype == 1)
    return ffn_run<__nv_bfloat16>(x, w1, b1, w2, b2, res, ln_s, ln_b, out,
                                  zf, part, tickets, M, H, I, bi, act, norm,
                                  eps, d, st);
  return (int)cudaErrorInvalidValue;
}
