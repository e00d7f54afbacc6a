// The weight-streaming f32 GEMM core of the sub-blocks' decode route
// ("stream", fused_block.cu): C (M, N) = A (M, K) @ W (K, N) for a few
// dozen rows at most (decode: M = the slot count, 8; the short prefill
// buckets), A and W f32 and row-major, K and N multiples of 64, A and W
// 16-byte aligned, then one of two epilogues:
//   MODE 0  out = act(acc + bias)                  fused_ffn_ln's hid
//   MODE 1  out = res + dropout(acc + bias)        fused_out_ln's z,
//           [h = LN(out) * ln_s + ln_b]            fused_ffn_ln's output
//
// Bound: bytes. At M = 8 the product does 2 FMAs per weight element, far
// below the card's 10 FLOP a byte, so the time is W's stream from device
// memory: 16.8 MB for fused_out_ln at GPT-3 XL width (5 us at 3.35 TB/s),
// 67 MB for each FFN product (20 us). What the design is for is keeping
// enough of that stream in flight, with little work and no padding
// around it:
//   * A block owns a slice of kCols = 32 columns of W (128 bytes a row)
//     and a range of K. The grid is (row tiles, N / 32, splits): the
//     row tiles of a slice are neighbours (they share its stream in L2)
//     and the K splits (ops/fused_block.py stream_splits, from the shapes
//     and the SM count) bring the grid to about two blocks an SM.
//   * The slice streams through a ring of kStages stages of kStage = 64
//     rows (8 KB of W) filled by 16-byte cp.async.cg, three in flight
//     while one is used: 48 KB in flight an SM with two blocks, against
//     the ~25 KB Little's law asks at 3.35 TB/s. The A rows of the same
//     K range (from L2) ride in the same stage.
//   * Thread (kg, c4) of 256 owns the float4 c4 of the slice and the
//     two k rows 2 kg, 2 kg + 1 of every stage (kRowsPer = 2 at 32
//     columns), with accumulators for the MR rows of its row tile: MR is
//     4, 8 or 16 by M (rows_a_pass), so decode's 8 rows are not padded
//     to a 32-row tile. A stage costs a thread 2 float4 and MR float2
//     shared loads for 8 MR FMAs.
//   * The 32 k groups are summed in a fixed order (shuffles across the
//     four of a warp, then the eight warps through shared memory). With
//     splits, each block writes its partial (MR, 32) sums, and the last
//     block of the column tile to take its ticket adds the splits in
//     split order and applies the epilogue.
//   * With an LN, that block also writes each row's (mean, M2) over its
//     32 columns (a warp holds one row's 32 columns: two shuffle sums),
//     and the last column tile of a row tile to take a second ticket
//     combines a row's n / 32 pairs in slice order (Chan et al.'s
//     pairwise update, equal counts) and normalises the tile's rows with
//     every thread, eight independent float4 reads of z from L2 before
//     their stores. (One warp a row in three dependent passes over z,
//     the SIMT kernels' way, left 11 us of tail at M = 8, N = 2048.)
//   * No float atomics: two runs give the same bits. The last block to
//     take a ticket sets it back to zero, so the tickets, partials and
//     statistics live in a per-stream workspace of the caller's, with
//     no fill launch and no allocation a call.
#pragma once
#include <cuda_runtime.h>

#include "block_gemm.cuh"
#include "ffma_tile.cuh"
#include "ffn_common.cuh"

namespace stream_gemm {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 32;    // W columns a block (a multiple of 32)
constexpr int kStage = 64;   // k rows a stage
constexpr int kStages = 4;   // the ring: 3 stages in flight
constexpr int kC4 = kCols / 4;          // threads a W row (float4 each)
constexpr int kGroups = kThreads / kC4; // k groups
constexpr int kRowsPer = kStage / kGroups;  // k rows a group, a stage
static_assert(kRowsPer % 2 == 0 && kC4 <= 32, "thread layout");

// Rows of a row tile (the accumulators a thread column holds): mirrored
// by ops/fused_block.py stream_rows.
__host__ __device__ constexpr int rows_a_pass(int M) {
  return M <= 4 ? 4 : M <= 8 ? 8 : 16;
}

// The ring: W [kStages][kStage][kCols], then A [kStages][MR][kStage].
// After the k loop it holds the eight warps' sums [kWarps][MR][kCols].
template <int MR>
constexpr int smem_bytes() {
  return kStages * (kStage * kCols + MR * kStage) * (int)sizeof(float);
}

// What a block does with its f32 sums. MODE 0: out = act(acc + bias).
// MODE 1: out = res + dropout(acc + bias); then, where ln_s is not null,
// h = LN(out) * ln_s + ln_b over whole rows (h may be out itself).
struct Epi {
  const float* bias;
  const float* res;
  float* out;
  float* h;
  const float* ln_s;
  const float* ln_b;
  int act;
  float eps;
  Drop drop;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Block-wide "am I the last of `total` arrivals at tickets[idx]?" after
// this block's global writes; the last one sets the ticket back to zero
// for the next launch on the stream. Callers return (block-uniformly) if
// not.
__device__ __forceinline__ bool last_to_arrive(int* tickets, int idx,
                                               int total, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool last = atomicAdd(&tickets[idx], 1) == total - 1;
    if (last) tickets[idx] = 0;
    *flag = last;
  }
  __syncthreads();
  const bool last = *flag;
  if (last) __threadfence();
  return last;
}

// h = LN(z) * s + b over the rows row0 .. row0 + MR - 1 below M (s and b
// 16-byte aligned), from
// the (mean, M2) of each row's 32-column slices in `stats` (row-major,
// N / 32 a row): a warp a row combines them in slice order, then every
// thread normalises float4s of the tile (rows contiguous in z and h),
// eight reads of z from L2 before their stores. h may alias z: each
// element is stored by the thread that read it, after its read.
template <int MR>
__device__ __forceinline__ void ln_tile(const float* z, float* h,
                                        const float2* stats,
                                        const float* __restrict__ s,
                                        const float* __restrict__ b,
                                        int row0, int M, int N, float eps,
                                        float* mu, float* rs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slices = N / 32;
  for (int r = warp; r < MR; r += kWarps) {
    const int row = row0 + r;
    if (row >= M) break;
    const float2* st = stats + (size_t)row * slices;
    float sum = 0.f;
    for (int j = lane; j < slices; j += 32) sum += __ldcg(st + j).x;
    const float mean = warp_sum(sum) / slices;  // equal counts
    float m2 = 0.f;
    for (int j = lane; j < slices; j += 32) {
      const float2 v = __ldcg(st + j);
      const float d = v.x - mean;
      m2 += v.y + 32.f * d * d;
    }
    const float var = warp_sum(m2) / N;
    if (lane == 0) mu[r] = mean, rs[r] = 1.0f / sqrtf(var + eps);
  }
  __syncthreads();
  const int n4 = N / 4, total = min(MR, M - row0) * n4;
  const float4* z4 = reinterpret_cast<const float4*>(z + (size_t)row0 * N);
  float4* h4 = reinterpret_cast<float4*>(h + (size_t)row0 * N);
  const float4* s4 = reinterpret_cast<const float4*>(s);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  for (int base = threadIdx.x; base < total; base += 8 * kThreads) {
    float4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = base + u * kThreads;
      if (i < total) v[u] = __ldcg(z4 + i);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = base + u * kThreads;
      if (i >= total) continue;
      const int r = i / n4, k = i % n4;
      const float m = mu[r], q = rs[r];
      const float4 sv = s4[k], bv = b4[k];
      h4[i] = make_float4((v[u].x - m) * q * sv.x + bv.x,
                          (v[u].y - m) * q * sv.y + bv.y,
                          (v[u].z - m) * q * sv.z + bv.z,
                          (v[u].w - m) * q * sv.w + bv.w);
    }
  }
}

template <int MR, int MODE>
__global__ void __launch_bounds__(kThreads, 2)
    stream_kernel(const float* __restrict__ A, const float* __restrict__ W,
                  Epi ep, float* part, int* tickets, int M, int K, int N,
                  int kc) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int flag;
  __shared__ float row_mu[MR], row_rs[MR];
  const int rt = blockIdx.x, cs = blockIdx.y, sp = blockIdx.z;
  const int n_rt = gridDim.x, n_cs = gridDim.y, splits = gridDim.z;
  const int row0 = rt * MR, col0 = cs * kCols;
  const int k0 = sp * kc, k1 = min(K, k0 + kc);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c4 = tid % kC4, kg = tid / kC4;
  float* Ws = smem;
  float* As = smem + kStages * kStage * kCols;
  const int nst = (k1 - k0) / kStage;  // K and kc are multiples of kStage

  auto issue = [&](int t) {
    const int kb = k0 + t * kStage;
    float* ws = Ws + (t % kStages) * kStage * kCols;
    float* as = As + (t % kStages) * MR * kStage;
#pragma unroll
    for (int i = 0; i < kStage * kC4 / kThreads; ++i) {
      const int p = tid + i * kThreads;
      const int r = p / kC4, c = (p % kC4) * 4;
      ffma_tile::cp16(ws + r * kCols + c, W + (size_t)(kb + r) * N + col0 + c,
                      true);
    }
    constexpr int a_pieces = MR * kStage / 4;
#pragma unroll
    for (int i = 0; i < (a_pieces + kThreads - 1) / kThreads; ++i) {
      const int p = tid + i * kThreads;
      if (p < a_pieces) {
        const int r = p / (kStage / 4), c = (p % (kStage / 4)) * 4;
        const bool ok = row0 + r < M;  // rows past M read as 0
        ffma_tile::cp16(as + r * kStage + c,
                        ok ? A + (size_t)(row0 + r) * K + kb + c : A, ok);
      }
    }
  };

  // thread (kg, c4): W's float4 c4 of the slice, the k rows kg * kRowsPer
  // ... + kRowsPer - 1 of each stage, the MR rows of the row tile
  float acc[MR][4] = {};
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < nst) issue(t);
    ffma_tile::commit();
  }
  for (int t = 0; t < nst; ++t) {
    // stage t has landed; every thread is done with stage t - 1, whose
    // slot the next copy refills
    ffma_tile::wait_pending<kStages - 2>();
    __syncthreads();
    if (t + kStages - 1 < nst) issue(t + kStages - 1);
    ffma_tile::commit();
    const float* ws = Ws + (t % kStages) * kStage * kCols + 4 * c4;
    const float* as = As + (t % kStages) * MR * kStage + kRowsPer * kg;
#pragma unroll
    for (int j = 0; j < kRowsPer; j += 2) {
      const int k = kRowsPer * kg + j;
      const float4 w0 = *reinterpret_cast<const float4*>(ws + k * kCols);
      const float4 w1 =
          *reinterpret_cast<const float4*>(ws + (k + 1) * kCols);
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        const float2 a =
            *reinterpret_cast<const float2*>(as + m * kStage + j);
        acc[m][0] = fmaf(a.y, w1.x, fmaf(a.x, w0.x, acc[m][0]));
        acc[m][1] = fmaf(a.y, w1.y, fmaf(a.x, w0.y, acc[m][1]));
        acc[m][2] = fmaf(a.y, w1.z, fmaf(a.x, w0.z, acc[m][2]));
        acc[m][3] = fmaf(a.y, w1.w, fmaf(a.x, w0.w, acc[m][3]));
      }
    }
  }
  ffma_tile::wait_pending<0>();  // the trailing (empty) groups
  __syncthreads();               // the ring is free for the warp sums

  // the k groups of a warp (lanes kC4 apart), then the eight warps in
  // order
  float* red = smem;
#pragma unroll
  for (int m = 0; m < MR; ++m) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int off = kC4; off < 32; off <<= 1)
        acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], off);
    if (lane < kC4)
      *reinterpret_cast<float4*>(red + (warp * MR + m) * kCols + 4 * lane) =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  }
  __syncthreads();
  // output i of this thread: row row0 + idx / kCols, column col0 + idx %
  // kCols (a warp: 32 contiguous columns of one row)
  constexpr int kOut = (MR * kCols + kThreads - 1) / kThreads;
  float sum[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) {
    const int idx = tid + i * kThreads;
    float v = 0.f;
    if (idx < MR * kCols)
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += red[w * MR * kCols + idx];
    sum[i] = v;
  }
  auto valid = [&](int i) {  // warp-uniform
    const int idx = tid + i * kThreads;
    return idx < MR * kCols && row0 + idx / kCols < M;
  };
  auto elem = [&](int i) {
    const int idx = tid + i * kThreads;
    return (size_t)(row0 + idx / kCols) * N + col0 + idx % kCols;
  };

  if (splits > 1) {
#pragma unroll
    for (int i = 0; i < kOut; ++i)
      if (valid(i)) part[sp * (size_t)M * N + elem(i)] = sum[i];
    if (!last_to_arrive(tickets, rt * n_cs + cs, splits, &flag)) return;
#pragma unroll
    for (int i = 0; i < kOut; ++i) {
      if (!valid(i)) continue;
      float v = 0.f;
      for (int q = 0; q < splits; ++q)
        v += __ldcg(part + q * (size_t)M * N + elem(i));
      sum[i] = v;
    }
  }

#pragma unroll
  for (int i = 0; i < kOut; ++i) {
    if (!valid(i)) continue;
    const size_t e = elem(i);
    const int col = (int)(e % N), row = (int)(e / N);
    const float v = sum[i] + ep.bias[col];
    if constexpr (MODE == 0) {
      ep.out[e] = activate(ep.act, v);
    } else {
      sum[i] = ep.drop.apply(v, row, col, N) + ep.res[e];
      ep.out[e] = sum[i];
    }
  }

  if constexpr (MODE == 1) {
    if (ep.ln_s == nullptr) return;
    // each row's (mean, M2) over this block's 32-column pieces, after the
    // partials (if any) in the workspace; the last column tile of the row
    // tile normalises its rows
    float2* stats = reinterpret_cast<float2*>(
        part + (splits > 1 ? (size_t)splits * M * N : 0));
#pragma unroll
    for (int i = 0; i < kOut; ++i) {
      const bool ok = valid(i);
      const float mean = warp_sum(ok ? sum[i] : 0.f) / 32.f;
      const float d = ok ? sum[i] - mean : 0.f;
      const float m2 = warp_sum(d * d);
      if (ok && lane == 0) stats[elem(i) / 32] = make_float2(mean, m2);
    }
    // ln_s and ln_b of this slice's columns into L2 for the LN's block
    if (tid == 0) {
      asm volatile("prefetch.global.L2 [%0];" ::"l"(ep.ln_s + col0));
      asm volatile("prefetch.global.L2 [%0];" ::"l"(ep.ln_b + col0));
    }
    if (!last_to_arrive(tickets, n_rt * n_cs + rt, n_cs, &flag)) return;
    ln_tile<MR>(ep.out, ep.h, stats, ep.ln_s, ep.ln_b, row0, M, N, ep.eps,
                row_mu, row_rs);
  }
}

template <int MR, int MODE>
int launch(dim3 grid, const float* A, const float* W, const Epi& ep,
           float* part, int* tickets, int M, int K, int N, int kc,
           cudaStream_t st) {
  auto kern = stream_kernel<MR, MODE>;
  constexpr int smem = smem_bytes<MR>();
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (opt_in != cudaSuccess) return (int)opt_in;
  kern<<<grid, kThreads, smem, st>>>(A, W, ep, part, tickets, M, K, N, kc);
  return (int)cudaGetLastError();
}

// C = A (M, K) @ W (K, N) through the epilogue MODE, the K / 64 stages
// cut into `splits` ranges of ceil(stages / splits) stages (fewer run
// where that leaves a range empty; ops/fused_block.py stream_splits gives
// a count that leaves none). part: f32, (splits, M, N) partials with more
// than one split, then (M, N / 32) (mean, M2) pairs with an LN; tickets:
// ceil(M / MR) * (N / kCols + 1) int32 zeros with more than one split or
// an LN, zero again when the launch ends. Launches on one stream may
// share part and tickets; launches that may overlap may not.
template <int MODE>
int run(const float* A, const float* W, const Epi& ep, float* part,
        int* tickets, int M, int K, int N, int splits, cudaStream_t st) {
  if (M < 1 || K < kStage || K % kStage || N < kCols || N % kCols ||
      splits < 1)
    return (int)cudaErrorInvalidValue;
  const int stages = K / kStage;
  const int per = (stages + splits - 1) / splits;
  const int used = (stages + per - 1) / per;
  const bool ln = MODE == 1 && ep.ln_s != nullptr;
  if (((used > 1 || ln) && (part == nullptr || tickets == nullptr)) ||
      (ln && ep.ln_b == nullptr))
    return (int)cudaErrorInvalidValue;
  const int mr = rows_a_pass(M);
  const dim3 grid((M + mr - 1) / mr, N / kCols, used);
  const int kc = per * kStage;
  if (mr == 4)
    return launch<4, MODE>(grid, A, W, ep, part, tickets, M, K, N, kc, st);
  if (mr == 8)
    return launch<8, MODE>(grid, A, W, ep, part, tickets, M, K, N, kc, st);
  return launch<16, MODE>(grid, A, W, ep, part, tickets, M, K, N, kc, st);
}

}  // namespace stream_gemm
