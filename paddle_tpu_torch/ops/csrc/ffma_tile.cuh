// Register-tiled f32 GEMM core on the CUDA cores (FFMA) for Hopper
// (sm_90a): the sums of one BM x BN output tile of C = A @ B, A (M, K)
// and B (K, N) both f32 and row-major, K and N multiples of 64, A and B
// 16-byte aligned; rows of A past M and columns of B past N read as 0.
// Used by fused_block.cu's f32 route of fused_out_ln / fused_ffn_ln at
// token-batch shapes (M >= 128), which adds the epilogues.
//
// f32 stays full precision (no TF32), so the bound is the CUDA cores'
// 67 TFLOP/s: at M = 256..2048 rows the sub-blocks do 40-250 FMAs per
// byte they must move, far above the card's 10 (67 TFLOP/s over 3.35
// TB/s), so they are compute bound and what matters is that the FMA
// units, not shared memory, set the pace:
//   * 256 threads as a 16 x 16 grid; thread (ty, tx) owns the rows
//     g * 64 + i * 16 + ty (i < 4) and the columns h * 64 + tx * 4 +
//     [0, 4) of the tile, g < BM / 64, h < BN / 64: an 8 x 8 micro-tile
//     at 128 x 128 (8 x 4 at 128 x 64, 4 x 4 at 64 x 64), so each k step
//     reads 16 words of shared memory for 64 FMAs at 128 x 128. A warp
//     is 4 x 8 threads: its B reads are 8 contiguous float4 and its A
//     reads 4 consecutive rows, each one wavefront.
//   * A stays row-major in shared memory (BM x BK) and is read as float4
//     along k, four k steps a read: the same words per FMA as a k-major
//     copy, without the transpose that cp.async cannot do (a copy through
//     registers that transposes would hold the stage's loads in
//     registers across the FMAs).
//   * A ring of STAGES k stages of BK = 32, filled by 16-byte cp.async.cg
//     copies (zero-filled past M and N): one __syncthreads a stage, the
//     copy of stage t + STAGES - 1 in flight during the FMAs of stage t.
//     (BK = 16 ran slower on the H100: twice the barriers a k step.)
//   * No split over K: every output element is one thread's fmaf chain
//     in k order, so two runs give the same bits.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace ffma_tile {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int BK = 32;         // k depth of a stage
constexpr int STAGES = 3;
// A's rows in shared memory are LDA = BK + APAD floats apart: the four
// consecutive rows a warp reads at once fall in distinct banks, and each
// row stays 16-byte aligned for cp.async
constexpr int APAD = 4;
constexpr int LDA = BK + APAD;

// Shared memory of a BM x BN tile's ring: A [STAGES][BM][LDA], then B
// [STAGES][BK][BN]: 102 KB at 128 x 128, 78 KB at 128 x 64, 51 KB at
// 64 x 64.
template <int BM, int BN>
constexpr int smem_bytes() {
  return STAGES * (BM * LDA + BK * BN) * (int)sizeof(float);
}

__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The thread's place in the 16 x 16 grid: a warp is 4 rows x 8 columns
// of threads, so its B reads are 8 distinct float4 (128 contiguous
// bytes) and its A reads 4 distinct rows (below), one wavefront each.
__device__ __forceinline__ int thread_y() {
  return (threadIdx.x / 64) * 4 + (threadIdx.x % 32) / 8;
}
__device__ __forceinline__ int thread_x() {
  return (threadIdx.x / 32) % 2 * 8 + threadIdx.x % 8;
}
// Row of the tile that the thread's accumulator row g * 4 + i holds:
// rows 16 apart, so a warp's four ty read consecutive rows of A, which
// LDA puts in distinct banks.
__device__ __forceinline__ int tile_row(int g, int i, int ty) {
  return g * 64 + i * 16 + ty;
}
// First of the four columns of the tile that accumulator columns h * 4
// .. h * 4 + 3 hold.
__device__ __forceinline__ int tile_col(int h, int tx) {
  return h * 64 + tx * 4;
}

// Issues the copies of the k stage at kb into As (BM x BK) and Bs
// (BK x BN), 16 bytes a copy: BM * BK / 1024 of A and BK * BN / 1024 of
// B a thread, a warp's copies covering contiguous rows.
template <int BM, int BN>
__device__ __forceinline__ void load_stage(float* As, float* Bs,
                                           const float* A, const float* B,
                                           int M, int N, int K, int row0,
                                           int col0, int kb) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < BM * BK / (4 * kThreads); ++i) {
    const int e = tid + i * kThreads;
    const int r = e / (BK / 4), c = (e % (BK / 4)) * 4;
    const bool ok = row0 + r < M;
    cp16(As + r * LDA + c, ok ? A + (size_t)(row0 + r) * K + kb + c : A, ok);
  }
#pragma unroll
  for (int i = 0; i < BK * BN / (4 * kThreads); ++i) {
    const int e = tid + i * kThreads;
    const int r = e / (BN / 4), c = (e % (BN / 4)) * 4;
    const bool ok = col0 + c < N;
    cp16(Bs + r * BN + c, ok ? B + (size_t)(kb + r) * N + col0 + c : B, ok);
  }
}

// acc[g * 4 + i][h * 4 + j] = sum over k of A[row0 + tile_row(g, i, ty),
// k] * B[k, col0 + tile_col(h, tx) + j], k = 0 .. K-1 in order. `smem`
// holds smem_bytes<BM, BN>() and is 16-byte aligned.
template <int BM, int BN>
__device__ __forceinline__ void mainloop(
    const float* __restrict__ A, const float* __restrict__ B, int M, int N,
    int K, int row0, int col0, float (&acc)[BM / 16][BN / 16],
    float* smem) {
  static_assert(BM % 64 == 0 && BN % 64 == 0, "64-row/column groups");
  constexpr int RG = BM / 64, CG = BN / 64;
  float* As = smem;
  float* Bs = smem + STAGES * BM * LDA;
  const int ty = thread_y(), tx = thread_x();
  const int nk = K / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_stage<BM, BN>(As + s * BM * LDA, Bs + s * BK * BN, A, B, M, N, K,
                         row0, col0, s * BK);
    commit();  // an empty group past nk keeps the count uniform
  }
  for (int t = 0; t < nk; ++t) {
    wait_pending<STAGES - 2>();  // this thread's copies of stage t landed
    __syncthreads();  // everyone's have, and stage t - 1 is consumed
    const int f = t + STAGES - 1;
    if (f < nk)
      load_stage<BM, BN>(As + (f % STAGES) * BM * LDA,
                         Bs + (f % STAGES) * BK * BN, A, B, M, N, K, row0,
                         col0, f * BK);
    commit();
    const float* as = As + (t % STAGES) * BM * LDA;
    const float* bs = Bs + (t % STAGES) * BK * BN;
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float a[4 * RG][4];
#pragma unroll
      for (int g = 0; g < RG; ++g)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(
              as + tile_row(g, i, ty) * LDA + k4);
          a[g * 4 + i][0] = v.x, a[g * 4 + i][1] = v.y;
          a[g * 4 + i][2] = v.z, a[g * 4 + i][3] = v.w;
        }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float b[4 * CG];
#pragma unroll
        for (int h = 0; h < CG; ++h) {
          const float4 v = *reinterpret_cast<const float4*>(
              bs + (k4 + kk) * BN + tile_col(h, tx));
          b[h * 4] = v.x, b[h * 4 + 1] = v.y;
          b[h * 4 + 2] = v.z, b[h * 4 + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < 4 * RG; ++i)
#pragma unroll
          for (int j = 0; j < 4 * CG; ++j)
            acc[i][j] = fmaf(a[i][kk], b[j], acc[i][j]);
      }
    }
  }
  wait_pending<0>();
}

}  // namespace ffma_tile
