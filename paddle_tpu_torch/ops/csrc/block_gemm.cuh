// The GEMM cores of this directory's token-batch routes, with their fused
// epilogues, shared by fused_block.cu (B rows 2-3: fused_out_ln,
// fused_ffn_ln) and fused_ffn.cu (B row 10: fused_ffn):
//
//   tc_gemm<MODE>    bf16 C = A @ B on wgmma fed by TMA (wgmma_tile.cuh),
//                    128 x 128 tiles, one persistent block an SM;
//   ffma_gemm<MODE>  f32 C = A @ B on the register-tiled FFMA core
//                    (ffma_tile.cuh), the tile picked by the caller.
//
// Neither splits K: every output element is summed by one thread (or one
// warpgroup's fragment) in one fixed order, so reruns give the same bits.
// The epilogue MODE says what a tile does with its f32 sums:
//   0  out = round(act(acc + bias))          the FFNs' hid
//   1  y = res + dropout(acc + bias)         fused_out_ln's z, fused_ffn_ln's
//                                            output (to zf in f32 and/or out)
//   2  out = round(acc + bias)               fused_ffn's output: no residual
//                                            load and no dropout hash
// (round is to bf16 on the tensor cores, the identity in f32.)
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dropout_hash.cuh"
#include "ffma_tile.cuh"
#include "ffn_common.cuh"
#include "wgmma_tile.cuh"

namespace {

// Dropout of a GEMM output: keep where the hash of (seed, element id)
// >= thr, kept elements divided by keep_div = 1 - p.
struct Drop {
  uint32_t seed, thr;
  int on;  // p > 0
  float keep_div;
  __device__ __forceinline__ float apply(float y, int row, int col,
                                         int ncols) const {
    if (!on) return y;
    return dropout_hash::keep(seed, row, col, ncols, thr) ? y / keep_div
                                                           : 0.f;
  }
};

// ---------------------------------------------------------------------------
// the tensor-core route (bf16)
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
namespace wt = wgmma_tile;

// What a tile does with its f32 sums. MODE 0: out = round(act(acc +
// bias)) (the FFNs' hid). MODE 1: y = res + dropout(acc + bias),
// written to zf (f32) and/or out (bf16) where not null. MODE 2: out =
// round(acc + bias) (res, zf, act and drop unused).
struct TcEpi {
  const bf16* bias;
  const bf16* res;
  bf16* out;
  float* zf;
  int act;
  Drop drop;
};

// Bias, then activation, dropout + residual or nothing, and the stores of
// one consumer warpgroup's 64 x 128 sums at (m0, n0). Every load comes
// first: the outputs may alias the inputs as far as the compiler knows,
// so a load after a store would wait for it, one global round trip per
// column.
template <int MODE>
__device__ __forceinline__ void tc_epilogue(const float (&acc)[64],
                                            const TcEpi& ep, int m0, int n0,
                                            int M, int N) {
  const int t = threadIdx.x & 127;
  const int row0 = m0 + (t >> 5) * 16 + ((t & 31) >> 2);
  const int col0 = n0 + 2 * (t & 3);
  __nv_bfloat162 bias[16], res[16][2];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = col0 + 8 * j;  // N % 64 == 0: col + 1 < N as well
    if (col < N)
      bias[j] = *reinterpret_cast<const __nv_bfloat162*>(ep.bias + col);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (MODE == 1 && col < N && row0 + 8 * h < M)
        res[j][h] = *reinterpret_cast<const __nv_bfloat162*>(
            ep.res + (size_t)(row0 + 8 * h) * N + col);
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = col0 + 8 * j;
    if (col >= N) continue;
    const float2 b = __bfloat1622float2(bias[j]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= M) continue;
      const size_t e = (size_t)row * N + col;
      float v0 = acc[4 * j + 2 * h] + b.x;
      float v1 = acc[4 * j + 2 * h + 1] + b.y;
      if constexpr (MODE == 0) {
        *reinterpret_cast<__nv_bfloat162*>(ep.out + e) =
            __floats2bfloat162_rn(activate(ep.act, v0),
                                  activate(ep.act, v1));
      } else if constexpr (MODE == 2) {
        *reinterpret_cast<__nv_bfloat162*>(ep.out + e) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        const float2 r = __bfloat1622float2(res[j][h]);
        v0 = ep.drop.apply(v0, row, col, N) + r.x;
        v1 = ep.drop.apply(v1, row, col + 1, N) + r.y;
        if (ep.zf) *reinterpret_cast<float2*>(ep.zf + e) = make_float2(v0, v1);
        if (ep.out)
          *reinterpret_cast<__nv_bfloat162*>(ep.out + e) =
              __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(wt::kThreads, 1)
    tc_gemm_kernel(const __grid_constant__ CUtensorMap ta,
                   const __grid_constant__ CUtensorMap tb, int M, int N,
                   int K, TcEpi ep) {
  extern __shared__ uint8_t smem_raw[];
  const wt::Ring ring = wt::make_ring(smem_raw);
  // tiles in column-major order (row tiles fastest: the blocks running
  // at once share W's column tiles), dealt round-robin to the blocks
  const int n_row = (M + wt::BM - 1) / wt::BM;
  const int tiles = n_row * ((N + wt::BN - 1) / wt::BN);
  const int nk = K / wt::BK;
  const int wg = threadIdx.x / 128;
  wt::Pipe<> pipe;
  if (wg == 2) {  // the producer warpgroup: one thread issues every load
    if (threadIdx.x == 256)
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
        wt::produce(ring, pipe, &ta, &tb, tile % n_row * wt::BM,
                    tile / n_row * wt::BN, nk);
    return;
  }
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    float acc[64];
    wt::consume(ring, pipe, wg, nk, acc);
    tc_epilogue<MODE>(acc, ep, tile % n_row * wt::BM + wg * 64,
                      tile / n_row * wt::BN, M, N);
  }
}

// C (M, N) = A (M, K) @ B (K, N), both bf16 row-major, through the
// epilogue MODE.
template <int MODE>
int tc_gemm(const void* a, const void* b, int M, int N, int K,
            const TcEpi& ep, cudaStream_t st) {
  CUtensorMap ta, tb;
  int err = wt::map_2d(&ta, a, M, K, wt::BM);
  if (err == 0) err = wt::map_2d(&tb, b, K, N, wt::BK);
  if (err != 0) return err;
  auto kern = tc_gemm_kernel<MODE>;
  err = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, wt::SMEM_BYTES);
  if (err != 0) return err;
  int dev = 0, sms = 0;
  err = (int)cudaGetDevice(&dev);
  if (err == 0)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (err != 0) return err;
  const long tiles = (long)((M + wt::BM - 1) / wt::BM) *
                     ((N + wt::BN - 1) / wt::BN);
  const int grid = (int)(tiles < sms ? tiles : sms);  // one block an SM
  kern<<<grid, wt::kThreads, wt::SMEM_BYTES, st>>>(ta, tb, M, N, K, ep);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the FFMA route (float32, M >= 128)
// ---------------------------------------------------------------------------
namespace ft = ffma_tile;
// Blocks an SM each tile shape is compiled for: its register cap is
// 65536 / (256 * blocks), 128 at the 128-row tiles (the 8 x 8 tile fits
// without spills) and 85 at 64 x 64. ops/fused_block.py _FFMA_BLOCKS
// counts with the same numbers; shared memory allows them (2 x 102 KB,
// 2 x 78 KB, 3 x 51 KB).
template <int BM, int BN>
constexpr int ffma_blocks() {
  return BM == 64 ? 3 : 2;
}

// What a tile does with its f32 sums, tc_epilogue's modes in f32. MODE
// 0: out = act(acc + bias) (the FFNs' hid; rounding it to x's type is
// the identity). MODE 1: out = res + dropout(acc + bias). MODE 2: out =
// acc + bias (res, act and drop unused).
struct FfmaEpi {
  const float* bias;
  const float* res;
  float* out;
  int act;
  Drop drop;
};

// Bias, then activation, dropout + residual or nothing (MODE 2: the
// residual is never loaded), and the float4 stores of one
// thread's micro-tile (ffma_tile.cuh's layout), ER rows at a time:
// every load of a group comes before its stores (the outputs may alias
// the inputs as far as the compiler knows). ER is 2 at 128 x 128, where
// four rows of residual beside the 64 sums would spill under the
// 128-register cap. Dropout hashes the element's global (row, col) of
// the (M, N) output: keep_mask's bits.
template <int MODE, int RG, int CG>
__device__ __forceinline__ void ffma_epilogue(
    const float (&acc)[4 * RG][4 * CG], const FfmaEpi& ep, int row0,
    int col0, int M, int N) {
  constexpr int ER = RG * CG == 4 ? 2 : 4;
  const int ty = ft::thread_y(), tx = ft::thread_x();
  float4 bias[CG];
#pragma unroll
  for (int h = 0; h < CG; ++h) {
    const int col = col0 + ft::tile_col(h, tx);  // N % 64 == 0: +3 < N
    bias[h] = col < N ? *reinterpret_cast<const float4*>(ep.bias + col)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int q = 0; q < 4 * RG; q += ER) {
    const int g = q / 4;
    float4 res[ER][CG];
#pragma unroll
    for (int u = 0; u < ER; ++u)
#pragma unroll
      for (int h = 0; h < CG; ++h) {
        const int i = q % 4 + u;
        const int row = row0 + ft::tile_row(g, i, ty);
        const int col = col0 + ft::tile_col(h, tx);
        res[u][h] = MODE == 1 && row < M && col < N
                        ? *reinterpret_cast<const float4*>(
                              ep.res + (size_t)row * N + col)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
    for (int u = 0; u < ER; ++u)
#pragma unroll
      for (int h = 0; h < CG; ++h) {
        const int i = q % 4 + u;
        const int row = row0 + ft::tile_row(g, i, ty);
        const int col = col0 + ft::tile_col(h, tx);
        if (row >= M || col >= N) continue;
        float v[4] = {acc[g * 4 + i][h * 4] + bias[h].x,
                      acc[g * 4 + i][h * 4 + 1] + bias[h].y,
                      acc[g * 4 + i][h * 4 + 2] + bias[h].z,
                      acc[g * 4 + i][h * 4 + 3] + bias[h].w};
        if constexpr (MODE == 0) {
#pragma unroll
          for (int c = 0; c < 4; ++c) v[c] = activate(ep.act, v[c]);
        } else if constexpr (MODE == 1) {
          const float r[4] = {res[u][h].x, res[u][h].y, res[u][h].z,
                              res[u][h].w};
#pragma unroll
          for (int c = 0; c < 4; ++c)
            v[c] = ep.drop.apply(v[c], row, col + c, N) + r[c];
        }
        *reinterpret_cast<float4*>(ep.out + (size_t)row * N + col) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
  }
}

// One BM x BN tile of C = A @ B a block (grid: row tiles fastest, so the
// blocks resident at once share B's column tiles), then the epilogue.
template <int MODE, int BM, int BN>
__global__ void __launch_bounds__(ft::kThreads, ffma_blocks<BM, BN>())
    ffma_gemm_kernel(const float* __restrict__ a,
                     const float* __restrict__ b, int M, int N, int K,
                     FfmaEpi ep) {
  extern __shared__ __align__(16) float ffma_smem[];
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  float acc[BM / 16][BN / 16] = {};
  ft::mainloop<BM, BN>(a, b, M, N, K, row0, col0, acc, ffma_smem);
  ffma_epilogue<MODE, BM / 64, BN / 64>(acc, ep, row0, col0, M, N);
}

template <int MODE, int BM, int BN>
int ffma_run(const float* a, const float* b, int M, int N, int K,
             const FfmaEpi& ep, cudaStream_t st) {
  auto kern = ffma_gemm_kernel<MODE, BM, BN>;
  constexpr int smem = ft::smem_bytes<BM, BN>();
  const int err = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != 0) return err;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  kern<<<grid, ft::kThreads, smem, st>>>(a, b, M, N, K, ep);
  return (int)cudaGetLastError();
}

// C (M, N) = A (M, K) @ B (K, N) through the epilogue MODE, on the tile
// `tile` picks (ops/fused_block.py ffma_tiles): 0 128 x 128, 1 128 x 64,
// 2 64 x 64.
template <int MODE>
int ffma_gemm(const float* a, const float* b, int M, int N, int K, int tile,
              const FfmaEpi& ep, cudaStream_t st) {
  if (tile == 0) return ffma_run<MODE, 128, 128>(a, b, M, N, K, ep, st);
  if (tile == 1) return ffma_run<MODE, 128, 64>(a, b, M, N, K, ep, st);
  if (tile == 2) return ffma_run<MODE, 64, 64>(a, b, M, N, K, ep, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
