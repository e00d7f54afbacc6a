// The transformer FFN for Hopper (sm_90a), f32 or bf16 inputs with f32
// accumulation:
//     y = act(x @ W1 + b1) @ W2 + b2     x (M, H), W1 (H, I), W2 (I, H)
// Replaces paddle_tpu/ops/pallas_ffn.py:_ffn_kernel (launched by
// _ffn_fwd_impl). Its arithmetic, as the reference's: a = x @ W1 summed
// in f32, plus b1 widened to f32; hid = act(a) in f32, then ROUNDED TO
// x's TYPE (so in bf16 the second product sees bf16 hid); acc += hid @
// W2 in f32; y = acc + b2, rounded to x's type. act: gelu_tanh, gelu
// (the reference's A&S erf polynomial) or relu (ffn_common.cuh).
//
// Three routes, picked by the wrapper before the launch from the dtype,
// the row count, the widths and the pointers' alignment, with the rules
// of rows 2-3 (ops/fused_block.py tc_route, ffma_route, ffma_tiles):
//
//   tc    bf16, H and I multiples of 64, 16-byte aligned operands
//         (fused_ffn_tc_launch): two products on block_gemm.cuh's
//         tensor-core core (wgmma fed by TMA, 128 x 128 tiles, one
//         persistent block an SM), hid (M, I) through device memory in
//         bf16:  hid = round(act(x @ W1 + b1))   tc_gemm MODE 0
//                y   = round(hid @ W2 + b2)      tc_gemm MODE 2
//   ffma  f32, M >= 128, the same widths and alignment
//         (fused_ffn_ffma_launch): the same two launches in f32 on
//         block_gemm.cuh's register-tiled FFMA core, each product on the
//         tile the wrapper picks (ffma_tiles: 128 x 128 and 128 x 64 at
//         the preset M = 8192, H = 768, I = 3072 on 132 SMs); hid (M, I)
//         in f32 through device memory.
//   simt  everything else: f32 under 128 rows, widths that are not
//         multiples of 64, misaligned views (fused_ffn_launch, below).
//
// hid's round trip. The TPU kernel keeps hid in VMEM; the tc and ffma
// routes write it once and read it once (100.7 MB at the preset in f32,
// 50.3 MB in bf16, 16.8 MB at GPT-3 XL width M = 1024 in bf16), the
// trade rows 2-3 make: a block that kept its rows' hid on chip would own
// all of H (a (128, 768) f32 sum is 384 KB, beyond an SM) or recompute
// hid per column tile, as the SIMT kernel does. Neither product splits
// K, so every element is summed in one fixed order: identical bits run
// to run.
//
// The SIMT kernel. Its point is the TPU kernel's: the (M, I)
// intermediate never reaches device memory, with CUDA's blocks in place
// of the TPU's sequential grid. A block owns ROWS rows of the output and
// a column tile [c0, c0 + h_tile) of it, with that (ROWS, h_tile) f32
// accumulator in shared memory (up to 128 KB, dynamic shared memory). It
// walks I in chunks of 128: first
//     hid = act(x[rows] @ W1[:, chunk] + b1[chunk])   (ROWS, 128)
// into shared memory in x's type (the tile GEMM of ffn_common.cuh, x and
// W1 staged through shared memory in k stages of 32), then
//     acc += hid @ W2[chunk, c0:c0+h_tile]
// 256 output columns at a time, W2 staged through shared memory with the
// next stage prefetched into registers, each thread adding its 4 x 8 (or
// 2 x 8) register sums into the accumulator elements it alone owns. At
// the end it adds b2, rounds and stores. No partial sum touches device
// memory, there are no atomics, and every sum runs in a fixed order:
// identical bits run to run. The launcher picks the tiles from M, H and
// the card's SM count (pick_tiles): ROWS is 32 when that gives every SM
// a block and the accumulator of all of H fits, else 16; H wider than the
// accumulator (128 KB: 1024 columns at ROWS = 32, 2048 at 16) is split
// into column tiles, and so is H when the row blocks leave more than half
// the SMs idle (GPT-3 XL width, M = 1024: 64 row blocks become 128). Each
// column tile recomputes its rows' hid: the first GEMM once per tile.
//
// Bound on this card at the preset shape M = 8192, H = 768, I = 3072:
// 2 GEMMs of 2*M*H*I = 77.3 GFLOP, so operations bind: 1.15 ms in f32 at
// 67 TFLOP/s (CUDA cores; TF32 off), 0.078 ms in bf16 at the tensor
// cores' 989 TFLOP/s; the bytes (x, W1, W2, y once: 69 MB in f32) take
// 0.021 ms. PERF.md holds each route's times.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "block_gemm.cuh"
#include "ffn_common.cuh"

namespace {

constexpr int FI = 128;   // I columns per chunk
constexpr int FN = 256;   // output columns per pass of the second GEMM
constexpr int kMaxSmem = 232448;  // the opt-in maximum of an H100 block
constexpr int kAccFloats = 32768;  // a block's f32 accumulator: 128 KB

template <int ROWS>
constexpr size_t smem_bytes(int h_tile) {
  return sizeof(float) *
         ((size_t)ROWS * h_tile + ROWS * FI + BK * ROWS + BK * FN);
}

template <typename T, int ROWS>
__global__ void __launch_bounds__(kThreads)
    ffn_kernel(const T* __restrict__ x, const T* __restrict__ w1,
               const T* __restrict__ b1, const T* __restrict__ w2,
               const T* __restrict__ b2, T* __restrict__ y, int M, int H,
               int I, int h_tile, int act) {
  constexpr int TM = ROWS / 8;  // rows per thread in both GEMMs
  static_assert(TM * 8 * 32 == ROWS * 32 && kThreads == 256, "layout");
  // the weight stage first, so its float4 reads are 16-byte aligned
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;                                    // [BK][FI or FN]
  float(*Bs)[FN] = reinterpret_cast<float(*)[FN]>(bs);
  float(*hid)[FI] = reinterpret_cast<float(*)[FI]>(bs + BK * FN);
  float(*As)[ROWS] = reinterpret_cast<float(*)[ROWS]>(&hid[0][0] + ROWS * FI);
  float* acc = &As[0][0] + BK * ROWS;                  // [ROWS][h_tile]

  const int tid = threadIdx.x;
  const int tx = tid % 32, ty = tid / 32;
  const int row0 = blockIdx.x * ROWS;
  const int c0 = blockIdx.y * h_tile;
  const int hw = min(h_tile, H - c0);
  // this thread's columns of an FN pass: two runs of 4, 128 apart, so a
  // warp's float4 reads of a shared row are free of bank conflicts
  auto col_of = [&](int j) { return (j < 4 ? 0 : 128) + tx * 4 + (j & 3); };

  for (int n0 = 0; n0 < hw; n0 += FN)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + col_of(j);
        if (col < hw) acc[(ty * TM + i) * h_tile + col] = 0.f;
      }

  for (int i0 = 0; i0 < I; i0 += FI) {
    // hid = act(x[rows] @ W1[:, i0:i0+FI] + b1), rounded to T; the tile
    // GEMM's first barrier also retires the previous chunk's reads of hid
    {
      float a[TM][4] = {};
      gemm_tile<ROWS, FI, TM, 4>(x, H, M, row0, w1, I, I, i0, 0, H, a, As,
                                 reinterpret_cast<float(*)[FI]>(bs));
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = i0 + tx * 4 + j;
          hid[ty * TM + i][tx * 4 + j] =
              c < I ? to_f(from_f<T>(activate(act, a[i][j] + to_f(b1[c]))))
                    : 0.f;
        }
    }

    // acc[:, c0:c0+hw] += hid @ W2[i0:i0+kmax, c0:c0+hw]
    const int kmax = min(FI, I - i0);
    const int nk = (kmax + BK - 1) / BK;
    for (int n0 = 0; n0 < hw; n0 += FN) {
      float r[TM][8] = {};
      float pre[BK];  // a thread loads column tid of each stage's rows
      const int col = n0 + tid, gcol = c0 + col;
      auto load = [&](int kb) {
#pragma unroll
        for (int q = 0; q < BK; ++q) {
          const int k = kb + q;
          pre[q] = (k < kmax && col < hw)
                       ? to_f(w2[(size_t)(i0 + k) * H + gcol]) : 0.f;
        }
      };
      load(0);
      for (int t = 0; t < nk; ++t) {
        __syncthreads();  // hid written / the previous stage consumed
#pragma unroll
        for (int q = 0; q < BK; ++q) Bs[q][tid] = pre[q];
        __syncthreads();
        if (t + 1 < nk) load((t + 1) * BK);
        const int kb = t * BK;
#pragma unroll 4
        for (int kk = 0; kk < BK; ++kk) {
          float av[TM], bv[8];
#pragma unroll
          for (int i = 0; i < TM; ++i) av[i] = hid[ty * TM + i][kb + kk];
          const float4 lo = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
          const float4 hi =
              *reinterpret_cast<const float4*>(&Bs[kk][128 + tx * 4]);
          bv[0] = lo.x, bv[1] = lo.y, bv[2] = lo.z, bv[3] = lo.w;
          bv[4] = hi.x, bv[5] = hi.y, bv[6] = hi.z, bv[7] = hi.w;
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) r[i][j] += av[i] * bv[j];
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = n0 + col_of(j);
          if (c < hw) acc[(ty * TM + i) * h_tile + c] += r[i][j];
        }
    }
  }

  // y = acc + b2, from the elements this thread owns
  for (int n0 = 0; n0 < hw; n0 += FN)
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = row0 + ty * TM + i;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = n0 + col_of(j);
        if (c < hw)
          y[(size_t)row * H + c0 + c] = from_f<T>(
              acc[(ty * TM + i) * h_tile + c] + to_f(b2[c0 + c]));
      }
    }
}

// (rows, h_tile) of a block for (M, H) on a card of `sms` SMs.
void pick_tiles(int M, int H, int sms, int* rows, int* h_tile) {
  const int r =
      ((M + 31) / 32 >= sms && H <= kAccFloats / 32) ? 32 : 16;
  const int row_blocks = (M + r - 1) / r;
  int tiles = (H + kAccFloats / r - 1) / (kAccFloats / r);
  // more row blocks than half the SMs, or no tile narrower than one pass
  int fill = sms / row_blocks;
  if (fill > (H + FN - 1) / FN) fill = (H + FN - 1) / FN;
  if (fill > tiles) tiles = fill;
  *rows = r;
  *h_tile = (H + tiles - 1) / tiles;
}

template <typename T, int ROWS>
int ffn_run(const void* x, const void* w1, const void* b1, const void* w2,
            const void* b2, void* y, int M, int H, int I, int h_tile,
            int act, cudaStream_t st) {
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      ffn_kernel<T, ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (opt_in != cudaSuccess) return (int)opt_in;
  const dim3 grid((M + ROWS - 1) / ROWS, (H + h_tile - 1) / h_tile);
  ffn_kernel<T, ROWS><<<grid, kThreads, smem_bytes<ROWS>(h_tile), st>>>(
      (const T*)x, (const T*)w1, (const T*)b1, (const T*)w2, (const T*)b2,
      (T*)y, M, H, I, h_tile, act);
  return (int)cudaGetLastError();
}

}  // namespace

// The tiles fused_ffn_launch picks on a card of `sms` SMs: out[0] rows,
// out[1] h_tile.
extern "C" int fused_ffn_tiles(int* out, int M, int H, int sms) {
  if (M < 1 || H < 1 || sms < 1) return (int)cudaErrorInvalidValue;
  pick_tiles(M, H, sms, &out[0], &out[1]);
  return 0;
}

// dtype: 0 float32, 1 bfloat16 (x, w1, b1, w2, b2, y). act: 0 gelu_tanh,
// 1 gelu (erf polynomial), 2 relu.
extern "C" int fused_ffn_launch(const void* x, const void* w1,
                                const void* b1, const void* w2,
                                const void* b2, void* y, int M, int H, int I,
                                int dtype, int act, void* stream) {
  if (M < 1 || H < 1 || I < 1 || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  int dev, sms, rows, h_tile;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  pick_tiles(M, H, sms, &rows, &h_tile);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return rows == 32
               ? ffn_run<float, 32>(x, w1, b1, w2, b2, y, M, H, I, h_tile,
                                    act, st)
               : ffn_run<float, 16>(x, w1, b1, w2, b2, y, M, H, I, h_tile,
                                    act, st);
  if (dtype == 1)
    return rows == 32 ? ffn_run<__nv_bfloat16, 32>(x, w1, b1, w2, b2, y, M,
                                                   H, I, h_tile, act, st)
                      : ffn_run<__nv_bfloat16, 16>(x, w1, b1, w2, b2, y, M,
                                                   H, I, h_tile, act, st);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core route, bfloat16 only: H and I multiples of 64, every
// pointer 16-byte aligned. hid: (M, I) bf16 scratch the caller
// allocates. act as fused_ffn_launch. Returns a cudaError_t, or 10001 /
// 10002 when the TMA descriptor encoder is missing / refuses a matrix.
extern "C" int fused_ffn_tc_launch(const void* x, const void* w1,
                                   const void* b1, const void* w2,
                                   const void* b2, void* y, void* hid, int M,
                                   int H, int I, int act, void* stream) {
  if (act < 0 || act > 2 || M < 1 || H % 64 || I % 64 || H < 64 || I < 64)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Drop none{0, 0, 0, 1.f};
  const TcEpi up{(const bf16*)b1, nullptr, (bf16*)hid, nullptr, act, none};
  const int err = tc_gemm<0>(x, w1, M, I, H, up, st);
  if (err != 0) return err;
  const TcEpi down{(const bf16*)b2, nullptr, (bf16*)y, nullptr, 0, none};
  return tc_gemm<2>(hid, w2, M, H, I, down, st);
}

// The FFMA route, float32 only: H and I multiples of 64, every pointer
// 16-byte aligned (the wrapper sends M >= 128). hid: (M, I) f32 scratch
// the caller allocates. tile1 / tile2: the tiles of the (M, I) and
// (M, H) products, as ffma_gemm takes them. act as fused_ffn_launch.
extern "C" int fused_ffn_ffma_launch(const float* x, const float* w1,
                                     const float* b1, const float* w2,
                                     const float* b2, float* y, float* hid,
                                     int M, int H, int I, int tile1,
                                     int tile2, int act, void* stream) {
  if (act < 0 || act > 2 || M < 1 || H % 64 || I % 64 || H < 64 || I < 64)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Drop none{0, 0, 0, 1.f};
  const FfmaEpi up{b1, nullptr, hid, act, none};
  const int err = ffma_gemm<0>(x, w1, M, I, H, tile1, up, st);
  if (err != 0) return err;
  const FfmaEpi down{b2, nullptr, y, 0, none};
  return ffma_gemm<2>(hid, w2, M, H, I, tile2, down, st);
}
