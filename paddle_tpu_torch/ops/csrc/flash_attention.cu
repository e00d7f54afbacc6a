// Flash attention for Hopper (sm_90a): forward, backward dQ, backward dK/dV.
//
// Replaces the three Pallas bodies of paddle_tpu/ops/pallas_attention.py:
//   flash_fwd     <- _fwd_kernel     (launched by _flash_fwd_impl)
//   flash_bwd_dq  <- _bwd_dq_kernel  (launched by _flash_bwd)
//   flash_bwd_dkv <- _bwd_dkv_kernel (launched by _flash_bwd)
// causal or not, with an optional additive padding mask and optional
// dropout on the probabilities.
//
// Layouts (row-major, contiguous): q/do/o/dq (BH, S, D), k/v/dk/dv
// (BH, T, D) in T_ = float or bfloat16; lse/delta (BH, S) float32
// (the TPU kernel's (BH, S, 128) lane broadcast is a TPU tiling artefact);
// mask (B, T) float32, added to the scaled scores of the BH / B heads of
// its batch row (the reference's (B, 1, 1, T) padding mask; its (B, 8, T)
// sublane broadcast is again TPU tiling).
//   s   = q k^T * scale + mask [causal: col > row masked]
//   o   = (keep ? softmax(s) / (1 - p) : 0) v
//   lse = m + log(l) per row (l == 0 -> 1, as the reference)
//   pr  = exp(s - lse), delta = rowsum(do * o) (computed by the caller in
//   PyTorch, as the reference computes it in jnp)
//   ds  = pr * ((keep ? do v^T / (1 - p) : 0) - delta) * scale
//   dq  = ds k,   dk = ds^T q,   dv = (keep ? pr / (1 - p) : 0)^T do
// Dropout order: the row sum l and lse are of the UNDROPPED
// probabilities; only the product with V sees the mask, and the backward
// replays it from the seed (dropout_hash.cuh, salted with bh, counter
// row * T + col), so no mask tensor exists.
// Rounding, as the reference's kernels round: the dropped P before the
// product with V (against the running max after each of the reference's
// key blocks of rblock columns, its _auto_block choice), dS before the
// products with K and Q, and the dropped P before the product with dO, to
// the input type; sums are f32 and each output is rounded once at the
// store. In f32 the roundings are the identity.
// Two routes (ops/flash_attention.py flash_tc_route, decided before the
// launch): bf16 at D = 64 or 128 with 16-byte aligned operands runs the
// tensor-core kernels at the end of this file; everything else runs the
// SIMT kernels below (f32 FMA, no TF32; bf16 widened on load into shared
// memory).
//
// Design. A TPU grid runs in order on one core and can carry sums from
// step to step; here blocks run in parallel and in no order, so each
// sequential grid axis of the Pallas kernels becomes a loop inside one
// block, and every output tile is owned by exactly one block:
//   * flash_fwd: one block per (bh, BR-row Q tile); it walks the K/V tiles
//     up to the diagonal when causal (the `hi` of the reference) keeping
//     the running max, sum and the BR x D accumulator in registers.
//   * flash_bwd_dq: one block per Q tile, walking K/V tiles up to the
//     diagonal: dq += ds k.
//   * flash_bwd_dkv: one block per K/V tile, walking Q tiles from the
//     diagonal (the `lo` of the reference) to the end: dv += p^T do,
//     dk += ds^T q.
// dQ sums over K tiles and dK/dV over Q tiles, so one kernel that owned
// both would have to add into tiles that other blocks own (float atomics,
// an order that changes from run to run). Two kernels, each owning its
// outputs, keep every sum in a fixed order: two runs give identical bits.
//
// SIMT tiles: BR x BR (64, or 32 for head dims above 128) with 256
// threads as a 16 x 16 grid; thread (ty, tx) owns score rows ty + 16i
// and columns tx + 16j, and output columns tx + 16c. Tiles live in shared
// memory as f32 with rows padded by one word, so the 16 column-owning
// threads read 16 distinct banks. At D = 128 the dK/dV kernel holds K, V,
// Q, dO and two score tiles: 165 KB, past the 48 KB static limit, hence
// dynamic shared memory raised with cudaFuncSetAttribute per
// instantiation.
//
// Bound on this card at the training shape (B=1, H=16, T=1024, D=128,
// causal): the forward does 4 * BH * D * T^2 / 2 = 4.3 GFLOP over 16.8 MB
// of bf16 q/k/v/o: 4.3 us of bf16 tensor-core flops, 5.0 us of HBM bytes,
// so bytes bound it by a hair; the backward does 2.5x the flops over
// about twice the bytes. The SIMT kernels run on the CUDA cores (f32 FMA,
// 67 TFLOP/s peak, shared-memory operand bandwidth below that); the
// tensor-core kernels take bf16 to wgmma (989 TFLOP/s). PERF.md holds
// both routes' times against the bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "dropout_hash.cuh"
#include "wgmma_tile.cuh"

namespace {

// Dropout of the probabilities: keep where the salted hash of (seed, bh,
// element id) >= thr, kept elements divided by keep_div = 1 - p.
struct Drop {
  uint32_t seed, thr;
  int on;  // p > 0
  float keep_div;
  __device__ __forceinline__ bool kept(int bh, int row, int col,
                                       int t) const {
    return !on || dropout_hash::keep_salted(seed, bh, row, col, t, thr);
  }
  __device__ __forceinline__ float apply(float v, int bh, int row, int col,
                                         int t) const {
    if (!on) return v;
    return kept(bh, row, col, t) ? v / keep_div : 0.f;
  }
  // v as dropout leaves it, given the element's keep bit
  __device__ __forceinline__ float apply(float v, bool keep) const {
    return !on ? v : keep ? v / keep_div : 0.f;
  }
};

constexpr int kThreads = 256;  // a 16 x 16 grid of threads per tile

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

// ROWS x DMAX tile of a row-major (., D) matrix into shared memory as f32,
// row stride DMAX + 1; columns >= D read as 0.
template <typename T, int ROWS, int DMAX>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int D,
                                          float* dst) {
  constexpr int SD = DMAX + 1;
  for (int e = threadIdx.x; e < ROWS * DMAX; e += kThreads) {
    const int r = e / DMAX, c = e % DMAX;
    dst[r * SD + c] = c < D ? to_f(src[(size_t)r * D + c]) : 0.f;
  }
}

// max / sum over the 16 threads of a row (lanes tx = 0..15 of a half warp)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// s[i][j] = sum_d A[ra_i][d] * B[rb_j][d] (+ the same for a second pair
// when TWO): rows ra_i = ty + 16i of A, rb_j = tx + 16j of B.
template <int RT, int CT, int DMAX, bool TWO>
__device__ __forceinline__ void tile_dots(const float* A, const float* B,
                                          const float* A2, const float* B2,
                                          int ty, int tx, float (&s)[RT][CT],
                                          float (&s2)[RT][CT]) {
  constexpr int SD = DMAX + 1;
#pragma unroll 4
  for (int d = 0; d < DMAX; ++d) {
    float a[RT], b[CT], a2[RT], b2[CT];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      a[i] = A[(ty + 16 * i) * SD + d];
      if (TWO) a2[i] = A2[(ty + 16 * i) * SD + d];
    }
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      b[j] = B[(tx + 16 * j) * SD + d];
      if (TWO) b2[j] = B2[(tx + 16 * j) * SD + d];
    }
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        s[i][j] += a[i] * b[j];
        if (TWO) s2[i][j] += a2[i] * b2[j];
      }
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------
template <typename T, int BR, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse,
                     const float* __restrict__ mask, int heads, int S,
                     int Tk, int D, float scale, int causal, int rblock,
                     Drop drop) {
  constexpr int BC = BR, RT = BR / 16, CT = BC / 16, DT = DMAX / 16;
  constexpr int SD = DMAX + 1, SP = BC + 1;
  // bf16 rounds the dropped P before the product with V against the
  // running max after each reference key block (rblock columns, a
  // multiple of BC): a pre-pass of Q K^T over the block's tiles takes its
  // row max first. In f32 the rounding is the identity, and the max is
  // updated tile by tile.
  constexpr bool kRound = sizeof(T) == 2;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BR * SD;
  float* Vs = Ks + BC * SD;
  float* Ps = Vs + BC * SD;
  const int iq = blockIdx.x, bh = blockIdx.y;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = iq * BR;
  const T* kb = k + (size_t)bh * Tk * D;
  const T* vb = v + (size_t)bh * Tk * D;
  const float* mrow = mask ? mask + (size_t)(bh / heads) * Tk : nullptr;
  load_tile<T, BR, DMAX>(q + ((size_t)bh * S + row0) * D, D, Qs);

  float acc[RT][DT], m[RT], l[RT], m_blk[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DT; ++c) acc[i][c] = 0.f;
  }
  const int nk = Tk / BC;
  const int hi = (causal ? min(nk, (row0 + BR + BC - 1) / BC) : nk) * BC;
  const int span = kRound ? rblock : BC;
  // scaled, masked scores of this thread's rows against the tile at col0
  auto scores = [&](int col0, float (&s)[RT][CT]) {
    float unused[RT][CT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int c = 0; c < CT; ++c) s[i][c] = 0.f;
    tile_dots<RT, CT, DMAX, false>(Qs, Ks, nullptr, nullptr, ty, tx, s,
                                   unused);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int row = row0 + ty + 16 * i;
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const int col = col0 + tx + 16 * c;
        s[i][c] = (causal && col > row)
                      ? -INFINITY
                      : s[i][c] * scale + (mrow ? mrow[col] : 0.f);
      }
    }
  };
  for (int c0 = 0; c0 < hi; c0 += span) {
    const int c1 = min(c0 + span, hi);
    if constexpr (kRound) {
#pragma unroll
      for (int i = 0; i < RT; ++i) m_blk[i] = m[i];
      for (int col0 = c0; col0 < c1; col0 += BC) {
        __syncthreads();
        load_tile<T, BC, DMAX>(kb + (size_t)col0 * D, D, Ks);
        __syncthreads();
        float s[RT][CT];
        scores(col0, s);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          float mx = -INFINITY;
#pragma unroll
          for (int c = 0; c < CT; ++c) mx = fmaxf(mx, s[i][c]);
          m_blk[i] = fmaxf(m_blk[i], row_max(mx));
        }
      }
    }
    for (int col0 = c0; col0 < c1; col0 += BC) {
      __syncthreads();  // the previous tiles are no longer being read
      load_tile<T, BC, DMAX>(kb + (size_t)col0 * D, D, Ks);
      load_tile<T, BC, DMAX>(vb + (size_t)col0 * D, D, Vs);
      __syncthreads();
      float s[RT][CT];
      scores(col0, s);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int row = row0 + ty + 16 * i;
        if (!kRound) {
          float mx = -INFINITY;
#pragma unroll
          for (int c = 0; c < CT; ++c) mx = fmaxf(mx, s[i][c]);
          m_blk[i] = fmaxf(m[i], row_max(mx));
        }
        // a row masked so far keeps m = -inf; exp against 0 keeps it
        // NaN-free
        const float m_use = m_blk[i] == -INFINITY ? 0.f : m_blk[i];
        if (col0 == c0) {  // a new reference block: rescale to its max
          const float alpha = expf(m[i] - m_use);
          l[i] *= alpha;
          m[i] = m_blk[i];
#pragma unroll
          for (int c = 0; c < DT; ++c) acc[i][c] *= alpha;
        }
        float ps = 0.f;
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          const float p = expf(s[i][c] - m_use);
          // l sums the undropped p; only the product with V is dropped
          Ps[(ty + 16 * i) * SP + tx + 16 * c] = to_f(
              from_f<T>(drop.apply(p, bh, row, col0 + tx + 16 * c, Tk)));
          ps += p;
        }
        l[i] += row_sum(ps);
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < BC; ++kk) {
        float p[RT], b[DT];
#pragma unroll
        for (int i = 0; i < RT; ++i) p[i] = Ps[(ty + 16 * i) * SP + kk];
#pragma unroll
        for (int c = 0; c < DT; ++c) b[c] = Vs[kk * SD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int c = 0; c < DT; ++c) acc[i][c] += p[i] * b[c];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = row0 + ty + 16 * i;
    const float ls = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + ((size_t)bh * S + row) * D;
#pragma unroll
    for (int c = 0; c < DT; ++c) {
      const int col = tx + 16 * c;
      if (col < D) orow[col] = from_f<T>(acc[i][c] / ls);
    }
    if (tx == 0) lse[(size_t)bh * S + row] = m[i] + logf(ls);
  }
}

// ---------------------------------------------------------------------------
// backward: dq
// ---------------------------------------------------------------------------
template <typename T, int BR, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        const float* __restrict__ mask, int heads, int S,
                        int Tk, int D, float scale, int causal, Drop drop) {
  constexpr int BC = BR, RT = BR / 16, CT = BC / 16, DT = DMAX / 16;
  constexpr int SD = DMAX + 1, SP = BC + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BR * SD;
  float* Ks = dOs + BR * SD;
  float* Vs = Ks + BC * SD;
  float* DSs = Vs + BC * SD;
  const int iq = blockIdx.x, bh = blockIdx.y;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = iq * BR;
  const T* kb = k + (size_t)bh * Tk * D;
  const T* vb = v + (size_t)bh * Tk * D;
  const float* mrow = mask ? mask + (size_t)(bh / heads) * Tk : nullptr;
  load_tile<T, BR, DMAX>(q + ((size_t)bh * S + row0) * D, D, Qs);
  load_tile<T, BR, DMAX>(dout + ((size_t)bh * S + row0) * D, D, dOs);
  float lr[RT], dr[RT], acc[RT][DT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const size_t r = (size_t)bh * S + row0 + ty + 16 * i;
    lr[i] = lse[r];
    dr[i] = delta[r];
#pragma unroll
    for (int c = 0; c < DT; ++c) acc[i][c] = 0.f;
  }
  const int nk = Tk / BC;
  const int hi = causal ? min(nk, (row0 + BR + BC - 1) / BC) : nk;
  for (int j = 0; j < hi; ++j) {
    const int col0 = j * BC;
    __syncthreads();
    load_tile<T, BC, DMAX>(kb + (size_t)col0 * D, D, Ks);
    load_tile<T, BC, DMAX>(vb + (size_t)col0 * D, D, Vs);
    __syncthreads();
    float s[RT][CT] = {}, dp[RT][CT] = {};
    tile_dots<RT, CT, DMAX, true>(Qs, Ks, dOs, Vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int row = row0 + ty + 16 * i;
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const int col = col0 + tx + 16 * c;
        const float p =
            (causal && col > row)
                ? 0.f
                : expf(s[i][c] * scale + (mrow ? mrow[col] : 0.f) - lr[i]);
        const float dpd = drop.apply(dp[i][c], bh, row, col, Tk);
        // dS rounded to the input type before the product with K
        DSs[(ty + 16 * i) * SP + tx + 16 * c] =
            to_f(from_f<T>(p * (dpd - dr[i]) * scale));
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BC; ++kk) {
      float a[RT], b[DT];
#pragma unroll
      for (int i = 0; i < RT; ++i) a[i] = DSs[(ty + 16 * i) * SP + kk];
#pragma unroll
      for (int c = 0; c < DT; ++c) b[c] = Ks[kk * SD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int c = 0; c < DT; ++c) acc[i][c] += a[i] * b[c];
    }
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    T* drow = dq + ((size_t)bh * S + row0 + ty + 16 * i) * D;
#pragma unroll
    for (int c = 0; c < DT; ++c) {
      const int col = tx + 16 * c;
      if (col < D) drow[col] = from_f<T>(acc[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward: dk, dv
// ---------------------------------------------------------------------------
template <typename T, int BR, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv,
                         const float* __restrict__ mask, int heads, int S,
                         int Tk, int D, float scale, int causal, Drop drop) {
  constexpr int BC = BR, RT = BR / 16, CT = BC / 16, DT = DMAX / 16;
  constexpr int SD = DMAX + 1, SP = BC + 1;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BC * SD;
  float* Qs = Vs + BC * SD;
  float* dOs = Qs + BR * SD;
  float* Ps = dOs + BR * SD;
  float* DSs = Ps + BR * SP;
  float* Ls = DSs + BR * SP;
  float* Dl = Ls + BR;
  const int jk = blockIdx.x, bh = blockIdx.y;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int col0 = jk * BC;
  const float* mrow = mask ? mask + (size_t)(bh / heads) * Tk : nullptr;
  load_tile<T, BC, DMAX>(k + ((size_t)bh * Tk + col0) * D, D, Ks);
  load_tile<T, BC, DMAX>(v + ((size_t)bh * Tk + col0) * D, D, Vs);
  // this thread's K/V rows are ty + 16i (RT == CT: square tiles)
  float gk[CT][DT], gv[CT][DT];
#pragma unroll
  for (int i = 0; i < CT; ++i)
#pragma unroll
    for (int c = 0; c < DT; ++c) gk[i][c] = gv[i][c] = 0.f;
  const int nq = S / BR;
  const int lo = causal ? col0 / BR : 0;
  for (int iq = lo; iq < nq; ++iq) {
    const int row0 = iq * BR;
    __syncthreads();
    load_tile<T, BR, DMAX>(q + ((size_t)bh * S + row0) * D, D, Qs);
    load_tile<T, BR, DMAX>(dout + ((size_t)bh * S + row0) * D, D, dOs);
    for (int e = threadIdx.x; e < BR; e += kThreads) {
      Ls[e] = lse[(size_t)bh * S + row0 + e];
      Dl[e] = delta[(size_t)bh * S + row0 + e];
    }
    __syncthreads();
    // scores of Q rows ty + 16i against K rows tx + 16j
    float s[RT][CT] = {}, dp[RT][CT] = {};
    tile_dots<RT, CT, DMAX, true>(Qs, Ks, dOs, Vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const int cc = tx + 16 * c;
        const int row = row0 + r, col = col0 + cc;
        const float p =
            (causal && col > row)
                ? 0.f
                : expf(s[i][c] * scale + (mrow ? mrow[col] : 0.f) - Ls[r]);
        // the dropped P and dS rounded to the input type before their
        // products with dO and Q
        Ps[r * SP + cc] = to_f(from_f<T>(drop.apply(p, bh, row, col, Tk)));
        const float dpd = drop.apply(dp[i][c], bh, row, col, Tk);
        DSs[r * SP + cc] = to_f(from_f<T>(p * (dpd - Dl[r]) * scale));
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int r = 0; r < BR; ++r) {
      float p[CT], ds[CT], go[DT], qq[DT];
#pragma unroll
      for (int i = 0; i < CT; ++i) {
        p[i] = Ps[r * SP + ty + 16 * i];
        ds[i] = DSs[r * SP + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < DT; ++c) {
        go[c] = dOs[r * SD + tx + 16 * c];
        qq[c] = Qs[r * SD + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < CT; ++i)
#pragma unroll
        for (int c = 0; c < DT; ++c) {
          gv[i][c] += p[i] * go[c];
          gk[i][c] += ds[i] * qq[c];
        }
    }
  }
#pragma unroll
  for (int i = 0; i < CT; ++i) {
    const size_t row = (size_t)bh * Tk + col0 + ty + 16 * i;
#pragma unroll
    for (int c = 0; c < DT; ++c) {
      const int col = tx + 16 * c;
      if (col < D) {
        dk[row * D + col] = from_f<T>(gk[i][c]);
        dv[row * D + col] = from_f<T>(gv[i][c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the tensor-core route: bf16, D = 64 or 128, 16-byte aligned operands
// ---------------------------------------------------------------------------
// Three kernels on wgmma (wgmma_tile.cuh) fed by TMA, each a block of
// two warpgroups that own 64 rows of the block's 128-row output tile
// each. Thread 0 also feeds them: it loads the block's resident tiles
// once (Q, or Q and dO, or K and V) and streams the tiles the block walks
// through a ring of NS stages (full / empty mbarriers, as wgmma_tile's
// ring), refilling a stage once both warpgroups released it; a stage also
// carries the tile's slice of the padding mask (forward, dQ) or of lse
// and delta (dK/dV) by bulk copy. Tiles are read through 3-D tensor maps
// (BH, rows, D), so a box never reads into the next head: rows past S or
// T arrive as zeros and are masked or not stored. A tile of R rows x D
// columns sits in shared memory as D / 64 boxes of R rows x 128 bytes in
// the 128-byte swizzle; one box serves both as a K-major operand (rows =
// N or M) and as an MN-major B (rows = K), so K, V, Q and dO are never
// transposed.
//   flash_fwd: S = Q K^T (A = Q, B = K K-major), scale, padding mask,
//     causal mask (tiles past the diagonal are not walked); the row max
//     and sum over the 4 lanes that share a row (shuffles xor 1, 2); P =
//     exp(S - m) dropped and rounded to bf16 in registers is the A
//     fragment of O += P V (B = V MN-major). P is rounded against the
//     running max at the reference's key-block boundaries: a 128-column
//     block is the tile itself, a 64-column block each half of it (two
//     products, O rescaled between them), a wider block takes a pre-pass
//     of Q K^T over its tiles for the row max (+50% of the forward's
//     products at T = 1024, where the block is 512).
//   flash_bwd_dq: S = Q K^T, dP = dO V^T over K/V tiles of 64 up to the
//     diagonal; dS = P (drop(dP) - delta) scale rounded to bf16 in
//     registers; dQ += dS K (B = K MN-major).
//   flash_bwd_dkv: the scores transposed, S^T = K Q^T and dP^T = V dO^T
//     (A = K or V resident, B = Q or dO K-major) over Q tiles of 64 from
//     the diagonal: P^T and dS^T come out with keys as rows, already the
//     A fragments of dV += drop(P^T) dO and dK += dS^T Q (B = dO, Q
//     MN-major). lse and delta are read per column; the dropout counter
//     stays (q row) * T + key.
// A thread may take 255 registers (dK and dV take 64 + 64 f32 registers,
// S^T and dP^T 32 + 32). Every output tile has one owner, every sum a
// fixed order: two runs give identical bits. Causal blocks are launched
// longest first.
// Bound at the GPT-3 XL shape (above): 5.0 us of bytes for the forward,
// 6.5 and 8.7 us of bf16 tensor-core operations for dQ and dK/dV; the
// causal diagonal leaves the blocks of late Q tiles (forward, dQ) and
// early K tiles (dK/dV) the most work, so the longest block sets the
// time (PERF.md).
namespace wt = wgmma_tile;
using bf16 = __nv_bfloat16;

namespace tc {

// Two warpgroups, no producer warp: a warp more would put three warps on
// one of the SM's four register-file quarters and cap a thread at 168
// registers, where ptxas spilled and serialised the wgmma of dK/dV at
// D = 128; 256 threads leave 255.
constexpr int kThreads = 256;

struct Params {
  const float *lse_in, *delta, *mask;
  bf16 *o, *dq, *dk, *dv;
  float* lse;
  int heads, S, Tk, causal, rblock;
  float scale;
  Drop drop;
};

template <int R>
__host__ __device__ constexpr int box_bytes() {
  return R * 128;
}

// K-major descriptor: rows r0.. of a tile of R-row boxes, k-step kk
// (columns 16kk..16kk+15: box kk / 4, 32 bytes a step inside it)
template <int R>
__device__ __forceinline__ uint64_t kmaj(const uint8_t* tile, int r0,
                                         int kk) {
  return wt::desc(tile + (kk >> 2) * box_bytes<R>() + r0 * 128 +
                      (kk & 3) * 32,
                  16, 1024);
}
// MN-major B descriptor: k-rows 16kk.. of a tile of R-row boxes, N across
// its boxes (LBO: one box)
template <int R>
__device__ __forceinline__ uint64_t mnmaj(const uint8_t* tile, int kk) {
  return wt::desc(tile + kk * 16 * 128, box_bytes<R>(), 1024);
}

// the R x D tile at `row` of matrix z of `map`, D / 64 boxes, on bar
template <int R, int D>
__device__ __forceinline__ void load(uint8_t* dst, const CUtensorMap* map,
                                     int row, int z, uint64_t* bar) {
#pragma unroll
  for (int b = 0; b < D / 64; ++b)
    wt::tma_load_3d(dst + b * box_bytes<R>(), map, 64 * b, row, z, bar);
}

// Dynamic shared memory: RES bytes of resident tiles, NS stages of STAGE
// bytes, their full / empty barriers and the resident tiles' barrier.
template <int RES, int STAGE, int NS>
struct Mem {
  static constexpr int kBytes = 1024 + RES + NS * STAGE + (2 * NS + 1) * 8;
  uint8_t* res;
  uint8_t* ring;
  uint64_t *full, *empty, *resbar;
  __device__ __forceinline__ uint8_t* stage(int s) const {
    return ring + s * STAGE;
  }
  // every thread of the block calls it (it synchronises)
  __device__ __forceinline__ explicit Mem(uint8_t* raw) {
    res = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
    ring = res + RES;
    full = reinterpret_cast<uint64_t*>(ring + NS * STAGE);
    empty = full + NS;
    resbar = empty + NS;
    if (threadIdx.x == 0) {
      for (int i = 0; i < NS; ++i) {
        wt::mbar_init(&full[i], 1);   // the producer's expect_tx arrival
        wt::mbar_init(&empty[i], 2);  // one arrival per consumer warpgroup
      }
      wt::mbar_init(resbar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
};

// A consumer thread's place in its warpgroup's 64-row accumulator
// (wgmma_tile.cuh): rows r and r + 8 (h = 0, 1), columns 8j + c + e.
struct Frag {
  int r, c;
  __device__ __forceinline__ Frag()
      : r(((threadIdx.x & 127) >> 5) * 16 + ((threadIdx.x & 31) >> 2)),
        c(2 * (threadIdx.x & 3)) {}
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// A warpgroup done with its ring stage releases it; thread 0 then waits
// until both warpgroups have, and refills it through next(stage) with the
// item NS places further on (next issues nothing past the last item).
template <int NS, typename Next>
__device__ __forceinline__ void recycle(uint64_t* empty, wt::Pipe<NS>& st,
                                        Next& next) {
  if ((threadIdx.x & 127) == 0) wt::mbar_arrive(&empty[st.s]);
  if (threadIdx.x == 0) {
    wt::mbar_wait(&empty[st.s], st.ph);
    next(st.s);
  }
  st.advance();
}

// d (64 x N) = A (64 rows of a K-major tile of RA-row boxes, from row
// ra) @ B^T (an N-row K-major tile of RB-row boxes), D / 16 k-steps
template <int D, int RA, int RB, int N>
__device__ __forceinline__ void ss_product(float (&d)[N / 2],
                                           const uint8_t* a, int ra,
                                           const uint8_t* b) {
  zero(d);
  wt::fence_acc(d);
  wt::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wt::wgmma_ss<0>(d, kmaj<RA>(a, ra, kk), kmaj<RB>(b, 0, kk));
}

// d (64 x D) += A (bf16 fragments a[K0..K1)) @ B (k-rows of an MN-major
// tile of RB-row boxes); waits for the products and fences
template <int K0, int K1, int RB, int N>
__device__ __forceinline__ void rs_product(float (&d)[N / 2],
                                           uint32_t (&a)[K1 - K0][4],
                                           const uint8_t* b) {
  wt::fence_acc(d);
  wt::wgmma_fence();
#pragma unroll
  for (int kk = K0; kk < K1; ++kk)
    wt::wgmma_rs<1>(d, a[kk - K0], mnmaj<RB>(b, kk));
}

// ---------------------------------------------------------------------------
// flash_fwd
// ---------------------------------------------------------------------------
template <int D>
struct Fwd {
  static constexpr int BM = 128, BN = 128;
  static constexpr int Q_BYTES = BM * D * 2, KV_BYTES = BN * D * 2;
  static constexpr int NS = D == 64 ? 4 : 2;
  // a stage: K, V, the tile's mask columns (BN floats; 1 KB keeps the
  // stages 1024-byte aligned)
  using M = Mem<Q_BYTES, 2 * KV_BYTES + 1024, NS>;
};

// The running max m (per h) moves to mnew: o, l rescale by exp(m - mnew).
template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], float (&l)[2],
                                        float (&m)[2], const float (&mnew)[2]) {
  float alpha[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // a row masked so far keeps m = -inf; exp against 0 keeps it NaN-free
    const float mu = mnew[h] == -INFINITY ? 0.f : mnew[h];
    alpha[h] = __expf(m[h] - mu);
    l[h] *= alpha[h];
    m[h] = mnew[h];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= alpha[(i >> 1) & 1];
}

// o += round(drop(exp(s - m))) V over the tile's k-steps [K0, K1) (keys
// 16 K0 .. 16 K1 - 1); l gathers the undropped p (this thread's part).
template <int D, int K0, int K1>
__device__ __forceinline__ void pv(float (&o)[D / 2], float (&l)[2],
                                   const float (&s)[64], const float (&m)[2],
                                   const uint8_t* vt, const Frag& f,
                                   const int (&row)[2], int col0, int bh,
                                   const Params& a) {
  const float mu[2] = {m[0] == -INFINITY ? 0.f : m[0],
                       m[1] == -INFINITY ? 0.f : m[1]};
  uint32_t pa[K1 - K0][4];
#pragma unroll
  for (int kk = K0; kk < K1; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = 2 * kk + (r >> 1), h = r & 1;
      const int col = col0 + 8 * j + f.c;
      const float p0 = __expf(s[4 * j + 2 * h] - mu[h]);
      const float p1 = __expf(s[4 * j + 2 * h + 1] - mu[h]);
      l[h] += p0 + p1;
      pa[kk - K0][r] = pack(a.drop.apply(p0, bh, row[h], col, a.Tk),
                            a.drop.apply(p1, bh, row[h], col + 1, a.Tk));
    }
  rs_product<K0, K1, Fwd<D>::BN, D>(o, pa, vt);
  wt::wgmma_commit();
  wt::wgmma_wait<0>();
  wt::fence_acc(o);
#pragma unroll
  for (int kk = 0; kk < K1 - K0; ++kk) wt::fence_regs(pa[kk]);
}

// the row max over the tile's column groups [J0, J1), across the quad
template <int J0, int J1>
__device__ __forceinline__ void tile_max(const float (&s)[64],
                                         float (&mx)[2]) {
#pragma unroll
  for (int j = J0; j < J1; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      mx[h] = fmaxf(mx[h], fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, Params a) {
  using F = Fwd<D>;
  extern __shared__ uint8_t smem_raw[];
  const typename F::M mem(smem_raw);
  const int iq = a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int bh = blockIdx.y, row0 = iq * F::BM;
  const int nk = (a.Tk + F::BN - 1) / F::BN;
  const int hi =
      (a.causal ? min(nk, (row0 + F::BM + F::BN - 1) / F::BN) : nk) * F::BN;
  const bool prepass = a.rblock > F::BN;
  const int span = prepass ? a.rblock : F::BN;
  const int wg = threadIdx.x / 128;
  // the items the ring carries, in the consumers' order: for each
  // reference block, its K tiles alone when it takes a pre-pass, then its
  // K and V tiles
  const float* mrow = a.mask ? a.mask + (size_t)(bh / a.heads) * a.Tk
                             : nullptr;
  int n_c0 = 0, n_c = 0, n_v = prepass ? 0 : 1;
  auto next = [&](int s) {
    if (n_c0 >= hi) return;
    uint8_t* kt = mem.stage(s);
    // the mask columns of the tile that lie in T (T % 128 == 64: half)
    const int mbytes = mrow ? 4 * min(F::BN, a.Tk - n_c) : 0;
    wt::mbar_expect_tx(&mem.full[s], (1 + n_v) * F::KV_BYTES + mbytes);
    load<F::BN, D>(kt, &tk, n_c, bh, &mem.full[s]);
    if (n_v) load<F::BN, D>(kt + F::KV_BYTES, &tv, n_c, bh, &mem.full[s]);
    if (mrow)
      wt::bulk_load(kt + 2 * F::KV_BYTES, mrow + n_c, mbytes, &mem.full[s]);
    n_c += F::BN;
    if (n_c >= min(n_c0 + span, hi)) {  // the block's tiles are issued
      if (!n_v) {
        n_v = 1, n_c = n_c0;
      } else {
        n_c0 += span, n_c = n_c0, n_v = prepass ? 0 : 1;
      }
    }
  };
  if (threadIdx.x == 0) {
    wt::mbar_expect_tx(mem.resbar, F::Q_BYTES);
    load<F::BM, D>(mem.res, &tq, row0, bh, mem.resbar);
    for (int s = 0; s < F::NS; ++s) next(s);
  }
  const Frag f;
  const int row[2] = {row0 + wg * 64 + f.r, row0 + wg * 64 + f.r + 8};
  float o[D / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  zero(o);
  // S of the stage's K tile, scaled and masked
  auto scores = [&](float (&s)[64], const uint8_t* kt, int col0) {
    const float* ms = reinterpret_cast<const float*>(kt + 2 * F::KV_BYTES);
    ss_product<D, F::BM, F::BN, 128>(s, mem.res, wg * 64, kt);
    wt::wgmma_commit();
    wt::wgmma_wait<0>();
    wt::fence_acc(s);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + 8 * j + f.c + e;
        const bool out = col >= a.Tk;  // T % 128 == 64: zeros past T
        const float add = (a.mask && !out) ? ms[col - col0] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float& x = s[4 * j + 2 * h + e];
          x = (out || (a.causal && col > row[h])) ? -INFINITY
                                                  : x * a.scale + add;
        }
      }
  };
  wt::mbar_wait(mem.resbar, 0);
  wt::Pipe<F::NS> st;
  for (int c0 = 0; c0 < hi; c0 += span) {
    const int c1 = min(c0 + span, hi);
    if (prepass) {  // the reference block's row max, from its K tiles
      float mx[2] = {m[0], m[1]};
      for (int c = c0; c < c1; c += F::BN) {
        wt::mbar_wait(&mem.full[st.s], st.ph);
        float s[64];
        scores(s, mem.stage(st.s), c);
        recycle(mem.empty, st, next);
        tile_max<0, 16>(s, mx);
      }
      const float mnew[2] = {quad_max(mx[0]), quad_max(mx[1])};
      rescale(o, l, m, mnew);
    }
    for (int c = c0; c < c1; c += F::BN) {
      wt::mbar_wait(&mem.full[st.s], st.ph);
      const uint8_t* kt = mem.stage(st.s);
      const uint8_t* vt = kt + F::KV_BYTES;
      float s[64];
      scores(s, kt, c);
      if (a.rblock == 64) {  // a reference block is half the tile
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float mx[2] = {m[0], m[1]};
          if (half == 0)
            tile_max<0, 8>(s, mx);
          else
            tile_max<8, 16>(s, mx);
          const float mnew[2] = {quad_max(mx[0]), quad_max(mx[1])};
          rescale(o, l, m, mnew);
          if (half == 0)
            pv<D, 0, 4>(o, l, s, m, vt, f, row, c, bh, a);
          else
            pv<D, 4, 8>(o, l, s, m, vt, f, row, c, bh, a);
        }
      } else {
        if (!prepass) {  // the reference block is the tile
          float mx[2] = {m[0], m[1]};
          tile_max<0, 16>(s, mx);
          const float mnew[2] = {quad_max(mx[0]), quad_max(mx[1])};
          rescale(o, l, m, mnew);
        }
        pv<D, 0, 8>(o, l, s, m, vt, f, row, c, bh, a);
      }
      recycle(mem.empty, st, next);
    }
  }
  const float lsum[2] = {quad_sum(l[0]), quad_sum(l[1])};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= a.S) continue;
    const float ls = lsum[h] == 0.f ? 1.f : lsum[h];
    bf16* orow = a.o + ((size_t)bh * a.S + row[h]) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + f.c) =
          __floats2bfloat162_rn(o[4 * j + 2 * h] / ls,
                                o[4 * j + 2 * h + 1] / ls);
    if (f.c == 0) a.lse[(size_t)bh * a.S + row[h]] = m[h] + logf(ls);
  }
}

// ---------------------------------------------------------------------------
// flash_bwd_dq
// ---------------------------------------------------------------------------
template <int D>
struct Dq {
  static constexpr int BM = 128, BN = 64;
  static constexpr int Q_BYTES = BM * D * 2, KV_BYTES = BN * D * 2;
  static constexpr int NS = 4;
  // resident Q, dO; a stage: K, V, the tile's mask columns (BN floats)
  using M = Mem<2 * Q_BYTES, 2 * KV_BYTES + 1024, NS>;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           Params a) {
  using F = Dq<D>;
  extern __shared__ uint8_t smem_raw[];
  const typename F::M mem(smem_raw);
  const int iq = a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int bh = blockIdx.y, row0 = iq * F::BM;
  const int nk = a.Tk / F::BN;
  const int hi =
      (a.causal ? min(nk, (row0 + F::BM + F::BN - 1) / F::BN) : nk) * F::BN;
  const int wg = threadIdx.x / 128;
  const float* mrow = a.mask ? a.mask + (size_t)(bh / a.heads) * a.Tk
                             : nullptr;
  int n_c = 0;  // the next K / V tile the ring carries
  auto next = [&](int s) {
    if (n_c >= hi) return;
    uint8_t* kt = mem.stage(s);
    const int mbytes = mrow ? 4 * F::BN : 0;
    wt::mbar_expect_tx(&mem.full[s], 2 * F::KV_BYTES + mbytes);
    load<F::BN, D>(kt, &tk, n_c, bh, &mem.full[s]);
    load<F::BN, D>(kt + F::KV_BYTES, &tv, n_c, bh, &mem.full[s]);
    if (mrow)
      wt::bulk_load(kt + 2 * F::KV_BYTES, mrow + n_c, mbytes, &mem.full[s]);
    n_c += F::BN;
  };
  if (threadIdx.x == 0) {
    wt::mbar_expect_tx(mem.resbar, 2 * F::Q_BYTES);
    load<F::BM, D>(mem.res, &tq, row0, bh, mem.resbar);
    load<F::BM, D>(mem.res + F::Q_BYTES, &tdo, row0, bh, mem.resbar);
    for (int s = 0; s < F::NS; ++s) next(s);
  }
  const Frag f;
  const int row[2] = {row0 + wg * 64 + f.r, row0 + wg * 64 + f.r + 8};
  float lr[2], dr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = row[h] < a.S;  // S % 128 == 64: zeros past S
    lr[h] = in ? a.lse_in[(size_t)bh * a.S + row[h]] : 0.f;
    dr[h] = in ? a.delta[(size_t)bh * a.S + row[h]] : 0.f;
  }
  float dq[D / 2];
  zero(dq);
  const int last_row = row0 + wg * 64 + 63;
  wt::mbar_wait(mem.resbar, 0);
  wt::Pipe<F::NS> st;
  for (int c = 0; c < hi; c += F::BN) {
    wt::mbar_wait(&mem.full[st.s], st.ph);
    const uint8_t* kt = mem.stage(st.s);
    const float* ms = reinterpret_cast<const float*>(kt + 2 * F::KV_BYTES);
    if (!(a.causal && c > last_row)) {  // else every column is masked
      float s[32], dp[32];
      ss_product<D, F::BM, F::BN, 64>(s, mem.res, wg * 64, kt);
      ss_product<D, F::BM, F::BN, 64>(dp, mem.res + F::Q_BYTES, wg * 64,
                                      kt + F::KV_BYTES);
      wt::wgmma_commit();
      wt::wgmma_wait<0>();
      wt::fence_acc(s);
      wt::fence_acc(dp);
      uint32_t da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = 2 * kk + (r >> 1), h = r & 1;
          float ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = c + 8 * j + f.c + e;
            const int i = 4 * j + 2 * h + e;
            const float p =
                (a.causal && col > row[h])
                    ? 0.f
                    : __expf(s[i] * a.scale +
                                 (a.mask ? ms[col - c] : 0.f) - lr[h]);
            const float dpd = a.drop.apply(dp[i], bh, row[h], col, a.Tk);
            ds[e] = p * (dpd - dr[h]) * a.scale;
          }
          da[kk][r] = pack(ds[0], ds[1]);  // dS rounded to bf16
        }
      rs_product<0, 4, F::BN, D>(dq, da, kt);
      wt::wgmma_commit();
      wt::wgmma_wait<0>();
      wt::fence_acc(dq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wt::fence_regs(da[kk]);
    }
    recycle(mem.empty, st, next);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= a.S) continue;
    bf16* drow = a.dq + ((size_t)bh * a.S + row[h]) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(drow + 8 * j + f.c) =
          __floats2bfloat162_rn(dq[4 * j + 2 * h], dq[4 * j + 2 * h + 1]);
  }
}

// ---------------------------------------------------------------------------
// flash_bwd_dkv
// ---------------------------------------------------------------------------
template <int D>
struct Dkv {
  static constexpr int BN = 128, BM = 64;  // keys a block, Q rows a tile
  static constexpr int KV_BYTES = BN * D * 2, Q_BYTES = BM * D * 2;
  static constexpr int NS = 4;
  // resident K, V; a stage: Q, dO, the tile's lse and delta (BM floats
  // each)
  using M = Mem<2 * KV_BYTES, 2 * Q_BYTES + 1024, NS>;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            Params a) {
  using F = Dkv<D>;
  extern __shared__ uint8_t smem_raw[];
  const typename F::M mem(smem_raw);
  const int bh = blockIdx.y, col0 = blockIdx.x * F::BN;
  // causal: Q rows below the block's first key see none of its keys
  const int lo = a.causal ? min(col0, a.S) : 0;
  const int wg = threadIdx.x / 128;
  const float* lse_b = a.lse_in + (size_t)bh * a.S;
  const float* dl_b = a.delta + (size_t)bh * a.S;
  int n_r = lo;  // the next Q / dO tile the ring carries
  auto next = [&](int s) {
    if (n_r >= a.S) return;
    uint8_t* qt = mem.stage(s);
    wt::mbar_expect_tx(&mem.full[s], 2 * F::Q_BYTES + 8 * F::BM);
    load<F::BM, D>(qt, &tq, n_r, bh, &mem.full[s]);
    load<F::BM, D>(qt + F::Q_BYTES, &tdo, n_r, bh, &mem.full[s]);
    wt::bulk_load(qt + 2 * F::Q_BYTES, lse_b + n_r, 4 * F::BM, &mem.full[s]);
    wt::bulk_load(qt + 2 * F::Q_BYTES + 4 * F::BM, dl_b + n_r, 4 * F::BM,
                  &mem.full[s]);
    n_r += F::BM;
  };
  if (threadIdx.x == 0) {
    wt::mbar_expect_tx(mem.resbar, 2 * F::KV_BYTES);
    load<F::BN, D>(mem.res, &tk, col0, bh, mem.resbar);
    load<F::BN, D>(mem.res + F::KV_BYTES, &tv, col0, bh, mem.resbar);
    for (int s = 0; s < F::NS; ++s) next(s);
  }
  const Frag f;
  // this thread's keys: the rows of S^T
  const int key[2] = {col0 + wg * 64 + f.r, col0 + wg * 64 + f.r + 8};
  const float* mrow = a.mask ? a.mask + (size_t)(bh / a.heads) * a.Tk
                             : nullptr;
  float madd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)  // T % 128 == 64: zeros past T
    madd[h] = (mrow && key[h] < a.Tk) ? mrow[key[h]] : 0.f;
  float dk[D / 2], dv[D / 2];
  zero(dk);
  zero(dv);
  const int first_key = col0 + wg * 64;
  wt::mbar_wait(mem.resbar, 0);
  wt::Pipe<F::NS> st;
  for (int r0 = lo; r0 < a.S; r0 += F::BM) {
    wt::mbar_wait(&mem.full[st.s], st.ph);
    const uint8_t* qt = mem.stage(st.s);
    const uint8_t* dot = qt + F::Q_BYTES;
    const float* ls = reinterpret_cast<const float*>(qt + 2 * F::Q_BYTES);
    const float* dls = ls + F::BM;
    if (!(a.causal && r0 + F::BM - 1 < first_key)) {  // else all masked
      float s[32], dp[32];
      ss_product<D, F::BN, F::BM, 64>(s, mem.res, wg * 64, qt);
      ss_product<D, F::BN, F::BM, 64>(dp, mem.res + F::KV_BYTES, wg * 64,
                                      dot);
      wt::wgmma_commit();
      wt::wgmma_wait<0>();
      wt::fence_acc(s);
      wt::fence_acc(dp);
      uint32_t pa[4][4], sa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = 2 * kk + (r >> 1), h = r & 1;
          float pd[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qr = r0 + 8 * j + f.c + e;  // the column: a Q row
            const int i = 4 * j + 2 * h + e;
            const bool dead = key[h] >= a.Tk || (a.causal && key[h] > qr);
            const float p =
                dead ? 0.f : __expf(s[i] * a.scale + madd[h] - ls[qr - r0]);
            const bool keep = a.drop.kept(bh, qr, key[h], a.Tk);
            pd[e] = a.drop.apply(p, keep);
            ds[e] = p * (a.drop.apply(dp[i], keep) - dls[qr - r0]) * a.scale;
          }
          pa[kk][r] = pack(pd[0], pd[1]);  // the dropped P^T, bf16
          sa[kk][r] = pack(ds[0], ds[1]);  // dS^T, bf16
        }
      rs_product<0, 4, F::BM, D>(dv, pa, dot);
      rs_product<0, 4, F::BM, D>(dk, sa, qt);
      wt::wgmma_commit();
      wt::wgmma_wait<0>();
      wt::fence_acc(dv);
      wt::fence_acc(dk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wt::fence_regs(pa[kk]);
        wt::fence_regs(sa[kk]);
      }
    }
    recycle(mem.empty, st, next);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= a.Tk) continue;
    const size_t off = ((size_t)bh * a.Tk + key[h]) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(a.dk + off + 8 * j + f.c) =
          __floats2bfloat162_rn(dk[4 * j + 2 * h], dk[4 * j + 2 * h + 1]);
      *reinterpret_cast<__nv_bfloat162*>(a.dv + off + 8 * j + f.c) =
          __floats2bfloat162_rn(dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);
    }
  }
}

template <typename K, typename... Ts>
int launch(K kernel, int smem, dim3 grid, cudaStream_t st, Ts... args) {
  if (int e = (int)cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
    return e;
  kernel<<<grid, kThreads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// launchers: the SIMT route by D's tile and head-dim bucket, then the
// input type; the tensor-core route by D
// ---------------------------------------------------------------------------
struct Args {
  const void *q, *k, *v, *dout;
  const float *lse_in, *delta, *mask;
  void *o, *dq, *dk, *dv;
  float* lse;
  int BH, heads, S, Tk, D, rblock;
  Drop drop;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <int BR, int DMAX>
constexpr size_t tile_bytes() {
  return sizeof(float) * BR * (DMAX + 1);
}
template <int BR>
constexpr size_t score_bytes() {
  return sizeof(float) * BR * (BR + 1);
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int BR, int DMAX>
int run(int which, const Args& a) {
  const dim3 block(kThreads);
  if (which == 0) {
    const size_t smem = 3 * tile_bytes<BR, DMAX>() + score_bytes<BR>();
    auto kern = flash_fwd_kernel<T, BR, DMAX>;
    if (int e = set_smem(kern, smem)) return e;
    kern<<<dim3(a.S / BR, a.BH), block, smem, a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.o, a.lse, a.mask,
        a.heads, a.S, a.Tk, a.D, a.scale, a.causal, a.rblock, a.drop);
  } else if (which == 1) {
    const size_t smem = 4 * tile_bytes<BR, DMAX>() + score_bytes<BR>();
    auto kern = flash_bwd_dq_kernel<T, BR, DMAX>;
    if (int e = set_smem(kern, smem)) return e;
    kern<<<dim3(a.S / BR, a.BH), block, smem, a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
        a.lse_in, a.delta, (T*)a.dq, a.mask, a.heads, a.S, a.Tk, a.D,
        a.scale, a.causal, a.drop);
  } else {
    const size_t smem = 4 * tile_bytes<BR, DMAX>() + 2 * score_bytes<BR>() +
                        2 * sizeof(float) * BR;
    auto kern = flash_bwd_dkv_kernel<T, BR, DMAX>;
    if (int e = set_smem(kern, smem)) return e;
    kern<<<dim3(a.Tk / BR, a.BH), block, smem, a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
        a.lse_in, a.delta, (T*)a.dk, (T*)a.dv, a.mask, a.heads, a.S, a.Tk,
        a.D, a.scale, a.causal, a.drop);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int run_by_dim(int which, const Args& a) {
  if (a.D <= 64) return run<T, 64, 64>(which, a);
  if (a.D <= 128) return run<T, 64, 128>(which, a);
  return run<T, 32, 256>(which, a);
}

// the domain of can_use_flash: D % 8 == 0, D <= 256, S and T multiples
// of 64 (which every tile size divides); the reference's key block
// (rblock) is one of 64..512 dividing T
bool valid(const Args& a) {
  return a.D >= 8 && a.D % 8 == 0 && a.D <= 256 && a.S > 0 && a.S % 64 == 0 &&
         a.Tk > 0 && a.Tk % 64 == 0 && a.BH > 0 && a.BH <= 65535 &&
         a.heads > 0 && a.BH % a.heads == 0 &&
         (a.rblock == 64 || a.rblock == 128 || a.rblock == 256 ||
          a.rblock == 512) &&
         a.Tk % a.rblock == 0;
}

int dispatch(int which, int dtype, const Args& a) {
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return run_by_dim<float>(which, a);
  if (dtype == 1) return run_by_dim<__nv_bfloat16>(which, a);
  return (int)cudaErrorInvalidValue;
}

template <int D>
int tc_by_dim(int which, const Args& a, const CUtensorMap& tq,
              const CUtensorMap& tk, const CUtensorMap& tv,
              const CUtensorMap& tdo, const tc::Params& p) {
  const int q_tiles = (a.S + 127) / 128, k_tiles = (a.Tk + 127) / 128;
  if (which == 0)
    return tc::launch(tc::flash_fwd_tc_kernel<D>, tc::Fwd<D>::M::kBytes,
                      dim3(q_tiles, a.BH), a.stream, tq, tk, tv, p);
  if (which == 1)
    return tc::launch(tc::flash_bwd_dq_tc_kernel<D>, tc::Dq<D>::M::kBytes,
                      dim3(q_tiles, a.BH), a.stream, tq, tk, tv, tdo, p);
  return tc::launch(tc::flash_bwd_dkv_tc_kernel<D>, tc::Dkv<D>::M::kBytes,
                    dim3(k_tiles, a.BH), a.stream, tq, tk, tv, tdo, p);
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The tensor-core route (ops/flash_attention.py flash_tc_route): bf16,
// D = 64 or 128, q, k, v, dout, mask, lse and delta 16-byte aligned (TMA
// and bulk copies read them; S and T are multiples of 64, so every row
// they start at is aligned too).
int dispatch_tc(int which, int dtype, const Args& a) {
  if (!valid(a) || dtype != 1 || (a.D != 64 && a.D != 128) ||
      !aligned16(a.q) || !aligned16(a.k) || !aligned16(a.v) ||
      !aligned16(a.dout) || !aligned16(a.mask) || !aligned16(a.lse_in) ||
      !aligned16(a.delta))
    return (int)cudaErrorInvalidValue;
  // box rows: 128-row tiles, and the 64-row tiles each kernel walks
  // (K / V in dq, Q / dO in dk/dv)
  const uint32_t q_box = which == 2 ? 64 : 128, k_box = which == 1 ? 64 : 128;
  CUtensorMap tq, tk, tv, tdo;
  int err = wt::map_3d(&tq, a.q, a.BH, a.S, a.D, q_box);
  if (err == 0) err = wt::map_3d(&tk, a.k, a.BH, a.Tk, a.D, k_box);
  if (err == 0) err = wt::map_3d(&tv, a.v, a.BH, a.Tk, a.D, k_box);
  if (err == 0 && which != 0)
    err = wt::map_3d(&tdo, a.dout, a.BH, a.S, a.D, q_box);
  if (err != 0) return err;
  const tc::Params p{a.lse_in, a.delta, a.mask, (bf16*)a.o, (bf16*)a.dq,
                     (bf16*)a.dk, (bf16*)a.dv, a.lse, a.heads, a.S, a.Tk,
                     a.causal, a.rblock, a.scale, a.drop};
  if (a.D == 64) return tc_by_dim<64>(which, a, tq, tk, tv, tdo, p);
  return tc_by_dim<128>(which, a, tq, tk, tv, tdo, p);
}

}  // namespace

// Common tail of the entry points: mask (B, T) float32 or null, heads =
// BH / B, the dropout of (seed, thr, keep_div) when drop != 0, and the
// reference's key block rblock (the forward rounds P in bf16 against the
// running max at its boundaries). Each returns a cudaError_t, or 10001 /
// 10002 when the TMA descriptor encoder is missing / refuses a tensor.
#define FLASH_TAIL_PARAMS                                                  \
  const float *mask, int BH, int S, int Tk, int D, int dtype, int causal,  \
      int heads, int seed, int drop, int rblock, unsigned int thr,         \
      float keep_div, float scale, void *stream
#define FLASH_TAIL_SET(a)                                                  \
  a.mask = mask, a.BH = BH, a.heads = heads, a.S = S, a.Tk = Tk, a.D = D;  \
  a.rblock = rblock, a.scale = scale, a.causal = causal;                   \
  a.drop = Drop{(uint32_t)seed, thr, drop, keep_div};                      \
  a.stream = static_cast<cudaStream_t>(stream)

static Args fwd_args(const void* q, const void* k, const void* v, void* o,
                     float* lse) {
  Args a{};
  a.q = q, a.k = k, a.v = v, a.o = o, a.lse = lse;
  return a;
}
static Args dq_args(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dq) {
  Args a{};
  a.q = q, a.k = k, a.v = v, a.dout = dout, a.lse_in = lse, a.delta = delta;
  a.dq = dq;
  return a;
}
static Args dkv_args(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dk, void* dv) {
  Args a{};
  a.q = q, a.k = k, a.v = v, a.dout = dout, a.lse_in = lse, a.delta = delta;
  a.dk = dk, a.dv = dv;
  return a;
}

extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, float* lse, FLASH_TAIL_PARAMS) {
  Args a = fwd_args(q, k, v, o, lse);
  FLASH_TAIL_SET(a);
  return dispatch(0, dtype, a);
}

extern "C" int flash_fwd_tc_launch(const void* q, const void* k,
                                   const void* v, void* o, float* lse,
                                   FLASH_TAIL_PARAMS) {
  Args a = fwd_args(q, k, v, o, lse);
  FLASH_TAIL_SET(a);
  return dispatch_tc(0, dtype, a);
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   void* dq, FLASH_TAIL_PARAMS) {
  Args a = dq_args(q, k, v, dout, lse, delta, dq);
  FLASH_TAIL_SET(a);
  return dispatch(1, dtype, a);
}

extern "C" int flash_bwd_dq_tc_launch(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const float* lse, const float* delta,
                                      void* dq, FLASH_TAIL_PARAMS) {
  Args a = dq_args(q, k, v, dout, lse, delta, dq);
  FLASH_TAIL_SET(a);
  return dispatch_tc(1, dtype, a);
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const float* lse, const float* delta,
                                    void* dk, void* dv, FLASH_TAIL_PARAMS) {
  Args a = dkv_args(q, k, v, dout, lse, delta, dk, dv);
  FLASH_TAIL_SET(a);
  return dispatch(2, dtype, a);
}

extern "C" int flash_bwd_dkv_tc_launch(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const float* lse, const float* delta,
                                       void* dk, void* dv,
                                       FLASH_TAIL_PARAMS) {
  Args a = dkv_args(q, k, v, dout, lse, delta, dk, dv);
  FLASH_TAIL_SET(a);
  return dispatch_tc(2, dtype, a);
}
