// Flash attention for Hopper (sm_90a): forward, backward dQ, backward dK/dV.
//
// Replaces the three Pallas bodies of paddle_tpu/ops/pallas_attention.py:
//   flash_fwd     <- _fwd_kernel     (launched by _flash_fwd_impl)
//   flash_bwd_dq  <- _bwd_dq_kernel  (launched by _flash_bwd)
//   flash_bwd_dkv <- _bwd_dkv_kernel (launched by _flash_bwd)
// for the no-mask, no-dropout case (causal or not). Padding masks and the
// in-kernel dropout hash come with the BERT slice of the port.
//
// Layouts (row-major, contiguous): q/do/o/dq (BH, S, D), k/v/dk/dv
// (BH, T, D) in T_ = float or bfloat16; lse/delta (BH, S) float32
// (the TPU kernel's (BH, S, 128) lane broadcast is a TPU tiling artefact).
//   o   = softmax(q k^T * scale [causal: col > row masked]) v
//   lse = m + log(l) per row (l == 0 -> 1, as the reference)
//   p   = exp(q k^T * scale - lse), delta = rowsum(do * o) (computed by the
//   caller in PyTorch, as the reference computes it in jnp)
//   ds  = p * (do v^T - delta) * scale
//   dq  = ds k,   dk = ds^T q,   dv = p^T do
// All arithmetic is f32 (f32 FMA, no TF32); bf16 inputs are widened on
// load into shared memory and outputs rounded once at the store.
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
// Tiles: BR x BR (64, or 32 for head dims above 128) with 256 threads as a
// 16 x 16 grid; thread (ty, tx) owns score rows ty + 16i and columns
// tx + 16j, and output columns tx + 16c. Tiles live in shared memory as f32
// with rows padded by one word, so the 16 column-owning threads read 16
// distinct banks. At D = 128 the dK/dV kernel holds K, V, Q, dO and two
// score tiles: 165 KB, past the 48 KB static limit, hence dynamic shared
// memory raised with cudaFuncSetAttribute per instantiation.
//
// Bound on this card at the training shape (B=1, H=16, T=1024, D=128,
// causal): the forward does 4 * BH * D * T^2 / 2 = 4.3 GFLOP over 16.8 MB
// of bf16 q/k/v/o: 4.3 us of bf16 tensor-core flops, 5.0 us of HBM bytes,
// so bytes bound it by a hair; the backward does 2.5x the flops over
// about twice the bytes. This first version runs on the CUDA cores (f32
// FMA, 67 TFLOP/s peak, shared-memory operand bandwidth below that), so
// its time sits above the bound by the factor recorded in PERF.md;
// mma/wgmma tiles are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

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
                     float* __restrict__ lse, int S, int Tk, int D,
                     float scale, int causal) {
  constexpr int BC = BR, RT = BR / 16, CT = BC / 16, DT = DMAX / 16;
  constexpr int SD = DMAX + 1, SP = BC + 1;
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
  load_tile<T, BR, DMAX>(q + ((size_t)bh * S + row0) * D, D, Qs);

  float acc[RT][DT], m[RT], l[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DT; ++c) acc[i][c] = 0.f;
  }
  const int nk = Tk / BC;
  const int hi = causal ? min(nk, (row0 + BR + BC - 1) / BC) : nk;
  for (int j = 0; j < hi; ++j) {
    const int col0 = j * BC;
    __syncthreads();  // the previous tiles are no longer being read
    load_tile<T, BC, DMAX>(kb + (size_t)col0 * D, D, Ks);
    load_tile<T, BC, DMAX>(vb + (size_t)col0 * D, D, Vs);
    __syncthreads();
    float s[RT][CT] = {}, unused[RT][CT];
    tile_dots<RT, CT, DMAX, false>(Qs, Ks, nullptr, nullptr, ty, tx, s,
                                   unused);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int row = row0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const int col = col0 + tx + 16 * c;
        s[i][c] = (causal && col > row) ? -INFINITY : s[i][c] * scale;
        mx = fmaxf(mx, s[i][c]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      // a row masked so far keeps m = -inf; exp against 0 keeps it NaN-free
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - m_use);
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const float p = expf(s[i][c] - m_use);
        Ps[(ty + 16 * i) * SP + tx + 16 * c] = p;
        ps += p;
      }
      l[i] = alpha * l[i] + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DT; ++c) acc[i][c] *= alpha;
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
                        int S, int Tk, int D, float scale, int causal) {
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
            (causal && col > row) ? 0.f : expf(s[i][c] * scale - lr[i]);
        DSs[(ty + 16 * i) * SP + tx + 16 * c] = p * (dp[i][c] - dr[i]) * scale;
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
                         T* __restrict__ dk, T* __restrict__ dv, int S,
                         int Tk, int D, float scale, int causal) {
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
        const float p = (causal && col0 + cc > row0 + r)
                            ? 0.f
                            : expf(s[i][c] * scale - Ls[r]);
        Ps[r * SP + cc] = p;
        DSs[r * SP + cc] = p * (dp[i][c] - Dl[r]) * scale;
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
// launchers: tile and head-dim bucket by D, then the input type
// ---------------------------------------------------------------------------
struct Args {
  const void *q, *k, *v, *dout;
  const float *lse_in, *delta;
  void *o, *dq, *dk, *dv;
  float* lse;
  int BH, S, Tk, D;
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
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.o, a.lse, a.S,
        a.Tk, a.D, a.scale, a.causal);
  } else if (which == 1) {
    const size_t smem = 4 * tile_bytes<BR, DMAX>() + score_bytes<BR>();
    auto kern = flash_bwd_dq_kernel<T, BR, DMAX>;
    if (int e = set_smem(kern, smem)) return e;
    kern<<<dim3(a.S / BR, a.BH), block, smem, a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
        a.lse_in, a.delta, (T*)a.dq, a.S, a.Tk, a.D, a.scale, a.causal);
  } else {
    const size_t smem = 4 * tile_bytes<BR, DMAX>() + 2 * score_bytes<BR>() +
                        2 * sizeof(float) * BR;
    auto kern = flash_bwd_dkv_kernel<T, BR, DMAX>;
    if (int e = set_smem(kern, smem)) return e;
    kern<<<dim3(a.Tk / BR, a.BH), block, smem, a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
        a.lse_in, a.delta, (T*)a.dk, (T*)a.dv, a.S, a.Tk, a.D, a.scale,
        a.causal);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int run_by_dim(int which, const Args& a) {
  if (a.D <= 64) return run<T, 64, 64>(which, a);
  if (a.D <= 128) return run<T, 64, 128>(which, a);
  return run<T, 32, 256>(which, a);
}

int dispatch(int which, int dtype, const Args& a) {
  // the domain of can_use_flash: D % 8 == 0, D <= 256, S and T multiples
  // of 64 (which every tile size divides)
  if (a.D < 8 || a.D % 8 || a.D > 256 || a.S <= 0 || a.S % 64 ||
      a.Tk <= 0 || a.Tk % 64 || a.BH <= 0 || a.BH > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return run_by_dim<float>(which, a);
  if (dtype == 1) return run_by_dim<__nv_bfloat16>(which, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, float* lse, int BH, int S, int Tk,
                                int D, int dtype, int causal, float scale,
                                void* stream) {
  Args a{};
  a.q = q, a.k = k, a.v = v, a.o = o, a.lse = lse;
  a.BH = BH, a.S = S, a.Tk = Tk, a.D = D, a.scale = scale, a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(0, dtype, a);
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   void* dq, int BH, int S, int Tk, int D,
                                   int dtype, int causal, float scale,
                                   void* stream) {
  Args a{};
  a.q = q, a.k = k, a.v = v, a.dout = dout, a.lse_in = lse, a.delta = delta;
  a.dq = dq;
  a.BH = BH, a.S = S, a.Tk = Tk, a.D = D, a.scale = scale, a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(1, dtype, a);
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const float* lse, const float* delta,
                                    void* dk, void* dv, int BH, int S,
                                    int Tk, int D, int dtype, int causal,
                                    float scale, void* stream) {
  Args a{};
  a.q = q, a.k = k, a.v = v, a.dout = dout, a.lse_in = lse, a.delta = delta;
  a.dk = dk, a.dv = dv;
  a.BH = BH, a.S = S, a.Tk = Tk, a.D = D, a.scale = scale, a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(2, dtype, a);
}
