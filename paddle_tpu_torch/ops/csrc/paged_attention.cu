// Ragged paged-attention decode for Hopper (sm_90a), split over the
// context.
//
// Replaces paddle_tpu/ops/paged_attention.py:_paged_kernel (launched by
// paged_attention_pallas): one query token per slot against that slot's
// ragged KV history in a page pool, softmax in f32, masked past ctx_lens;
// an all-masked row (ctx 0) returns 0 (the l == 0 -> 1 rule). P stays in
// f32 for the product with V, as _paged_kernel keeps it (:98-103). The
// JAX package's gather path, paged_attention_xla (:52-72), and the port's
// plain version (ops/paged_attention.py paged_attention_reference, its
// port) round the probabilities to V's type instead: a difference between
// the reference's two functions, inside the bf16 tolerance (2e-2), which
// the port keeps as it is. The split-and-merge plain version,
// paged_attention_split_reference, keeps P in f32 as this kernel does.
//
// Two kernels share the grid, the softmax and the merge:
//   * paged_split_kernel, the vector route: q f32, K/V pools f32 or bf16
//     (template T), contiguous and 16-byte aligned, d <= 128 with
//     d * sizeof(T) a multiple of 16; rows arrive by cp.async. The
//     serving shapes (GPT-3 XL: d = 128, ps = 16) take it.
//   * paged_scalar_kernel, the scalar route: every other call the
//     reference serves. q and pools in f32, bf16 or f16 (each its own
//     type), any d up to kScalarMaxDim, pools of any element strides
//     (a view at any element offset), read by plain loads; out in q's
//     type.
//
// Layouts (row-major; the scalar route's pools by their strides):
//   q          [S, H, d]        f32 (vector route), f32/bf16/f16 (scalar)
//   k/v pages  [P, ps, H, d]    see above
//   page_table [S, M]           int32, every entry a valid pool index
//   ctx_lens   [S]              int32
//   out        [S, H, d]        q's type
//   part       [S, H, splits, d + 2] f32 workspace (m, l, acc[d]) when
//              splits > 1
//   tickets    [S, H] int32, zero before the launch and zero again after
//              it (the last block of a (slot, head) resets its own), when
//              splits > 1
// Any page size ps >= 1.
//
// Bound on this card: bytes. A call must read the K and V rows of the
// ctx tokens of every (slot, head) once: 2 * sum(ctx) * H * d *
// sizeof(T), against 4 flops a byte in f32. At the serving shape (S = 8,
// H = 16, d = 128, ps = 16, ctx 1..2048, 6,143 tokens) that is 100.6 MB
// in f32: 0.030 ms at 3.35 TB/s (0.015 ms in bf16).
//
// Design. The TPU kernel walks a slot's pages in order on one core; here
// that walk would put a (slot, head) on one SM and let the longest slot
// set the time. So the context is split:
//   * Grid (S, H, splits). Block (s, h, j) takes the pages [j * pps,
//     (j + 1) * pps) of slot s, head h. pps comes from the host
//     (ops/paged_attention.py paged_splits: M, S, H and the SM count,
//     never ctx_lens, which live on the device), so the launch needs no
//     host sync. A block streams its pages at about one SM's share of the
//     card's bandwidth (issuing the copies, not the arithmetic, sets its
//     pace), so the split aims at twelve blocks an SM for a full table:
//     the longest slot's pages then spread over many SMs. A block past
//     its slot's last page writes an empty partial (m = -1e30, l = 0,
//     acc = 0) and exits.
//   * The block's page indices are read into shared memory once, so a
//     chunk's copies wait on no dependent global load.
//   * Inside a block, its tokens stream through shared memory in chunks
//     of 16: each chunk's K and V rows of head h (d * sizeof(T)
//     contiguous bytes each, H * d apart) arrive by 16-byte cp.async into
//     a ring of 4 stages, 3 chunks in flight while one is used (3 pages
//     at ps = 16). Tokens past the block's end or ctx are zero-filled.
//   * Scores: a warp scores 4 tokens at once, 8 lanes a token, each lane
//     reading 16-byte vectors of its token's K row (lane j of a group
//     takes vectors j, j + 8, ...) against its slice of q held in
//     registers, then a 3-step shuffle sum in the group.
//   * Softmax in f32 over the block's tokens, chunk by chunk (running
//     max, rescaled sum and accumulator), masked past ctx. Every warp
//     forms a chunk's 16 probabilities itself, one exp a lane with
//     butterfly max and sum (no third barrier, no exp repeated by every
//     thread); thread i < d owns dimension i of P V and adds p_t *
//     v_t[i], even and odd tokens in two chains.
//   * Merge. With one split the block normalises and writes out itself.
//     Otherwise it writes (m, l, acc) to the workspace, takes a ticket of
//     its (slot, head), and the last of the splits to arrive combines
//     them in split order (a thread per dimension), as the SIMT
//     sub-blocks finish their rows: no second launch. The only atomic is
//     the ticket; every sum runs in a fixed order, so reruns give the
//     same bits.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxDim = 128;   // vector route: one P V dimension a thread
constexpr int kScalarMaxDim = 16384;  // scalar route: q and acc in smem
constexpr int kChunk = 16;     // tokens a stage: 4 warps x 4 tokens
constexpr int kStages = 4;     // ring of chunks: 3 in flight
constexpr int kGroup = 8;      // lanes scoring one token
constexpr int kMaxSmem = 232448;  // the opt-in maximum of an H100 block
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

// The elements of one 16-byte vector as f32.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kElems = 4;
  __device__ __forceinline__ static void load(const float* p, float* o) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    o[0] = t.x, o[1] = t.y, o[2] = t.z, o[3] = t.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kElems = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* o) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 b =
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
      o[2 * i] = __low2float(b), o[2 * i + 1] = __high2float(b);
    }
  }
};

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
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

// Calls f(i) for the P V dimensions i that thread tid owns: tid, tid +
// kThreads, ... below d where kWide (the scalar route), else tid alone
// (the vector route, d <= kThreads).
template <bool kWide, typename F>
__device__ __forceinline__ void each_dim(int d, F f) {
  if constexpr (kWide) {
    for (int i = threadIdx.x; i < d; i += kThreads) f(i);
  } else {
    if ((int)threadIdx.x < d) f((int)threadIdx.x);
  }
}

// The end of block (sh = slot * H + head, split sp) with its running
// max m, sum l and P V accumulator acc(i) of dimension i (each_dim's
// dimensions). One split: the block normalises and writes out.
// Otherwise it writes (m, l, acc) to the workspace and takes a ticket;
// the last of the splits to arrive combines all of them in split order
// (reading the others' partials from L2 after the fence) and resets the
// ticket for the next call. Called by the whole block (it holds
// barriers); *last is a shared word.
template <bool kWide, typename TO, typename Acc>
__device__ __forceinline__ void finish(float m, float l, Acc acc,
                                       TO* __restrict__ out,
                                       float* __restrict__ part,
                                       int* __restrict__ tickets, size_t sh,
                                       int d, int splits, int sp,
                                       int* last) {
  const int tid = threadIdx.x;
  if (splits == 1) {
    each_dim<kWide>(d, [&](int i) {
      out[sh * d + i] = from_f32<TO>(acc(i) / (l == 0.f ? 1.f : l));
    });
    return;
  }
  float* pp = part + sh * splits * (d + 2);
  if (tid == 0) pp[sp * (d + 2)] = m, pp[sp * (d + 2) + 1] = l;
  each_dim<kWide>(d, [&](int i) { pp[sp * (d + 2) + 2 + i] = acc(i); });
  __threadfence();
  __syncthreads();
  if (tid == 0) *last = atomicAdd(&tickets[sh], 1) == splits - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  if (tid == 0) tickets[sh] = 0;
  if (tid >= d) return;
  float m_tot = kNeg;
  for (int j = 0; j < splits; ++j)
    m_tot = fmaxf(m_tot, __ldcg(pp + j * (d + 2)));
  each_dim<kWide>(d, [&](int i) {
    float l_tot = 0.f, a = 0.f;
    for (int j = 0; j < splits; ++j) {
      const float* p = pp + j * (d + 2);
      const float f = expf(__ldcg(p) - m_tot);
      l_tot += __ldcg(p + 1) * f;
      a += __ldcg(p + 2 + i) * f;
    }
    out[sh * d + i] = from_f32<TO>(a / (l_tot == 0.f ? 1.f : l_tot));
  });
}

// The ring, the chunk's scores, the block's page indices, then finish's
// flag.
template <typename T>
constexpr int smem_bytes(int d, int pps) {
  return 2 * kStages * kChunk * d * (int)sizeof(T) + kChunk * 4 + pps * 4 +
         4;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_split_kernel(const float* __restrict__ q,
                       const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const int* __restrict__ page_table,
                       const int* __restrict__ ctx_lens,
                       float* __restrict__ out, float* __restrict__ part,
                       int* __restrict__ tickets, int H, int d, int ps,
                       int M, int pps, float scale) {
  constexpr int VE = Vec<T>::kElems;                // elements a vector
  constexpr int R = kMaxDim / VE / kGroup;          // vectors a lane, max
  // 16-byte pieces of a chunk's K (or V) rows a thread copies, at most
  constexpr int PIECES = kChunk * (kMaxDim / VE) / kThreads;
  extern __shared__ __align__(16) uint8_t smem[];
  T* kring = reinterpret_cast<T*>(smem);
  T* vring = kring + kStages * kChunk * d;
  float* sc = reinterpret_cast<float*>(vring + kStages * kChunk * d);
  int* pages = reinterpret_cast<int*>(sc + kChunk);
  int* last = pages + pps;

  const int s = blockIdx.x, h = blockIdx.y, sp = blockIdx.z;
  const int splits = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = lane % kGroup, tt = lane / kGroup;
  const int nv = d / VE;                            // vectors a row
  const size_t sh = (size_t)s * H + h, qo = sh * d;

  const int ctx = max(0, min(ctx_lens[s], M * ps));
  const int t0 = sp * pps * ps;
  const int t1 = min(ctx, t0 + pps * ps);
  if (t0 >= t1) {  // nothing of this slot in this split: an empty partial
    finish<false>(kNeg, 0.f, [](int) { return 0.f; }, out, part, tickets,
                  sh, d, splits, sp, last);
    return;
  }

  float qr[R][VE];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int v = j + kGroup * r;
#pragma unroll
    for (int e = 0; e < VE; ++e)
      qr[r][e] = v < nv ? q[qo + v * VE + e] : 0.f;
  }

  // the block's page indices, read once: a chunk's copies then wait on
  // shared memory, not on a dependent global load each
  const int p0 = sp * pps;
  for (int i = tid; i < (t1 - t0 + ps - 1) / ps; i += kThreads)
    pages[i] = page_table[(size_t)s * M + p0 + i];
  __syncthreads();

  // the pieces this thread copies of every chunk: token and vector
  int tok_of[PIECES], v_of[PIECES];
#pragma unroll
  for (int i = 0; i < PIECES; ++i) {
    const int p = tid + i * kThreads;
    tok_of[i] = p < kChunk * nv ? p / nv : kChunk;  // kChunk: no piece
    v_of[i] = p - tok_of[i] * nv;
  }
  const size_t tok_stride = (size_t)H * d;
  const int n_chunks = (t1 - t0 + kChunk - 1) / kChunk;
  auto issue = [&](int c) {
    const int base = c * kChunk;                    // from t0
    T* ks = kring + (c % kStages) * kChunk * d;
    T* vs = vring + (c % kStages) * kChunk * d;
    size_t off[PIECES];
    bool ok[PIECES];
#pragma unroll
    for (int i = 0; i < PIECES; ++i) {
      const int t = base + tok_of[i];
      ok[i] = tok_of[i] < kChunk && t0 + t < t1;
      off[i] = ok[i] ? ((size_t)pages[t / ps] * ps + t % ps) * tok_stride +
                           (size_t)h * d + v_of[i] * VE
                     : 0;
    }
#pragma unroll
    for (int i = 0; i < PIECES; ++i)
      if (tok_of[i] < kChunk) {
        const int dst = tok_of[i] * d + v_of[i] * VE;
        cp16(ks + dst, k_pages + off[i], ok[i]);
        cp16(vs + dst, v_pages + off[i], ok[i]);
      }
  };
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n_chunks) issue(c);
    commit();
  }

  float m_run = kNeg, l_run = 0.f, acc = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    // chunk c has landed; every thread is done with chunk c - 1's stage
    // (the one refilled next) and with the scores
    wait_pending<kStages - 2>();
    __syncthreads();
    if (c + kStages - 1 < n_chunks) issue(c + kStages - 1);
    commit();

    const int base = t0 + c * kChunk;
    const T* ks = kring + (c % kStages) * kChunk * d;
    const T* vs = vring + (c % kStages) * kChunk * d;
    {
      const int tok = warp * (32 / kGroup) + tt;
      float dot = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int v = j + kGroup * r;
        if (v < nv) {
          float kv[VE];
          Vec<T>::load(ks + tok * d + v * VE, kv);
#pragma unroll
          for (int e = 0; e < VE; ++e) dot += qr[r][e] * kv[e];
        }
      }
#pragma unroll
      for (int off = kGroup / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (j == 0) sc[tok] = base + tok < t1 ? dot * scale : kNeg;
    }
    __syncthreads();

    // every warp forms the chunk's probabilities itself, lane k for
    // token k: one exp a lane and butterfly max / sum (the same numbers
    // in every warp, in a fixed order), then each thread's dimension of
    // P V from the lanes' p by shuffle
    const float sk = lane < kChunk ? sc[lane] : kNeg;
    float cmax = sk;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, off));
    const float m_new = fmaxf(m_run, cmax);
    const float alpha = expf(m_run - m_new);
    const float pk =
        lane < kChunk && base + lane < t1 ? expf(sk - m_new) : 0.f;
    float psum = pk;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l_run = l_run * alpha + psum;
    float a0 = 0.f, a1 = 0.f;  // even and odd tokens: two short chains
#pragma unroll
    for (int k = 0; k < kChunk; k += 2) {
      const float p0 = __shfl_sync(0xffffffffu, pk, k);
      const float p1 = __shfl_sync(0xffffffffu, pk, k + 1);
      if (tid < d) {
        a0 += p0 * to_f32(vs[k * d + tid]);
        a1 += p1 * to_f32(vs[(k + 1) * d + tid]);
      }
    }
    acc = acc * alpha + (a0 + a1);
    m_run = m_new;
  }
  wait_pending<0>();  // the trailing (empty) groups
  finish<false>(m_run, l_run, [&](int) { return acc; }, out, part, tickets,
                sh, d, splits, sp, last);
}

// Element strides of a page pool [P, ps, H, d].
struct Strides {
  long long page, tok, head, dim;
};

// The scalar route: the vector route's grid, chunks of kChunk tokens,
// softmax and merge, with plain loads instead of the cp.async ring, so
// no term on d, alignment, contiguity or types but d <= kScalarMaxDim.
//   * q, converted to f32, and the P V accumulator (thread tid owns
//     dimensions tid, tid + kThreads, ...) live in shared memory.
//   * Scores: a warp scores its 4 tokens of a chunk one after another,
//     its lanes reading dimensions lane, lane + 32, ... of the token's K
//     row (coalesced where the pool is contiguous in d), then a 5-step
//     butterfly sum.
//   * P V: each thread reads its dimensions of the chunk's V rows
//     straight from global memory (consecutive threads, consecutive
//     addresses), P from the lanes by shuffle.
template <typename TQ, typename TK>
__global__ void __launch_bounds__(kThreads)
    paged_scalar_kernel(const TQ* __restrict__ q,
                        const TK* __restrict__ k_pages,
                        const TK* __restrict__ v_pages,
                        const int* __restrict__ page_table,
                        const int* __restrict__ ctx_lens,
                        TQ* __restrict__ out, float* __restrict__ part,
                        int* __restrict__ tickets, int H, int d, int ps,
                        int M, int pps, float scale, Strides ks,
                        Strides vs) {
  extern __shared__ __align__(16) uint8_t smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* acc = qs + d;
  float* sc = acc + d;
  int* last = reinterpret_cast<int*>(sc + kChunk);

  const int s = blockIdx.x, h = blockIdx.y, sp = blockIdx.z;
  const int splits = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t sh = (size_t)s * H + h;

  const int ctx = max(0, min(ctx_lens[s], M * ps));
  const int t0 = sp * pps * ps;
  const int t1 = min(ctx, t0 + pps * ps);
  if (t0 >= t1) {  // nothing of this slot in this split: an empty partial
    finish<true>(kNeg, 0.f, [](int) { return 0.f; }, out, part, tickets, sh,
                 d, splits, sp, last);
    return;
  }
  for (int i = tid; i < d; i += kThreads)
    qs[i] = to_f32(q[sh * d + i]), acc[i] = 0.f;
  const int* table = page_table + (size_t)s * M;
  const TK* kh = k_pages + (size_t)h * ks.head;
  const TK* vh = v_pages + (size_t)h * vs.head;

  float m_run = kNeg, l_run = 0.f;
  for (int base = t0; base < t1; base += kChunk) {
    // every thread is done with the last chunk's scores; q is in place
    __syncthreads();
    for (int i = 0; i < kChunk / 4; ++i) {
      const int tok = warp * (kChunk / 4) + i, t = base + tok;
      float dot = 0.f;
      if (t < t1) {
        const TK* kr =
            kh + (size_t)table[t / ps] * ks.page + (size_t)(t % ps) * ks.tok;
        for (int e = lane; e < d; e += 32)
          dot += qs[e] * to_f32(kr[(size_t)e * ks.dim]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (lane == 0) sc[tok] = t < t1 ? dot * scale : kNeg;
    }
    __syncthreads();

    // the chunk's probabilities in every warp, as the vector route forms
    // them
    const float sk = lane < kChunk ? sc[lane] : kNeg;
    float cmax = sk;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, off));
    const float m_new = fmaxf(m_run, cmax);
    const float alpha = expf(m_run - m_new);
    const float pk =
        lane < kChunk && base + lane < t1 ? expf(sk - m_new) : 0.f;
    float psum = pk;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l_run = l_run * alpha + psum;
    float p[kChunk];
    const TK* vr[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      p[k] = __shfl_sync(0xffffffffu, pk, k);
      const int t = min(base + k, t1 - 1);  // p[k] = 0 past t1
      vr[k] = vh + (size_t)table[t / ps] * vs.page + (size_t)(t % ps) * vs.tok;
    }
    for (int i = tid; i < d; i += kThreads) {
      float a0 = 0.f, a1 = 0.f;  // even and odd tokens: two short chains
#pragma unroll
      for (int k = 0; k < kChunk; k += 2) {
        a0 += p[k] * to_f32(vr[k][(size_t)i * vs.dim]);
        a1 += p[k + 1] * to_f32(vr[k + 1][(size_t)i * vs.dim]);
      }
      acc[i] = acc[i] * alpha + (a0 + a1);
    }
    m_run = m_new;
  }
  __syncthreads();
  finish<true>(m_run, l_run, [&](int i) { return acc[i]; }, out, part,
               tickets, sh, d, splits, sp, last);
}

template <typename T>
int run(const float* q, const void* k_pages, const void* v_pages,
        const int* page_table, const int* ctx_lens, float* out, float* part,
        int* tickets, int S, int H, int d, int ps, int M, int pps,
        float scale, cudaStream_t st) {
  if (d * (int)sizeof(T) % 16 != 0) return (int)cudaErrorInvalidValue;
  auto kern = paged_split_kernel<T>;
  const int smem = smem_bytes<T>(d, pps);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (opt_in != cudaSuccess) return (int)opt_in;
  const int splits = (M + pps - 1) / pps;
  const dim3 grid(S, H, splits);
  kern<<<grid, kThreads, smem, st>>>(
      q, static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
      page_table, ctx_lens, out, part, tickets, H, d, ps, M, pps, scale);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TK>
int run_scalar(const void* q, const void* k_pages, const void* v_pages,
               const int* page_table, const int* ctx_lens, void* out,
               float* part, int* tickets, int S, int H, int d, int ps, int M,
               int pps, float scale, Strides ks, Strides vs,
               cudaStream_t st) {
  auto kern = paged_scalar_kernel<TQ, TK>;
  const int smem = (2 * d + kChunk + 1) * 4;
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (opt_in != cudaSuccess) return (int)opt_in;
  const dim3 grid(S, H, (M + pps - 1) / pps);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const TQ*>(q), static_cast<const TK*>(k_pages),
      static_cast<const TK*>(v_pages), page_table, ctx_lens,
      static_cast<TQ*>(out), part, tickets, H, d, ps, M, pps, scale, ks, vs);
  return (int)cudaGetLastError();
}

template <typename TQ>
int scalar_by_pool(int kv_type, const void* q, const void* k_pages,
                   const void* v_pages, const int* page_table,
                   const int* ctx_lens, void* out, float* part,
                   int* tickets, int S, int H, int d, int ps, int M, int pps,
                   float scale, Strides ks, Strides vs, cudaStream_t st) {
  switch (kv_type) {
    case 0:
      return run_scalar<TQ, float>(q, k_pages, v_pages, page_table, ctx_lens,
                                   out, part, tickets, S, H, d, ps, M, pps,
                                   scale, ks, vs, st);
    case 1:
      return run_scalar<TQ, __nv_bfloat16>(q, k_pages, v_pages, page_table,
                                           ctx_lens, out, part, tickets, S,
                                           H, d, ps, M, pps, scale, ks, vs,
                                           st);
    case 2:
      return run_scalar<TQ, __half>(q, k_pages, v_pages, page_table,
                                    ctx_lens, out, part, tickets, S, H, d,
                                    ps, M, pps, scale, ks, vs, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// pps: pages a split (ops/paged_attention.py paged_splits); part: the
// [S, H, ceil(M / pps), d + 2] f32 workspace and tickets: S * H int32
// zeros (zero again when the launch ends), both unused (may be null) with
// one split. Launches on one stream may share part and tickets; launches
// that may overlap may not. Returns a cudaError_t.
extern "C" int paged_attention_launch(const float* q, const void* k_pages,
                                      const void* v_pages,
                                      const int* page_table,
                                      const int* ctx_lens, float* out,
                                      float* part, int* tickets, int S,
                                      int H, int d, int ps, int M, int pps,
                                      float scale, int cache_is_bf16,
                                      void* stream) {
  if (S < 1 || H < 1 || d < 1 || d > kMaxDim || ps < 1 || M < 1 ||
      pps < 1 ||
      ((M + pps - 1) / pps > 1 && (part == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cache_is_bf16)
    return run<__nv_bfloat16>(q, k_pages, v_pages, page_table, ctx_lens, out,
                              part, tickets, S, H, d, ps, M, pps, scale, st);
  return run<float>(q, k_pages, v_pages, page_table, ctx_lens, out, part,
                    tickets, S, H, d, ps, M, pps, scale, st);
}

// The scalar route, with paged_attention_launch's arguments and: q_type
// and kv_type 0 = f32, 1 = bf16, 2 = f16 (out in q's type, contiguous
// like q, page_table and ctx_lens); k_strides and v_strides the pools'
// element strides (page, token, head, dim). 1 <= d <= 16384. Returns a
// cudaError_t.
extern "C" int paged_attention_scalar_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const int* page_table, const int* ctx_lens, void* out, float* part,
    int* tickets, int S, int H, int d, int ps, int M, int pps, float scale,
    int q_type, int kv_type, long long k_page, long long k_tok,
    long long k_head, long long k_dim, long long v_page, long long v_tok,
    long long v_head, long long v_dim, void* stream) {
  if (S < 1 || H < 1 || d < 1 || d > kScalarMaxDim || ps < 1 || M < 1 ||
      pps < 1 ||
      ((M + pps - 1) / pps > 1 && (part == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides ks{k_page, k_tok, k_head, k_dim};
  const Strides vs{v_page, v_tok, v_head, v_dim};
  switch (q_type) {
    case 0:
      return scalar_by_pool<float>(kv_type, q, k_pages, v_pages, page_table,
                                   ctx_lens, out, part, tickets, S, H, d, ps,
                                   M, pps, scale, ks, vs, st);
    case 1:
      return scalar_by_pool<__nv_bfloat16>(kv_type, q, k_pages, v_pages,
                                           page_table, ctx_lens, out, part,
                                           tickets, S, H, d, ps, M, pps,
                                           scale, ks, vs, st);
    case 2:
      return scalar_by_pool<__half>(kv_type, q, k_pages, v_pages, page_table,
                                    ctx_lens, out, part, tickets, S, H, d, ps,
                                    M, pps, scale, ks, vs, st);
  }
  return (int)cudaErrorInvalidValue;
}
