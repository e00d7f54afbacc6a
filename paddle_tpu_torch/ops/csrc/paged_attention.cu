// Ragged paged-attention decode for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/paged_attention.py:_paged_kernel (launched by
// paged_attention_pallas): one query token per slot against that slot's
// ragged KV history in a page pool, online softmax in f32, masked past
// ctx_lens, an all-masked row (ctx 0) returns 0 (the l==0 -> 1 rule).
//
// Layouts (row-major, contiguous):
//   q          [S, H, d]        f32
//   k/v pages  [P, ps, H, d]    f32 or bf16 (template T)
//   page_table [S, M]           int32, every entry a valid pool index
//   ctx_lens   [S]              int32
//   out        [S, H, d]        f32
//
// Design: one block per (slot, head), 4 warps, each lane owning
// head dimensions lane, lane+32, ... (d <= 128). Warp w walks its own
// page stream (pages w, w+4, ...) below ceil(ctx/ps), reading the page
// indices itself from page_table (the TPU kernel scalar-prefetched
// them): per page it scores the tokens (lane partial dot products +
// xor-shuffle sums, a fixed order), rescales its running max / sum /
// accumulator once, and adds p_t * v_t. No block barrier per page; the
// four warps' (max, sum, acc) merge once at the end in warp order.
//
// Bound on this card: bytes. Each call must read q, the K and V rows
// of the ctx tokens of every (slot, head), the tables and write out:
// about 2 * sum(ctx) * H * d * sizeof(T) bytes, against a handful of
// flops per byte. At the serving shapes (S=8, H=16, d=128, f32 cache,
// ctx up to 2048) that is at most 268 MB, i.e. 80 us at 3.35 TB/s.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDim = 128;   // head dim bound: 4 dims per lane
constexpr int kDimPerLane = kMaxDim / 32;
constexpr int kMaxPage = 128;  // score buffer bound (page_size)
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const float* __restrict__ q,
                           const T* __restrict__ k_pages,
                           const T* __restrict__ v_pages,
                           const int* __restrict__ page_table,
                           const int* __restrict__ ctx_lens,
                           float* __restrict__ out, int H, int d, int ps,
                           int M, float scale) {
  __shared__ float score_s[kWarps][kMaxPage];
  __shared__ float m_s[kWarps], l_s[kWarps];
  __shared__ float acc_s[kWarps][kMaxDim];
  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const size_t qo = ((size_t)s * H + h) * d;
  float qr[kDimPerLane], acc[kDimPerLane];
#pragma unroll
  for (int j = 0; j < kDimPerLane; ++j) {
    const int i = lane + 32 * j;
    qr[j] = i < d ? q[qo + i] : 0.f;
    acc[j] = 0.f;
  }

  const int ctx = ctx_lens[s];
  int n_pages = ctx > 0 ? (ctx + ps - 1) / ps : 0;
  if (n_pages > M) n_pages = M;
  const size_t tok_stride = (size_t)H * d;
  const size_t page_stride = (size_t)ps * tok_stride;
  float* sc = score_s[warp];

  float m_run = kNeg, l_run = 0.f;
  for (int m = warp; m < n_pages; m += kWarps) {
    const size_t base =
        (size_t)page_table[(size_t)s * M + m] * page_stride + (size_t)h * d;
    const T* kb = k_pages + base;
    const T* vb = v_pages + base;
    const int valid = min(ps, ctx - m * ps);   // tokens of this page < ctx
    float pmax = kNeg;
    for (int t = 0; t < valid; ++t) {
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < kDimPerLane; ++j) {
        const int i = lane + 32 * j;
        if (i < d) part += qr[j] * to_f32(kb[t * tok_stride + i]);
      }
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      part *= scale;
      if (lane == 0) sc[t] = part;
      pmax = fmaxf(pmax, part);
    }
    __syncwarp();
    const float m_new = fmaxf(m_run, pmax);
    const float alpha = expf(m_run - m_new);
    l_run *= alpha;
#pragma unroll
    for (int j = 0; j < kDimPerLane; ++j) acc[j] *= alpha;
    for (int t = 0; t < valid; ++t) {
      const float p = expf(sc[t] - m_new);
      l_run += p;
#pragma unroll
      for (int j = 0; j < kDimPerLane; ++j) {
        const int i = lane + 32 * j;
        if (i < d) acc[j] += p * to_f32(vb[t * tok_stride + i]);
      }
    }
    m_run = m_new;
    __syncwarp();   // sc is rewritten by the next page
  }

  if (lane == 0) {
    m_s[warp] = m_run;
    l_s[warp] = l_run;
  }
#pragma unroll
  for (int j = 0; j < kDimPerLane; ++j) acc_s[warp][lane + 32 * j] = acc[j];
  __syncthreads();
  const int i = threadIdx.x;
  if (i < d) {
    float m_tot = kNeg;
    for (int w = 0; w < kWarps; ++w) m_tot = fmaxf(m_tot, m_s[w]);
    float l_tot = 0.f, a_tot = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(m_s[w] - m_tot);
      l_tot += l_s[w] * f;
      a_tot += acc_s[w][i] * f;
    }
    out[qo + i] = a_tot / (l_tot == 0.f ? 1.f : l_tot);
  }
}

}  // namespace

extern "C" int paged_attention_launch(const float* q, const void* k_pages,
                                      const void* v_pages,
                                      const int* page_table,
                                      const int* ctx_lens, float* out, int S,
                                      int H, int d, int ps, int M,
                                      float scale, int cache_is_bf16,
                                      void* stream) {
  if (d > kMaxDim || ps > kMaxPage) return (int)cudaErrorInvalidValue;
  const dim3 grid(S, H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cache_is_bf16) {
    paged_attention_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        q, static_cast<const __nv_bfloat16*>(k_pages),
        static_cast<const __nv_bfloat16*>(v_pages), page_table, ctx_lens,
        out, H, d, ps, M, scale);
  } else {
    paged_attention_kernel<float><<<grid, kThreads, 0, st>>>(
        q, static_cast<const float*>(k_pages),
        static_cast<const float*>(v_pages), page_table, ctx_lens, out, H, d,
        ps, M, scale);
  }
  return (int)cudaGetLastError();
}
