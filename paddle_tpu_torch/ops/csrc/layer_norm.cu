// Row layer norm for Hopper (sm_90a): forward with saved statistics, and
// the backward's dx.
//
// Replaces the two Pallas bodies of paddle_tpu/ops/pallas_layer_norm.py:
//   layer_norm_fwd    <- _fwd_kernel     (launched by _ln_fwd_impl)
//   layer_norm_bwd_dx <- _bwd_dx_kernel  (launched by _ln_bwd)
// on x/y/dy/dx (R, C) row-major in T = float or bfloat16, scale/bias (C,)
// float32, mean/rstd (R,) float32 (the TPU kernel's (R, 128) lane
// broadcast of the statistics is a TPU tiling artefact, not part of the
// function):
//   mean = sum(x) / C                 var = sum((x - mean)^2) / C
//   rstd = rsqrt(var + eps)           y = (x - mean) * rstd * scale + bias
//   a = dy * scale, xhat = (x - mean) * rstd
//   dx = rstd * (a - mean(a) - xhat * mean(a * xhat))
// dscale and dbias are cross-row sums that the caller computes in
// PyTorch, as the reference leaves them to jnp.
//
// Design. The TPU kernel normalises a block of 8..256 rows per grid step
// because a VMEM tile wants whole (8, 128) vregs; here a row is the unit:
// one block per row stages it in shared memory as f32 with one pass over
// global memory (vector loads of four elements when C % 4 == 0 and the
// pointers are 16-byte aligned), then takes the two-pass statistics from
// shared memory: the mean first, then the mean of squared differences
// (not E[x^2] - mean^2, which cancels at BERT's eps = 1e-12). Sums are
// warp shuffles and one shared-memory step in a fixed order, so two runs
// give the same bits. Any R >= 1 (one block each), 1 <= C <= 16384 (64 KB
// of shared memory for the forward's row, 128 KB for the backward's two).
//
// Bound on this card (HBM 3.35 TB/s): the forward reads x and writes y,
// the backward reads x and dy and writes dx; at R = 2048, C = 768 in f32
// that is 12.6 MB (3.8 us) and 18.9 MB (5.6 us).
#include "row_norm.cuh"

namespace {

using namespace row_norm;

template <typename T, bool VEC>
__global__ void ln_fwd_kernel(const T* __restrict__ x,
                              const float* __restrict__ scale,
                              const float* __restrict__ bias,
                              T* __restrict__ y, float* __restrict__ mean,
                              float* __restrict__ rstd, int C, float eps) {
  extern __shared__ float smem[];
  __shared__ float red[32];
  float* row = smem;
  const size_t r = blockIdx.x;
  float s = 0.f;
  for_row<VEC>(x + r * C, C, [&](int c, float v) {
    row[c] = v;
    s += v;
  });
  const float mu = block_sum(s, red) / C;  // also orders row[] for all
  float sq = 0.f;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float d = row[c] - mu;
    sq += d * d;
  }
  const float rs = rsqrtf(block_sum(sq, red) / C + eps);
  write_row<VEC>(y + r * C, C, [&](int c) {
    return (row[c] - mu) * rs * scale[c] + bias[c];
  });
  if (threadIdx.x == 0) {
    mean[r] = mu;
    rstd[r] = rs;
  }
}

template <typename T, bool VEC>
__global__ void ln_bwd_dx_kernel(const T* __restrict__ x,
                                 const float* __restrict__ scale,
                                 const float* __restrict__ mean,
                                 const float* __restrict__ rstd,
                                 const T* __restrict__ dy,
                                 T* __restrict__ dx, int C) {
  extern __shared__ float smem[];
  __shared__ float red[32];
  float* xh = smem;      // xhat
  float* a = smem + C;   // dy * scale
  const size_t r = blockIdx.x;
  const float mu = mean[r], rs = rstd[r];
  for_row<VEC>(x + r * C, C, [&](int c, float v) { xh[c] = (v - mu) * rs; });
  float s1 = 0.f, s2 = 0.f;
  // each thread reads back only the xhat entries it wrote itself
  for_row<VEC>(dy + r * C, C, [&](int c, float v) {
    const float av = v * scale[c];
    a[c] = av;
    s1 += av;
    s2 += av * xh[c];
  });
  const float c1 = block_sum(s1, red) / C;
  const float c2 = block_sum(s2, red) / C;
  write_row<VEC>(dx + r * C, C, [&](int c) {
    return rs * (a[c] - c1 - xh[c] * c2);
  });
}

template <typename T>
int fwd_run(const void* x, const float* scale, const float* bias, void* y,
            float* mean, float* rstd, int R, int C, float eps,
            cudaStream_t st) {
  const bool vec = C % 4 == 0 && aligned16(x) && aligned16(y);
  const size_t smem = sizeof(float) * C;
  auto kern = vec ? ln_fwd_kernel<T, true> : ln_fwd_kernel<T, false>;
  if (int e = set_smem(kern, smem)) return e;
  kern<<<R, threads_for(C), smem, st>>>((const T*)x, scale, bias, (T*)y,
                                        mean, rstd, C, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_run(const void* x, const float* scale, const float* mean,
            const float* rstd, const void* dy, void* dx, int R, int C,
            cudaStream_t st) {
  const bool vec =
      C % 4 == 0 && aligned16(x) && aligned16(dy) && aligned16(dx);
  const size_t smem = 2 * sizeof(float) * C;
  auto kern = vec ? ln_bwd_dx_kernel<T, true> : ln_bwd_dx_kernel<T, false>;
  if (int e = set_smem(kern, smem)) return e;
  kern<<<R, threads_for(C), smem, st>>>((const T*)x, scale, mean, rstd,
                                        (const T*)dy, (T*)dx, C);
  return (int)cudaGetLastError();
}

bool bad_shape(int R, int C) { return R <= 0 || C <= 0 || C > kMaxCols; }

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, y); scale, bias, mean, rstd float32.
extern "C" int layer_norm_fwd_launch(const void* x, const float* scale,
                                     const float* bias, void* y, float* mean,
                                     float* rstd, int R, int C, int dtype,
                                     float eps, void* stream) {
  if (bad_shape(R, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fwd_run<float>(x, scale, bias, y, mean, rstd, R, C, eps, st);
  if (dtype == 1)
    return fwd_run<__nv_bfloat16>(x, scale, bias, y, mean, rstd, R, C, eps,
                                  st);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 float32, 1 bfloat16 (x, dy, dx); scale, mean, rstd float32.
extern "C" int layer_norm_bwd_dx_launch(const void* x, const float* scale,
                                        const float* mean, const float* rstd,
                                        const void* dy, void* dx, int R,
                                        int C, int dtype, void* stream) {
  if (bad_shape(R, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd_run<float>(x, scale, mean, rstd, dy, dx, R, C, st);
  if (dtype == 1)
    return bwd_run<__nv_bfloat16>(x, scale, mean, rstd, dy, dx, R, C, st);
  return (int)cudaErrorInvalidValue;
}
