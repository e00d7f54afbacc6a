// Fused dropout + residual add + layer norm for Hopper (sm_90a), forward
// and backward.
//
// Replaces the two Pallas bodies of
// paddle_tpu/ops/pallas_fused_residual.py:
//   dropout_add_ln_fwd <- _fwd_kernel  (launched by _fwd_impl)
//   dropout_add_ln_bwd <- _bwd_kernel  (launched by _vjp_bwd)
// on x/res/y/z/dy/dx/dres (R, C) row-major in T = float or bfloat16,
// scale/bias (C,) float32, mean/rstd (R,) float32:
//   z = res + (keep ? x / (1 - p) : 0)       y = LN(z) * scale + bias
//   dz = rstd * (a - mean(a) - zhat * mean(a * zhat)),  a = dy * scale
//   dres = dz                                 dx = keep ? dz / (1 - p) : 0
// The transformer sub-layer epilogue in one pass over memory each way. No
// mask tensor exists: the backward replays the mask from the seed with
// the counter hash of dropout_hash.cuh over the element ids row * C + col
// (uint32 wrap-around, as the reference's int32 ids wrap). The layer norm
// runs on the unrounded f32 z; the saved z is rounded to T once.
//
// Design: as layer_norm.cu, one block per row, the row staged in shared
// memory as f32 (the backward stages zhat and a), two-pass statistics,
// fixed-order sums. Any R >= 1, 1 <= C <= 16384.
//
// Bound on this card (HBM 3.35 TB/s) at R = 2048, C = 768, f32: the
// forward moves x, res, y, z (25.2 MB, 7.5 us), the backward z, dy, dx,
// dres (25.2 MB, 7.5 us).
#include "dropout_hash.cuh"
#include "row_norm.cuh"

namespace {

using namespace row_norm;

struct Drop {
  uint32_t seed, thr;
  int on;          // p > 0
  float keep_div;  // 1 - p
};

template <typename T, bool VEC>
__global__ void dal_fwd_kernel(const T* __restrict__ x,
                               const T* __restrict__ res,
                               const float* __restrict__ scale,
                               const float* __restrict__ bias,
                               T* __restrict__ y, T* __restrict__ z,
                               float* __restrict__ mean,
                               float* __restrict__ rstd, int C, float eps,
                               Drop d) {
  extern __shared__ float smem[];
  __shared__ float red[32];
  float* row = smem;
  const size_t r = blockIdx.x;
  for_row<VEC>(x + r * C, C, [&](int c, float v) {
    if (d.on)
      v = dropout_hash::keep(d.seed, (uint32_t)r, c, C, d.thr)
              ? v / d.keep_div : 0.f;
    row[c] = v;
  });
  float s = 0.f;
  // each thread adds the residual to the entries it wrote itself
  for_row<VEC>(res + r * C, C, [&](int c, float v) {
    const float zv = row[c] + v;
    row[c] = zv;
    s += zv;
  });
  const float mu = block_sum(s, red) / C;
  float sq = 0.f;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float dv = row[c] - mu;
    sq += dv * dv;
  }
  const float rs = rsqrtf(block_sum(sq, red) / C + eps);
  write_row<VEC>(z + r * C, C, [&](int c) { return row[c]; });
  write_row<VEC>(y + r * C, C, [&](int c) {
    return (row[c] - mu) * rs * scale[c] + bias[c];
  });
  if (threadIdx.x == 0) {
    mean[r] = mu;
    rstd[r] = rs;
  }
}

template <typename T, bool VEC>
__global__ void dal_bwd_kernel(const T* __restrict__ z,
                               const float* __restrict__ scale,
                               const float* __restrict__ mean,
                               const float* __restrict__ rstd,
                               const T* __restrict__ dy, T* __restrict__ dx,
                               T* __restrict__ dres, int C, Drop d) {
  extern __shared__ float smem[];
  __shared__ float red[32];
  float* zh = smem;     // zhat
  float* a = smem + C;  // dy * scale
  const size_t r = blockIdx.x;
  const float mu = mean[r], rs = rstd[r];
  for_row<VEC>(z + r * C, C, [&](int c, float v) { zh[c] = (v - mu) * rs; });
  float s1 = 0.f, s2 = 0.f;
  for_row<VEC>(dy + r * C, C, [&](int c, float v) {
    const float av = v * scale[c];
    a[c] = av;
    s1 += av;
    s2 += av * zh[c];
  });
  const float c1 = block_sum(s1, red) / C;
  const float c2 = block_sum(s2, red) / C;
  auto dz = [&](int c) { return rs * (a[c] - c1 - zh[c] * c2); };
  write_row<VEC>(dres + r * C, C, dz);
  write_row<VEC>(dx + r * C, C, [&](int c) {
    const float g = dz(c);
    if (!d.on) return g;
    return dropout_hash::keep(d.seed, (uint32_t)r, c, C, d.thr)
               ? g / d.keep_div : 0.f;
  });
}

template <typename T>
int fwd_run(const void* x, const void* res, const float* scale,
            const float* bias, void* y, void* z, float* mean, float* rstd,
            int R, int C, float eps, Drop d, cudaStream_t st) {
  const bool vec = C % 4 == 0 && aligned16(x) && aligned16(res) &&
                   aligned16(y) && aligned16(z);
  const size_t smem = sizeof(float) * C;
  auto kern = vec ? dal_fwd_kernel<T, true> : dal_fwd_kernel<T, false>;
  if (int e = set_smem(kern, smem)) return e;
  kern<<<R, threads_for(C), smem, st>>>((const T*)x, (const T*)res, scale,
                                        bias, (T*)y, (T*)z, mean, rstd, C,
                                        eps, d);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_run(const void* z, const float* scale, const float* mean,
            const float* rstd, const void* dy, void* dx, void* dres, int R,
            int C, Drop d, cudaStream_t st) {
  const bool vec = C % 4 == 0 && aligned16(z) && aligned16(dy) &&
                   aligned16(dx) && aligned16(dres);
  const size_t smem = 2 * sizeof(float) * C;
  auto kern = vec ? dal_bwd_kernel<T, true> : dal_bwd_kernel<T, false>;
  if (int e = set_smem(kern, smem)) return e;
  kern<<<R, threads_for(C), smem, st>>>((const T*)z, scale, mean, rstd,
                                        (const T*)dy, (T*)dx, (T*)dres, C,
                                        d);
  return (int)cudaGetLastError();
}

bool bad_shape(int R, int C) { return R <= 0 || C <= 0 || C > kMaxCols; }

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, res, y, z); scale, bias, mean, rstd
// float32. drop != 0 applies the mask of (seed, thr) and divides the kept
// elements by keep_div = 1 - p.
extern "C" int dropout_add_ln_fwd_launch(
    const void* x, const void* res, const float* scale, const float* bias,
    void* y, void* z, float* mean, float* rstd, int R, int C, int dtype,
    int seed, int drop, unsigned int thr, float keep_div, float eps,
    void* stream) {
  if (bad_shape(R, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Drop d{(uint32_t)seed, thr, drop, keep_div};
  if (dtype == 0)
    return fwd_run<float>(x, res, scale, bias, y, z, mean, rstd, R, C, eps,
                          d, st);
  if (dtype == 1)
    return fwd_run<__nv_bfloat16>(x, res, scale, bias, y, z, mean, rstd, R,
                                  C, eps, d, st);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 float32, 1 bfloat16 (z, dy, dx, dres).
extern "C" int dropout_add_ln_bwd_launch(
    const void* z, const float* scale, const float* mean, const float* rstd,
    const void* dy, void* dx, void* dres, int R, int C, int dtype, int seed,
    int drop, unsigned int thr, float keep_div, void* stream) {
  if (bad_shape(R, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Drop d{(uint32_t)seed, thr, drop, keep_div};
  if (dtype == 0)
    return bwd_run<float>(z, scale, mean, rstd, dy, dx, dres, R, C, d, st);
  if (dtype == 1)
    return bwd_run<__nv_bfloat16>(z, scale, mean, rstd, dy, dx, dres, R, C,
                                  d, st);
  return (int)cudaErrorInvalidValue;
}
