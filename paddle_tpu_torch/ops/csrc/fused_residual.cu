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
// Two routes, picked by the wrapper before the launch with the layer
// norm's picker (ops/layer_norm.py ln_route over the pointers a call
// reads and writes) and grid (ln_grid):
//
// The warp route (C a multiple of one 16-byte vector, C <= 1024, every
// tensor 16-byte aligned: BERT's C = 768 in f32 and bf16), on
// row_norm.cuh's warp frame, as layer_norm.cu's. One warp owns a row:
// lane l takes the 16-byte vectors l, l + 32, ... of the row, NV of them
// (a template parameter: 6 in f32 and 3 in bf16 at C = 768), and issues
// every load of the row (x and res forward, z and dy backward) before
// it uses any. In registers the forward replays the mask, adds
// z = res + x' in f32 and takes two-pass statistics (the mean, then the
// sum of squared differences), each sum an xor butterfly of shuffles in
// a fixed order: every lane holds the same bits, two runs agree, and
// there is no shared memory and no __syncthreads. z (rounded to T once)
// and y leave as 16-byte stores; lane 0 writes mean and rstd. The
// backward holds its scale slice for every row the warp takes, reads
// mean and rstd as two scalars a row, takes s1 = sum(a) and
// s2 = sum(a * zhat) in one register pass (warp_sum2), then writes dres
// and, from the same registers with the mask replayed, dx.
//
// The mask. Each lane hashes its (at most 32) columns into one keep
// bitmask while the row's loads are in flight (the hash needs no data),
// then divides the kept elements by 1 - p (a division, as the plain
// version's, not a product with a reciprocal).
//
// Registers. The forward holds x and res of its row (2 x 32 floats a
// lane at the cap) but not scale and bias: it reads their 16-byte
// slices again for each row it stores, from L1 (6 KB at C = 768 in f32,
// shared by every warp of the SM). The backward holds z, dy and the
// scale slice, as layer_norm.cu's dx kernel does. Both are bounded to
// two blocks of 256 threads an SM (ln_grid's one wave at R = 2048), so
// ptxas has 128 registers a thread; without that bound it spilled the
// f32 forward at NV = 8 to stay at 80. ptxas -v (sm_90a), registers at
// NV = 1 / 2 / 3 / 4 / 6 / 8 (f32) and 1 / 2 / 3 / 4 (bf16), no spills
// (BERT's C = 768 takes f32 NV 6 and bf16 NV 3):
//   dal_fwd_warp_kernel f32 39/50/56/70/96/111, bf16 48/64/70/77
//   dal_bwd_warp_kernel f32 40/56/64/86/124/128, bf16 53/87/116/128
//
// The row route (everything else: any R >= 1, 1 <= C <= 16384, any
// alignment; the first port's kernels): as layer_norm.cu's, one block
// per row, the row staged in shared memory as f32 (the backward stages
// zhat and a), two-pass statistics, fixed-order block sums.
//
// p = 0 backward. dx = dz / 1 is dres bit for bit, so the launch takes a
// null dx and writes dres only; the wrapper hands dres back as both
// gradients. At p > 0 both are written.
//
// Bound on this card (HBM 3.35 TB/s) at R = 2048, C = 768, f32: the
// forward moves x, res, y, z (25.2 MB, 7.5 us); the backward z, dy, dx,
// dres at p > 0 (25.2 MB, 7.5 us) and z, dy, dres at p = 0 (18.9 MB,
// 5.6 us). bf16 halves each.
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
  if (!dx) return;  // p = 0: dx is dres
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

// ---- the warp route ----------------------------------------------------

// The VW float32 columns of vector vi of a (C,) vector (scale, bias),
// laid out as load_row lays out a row of T.
template <typename T>
__device__ __forceinline__ void load_cols(const float* p, int vi,
                                          float (&v)[kVec<T>]) {
#pragma unroll
  for (int j = 0; j < kVec<T>; j += 4)
    unpack16<float>(ld16(p + (size_t)vi * kVec<T> + j), &v[j]);
}

// Bit i * VW + j set where dropout keeps column (lane + 32 i) * VW + j
// of row r: the lane's whole mask in one register (a lane holds at most
// kLaneElems = 32 columns). It needs no data, so a kernel takes it while
// the row's loads are in flight.
template <int VW, int NV>
__device__ __forceinline__ uint32_t keep_bits(const Drop& d, uint32_t r,
                                              int lane, int C) {
  static_assert(VW * NV <= 32, "a lane's mask is one uint32");
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int j = 0; j < VW; ++j)
      bits |= (uint32_t)dropout_hash::keep(d.seed, r, (lane + 32 * i) * VW + j,
                                           C, d.thr)
              << (i * VW + j);
  return bits;
}

// keep ? v / (1 - p) : 0 for bit b of a keep_bits mask.
__device__ __forceinline__ float drop(float v, uint32_t bits, int b,
                                      const Drop& d) {
  return (bits >> b) & 1u ? v / d.keep_div : 0.f;
}

template <typename T, int NV>
__global__ void __launch_bounds__(32 * kMaxWarps, 2)
    dal_fwd_warp_kernel(const T* __restrict__ x, const T* __restrict__ res,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias, T* __restrict__ y,
                        T* __restrict__ z, float* __restrict__ mean,
                        float* __restrict__ rstd, int R, int C, float eps,
                        Drop d) {
  constexpr int VW = kVec<T>;
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int nvec = C / VW;
  for (int r = blockIdx.x * warps + (threadIdx.x >> 5); r < R;
       r += gridDim.x * warps) {
    uint4 rx[NV], rr[NV];
    issue_row<T, NV>(x + (size_t)r * C, nvec, lane, rx);
    issue_row<T, NV>(res + (size_t)r * C, nvec, lane, rr);
    const uint32_t keep = d.on ? keep_bits<VW, NV>(d, r, lane, C) : 0u;
    // past the row x and res read as 0, so z and its sum add 0
    float v[NV][VW];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float xv[VW], rv[VW];
      unpack16<T>(rx[i], xv);
      unpack16<T>(rr[i], rv);
#pragma unroll
      for (int j = 0; j < VW; ++j) {
        v[i][j] = rv[j] + (d.on ? drop(xv[j], keep, i * VW + j, d) : xv[j]);
        s += v[i][j];
      }
    }
    const float mu = warp_sum(s) / C;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (lane + 32 * i < nvec)
#pragma unroll
        for (int j = 0; j < VW; ++j) {
          const float dv = v[i][j] - mu;
          sq += dv * dv;
        }
    const float rs = rsqrtf(warp_sum(sq) / C + eps);
    T* zr = z + (size_t)r * C;
    T* yr = y + (size_t)r * C;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int vi = lane + 32 * i;
      if (vi < nvec) {
        float sc[VW], bi[VW], o[VW];
        load_cols<T>(scale, vi, sc);
        load_cols<T>(bias, vi, bi);
#pragma unroll
        for (int j = 0; j < VW; ++j)
          o[j] = (v[i][j] - mu) * rs * sc[j] + bi[j];
        st16(zr + (size_t)vi * VW, pack16<T>(v[i]));
        st16(yr + (size_t)vi * VW, pack16<T>(o));
      }
    }
    if (lane == 0) {
      mean[r] = mu;
      rstd[r] = rs;
    }
  }
}

template <typename T, int NV>
__global__ void __launch_bounds__(32 * kMaxWarps, 2)
    dal_bwd_warp_kernel(const T* __restrict__ z,
                        const float* __restrict__ scale,
                        const float* __restrict__ mean,
                        const float* __restrict__ rstd,
                        const T* __restrict__ dy, T* __restrict__ dx,
                        T* __restrict__ dres, int R, int C, Drop d) {
  constexpr int VW = kVec<T>;
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int nvec = C / VW;
  float sc[NV][VW];
  load_slice<T, NV>(scale, nvec, lane, sc);
  for (int r = blockIdx.x * warps + (threadIdx.x >> 5); r < R;
       r += gridDim.x * warps) {
    uint4 rz[NV], rd[NV];
    issue_row<T, NV>(z + (size_t)r * C, nvec, lane, rz);
    issue_row<T, NV>(dy + (size_t)r * C, nvec, lane, rd);
    const float mu = mean[r], rs = rstd[r];
    const uint32_t keep = dx && d.on ? keep_bits<VW, NV>(d, r, lane, C) : 0u;
    float zh[NV][VW], a[NV][VW];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      unpack16<T>(rz[i], zh[i]);
      unpack16<T>(rd[i], a[i]);
    }
    // past the row dy and scale read as 0, so a and a * zhat add 0
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int j = 0; j < VW; ++j) {
        zh[i][j] = (zh[i][j] - mu) * rs;
        a[i][j] *= sc[i][j];
        s1 += a[i][j];
        s2 += a[i][j] * zh[i][j];
      }
    warp_sum2(s1, s2);
    const float c1 = s1 / C, c2 = s2 / C;
    T* rr = dres + (size_t)r * C;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int vi = lane + 32 * i;
      if (vi < nvec) {
        float o[VW];
#pragma unroll
        for (int j = 0; j < VW; ++j)
          o[j] = rs * (a[i][j] - c1 - zh[i][j] * c2);
        st16(rr + (size_t)vi * VW, pack16<T>(o));
        if (dx) {  // null at p = 0: dx is dres
          if (d.on)
#pragma unroll
            for (int j = 0; j < VW; ++j)
              o[j] = drop(o[j], keep, i * VW + j, d);
          st16(dx + (size_t)r * C + (size_t)vi * VW, pack16<T>(o));
        }
      }
    }
  }
}

template <typename T>
int fwd_warp_run(const void* x, const void* res, const float* scale,
                 const float* bias, void* y, void* z, float* mean,
                 float* rstd, int R, int C, float eps, Drop d, int warps,
                 int blocks, cudaStream_t st) {
  if (!warp_takes<T>(R, C, warps, blocks, {x, res, scale, bias, y, z}))
    return (int)cudaErrorInvalidValue;
  const int need = (C / kVec<T> + 31) / 32;
  return with_nv<T>(need, [&](auto nv) {
    dal_fwd_warp_kernel<T, decltype(nv)::value>
        <<<blocks, 32 * warps, 0, st>>>((const T*)x, (const T*)res, scale,
                                        bias, (T*)y, (T*)z, mean, rstd, R,
                                        C, eps, d);
    return (int)cudaGetLastError();
  });
}

template <typename T>
int bwd_warp_run(const void* z, const float* scale, const float* mean,
                 const float* rstd, const void* dy, void* dx, void* dres,
                 int R, int C, Drop d, int warps, int blocks,
                 cudaStream_t st) {
  if (!warp_takes<T>(R, C, warps, blocks, {z, scale, dy, dres}) ||
      !aligned16(dx))
    return (int)cudaErrorInvalidValue;
  const int need = (C / kVec<T> + 31) / 32;
  return with_nv<T>(need, [&](auto nv) {
    dal_bwd_warp_kernel<T, decltype(nv)::value>
        <<<blocks, 32 * warps, 0, st>>>((const T*)z, scale, mean, rstd,
                                        (const T*)dy, (T*)dx, (T*)dres, R,
                                        C, d);
    return (int)cudaGetLastError();
  });
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

// dtype: 0 float32, 1 bfloat16 (z, dy, dx, dres). dx may be null when
// drop == 0 (p = 0): then only dres is written, and it is dx as well.
extern "C" int dropout_add_ln_bwd_launch(
    const void* z, const float* scale, const float* mean, const float* rstd,
    const void* dy, void* dx, void* dres, int R, int C, int dtype, int seed,
    int drop, unsigned int thr, float keep_div, void* stream) {
  if (bad_shape(R, C) || (drop && !dx)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Drop d{(uint32_t)seed, thr, drop, keep_div};
  if (dtype == 0)
    return bwd_run<float>(z, scale, mean, rstd, dy, dx, dres, R, C, d, st);
  if (dtype == 1)
    return bwd_run<__nv_bfloat16>(z, scale, mean, rstd, dy, dx, dres, R, C,
                                  d, st);
  return (int)cudaErrorInvalidValue;
}

// The warp route (see the header): `warps` rows a block at once,
// `blocks` blocks walking the rows; the arguments of the row route's
// entry points otherwise. cudaErrorInvalidValue for a call the route
// does not take.
extern "C" int dropout_add_ln_fwd_warp_launch(
    const void* x, const void* res, const float* scale, const float* bias,
    void* y, void* z, float* mean, float* rstd, int R, int C, int dtype,
    int seed, int drop, unsigned int thr, float keep_div, float eps,
    int warps, int blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Drop d{(uint32_t)seed, thr, drop, keep_div};
  if (dtype == 0)
    return fwd_warp_run<float>(x, res, scale, bias, y, z, mean, rstd, R, C,
                               eps, d, warps, blocks, st);
  if (dtype == 1)
    return fwd_warp_run<__nv_bfloat16>(x, res, scale, bias, y, z, mean,
                                       rstd, R, C, eps, d, warps, blocks,
                                       st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int dropout_add_ln_bwd_warp_launch(
    const void* z, const float* scale, const float* mean, const float* rstd,
    const void* dy, void* dx, void* dres, int R, int C, int dtype, int seed,
    int drop, unsigned int thr, float keep_div, int warps, int blocks,
    void* stream) {
  if (drop && !dx) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Drop d{(uint32_t)seed, thr, drop, keep_div};
  if (dtype == 0)
    return bwd_warp_run<float>(z, scale, mean, rstd, dy, dx, dres, R, C, d,
                               warps, blocks, st);
  if (dtype == 1)
    return bwd_warp_run<__nv_bfloat16>(z, scale, mean, rstd, dy, dx, dres,
                                       R, C, d, warps, blocks, st);
  return (int)cudaErrorInvalidValue;
}
