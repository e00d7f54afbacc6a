// The bf16 tensor-core tile of this directory's kernels (sm_90a):
// acc (128 x 128, f32) = A[m0:m0+128, :] @ B[:, n0:n0+128] for a
// row-major A (M, K) and a row-major B (K, N), both bf16, K a multiple
// of 64, read through TMA into a ring of shared-memory stages and
// multiplied by wgmma.
//
// A block is three warpgroups. Warpgroups 0 and 1 are the consumers:
// each owns 64 rows of the tile and issues wgmma.mma_async m64n128k16
// with the f32 sum in 64 registers a thread. One thread of warpgroup 2
// is the producer: it keeps STAGES TMA loads in flight, each stage one
// 128 x 64 box of A and two 64 x 64 boxes of B, completion counted on
// the stage's "full" mbarrier; a consumer warpgroup arrives on the
// stage's "empty" mbarrier once the wgmma that read it has retired.
// A block may walk several tiles (a persistent grid): the ring and its
// phase carry over (Pipe), so the producer fills the next tile's stages
// while the consumers run the previous tile's epilogue.
//
// Layouts, both in the 128-byte swizzle that TMA writes and wgmma reads:
//   A is K-major (K contiguous): a stage holds 128 rows of 128 bytes
//     (64 k); a warpgroup's descriptor starts at its 64-row half, 8-row
//     groups 1024 bytes apart (SBO); a k16 step adds 32 bytes.
//   B is MN-major (N contiguous), as the weights arrive, so they are
//     never transposed on the host: a stage holds two 64-column boxes
//     of 64 k-rows of 128 bytes, 8192 bytes apart (LBO, the stride
//     between 64-column swizzle atoms), 8-k-row groups 1024 bytes apart
//     (SBO); a k16 step adds 16 rows (2048 bytes); the instruction's
//     transpose bit for B is set.
// Rows past M and columns past N read as zeros (TMA's out-of-bounds
// fill); the caller masks them in its epilogue.
//
// Beside the tile, the pieces the flash kernels (flash_attention.cu)
// build on: 3-D tensor maps (a box never crosses the outer dimension, so
// a tile of one head reads zeros past its rows, never the next head's),
// wgmma at N = 64 and 128 with B K-major (transpose bit 0: B given as N
// rows of K, as K and V arrive for Q K^T and dO V^T; the same descriptor
// as A's) or MN-major (bit 1), and with A from registers: the f32
// accumulator of one product, packed into bf16 pairs, is the A fragment
// of the next (k-step k takes accumulator columns 16k..16k+15: a[r] =
// pack(acc[8k + 2r], acc[8k + 2r + 1])).
//
// Accumulator fragment of a consumer thread (warpgroup thread t, warp
// w = t / 32, lane l): acc[4j + 2h + e] is the element at tile row
// 64 * wg + 16 w + l / 4 + 8 h and tile column 8 j + 2 (l % 4) + e, for
// j < 16, h < 2, e < 2 (the m64nNk16 f32 layout of the PTX ISA).
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wgmma_tile {

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 6;
constexpr int kThreads = 384;                 // 2 consumer + 1 producer WG
constexpr int A_BYTES = BM * BK * 2;          // 16 KB
constexpr int B_HALF = BK * 64 * 2;           // 8 KB: 64 k-rows x 64 cols
constexpr int STAGE_BYTES = A_BYTES + 2 * B_HALF;
// ring + barriers + slack to align the ring to the 1024-byte swizzle atom
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;

// -- host: TMA descriptors ----------------------------------------------

typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query, so the library needs no -lcuda.
inline EncodeTiledFn encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// Error codes of map_2d beyond cudaError_t's range.
constexpr int kNoEncoder = 10001, kEncodeFailed = 10002;

// A bf16 row-major (rows, cols) matrix at `base`, read in boxes of
// box_rows x 64 columns (128 bytes, the swizzle span). base must be 16-byte
// aligned and cols a multiple of 8 (the row stride a multiple of 16 bytes).
inline int map_2d(CUtensorMap* map, const void* base, uint64_t rows,
                  uint64_t cols, uint32_t box_rows) {
  EncodeTiledFn fn = encoder();
  if (fn == nullptr) return kNoEncoder;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 2};
  const cuuint32_t box[2] = {64, box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed;
}

// outer bf16 row-major (rows, cols) matrices at `base`, one after the
// other, read in boxes of box_rows x 64 columns of one matrix; rows past
// `rows` read as zeros. Same alignment rules as map_2d.
inline int map_3d(CUtensorMap* map, const void* base, uint64_t outer,
                  uint64_t rows, uint64_t cols, uint32_t box_rows) {
  EncodeTiledFn fn = encoder();
  if (fn == nullptr) return kNoEncoder;
  const cuuint64_t dims[3] = {cols, rows, outer};
  const cuuint64_t strides[2] = {cols * 2, rows * cols * 2};
  const cuuint32_t box[3] = {64, box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed;
}

// -- device: barriers, TMA, wgmma --------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// A phase that has not completed after kHangNs means a barrier protocol
// fault: trap (the launch fails with an error) rather than hang the card.
constexpr uint64_t kHangNs = 5000000000ull;

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try(bar, parity))
    if (global_ns() - t0 > kHangNs) __trap();
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)), "r"(bytes) : "memory");
}

// box at (col, row) of `map` -> dst, completion on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int col, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row) : "memory");
}

// box at (col, row, outer index z) of a 3-D `map` -> dst, completion on bar
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int col, int row, int z,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row), "r"(z) : "memory");
}

// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completion on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((smem_u32(p) >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of acc across the async wgmma.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// ... and from reusing an A fragment's registers before its wgmma retired.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d += A(64 x 16, K-major, smem) @ B(16 x 64, smem, K-major when TB = 0,
// MN-major when TB = 1)
template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, "
      "%25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "n"(1), "n"(TB));
}

// d += A(64 x 16, bf16 pairs in registers: the m64nNk16 A fragment) @
// B(16 x 64, smem, MN-major when TB = 1)
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, "
      "%25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1),
        "n"(TB));
}

// d += A(64 x 16, K-major, smem) @ B(16 x 128, smem, K-major when TB = 0,
// MN-major when TB = 1)
template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, "
      "%25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, "
      "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
      "%61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "n"(1), "n"(TB));
}

// d += A(64 x 16, bf16 pairs in registers: the m64nNk16 A fragment) @
// B(16 x 128, smem, MN-major when TB = 1)
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, "
      "%25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, "
      "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
      "%61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1),
        "n"(TB));
}

// -- the tile -----------------------------------------------------------

struct Ring {
  uint8_t* stage;  // STAGES x STAGE_BYTES, 1024-byte aligned
  uint64_t* full;  // STAGES
  uint64_t* empty;  // STAGES
};

// A thread's position in a ring of NS stages: the next stage and its
// phase parity.
template <int NS = STAGES>
struct Pipe {
  int s = 0;
  uint32_t ph = 0;
  __device__ __forceinline__ void advance() {
    if (++s == NS) s = 0, ph ^= 1;
  }
};

// Carves the ring out of dynamic shared memory and initialises its
// barriers; every thread of the block calls it (it synchronises).
__device__ __forceinline__ Ring make_ring(uint8_t* smem_raw) {
  Ring r;
  r.stage = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  r.full = reinterpret_cast<uint64_t*>(r.stage + STAGES * STAGE_BYTES);
  r.empty = r.full + STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&r.full[s], 1);   // the producer's expect_tx arrival
      mbar_init(&r.empty[s], 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

// The producer thread: nk stages of A (rows m0..) and B (columns n0..).
__device__ __forceinline__ void produce(const Ring& r, Pipe<>& p,
                                        const CUtensorMap* ta,
                                        const CUtensorMap* tb, int m0,
                                        int n0, int nk) {
  for (int t = 0; t < nk; ++t, p.advance()) {
    mbar_wait(&r.empty[p.s], p.ph ^ 1);  // the first round passes at once
    mbar_expect_tx(&r.full[p.s], STAGE_BYTES);
    uint8_t* a = r.stage + p.s * STAGE_BYTES;
    uint8_t* b = a + A_BYTES;
    tma_load(a, ta, t * BK, m0, &r.full[p.s]);
    tma_load(b, tb, n0, t * BK, &r.full[p.s]);
    tma_load(b + B_HALF, tb, n0 + 64, t * BK, &r.full[p.s]);
  }
}

// A consumer warpgroup (wg 0 or 1): acc = its 64 rows of the tile whose
// nk stages come next in the ring; every stage is released once read.
__device__ __forceinline__ void consume(const Ring& r, Pipe<>& p, int wg,
                                       int nk, float (&acc)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const bool leader = (threadIdx.x & 127) == 0;
  int prev = -1;
  for (int t = 0; t < nk; ++t, p.advance()) {
    mbar_wait(&r.full[p.s], p.ph);
    const uint8_t* a = r.stage + p.s * STAGE_BYTES + wg * 64 * 128;
    const uint8_t* b = r.stage + p.s * STAGE_BYTES + A_BYTES;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_ss<1>(acc, desc(a + kk * 32, 16, 1024),
                  desc(b + kk * 16 * 128, B_HALF, 1024));
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products have retired
    fence_acc(acc);
    if (prev >= 0 && leader) mbar_arrive(&r.empty[prev]);
    prev = p.s;
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (prev >= 0 && leader) mbar_arrive(&r.empty[prev]);
}

}  // namespace wgmma_tile
