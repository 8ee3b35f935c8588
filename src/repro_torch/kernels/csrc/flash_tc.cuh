// Building blocks of the bfloat16 tensor-core route of the flash-attention
// kernels for Hopper (sm_90a): flash_fwd.cu's forward and flash_bwd.cu's dQ
// and dK/dV. Inline PTX only (no CUTLASS or CuTe), so a build takes seconds.
//
// The forward and dQ share one shape. A block owns one (b, h, 128-row q
// tile) and runs 256 threads: two warpgroups of 64 q rows each, and no
// producer warp. ptxas budgets registers for whole warpgroups and, in this
// toolchain, does not raise a region's budget past the launch's for
// setmaxnreg, so a producer warp would cut every thread to 168 registers,
// and the 64 x D float32 accumulator (128 a thread at D = 256), the score
// tiles and the softmax's temporaries would spill. Thread 0 issues the TMA
// loads instead: the q tile (and dO) and the first K/V tile up front, then
// each later tile one iteration ahead, right after its warpgroup has issued
// that iteration's asynchronous wgmma, into the stage that both warpgroups
// have released (load_stage). Each of the kStages stages has four mbarriers
// (K full, V full, K empty, V empty), so a K tile is refilled as soon as the
// warpgroups are done with it, before they are done with its V tile.
//
// dK/dV turns the shape around: a block owns one (b, kv head, 64-key tile)
// whose K and V stay in shared memory, and the ring streams the 64-row Q and
// dO tiles of the GQA group instead, each with its rows' float32 lse or
// delta (a 1-D tensor map, load_stage_rows). Its two warpgroups split the
// work by accumulator, not by rows, and hand one float32 tile to each other
// through shared memory under named barriers (named_sync, named_arrive).
//
// The scores S = Q.K^T (and dP = dO.V^T) read both operands from shared
// memory, K-major; the second product (P.V, or dS.K) takes A from registers,
// the score accumulator rounded to bfloat16 in its own fragment layout, and
// B (V or K) from shared memory, MN-major (the transpose bit set), in one
// instruction for the whole head dimension. Every sum is float32. The two
// warpgroups of the forward and dQ take turns issuing their scores' products
// (pingpong_*), so one forms its softmax while the other's products run.
//
// Layout. Every TMA box is 64 columns (128 bytes, one 128-byte swizzle span)
// by R rows, so a tile of R rows and D columns lies in shared memory as
// ceil(D / 64) chunks of R x 128 bytes, 1024-byte aligned, with the 128-byte
// swizzle that wgmma's descriptors expect. A head dimension below 64 reads a
// 64-column box whose columns past D are out of bounds: TMA fills them with
// zeros, so they add nothing to S and give zero output columns, which are not
// stored. Rows past the tensor's length are zero-filled the same way; the
// kernels mask them from bounds.
//
// Fragments. The float32 accumulator of a wgmma m64nNk16 holds N / 2 values
// per thread; value r of the thread with lane l in warp w of its warpgroup
// sits at row 16 w + l / 4 + 8 ((r / 2) % 2) and column 8 (r / 4) + 2 (l % 4)
// + r % 2 (frag_row, frag_col). The A operand from registers of k-step t
// (columns 16 t .. 16 t + 15) is then the bfloat16 pairs (r, r + 1) for r =
// 8 t, 8 t + 2, 8 t + 4, 8 t + 6 of that accumulator, in that order.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time, so no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace flash_tc {

constexpr int kThreads = 256;           // two warpgroups of 64 q rows
constexpr int kStages = 2;              // K/V stages in the ring
constexpr int kChunkCols = 64;          // columns of one TMA box: 128 bytes of bfloat16
constexpr int kSmemAlign = 1024;        // the 128-byte swizzle repeats every 8 rows of 128 bytes
constexpr int kBarrierBytes = 128;      // q full, and (K full, V full, K empty, V empty) per stage: 9 x 8 bytes

// The barriers at `bars`: the q tile's, then four per stage.
struct Barriers {
  uint32_t bars;
  __device__ __forceinline__ uint32_t q_full() const { return bars; }
  __device__ __forceinline__ uint32_t k_full(int s) const { return bars + 8 * (1 + 4 * s); }
  __device__ __forceinline__ uint32_t v_full(int s) const { return bars + 8 * (2 + 4 * s); }
  __device__ __forceinline__ uint32_t k_empty(int s) const { return bars + 8 * (3 + 4 * s); }
  __device__ __forceinline__ uint32_t v_empty(int s) const { return bars + 8 * (4 + 4 * s); }
};

__host__ __device__ constexpr int chunks(int D) { return (D + kChunkCols - 1) / kChunkCols; }
// bytes of an R-row tile of head dimension D in shared memory
__host__ __device__ constexpr int tile_bytes(int rows, int D) { return chunks(D) * rows * 2 * kChunkCols; }

__device__ __forceinline__ int frag_row(int r, int warp, int lane) {
  return 16 * warp + (lane >> 2) + 8 * ((r >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int r, int lane) { return 8 * (r >> 2) + 2 * (lane & 3) + (r & 1); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// bfloat16 pair, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- mbarriers ----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive once and expect `bytes` more of TMA traffic in this phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits until the phase of parity `parity` has completed. A wait that lasts
// kWaitTrapCycles (about 8 s) can only be a fault of the kernel (a barrier
// that is never signalled): it traps, so the launch fails with an error
// instead of holding the card.
constexpr long long kWaitTrapCycles = 1ll << 34;

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > kWaitTrapCycles) __trap();
}

// One thread sets up the barriers; the block waits for it.
__device__ __forceinline__ void init_barriers(const Barriers& bar) {
  if (threadIdx.x == 0) {
    mbar_init(bar.q_full(), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar.k_full(s), 1);
      mbar_init(bar.v_full(s), 1);
      mbar_init(bar.k_empty(s), kThreads);
      mbar_init(bar.v_empty(s), kThreads);
    }
    mbar_init_fence();
  }
  __syncthreads();
}

// ---- TMA ------------------------------------------------------------------

// box at coordinates (c0, c1, c2, c3) = (column, row, head, batch) into dst
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// box at coordinate c0 of a 1-D tensor map into dst
__device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0)
      : "memory");
}

// ---- wgmma ------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// keeps the compiler from moving reads or writes of these registers across
// an asynchronous wgmma
template <int K>
__device__ __forceinline__ void fence_regs(float (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int K>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand at `addr`:
// lbo and sbo in bytes. K-major (rows of 128 bytes along K): sbo = 1024, the
// stride between 8-row groups, lbo unused. MN-major: sbo = 1024, the stride
// between 8-row groups along K, lbo the stride between 64-column chunks
// along MN.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

#define FLASH_TC_ACC8(d, i)                                                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), \
      "+f"(d[i + 7])

// d (64 x 32) (+)= A (64 x 16, K-major, shared) . B (32 x 16, K-major, shared)^T
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : FLASH_TC_ACC8(d, 0), FLASH_TC_ACC8(d, 8)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64) (+)= A (64 x 16, K-major, shared) . B (64 x 16, K-major, shared)^T
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "
      "%23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : FLASH_TC_ACC8(d, 0), FLASH_TC_ACC8(d, 8), FLASH_TC_ACC8(d, 16), FLASH_TC_ACC8(d, 24)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64) += A (64 x 16, bfloat16 pairs in registers) . B (16 x 64, MN-major, shared)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "
      "%23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : FLASH_TC_ACC8(d, 0), FLASH_TC_ACC8(d, 8), FLASH_TC_ACC8(d, 16), FLASH_TC_ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128) += A (64 x 16, bfloat16 pairs in registers) . B (16 x 128, MN-major, shared)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[2][32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : FLASH_TC_ACC8(d[0], 0), FLASH_TC_ACC8(d[0], 8), FLASH_TC_ACC8(d[0], 16), FLASH_TC_ACC8(d[0], 24),
        FLASH_TC_ACC8(d[1], 0), FLASH_TC_ACC8(d[1], 8), FLASH_TC_ACC8(d[1], 16), FLASH_TC_ACC8(d[1], 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 256) += A (64 x 16, bfloat16 pairs in registers) . B (16 x 256, MN-major, shared)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[4][32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : FLASH_TC_ACC8(d[0], 0), FLASH_TC_ACC8(d[0], 8), FLASH_TC_ACC8(d[0], 16), FLASH_TC_ACC8(d[0], 24),
        FLASH_TC_ACC8(d[1], 0), FLASH_TC_ACC8(d[1], 8), FLASH_TC_ACC8(d[1], 16), FLASH_TC_ACC8(d[1], 24),
        FLASH_TC_ACC8(d[2], 0), FLASH_TC_ACC8(d[2], 8), FLASH_TC_ACC8(d[2], 16), FLASH_TC_ACC8(d[2], 24),
        FLASH_TC_ACC8(d[3], 0), FLASH_TC_ACC8(d[3], 8), FLASH_TC_ACC8(d[3], 16), FLASH_TC_ACC8(d[3], 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O (64 x 64 DC) += A . B for the whole head dimension in one instruction:
// B's DC 64-column chunks lie lbo bytes apart (the descriptor's leading
// byte offset), each 8-row group of K 1024 bytes further.
__device__ __forceinline__ void wgmma_rs(float (&d)[1][32], const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_n64(d[0], a, b);
}
__device__ __forceinline__ void wgmma_rs(float (&d)[2][32], const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_n128(d, a, b);
}
__device__ __forceinline__ void wgmma_rs(float (&d)[4][32], const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_n256(d, a, b);
}

#undef FLASH_TC_ACC8

// ---- host: tensor maps ---------------------------------------------------

// Launch codes beside cudaError_t: no tensor-map encoder in the driver, or
// kErrTensorMap + the CUresult of a refused encoding.
constexpr int kErrNoEncoder = -2;
constexpr int kErrTensorMap = 100000;

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                                             &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The bfloat16 (B, H, S, D) view at `base` with element strides sb, sh, ss
// (the head dimension contiguous) as a 4-D tensor map (D, S, H, B) whose box
// is 64 columns by box_rows rows of one head, 128-byte swizzled; out-of-bounds
// elements read as zeros. Returns 0 or a launch code.
inline int make_tensor_map(CUtensorMap* map, const void* base, int D, int S, int H, int B, long long sb, long long sh,
                           long long ss, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2, static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {kChunkCols, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
                            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap + static_cast<int>(r);
}

// The float32 vector of n entries at `base` (one value per row of a (B, H,
// S) tensor, flattened) as a 1-D tensor map whose box is box_rows entries;
// entries past n read as zeros. TMA reads a box only from a 16-byte-aligned
// start (a coordinate that is a multiple of 4 here); any other start faults
// at run time. Returns 0 or a launch code.
inline int make_row_map(CUtensorMap* map, const float* base, long long n, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {0};  // rank 1 has no stride; never read
  const cuuint32_t box[1] = {static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[1] = {1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(base), dims, strides, box,
                            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap + static_cast<int>(r);
}

// The `rows`-row tile at key row k0 of kv head hk (all its 64-column chunks)
// into dst, completing on the barrier `full`.
template <int DC>
__device__ __forceinline__ void load_tile(const CUtensorMap* map, uint32_t full, uint32_t dst, int rows, int k0, int hk,
                                          int b) {
  mbar_expect_tx(full, DC * rows * 2 * kChunkCols);
#pragma unroll
  for (int c = 0; c < DC; ++c) tma_load_4d(dst + c * rows * 2 * kChunkCols, map, full, c * kChunkCols, k0, hk, b);
}

// Named barrier `id` (1..15; 0 is __syncthreads) over the block's 256
// threads: named_sync waits until all 256 have arrived, named_arrive counts
// in without waiting. Shared-memory writes before an arrival are visible to
// the threads that the barrier's sync releases.
__device__ __forceinline__ void named_sync(int id) { asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory"); }
__device__ __forceinline__ void named_arrive(int id) { asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory"); }

// Ping-pong of the two warpgroups (as in FlashAttention-3): the barrier of
// warpgroup w (named barrier 1 + w, 256 threads) passes when w has waited on
// it and the other warpgroup has arrived. Each warpgroup waits on its own
// before it issues an iteration's first products and then lets the other
// through, so the two issue them in turns and one's softmax runs while the
// other's products occupy the tensor cores. Warpgroup 1 lets 0 through
// first; 0 takes 1's last pass after its loop, so both barriers end empty.
__device__ __forceinline__ void pingpong_wait(int wg) { named_sync(1 + wg); }
__device__ __forceinline__ void pingpong_pass(int wg) { named_arrive(2 - wg); }

// Loads tile t (`rows` key rows from key0) into its stage at dst once the
// block has released the tile kStages before it there (barrier `empty`).
template <int DC>
__device__ __forceinline__ void load_stage(const CUtensorMap* map, uint32_t full, uint32_t empty, uint32_t dst, int t,
                                           int rows, int key0, int hk, int b) {
  if (t >= kStages) mbar_wait(empty, (t / kStages - 1) & 1);
  load_tile<DC>(map, full, dst, rows, key0, hk, b);
}

// Loads ring tile t, the `rows`-row tile at row r0 of head h and its rows'
// float32 values at flat index `row` (a 1-D map), into its stage at dst and
// row_dst once the block has released the tile kStages before it there
// (barrier `empty`); both complete on `full`.
template <int DC>
__device__ __forceinline__ void load_stage_rows(const CUtensorMap* map, const CUtensorMap* row_map, uint32_t full,
                                                uint32_t empty, uint32_t dst, uint32_t row_dst, int t, int rows,
                                                int r0, int h, int b, int row) {
  if (t >= kStages) mbar_wait(empty, (t / kStages - 1) & 1);
  mbar_expect_tx(full, DC * rows * 2 * kChunkCols + rows * 4);
#pragma unroll
  for (int c = 0; c < DC; ++c) tma_load_4d(dst + c * rows * 2 * kChunkCols, map, full, c * kChunkCols, r0, h, b);
  tma_load_1d(row_dst, row_map, full, row);
}

}  // namespace flash_tc
