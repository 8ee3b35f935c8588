// Flash-attention forward (FlashAttention-2 style online softmax) for Hopper
// (sm_90a) in two routes: float32 I/O on the CUDA cores in float32 (the
// kernel right below), bfloat16 I/O on the tensor cores (flash_fwd_tc_kernel
// further down, built from flash_tc.cuh). One launch is one attention layer:
//
//   q (B, H, Sq, D), k and v (B, Hkv, Sk, D), float32 or bfloat16, the kv
//   head of query head h is h / (H / Hkv);
//   s[i, j] = (q[i] * scale) . k[j], then softcap * tanh(s / softcap) when
//   softcap != 0, then -1e30 where the mask (causal, sliding(window) or
//   bidirectional, on positions 0..Sq-1 and 0..Sk-1) is false;
//   o[i]    = sum_j p[i, j] v[j] / max(l[i], 1e-30)   (in q's dtype)
//   lse[i]  = m[i] + log(max(l[i], 1e-30))            (float32, (B, H, Sq))
//   with m the row maximum of s, p = exp(s - m) and l the row sum of p.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:53
// _fwd_kernel (with its host wrapper _fwd at :172). The TPU kernel walks a
// sequential grid (B, H, Sq/Bq) and keeps the whole (Sk, D) K and V of one
// head in VMEM; here a block of 256 threads owns one (b, h, 64-row q tile)
// and loops over 64-row K/V tiles staged in shared memory, which is what a
// Hopper SM can hold (at D = 256 the Q, K, V and P tiles take 209 KB of the
// 227 KB a block may opt into).
//
// What bounds it. At the main path's shape (gemma2-2b prefill, B = 2, H = 8,
// S = 8,192, D = 256) a causal layer has 5.37e8 unmasked (q, k) pairs and
// 4 * D flops each, 5.50e11 flops: 0.556 ms at the bf16 tensor-core peak of
// 989 TFLOP/s, while Q, K, V and O move about 0.2 GB (0.06 ms at 3.35 TB/s).
// So it is bound by operations. The float32 kernel does those operations on
// the float32 CUDA cores (67 TFLOP/s), so it cannot come within about 15x of
// that bound; the bfloat16 route does them with wgmma on the tensor cores.
//
// What the float32 kernel's design does about it. Every score lives only in
// registers and
// shared memory: per K/V tile a thread computes a 4 x 4 block of S (rows
// 4*ty.., columns tx + 16*j) with 8 shared reads per 16 FMAs, reduces its
// rows' maximum and sum with shuffles over the 16 lanes that share them,
// parks P in shared memory, and accumulates a 4 x (D/16) block of O in
// registers with (4 + D/16) shared reads per 4 * D/16 FMAs. Q and K rows are
// padded by one float, so the lanes of a warp hit distinct banks. Tiles are
// visited only where the mask can be true: for causal and sliding masks the
// loop stops at the tile that holds the q tile's last row, and for a
// sliding mask it starts at the tile that holds the first row's window
// start. That is exact: every row of these masks keeps its diagonal key, and
// a skipped tile, wholly masked for the rows of this q tile, would only have
// been wiped by alpha = exp(-1e30 - m) = 0. A q tile that holds a row with
// no unmasked key at all (only a sliding mask with Sq > Sk + window - 1, or
// window < 1) visits every tile, so that row gets the reference's uniform
// average over all Sk keys. The ragged edges are masked from bounds: rows
// past Sq load zeros and are not written, keys past Sk score -inf (p = 0
// exactly, and they never reach the maximum), so any Sq and Sk are right.
//
// Numerics. Scores, softmax and sums are float32, as in the TPU kernel;
// expf, tanhf, logf and the divisions are the IEEE-accurate versions (the
// file is built without --use_fast_math). Sums are taken in another order
// than the reference, so results agree to float32 rounding, not bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "flash_tc.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per K/V tile
constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr float kNegInf = -1e30f;

enum Kind { kCausal = 0, kSliding = 1, kBidirectional = 2 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

// Shared memory of one block, in floats: Q and K tiles with rows padded to
// D + 1, the V tile, and the P tile with rows padded to kBK + 1. Keep in step
// with flash_smem_bytes in kernels/flash_attention.py.
constexpr size_t smem_floats(int D) {
  return static_cast<size_t>(kBQ) * (D + 1) + static_cast<size_t>(kBK) * (D + 1) +
         static_cast<size_t>(kBK) * D + static_cast<size_t>(kBQ) * (kBK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse,
                 int H, int G, int Sq, int Sk,
                 long long qsb, long long qsh, long long qss,
                 long long ksb, long long ksh, long long kss,
                 long long vsb, long long vsh, long long vss,
                 int kind, int window, float softcap, float scale) {
  constexpr int NC = D / 16;  // output columns per thread
  constexpr int DP = D + 1;   // padded Q/K row
  constexpr int PP = kBK + 1; // padded P row
  extern __shared__ float smem[];
  float* sQ = smem;            // kBQ x DP, pre-scaled
  float* sK = sQ + kBQ * DP;   // kBK x DP
  float* sV = sK + kBK * DP;   // kBK x D
  float* sP = sV + kBK * D;    // kBQ x PP

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // column lane
  const int ty = tid >> 4;  // row group: rows 4*ty .. 4*ty+3 of the tile
  // the tiles with most keys first: for causal masks the last q tile is
  // the heaviest
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * kBQ;
  const int q1 = min(q0 + kBQ, Sq);
  const T* qp = q + b * qsb + h * qsh;
  const T* kp = k + b * ksb + (h / G) * ksh;
  const T* vp = v + b * vsb + (h / G) * vsh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    sQ[r * DP + c] = q0 + r < Sq ? to_float(qp[(q0 + r) * qss + c]) * scale : 0.f;
  }

  // K/V tiles [lo, hi) that can hold an unmasked key of this q tile
  const int nk = (Sk + kBK - 1) / kBK;
  int lo = 0, hi = nk;
  if (kind != kBidirectional) {
    hi = min((q1 - 1) / kBK + 1, nk);
    if (kind == kSliding) {
      const bool empty_row = window < 1 || q1 - 1 > static_cast<long long>(Sk) + window - 2;
      if (empty_row) {
        hi = nk;
      } else {
        lo = max(0, q0 - window + 1) / kBK;
      }
    }
  }

  float acc[4][NC];
  float m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers of sK, sV and sP are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < Sk;
      sK[r * DP + c] = in ? to_float(kp[(k0 + r) * kss + c]) : 0.f;
      sV[r * D + c] = in ? to_float(vp[(k0 + r) * vss + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(4 * ty + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = sK[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

    // softcap, mask, and the online softmax of each of this thread's rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * ty + i;
      float mx = m_i[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        float x = s[i][j];
        if (softcap != 0.f) x = softcap * tanhf(x / softcap);
        const bool keep = kind == kBidirectional ||
                          (kj <= qi && (kind == kCausal || kj > qi - window));
        x = keep ? x : kNegInf;
        x = kj < Sk ? x : -CUDART_INF_F;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = expf(m_i[i] - mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mx);
        rs += p;
        sP[(4 * ty + i) * PP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[i] = l_i[i] * alpha + rs;
      m_i[i] = mx;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(4 * ty + i) * PP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = sV[kk * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

  const size_t row0 = (static_cast<size_t>(b) * H + h) * Sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    if (qi >= Sq) continue;
    const float ls = fmaxf(l_i[i], 1e-30f);
    T* orow = o + (row0 + qi) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) orow[tx + 16 * c] = from_float<T>(acc[i][c] / ls);
    if (tx == 0) lse[row0 + qi] = m_i[i] + logf(ls);
  }
}

template <typename T, int D>
int launch_typed(const void* q, const void* k, const void* v, void* o, float* lse,
                 int B, int H, int Hkv, int Sq, int Sk,
                 long long qsb, long long qsh, long long qss,
                 long long ksb, long long ksh, long long kss,
                 long long vsb, long long vsh, long long vss,
                 int kind, int window, float softcap, float scale, cudaStream_t stream) {
  const int smem = static_cast<int>(smem_floats(D) * sizeof(float));
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, H, H / Hkv, Sq, Sk,
      qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, kind, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dim(int D, const void* q, const void* k, const void* v, void* o, float* lse,
               int B, int H, int Hkv, int Sq, int Sk,
               long long qsb, long long qsh, long long qss,
               long long ksb, long long ksh, long long kss,
               long long vsb, long long vsh, long long vss,
               int kind, int window, float softcap, float scale, cudaStream_t stream) {
#define FLASH_CASE(DD)                                                                        \
  case DD:                                                                                    \
    return launch_typed<T, DD>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, qsb, qsh, qss, ksb, ksh,  \
                               kss, vsb, vsh, vss, kind, window, softcap, scale, stream);
  switch (D) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(128)
    FLASH_CASE(256)
    default:
      return -1;
  }
#undef FLASH_CASE
}

// ---- bfloat16 I/O: the tensor-core route (flash_tc.cuh) ---------------------
//
// One block per (b, h, 128-row q tile), heaviest causal tiles first; two
// warpgroups of 64 rows, thread 0 issuing the TMA loads (flash_tc.cuh). Per
// K/V tile a warpgroup forms S = Q.K^T (wgmma m64n64k16, 64 x 64 float32 in 32
// registers a thread), applies scale, softcap and mask in registers as the
// float32 kernel does, updates the online softmax in float32, rounds P to
// bfloat16 once and adds P.V into its 64 x D float32 output (D / 2 registers
// a thread). The K/V tile range is the float32 kernel's, for the block's 128
// rows: from the sliding window's first tile to the diagonal, or every tile
// where a row of the block sees no key.
//
// The per-score float32 work (IEEE tanhf for the softcap, expf, the mask)
// costs about as much as the products, so the warpgroups ping-pong
// (flash_tc.cuh); a tile wholly unmasked and in bounds for a warpgroup's 64
// rows skips the mask, and the rescale of O is skipped where no row maximum
// of the warp grew (alpha is then exactly 1).
//
// Shared memory at D = 256: Q 64 KB + 2 stages x (K 32 KB + V 32 KB) =
// 192 KB, plus the 1 KB alignment slack and the barriers: 197,760 B of the
// 232,448 B a block may opt into. Keep in step with flash_tc_smem_bytes in
// kernels/flash_attention.py.

constexpr int kTcBQ = 128;  // query rows per block: two consumer warpgroups of 64
constexpr int kTcBK = 64;   // keys per K/V stage

constexpr int tc_smem_bytes(int D) {
  return flash_tc::kSmemAlign + flash_tc::tile_bytes(kTcBQ, D) +
         flash_tc::kStages * 2 * flash_tc::tile_bytes(kTcBK, D) + flash_tc::kBarrierBytes;
}

// The scores of one consumer thread's N entries (rows ra, ra + 8) of a
// 64 x 2N tile at keys k0..: scale, softcap and, unless the whole tile is
// unmasked and in bounds (kMasked false), the mask; their running maximum.
template <bool kMasked, int N>
__device__ __forceinline__ void tc_scores(float (&sc)[N], float (&mx)[2], int ra, int k0, int lane, int Sk, int kind,
                                          int window, float softcap, float inv_cap, float scale) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const int j = (r >> 1) & 1;
    float x = sc[r] * scale;
    if (softcap != 0.f) x = softcap * tanhf(x * inv_cap);
    if (kMasked) {
      const int qi = ra + 8 * j;
      const int kj = k0 + flash_tc::frag_col(r, lane);
      const bool keep = kind == kBidirectional || (kj <= qi && (kind == kCausal || kj > qi - window));
      x = keep ? x : kNegInf;
      x = kj < Sk ? x : -CUDART_INF_F;
    }
    sc[r] = x;
    mx[j] = fmaxf(mx[j], x);
  }
}

template <int D>
__global__ void __launch_bounds__(flash_tc::kThreads, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    int H, int G, int Sq, int Sk, int kind, int window, float softcap, float scale) {
  using namespace flash_tc;
  constexpr int DC = chunks(D);
  constexpr uint32_t kQBytes = tile_bytes(kTcBQ, D);
  constexpr uint32_t kKVBytes = tile_bytes(kTcBK, D);
  constexpr uint32_t kQChunk = kTcBQ * 128;   // bytes of one 64-column chunk of the q tile
  constexpr uint32_t kKVChunk = kTcBK * 128;  // of a K or V tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + kSmemAlign - 1) & ~static_cast<uint32_t>(kSmemAlign - 1);
  const uint32_t sKV = sQ + kQBytes;  // stage s: K at sKV + 2 s kKVBytes, V right after
  const Barriers bar{sKV + kStages * 2 * kKVBytes};

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // the tiles with most keys first: for causal masks the last q tile is
  // the heaviest
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * kTcBQ;
  const int q1 = min(q0 + kTcBQ, Sq);

  // K/V tiles [lo, hi) that can hold an unmasked key of this q tile
  const int nk = (Sk + kTcBK - 1) / kTcBK;
  int lo = 0, hi = nk;
  if (kind != kBidirectional) {
    hi = min((q1 - 1) / kTcBK + 1, nk);
    if (kind == kSliding) {
      const bool empty_row = window < 1 || q1 - 1 > static_cast<long long>(Sk) + window - 2;
      if (empty_row) {
        hi = nk;
      } else {
        lo = max(0, q0 - window + 1) / kTcBK;
      }
    }
  }
  const int n = hi - lo;

  init_barriers(bar);
  const int hk = h / G;
  if (threadIdx.x == 0) {  // the q tile and the first K/V tile; the loop loads the rest
    mbar_expect_tx(bar.q_full(), kQBytes);
    for (int c = 0; c < DC; ++c) tma_load_4d(sQ + c * kQChunk, &tq, bar.q_full(), c * kChunkCols, q0, h, b);
    if (n > 0) {
      load_tile<DC>(&tk, bar.k_full(0), sKV, kTcBK, lo * kTcBK, hk, b);
      load_tile<DC>(&tv, bar.v_full(0), sKV + kKVBytes, kTcBK, lo * kTcBK, hk, b);
    }
  }

  // this thread: rows ra and ra + 8 of the q tile; its warpgroup's rows are
  // r_lo .. r_lo + 63
  const int wg = warp >> 2;
  const int r_lo = q0 + 64 * wg;
  const int ra = r_lo + frag_row(0, warp & 3, lane);
  const uint32_t sQw = sQ + 64 * wg * 128;  // this warpgroup's 64 rows in each chunk
  const float inv_cap = softcap != 0.f ? 1.f / softcap : 0.f;

  float acc[DC][32];
#pragma unroll
  for (int c = 0; c < DC; ++c)
#pragma unroll
    for (int r = 0; r < 32; ++r) acc[c][r] = 0.f;
  float m_i[2] = {kNegInf, kNegInf};
  float l_i[2] = {0.f, 0.f};

  if (wg == 1) pingpong_pass(wg);
  mbar_wait(bar.q_full(), 0);
  for (int i = 0; i < n; ++i) {
    const int s = i % kStages;
    const uint32_t phase = (i / kStages) & 1;
    const uint32_t sK = sKV + 2 * s * kKVBytes;
    const uint32_t sV = sK + kKVBytes;
    const int k0 = (lo + i) * kTcBK;

    float sc[kTcBK / 2];
#pragma unroll
    for (int r = 0; r < kTcBK / 2; ++r) sc[r] = 0.f;
    mbar_wait(bar.k_full(s), phase);
    pingpong_wait(wg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;  // 16 columns further along the chunk's 128-byte rows
      wgmma_ss_n64(sc, smem_desc(sQw + (kk >> 2) * kQChunk + off, 16, 1024),
                   smem_desc(sK + (kk >> 2) * kKVChunk + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    pingpong_pass(wg);
    // thread 0 loads tile i + 1 into the stage tile i - 1 held: K while the
    // scores are formed, V once P.V is issued
    const bool next = threadIdx.x == 0 && i + 1 < n;
    const int sn = (i + 1) % kStages;
    const uint32_t sKn = sKV + 2 * sn * kKVBytes;
    if (next) load_stage<DC>(&tk, bar.k_full(sn), bar.k_empty(sn), sKn, i + 1, kTcBK, k0 + kTcBK, hk, b);
    __syncwarp();
    wgmma_wait_all();
    fence_regs(sc);
    mbar_arrive(bar.k_empty(s));

    // scale, softcap and mask, and the online softmax of this thread's two
    // rows; a tile whose every key is in bounds and unmasked for all 64 rows
    // of the warpgroup skips the mask
    float mx[2] = {m_i[0], m_i[1]};
    const bool whole = k0 + kTcBK <= Sk &&
                       (kind == kBidirectional ||
                        (k0 + kTcBK - 1 <= r_lo && (kind == kCausal || k0 > r_lo + 63 - window)));
    if (whole) {
      tc_scores<false>(sc, mx, ra, k0, lane, Sk, kind, window, softcap, inv_cap, scale);
    } else {
      tc_scores<true>(sc, mx, ra, k0, lane, Sk, kind, window, softcap, inv_cap, scale);
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
      alpha[j] = expf(m_i[j] - mx[j]);
    }
    // alpha is exactly 1 for a row whose maximum did not grow: its rescale
    // is skipped where no row of the warp grew
    const bool grew = __any_sync(0xffffffffu, mx[0] != m_i[0] || mx[1] != m_i[1]);
#pragma unroll
    for (int r = 0; r < kTcBK / 2; ++r) {
      const int j = (r >> 1) & 1;
      sc[r] = expf(sc[r] - mx[j]);
      rs[j] += sc[r];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      rs[j] += __shfl_xor_sync(0xffffffffu, rs[j], 1);
      rs[j] += __shfl_xor_sync(0xffffffffu, rs[j], 2);
      l_i[j] = l_i[j] * alpha[j] + rs[j];
      m_i[j] = mx[j];
    }
    uint32_t pa[kTcBK / 16][4];  // P in bfloat16, the A operand of k-step t
#pragma unroll
    for (int t = 0; t < kTcBK / 16; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[t][e] = pack_bf16(sc[8 * t + 2 * e], sc[8 * t + 2 * e + 1]);
    if (grew) {
#pragma unroll
      for (int c = 0; c < DC; ++c)
#pragma unroll
        for (int r = 0; r < 32; ++r) acc[c][r] *= alpha[(r >> 1) & 1];
    }

    mbar_wait(bar.v_full(s), phase);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < kTcBK / 16; ++t) wgmma_rs(acc, pa[t], smem_desc(sV + t * 16 * 128, kKVChunk, 1024));
    wgmma_commit();
    if (next) load_stage<DC>(&tv, bar.v_full(sn), bar.v_empty(sn), sKn + kKVBytes, i + 1, kTcBK, k0 + kTcBK, hk, b);
    __syncwarp();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < DC; ++c) fence_regs(acc[c]);
#pragma unroll
    for (int t = 0; t < kTcBK / 16; ++t) fence_regs(pa[t]);
    mbar_arrive(bar.v_empty(s));
  }
  if (wg == 0) pingpong_wait(wg);

  const size_t row0 = (static_cast<size_t>(b) * H + h) * Sq;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int qi = ra + 8 * j;
    if (qi >= Sq) continue;
    const float ls = fmaxf(l_i[j], 1e-30f);
    __nv_bfloat16* orow = o + (row0 + qi) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int r = 2 * j; r < 32; r += 4) {
        const int col = c * kChunkCols + frag_col(r, lane);
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(acc[c][r] / ls, acc[c][r + 1] / ls);
      }
    if ((lane & 3) == 0) lse[row0 + qi] = m_i[j] + logf(ls);
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H, int Hkv, int Sq, int Sk,
              long long qsb, long long qsh, long long qss, long long ksb, long long ksh, long long kss,
              long long vsb, long long vsh, long long vss, int kind, int window, float softcap, float scale,
              cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int rc = flash_tc::make_tensor_map(&tq, q, D, Sq, H, B, qsb, qsh, qss, kTcBQ);
  if (rc == 0) rc = flash_tc::make_tensor_map(&tk, k, D, Sk, Hkv, B, ksb, ksh, kss, kTcBK);
  if (rc == 0) rc = flash_tc::make_tensor_map(&tv, v, D, Sk, Hkv, B, vsb, vsh, vss, kTcBK);
  if (rc != 0) return rc;
  const int smem = tc_smem_bytes(D);
  auto kern = flash_fwd_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kTcBQ - 1) / kTcBQ, H, B);
  kern<<<grid, flash_tc::kThreads, smem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, H, H / Hkv, Sq,
                                                   Sk, kind, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_tc_dim(int D, const void* q, const void* k, const void* v, void* o, float* lse, int B, int H, int Hkv,
                  int Sq, int Sk, long long qsb, long long qsh, long long qss, long long ksb, long long ksh,
                  long long kss, long long vsb, long long vsh, long long vss, int kind, int window, float softcap,
                  float scale, cudaStream_t stream) {
#define FLASH_TC_CASE(DD)                                                                                 \
  case DD:                                                                                                \
    return launch_tc<DD>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, \
                         kind, window, softcap, scale, stream);
  switch (D) {
    FLASH_TC_CASE(16)
    FLASH_TC_CASE(32)
    FLASH_TC_CASE(64)
    FLASH_TC_CASE(128)
    FLASH_TC_CASE(256)
    default:
      return -1;
  }
#undef FLASH_TC_CASE
}

}  // namespace

// C entry point, loaded with ctypes by kernels/flash_attention.py. Strides
// are in elements; the head dimension must be contiguous, and o is written
// contiguous (B, H, Sq, D). dtype 0 is float32, 1 is bfloat16. Returns the
// cudaError_t of the launch, or -1 for a head dimension or dtype that the
// file has no instance of.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, void* o, float* lse,
                                int B, int H, int Hkv, int Sq, int Sk, int D,
                                long long qsb, long long qsh, long long qss,
                                long long ksb, long long ksh, long long kss,
                                long long vsb, long long vsh, long long vss,
                                int kind, int window, float softcap, float scale, int dtype,
                                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dim<float>(D, q, k, v, o, lse, B, H, Hkv, Sq, Sk, qsb, qsh, qss, ksb, ksh, kss,
                             vsb, vsh, vss, kind, window, softcap, scale, st);
  if (dtype == 1)
    return launch_tc_dim(D, q, k, v, o, lse, B, H, Hkv, Sq, Sk, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, kind,
                         window, softcap, scale, st);
  return -1;
}
