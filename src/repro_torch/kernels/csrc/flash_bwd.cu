// Flash-attention backward (FlashAttention-2 style) for Hopper (sm_90a): two
// kernels, launched one after the other for one attention layer. float32 I/O
// runs both on the CUDA cores in float32; bfloat16 I/O runs both on the
// tensor cores instead (flash_dq_tc_kernel and flash_dkv_tc_kernel further
// down, built from flash_tc.cuh).
//
//   q and dO (B, H, Sq, D), k and v (B, Hkv, Sk, D), float32 or bfloat16, the
//   kv head of query head h is h / (H / Hkv); lse (B, H, Sq) is the forward's
//   float32 row log-sum-exp and delta (B, H, Sq) = rowsum(dO * O) in float32,
//   computed outside the kernels as the reference does. For each (q, k) pair:
//     s_raw = (q * scale) . k
//     s     = softcap * tanh(s_raw / softcap) when softcap != 0, else s_raw
//     p     = exp((mask ? s : -1e30) - lse)
//     ds    = mask ? p * (dO . v - delta) * (1 - tanh^2(s_raw / softcap)) : 0
//   (the last factor only with a softcap), and then
//     dq = scale * sum_k ds k             (flash_bwd_dq_kernel, in q's dtype)
//     dk = sum_q ds (q * scale), dv = sum_q p dO, the sums running over the
//          G query heads of the kv head  (flash_bwd_dkv_kernel, in k's dtype)
//   with the mask causal, sliding(window) or bidirectional on positions
//   0..Sq-1 and 0..Sk-1.
//
// Replaces the TPU kernels src/repro/kernels/flash_attention.py:96
// _dq_kernel and :127 _dkv_kernel (host wrapper _bwd at :202). The TPU
// kernels keep a whole head's K and V (dq) or Q and dO (dk/dv) in VMEM and
// walk a sequential grid of whole 512-row blocks; here every block stages
// tiles in shared memory, masks ragged tiles from bounds, and no block
// depends on another.
//
// Design of the CUDA-core kernels (float32 I/O). Both use 64 query rows by
// 32 keys per score tile and 256 threads: thread (ty, tx) = (tid / 16, tid %
// 16) owns rows 4*ty .. 4*ty+3 of the tile and keys tx and tx + 16, and forms
// their s and dO.v in one pass over D (12 shared reads per 16 FMAs). Rows of Q, dO, K and V are padded to
// D + 1 floats and rows of P and dS to 33, so the lanes of a warp hit distinct
// banks.
//  - dQ: one block per (b, h, 64-row q tile), heaviest causal tiles first.
//    Q (pre-scaled) and dO stay in shared memory; the block loops over the
//    32-key K/V tiles from the sliding window's first tile up to the causal
//    diagonal (a skipped tile is wholly masked, so its dS is 0 exactly), parks
//    dS in shared memory and accumulates a 4 x D/16 block of dQ in registers.
//    It writes dq * scale once.
//  - dK/dV: one block per (b, kv head, 32-key tile), the lowest key tiles
//    (which see the most causal rows) first. K and V stay in shared memory;
//    the block loops over the G query heads and, for each, over the 64-row q
//    tiles from the causal diagonal up to the window's last row, staging Q
//    (pre-scaled, as the reference loads it) and dO, and parks P and dS in
//    shared memory. Thread (ty, tx) accumulates keys 2*ty, 2*ty+1 by columns
//    tx + 16c of dK and dV in registers (4 * D/16 floats), in a fixed order
//    and with no atomics, so the GQA sums are reproducible. A sliding mask
//    with rows that see no key at all (Sq > Sk + window - 1, or window < 1)
//    makes every q tile visit every key tile: the reference's p for such a
//    row is exp(-1e30 - lse) = exp(0) = 1 at every key, and it reaches dV.
//  Shared memory at D = 256: dQ 205,824 B, dK/dV 214,784 B of the 232,448 B
//  a block may opt into, so one block runs per SM there. A 64 x 64 tile
//  does not fit with dK and dV in registers (64 keys x 256 x 2 floats is 128
//  per thread) or with Q, dO, K and V all staged in float32 (279,552 B).
//
// What bounds it. At the main path's shape (gemma2-2b training, B = 1, H = 8,
// S = 8,192, D = 256, causal) there are 2.685e8 unmasked pairs; dQ does
// 6 * D flops per pair (s, dO.v, dS.k) and dK/dV 8 * D (s, dO.v, P^T dO,
// dS^T q): 4.1e11 and 5.5e11 flops, 0.42 and 0.56 ms at the bf16 tensor-core
// peak of 989 TFLOP/s, while the tensors move about 0.1 GB (0.03 ms at 3.35
// TB/s). So both are bound by operations. The CUDA-core kernels run on the
// float32 CUDA cores (67 TFLOP/s, a floor of 6.2 and 8.2 ms); the bfloat16
// routes run on the tensor cores.
//
// Numerics. Every sum is float32 over the exact inputs; expf and tanhf are
// the IEEE-accurate versions (no --use_fast_math); the tensor-core kernels
// round only the operands they hand to the tensor cores (see there). Sums run in another order than the reference's, so
// results agree to float32 rounding, not bit for bit; they are the same from
// run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_tc.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 32;        // keys per tile
constexpr int kThreads = 256;  // 16 row groups x 16 key lanes
constexpr float kNegInf = -1e30f;

enum Kind { kCausal = 0, kSliding = 1, kBidirectional = 2 };

// Shared memory of one block, in floats. Keep in step with
// flash_bwd_smem_bytes in kernels/flash_attention.py.
// dQ: Q and dO tiles (kBQ rows), K and V tiles (kBK rows), rows padded to
// D + 1; the dS tile with rows padded to kBK + 1.
constexpr size_t dq_smem_floats(int D) {
  return 2 * static_cast<size_t>(kBQ) * (D + 1) + 2 * static_cast<size_t>(kBK) * (D + 1) +
         static_cast<size_t>(kBQ) * (kBK + 1);
}
// dK/dV: the same tiles, P and dS tiles, and the q tile's lse and delta.
constexpr size_t dkv_smem_floats(int D) {
  return 2 * static_cast<size_t>(kBQ) * (D + 1) + 2 * static_cast<size_t>(kBK) * (D + 1) +
         2 * static_cast<size_t>(kBQ) * (kBK + 1) + 2 * static_cast<size_t>(kBQ);
}

// Everything a launch needs, passed by value to both kernels. Strides are in
// elements; the head dimension is contiguous.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int B, H, Hkv, Sq, Sk;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, dsb, dsh, dss;
  int kind, window;
  float softcap, scale;
};

__device__ __forceinline__ bool unmasked(int qi, int kj, int kind, int window) {
  return kind == kBidirectional || (kj <= qi && (kind == kCausal || kj > qi - window));
}

// s = Q.K^T and dp = dO.V^T for this thread's 4 rows x 2 keys of the tile.
template <int D>
__device__ __forceinline__ void score_tile(const float* sQ, const float* sdO, const float* sK,
                                           const float* sV, int ty, int tx, float (&s)[4][2],
                                           float (&dp)[4][2]) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], g[4], kk[2], vv[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = sQ[(4 * ty + i) * DP + d];
      g[i] = sdO[(4 * ty + i) * DP + d];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      kk[j] = sK[(tx + 16 * j) * DP + d];
      vv[j] = sV[(tx + 16 * j) * DP + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[i][j] = fmaf(a[i], kk[j], s[i][j]);
        dp[i][j] = fmaf(g[i], vv[j], dp[i][j]);
      }
  }
}

// p and ds of one pair, as the reference's _dq_kernel and _dkv_kernel form
// them; a pair outside the Sq x Sk bounds gives 0 for both.
__device__ __forceinline__ void pair_grad(float s_raw, float dp, float lse, float delta, int qi, int kj,
                                          int Sq, int Sk, int kind, int window, float softcap, float& p,
                                          float& ds) {
  if (qi >= Sq || kj >= Sk) {
    p = ds = 0.f;
    return;
  }
  float s = s_raw, dcap = 1.f;
  if (softcap != 0.f) {
    const float t = tanhf(s_raw / softcap);
    s = softcap * t;
    dcap = 1.f - t * t;
  }
  const bool keep = unmasked(qi, kj, kind, window);
  p = expf((keep ? s : kNegInf) - lse);
  ds = keep ? p * (dp - delta) * dcap : 0.f;
}

// Stages rows [r0, r0 + rows) of a (.., S, D) head into a float tile with
// rows padded to D + 1, times mul; rows past S are zeros.
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src, long long row_stride, int r0, int rows, int S,
                                      float mul) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = r0 + r < S ? src[(r0 + r) * row_stride + c] * mul : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_kernel(const Args a) {
  constexpr int NC = D / 16;  // dQ columns per thread
  constexpr int DP = D + 1;
  constexpr int PP = kBK + 1;
  extern __shared__ float smem[];
  float* sQ = smem;            // kBQ x DP, pre-scaled
  float* sdO = sQ + kBQ * DP;  // kBQ x DP
  float* sK = sdO + kBQ * DP;  // kBK x DP
  float* sV = sK + kBK * DP;   // kBK x DP
  float* sdS = sV + kBK * DP;  // kBQ x PP

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  // the tiles with most keys first: for causal masks the last q tile
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int G = a.H / a.Hkv;
  const int q0 = qt * kBQ;
  const int q1 = min(q0 + kBQ, a.Sq);
  const float* kp = static_cast<const float*>(a.k) + b * a.ksb + (h / G) * a.ksh;
  const float* vp = static_cast<const float*>(a.v) + b * a.vsb + (h / G) * a.vsh;

  stage<D>(sQ, static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh, a.qss, q0, kBQ, a.Sq, a.scale);
  stage<D>(sdO, static_cast<const float*>(a.dout) + b * a.dsb + h * a.dsh, a.dss, q0, kBQ, a.Sq, 1.f);
  const size_t row0 = (static_cast<size_t>(b) * a.H + h) * a.Sq;
  float lse_i[4], delta_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    lse_i[i] = qi < a.Sq ? a.lse[row0 + qi] : 0.f;
    delta_i[i] = qi < a.Sq ? a.delta[row0 + qi] : 0.f;
  }

  // K/V tiles [lo, hi) that can hold an unmasked key of this q tile; dS is
  // 0 on every other tile
  const int nk = (a.Sk + kBK - 1) / kBK;
  int lo = 0, hi = nk;
  if (a.kind != kBidirectional) {
    hi = min((q1 - 1) / kBK + 1, nk);
    if (a.kind == kSliding) lo = max(0, q0 - a.window + 1) / kBK;
  }

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers of sK, sV and sdS are done
    stage<D>(sK, kp, a.kss, k0, kBK, a.Sk, 1.f);
    stage<D>(sV, vp, a.vss, k0, kBK, a.Sk, 1.f);
    __syncthreads();

    float s[4][2], dp[4][2];
    score_tile<D>(sQ, sdO, sK, sV, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float p, ds;
        pair_grad(s[i][j], dp[i][j], lse_i[i], delta_i[i], q0 + 4 * ty + i, k0 + tx + 16 * j, a.Sq, a.Sk,
                  a.kind, a.window, a.softcap, p, ds);
        sdS[(4 * ty + i) * PP + tx + 16 * j] = ds;
      }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float d[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) d[i] = sdS[(4 * ty + i) * PP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kv = sK[kk * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(d[i], kv, acc[i][c]);
      }
    }
  }

  float* dq = static_cast<float*>(a.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    if (qi >= a.Sq) continue;
    float* row = dq + (row0 + qi) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) row[tx + 16 * c] = acc[i][c] * a.scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkv_kernel(const Args a) {
  constexpr int NC = D / 16;  // dK and dV columns per thread
  constexpr int DP = D + 1;
  constexpr int PP = kBK + 1;
  extern __shared__ float smem[];
  float* sK = smem;            // kBK x DP
  float* sV = sK + kBK * DP;   // kBK x DP
  float* sQ = sV + kBK * DP;   // kBQ x DP, pre-scaled
  float* sdO = sQ + kBQ * DP;  // kBQ x DP
  float* sP = sdO + kBQ * DP;  // kBQ x PP
  float* sdS = sP + kBQ * PP;  // kBQ x PP
  float* sL = sdS + kBQ * PP;  // kBQ: lse of the q tile's rows
  float* sD = sL + kBQ;        // kBQ: delta of the q tile's rows

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  // the lowest key tiles first: under a causal mask they see the most rows
  const int kt = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = a.H / a.Hkv;
  const int k0 = kt * kBK;
  const int k1 = min(k0 + kBK, a.Sk);

  stage<D>(sK, static_cast<const float*>(a.k) + b * a.ksb + hk * a.ksh, a.kss, k0, kBK, a.Sk, 1.f);
  stage<D>(sV, static_cast<const float*>(a.v) + b * a.vsb + hk * a.vsh, a.vss, k0, kBK, a.Sk, 1.f);

  // q tiles [lo, hi) that can hold a row with an unmasked key of this tile;
  // p and dS are 0 on every other tile, unless a row sees no key at all
  const int nq = (a.Sq + kBQ - 1) / kBQ;
  int lo = 0, hi = nq;
  if (a.kind != kBidirectional) {
    lo = k0 / kBQ;
    if (a.kind == kSliding) {
      const bool empty_row = a.window < 1 || a.Sq - 1 > static_cast<long long>(a.Sk) + a.window - 2;
      if (empty_row) {
        lo = 0;
      } else {
        hi = static_cast<int>(min(static_cast<long long>(nq), (static_cast<long long>(k1) + a.window - 2) / kBQ + 1));
      }
    }
  }

  float dk[2][NC], dv[2][NC];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[r][c] = dv[r][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const float* qp = static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh;
    const float* dop = static_cast<const float*>(a.dout) + b * a.dsb + h * a.dsh;
    const size_t row0 = (static_cast<size_t>(b) * a.H + h) * a.Sq;
    for (int it = lo; it < hi; ++it) {
      const int q0 = it * kBQ;
      __syncthreads();  // the previous tile's readers of sQ, sdO, sP, sdS, sL and sD are done
      stage<D>(sQ, qp, a.qss, q0, kBQ, a.Sq, a.scale);
      stage<D>(sdO, dop, a.dss, q0, kBQ, a.Sq, 1.f);
      if (tid < kBQ) {
        const bool in = q0 + tid < a.Sq;
        sL[tid] = in ? a.lse[row0 + q0 + tid] : 0.f;
        sD[tid] = in ? a.delta[row0 + q0 + tid] : 0.f;
      }
      __syncthreads();

      float s[4][2], dp[4][2];
      score_tile<D>(sQ, sdO, sK, sV, ty, tx, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = 4 * ty + i;
          float p, ds;
          pair_grad(s[i][j], dp[i][j], sL[r], sD[r], q0 + r, k0 + tx + 16 * j, a.Sq, a.Sk, a.kind, a.window,
                    a.softcap, p, ds);
          sP[r * PP + tx + 16 * j] = p;
          sdS[r * PP + tx + 16 * j] = ds;
        }
      __syncthreads();

#pragma unroll 2
      for (int r = 0; r < kBQ; ++r) {
        float pr[2], dsr[2];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          pr[kk] = sP[r * PP + 2 * ty + kk];
          dsr[kk] = sdS[r * PP + 2 * ty + kk];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float o = sdO[r * DP + tx + 16 * c];
          const float qq = sQ[r * DP + tx + 16 * c];
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            dv[kk][c] = fmaf(pr[kk], o, dv[kk][c]);
            dk[kk][c] = fmaf(dsr[kk], qq, dk[kk][c]);
          }
        }
      }
    }
  }

  float* dkp = static_cast<float*>(a.dk);
  float* dvp = static_cast<float*>(a.dv);
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const int kj = k0 + 2 * ty + kk;
    if (kj >= a.Sk) continue;
    const size_t row = ((static_cast<size_t>(b) * a.Hkv + hk) * a.Sk + kj) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dkp[row + tx + 16 * c] = dk[kk][c];
      dvp[row + tx + 16 * c] = dv[kk][c];
    }
  }
}

// ---- bfloat16 I/O, dQ: the tensor-core route (flash_tc.cuh) -----------------
//
// One block per (b, h, 128-row q tile), heaviest causal tiles first; two
// warpgroups of 64 rows, thread 0 loading Q and dO once and streaming 32-key
// K/V tiles through the ring (flash_tc.cuh). Per tile a warpgroup forms
// S = Q.K^T and dP = dO.V^T (wgmma m64n32k16, 16 float32 registers a thread
// each), then p and dS with pair_grad, exactly as the float32 kernel does,
// and adds dS.K into its 64 x D float32 dQ (D / 2 registers a thread). dS
// goes to the tensor cores as two bfloat16 parts, hi = bf16(dS) and lo =
// bf16(dS - hi), two wgmma into the same accumulator: one rounding of dS
// alone (2^-9 relative) would not meet the 2^-8 relative + 1e-5 of the
// largest entry that dQ is held to where sum_k dS K cancels; hi + lo carries
// dS to about 2^-17. It writes dq * scale once. Key tiles run from the
// window's first tile to the diagonal, as in the float32 kernel.
//
// Shared memory at D = 256: Q and dO 64 KB each + 2 stages x (K 16 KB + V
// 16 KB) = 192 KB, plus the alignment slack and the barriers: 197,760 B.
// Keep in step with flash_dq_tc_smem_bytes in kernels/flash_attention.py.

constexpr int kDqTcBQ = 128;  // query rows per block: two consumer warpgroups of 64
constexpr int kDqTcBK = 32;   // keys per K/V stage

constexpr int dq_tc_smem_bytes(int D) {
  return flash_tc::kSmemAlign + 2 * flash_tc::tile_bytes(kDqTcBQ, D) +
         flash_tc::kStages * 2 * flash_tc::tile_bytes(kDqTcBK, D) + flash_tc::kBarrierBytes;
}

template <int D>
__global__ void __launch_bounds__(flash_tc::kThreads, 1)
flash_dq_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
                   int H, int G, int Sq, int Sk, int kind, int window, float softcap, float scale) {
  using namespace flash_tc;
  constexpr int DC = chunks(D);
  constexpr uint32_t kQBytes = tile_bytes(kDqTcBQ, D);
  constexpr uint32_t kKVBytes = tile_bytes(kDqTcBK, D);
  constexpr uint32_t kQChunk = kDqTcBQ * 128;   // bytes of one 64-column chunk of the q (or dO) tile
  constexpr uint32_t kKVChunk = kDqTcBK * 128;  // of a K or V tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + kSmemAlign - 1) & ~static_cast<uint32_t>(kSmemAlign - 1);
  const uint32_t sdO = sQ + kQBytes;
  const uint32_t sKV = sdO + kQBytes;  // stage s: K at sKV + 2 s kKVBytes, V right after
  const Barriers bar{sKV + kStages * 2 * kKVBytes};

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // the tiles with most keys first: for causal masks the last q tile
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * kDqTcBQ;
  const int q1 = min(q0 + kDqTcBQ, Sq);

  // K/V tiles [lo, hi) that can hold an unmasked key of this q tile; dS is
  // 0 on every other tile
  const int nk = (Sk + kDqTcBK - 1) / kDqTcBK;
  int lo = 0, hi = nk;
  if (kind != kBidirectional) {
    hi = min((q1 - 1) / kDqTcBK + 1, nk);
    if (kind == kSliding) lo = max(0, q0 - window + 1) / kDqTcBK;
  }
  const int n = max(hi - lo, 0);

  init_barriers(bar);
  const int hk = h / G;
  if (threadIdx.x == 0) {  // the q and dO tiles and the first K/V tile; the loop loads the rest
    mbar_expect_tx(bar.q_full(), 2 * kQBytes);
    for (int c = 0; c < DC; ++c) {
      tma_load_4d(sQ + c * kQChunk, &tq, bar.q_full(), c * kChunkCols, q0, h, b);
      tma_load_4d(sdO + c * kQChunk, &tdo, bar.q_full(), c * kChunkCols, q0, h, b);
    }
    if (n > 0) {
      load_tile<DC>(&tk, bar.k_full(0), sKV, kDqTcBK, lo * kDqTcBK, hk, b);
      load_tile<DC>(&tv, bar.v_full(0), sKV + kKVBytes, kDqTcBK, lo * kDqTcBK, hk, b);
    }
  }

  // this thread: rows ra and ra + 8 of the q tile; its warpgroup's rows are
  // r_lo .. r_lo + 63
  const int wg = warp >> 2;
  const int r_lo = q0 + 64 * wg;
  const int ra = r_lo + frag_row(0, warp & 3, lane);
  const uint32_t sQw = sQ + 64 * wg * 128;  // this warpgroup's 64 rows in each chunk
  const uint32_t sdOw = sdO + 64 * wg * 128;
  const size_t row0 = (static_cast<size_t>(b) * H + h) * Sq;
  float lse_i[2], delta_i[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int qi = ra + 8 * j;
    lse_i[j] = qi < Sq ? lse[row0 + qi] : 0.f;
    delta_i[j] = qi < Sq ? delta[row0 + qi] : 0.f;
  }

  float acc[DC][32];
#pragma unroll
  for (int c = 0; c < DC; ++c)
#pragma unroll
    for (int r = 0; r < 32; ++r) acc[c][r] = 0.f;

  if (wg == 1) pingpong_pass(wg);
  mbar_wait(bar.q_full(), 0);
  for (int i = 0; i < n; ++i) {
    const int s = i % kStages;
    const uint32_t phase = (i / kStages) & 1;
    const uint32_t sK = sKV + 2 * s * kKVBytes;
    const uint32_t sV = sK + kKVBytes;
    const int k0 = (lo + i) * kDqTcBK;

    float sc[16], dp[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) sc[r] = dp[r] = 0.f;
    mbar_wait(bar.k_full(s), phase);
    pingpong_wait(wg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;  // 16 columns further along the chunk's 128-byte rows
      wgmma_ss_n32(sc, smem_desc(sQw + (kk >> 2) * kQChunk + off, 16, 1024),
                   smem_desc(sK + (kk >> 2) * kKVChunk + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    mbar_wait(bar.v_full(s), phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      wgmma_ss_n32(dp, smem_desc(sdOw + (kk >> 2) * kQChunk + off, 16, 1024),
                   smem_desc(sV + (kk >> 2) * kKVChunk + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    pingpong_pass(wg);
    // thread 0 loads tile i + 1 into the stage tile i - 1 held: V while S and
    // dP are formed, K once dS.K is issued
    const bool next = threadIdx.x == 0 && i + 1 < n;
    const int sn = (i + 1) % kStages;
    const uint32_t sKn = sKV + 2 * sn * kKVBytes;
    if (next)
      load_stage<DC>(&tv, bar.v_full(sn), bar.v_empty(sn), sKn + kKVBytes, i + 1, kDqTcBK, k0 + kDqTcBK, hk, b);
    __syncwarp();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);
    mbar_arrive(bar.v_empty(s));

    // dS as pair_grad forms it; a tile whose every pair is in bounds and
    // unmasked for all 64 rows of the warpgroup skips the mask and bounds
    const bool whole = k0 + kDqTcBK <= Sk && r_lo + 64 <= Sq &&
                       (kind == kBidirectional ||
                        (k0 + kDqTcBK - 1 <= r_lo && (kind == kCausal || k0 > r_lo + 63 - window)));
    float ds[16];
    if (whole) {
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int j = (r >> 1) & 1;
        const float s_raw = sc[r] * scale;
        float x = s_raw, dcap = 1.f;
        if (softcap != 0.f) {
          const float t = tanhf(s_raw / softcap);
          x = softcap * t;
          dcap = 1.f - t * t;
        }
        ds[r] = expf(x - lse_i[j]) * (dp[r] - delta_i[j]) * dcap;
      }
    } else {
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int j = (r >> 1) & 1;
        float p;
        pair_grad(sc[r] * scale, dp[r], lse_i[j], delta_i[j], ra + 8 * j, k0 + frag_col(r, lane), Sq, Sk, kind,
                  window, softcap, p, ds[r]);
      }
    }
    uint32_t dhi[2][4], dlo[2][4];  // dS in bfloat16, hi and lo, the A operand of k-step t
#pragma unroll
    for (int r = 0; r < 16; r += 2) {
      const __nv_bfloat162 hi2 = __floats2bfloat162_rn(ds[r], ds[r + 1]);
      const float2 hif = __bfloat1622float2(hi2);
      dhi[r >> 3][(r >> 1) & 3] = *reinterpret_cast<const uint32_t*>(&hi2);
      dlo[r >> 3][(r >> 1) & 3] = pack_bf16(ds[r] - hif.x, ds[r + 1] - hif.y);
    }

    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const uint64_t kd = smem_desc(sK + t * 16 * 128, kKVChunk, 1024);
      wgmma_rs(acc, dhi[t], kd);
      wgmma_rs(acc, dlo[t], kd);
    }
    wgmma_commit();
    if (next) load_stage<DC>(&tk, bar.k_full(sn), bar.k_empty(sn), sKn, i + 1, kDqTcBK, k0 + kDqTcBK, hk, b);
    __syncwarp();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < DC; ++c) fence_regs(acc[c]);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      fence_regs(dhi[t]);
      fence_regs(dlo[t]);
    }
    mbar_arrive(bar.k_empty(s));
  }
  if (wg == 0) pingpong_wait(wg);

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int qi = ra + 8 * j;
    if (qi >= Sq) continue;
    __nv_bfloat16* row = dq + (row0 + qi) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int r = 2 * j; r < 32; r += 4) {
        const int col = c * kChunkCols + frag_col(r, lane);
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(row + col) =
              __floats2bfloat162_rn(acc[c][r] * scale, acc[c][r + 1] * scale);
      }
  }
}

template <int D>
int launch_dq_tc(const Args& a, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int rc = flash_tc::make_tensor_map(&tq, a.q, D, a.Sq, a.H, a.B, a.qsb, a.qsh, a.qss, kDqTcBQ);
  if (rc == 0) rc = flash_tc::make_tensor_map(&tdo, a.dout, D, a.Sq, a.H, a.B, a.dsb, a.dsh, a.dss, kDqTcBQ);
  if (rc == 0) rc = flash_tc::make_tensor_map(&tk, a.k, D, a.Sk, a.Hkv, a.B, a.ksb, a.ksh, a.kss, kDqTcBK);
  if (rc == 0) rc = flash_tc::make_tensor_map(&tv, a.v, D, a.Sk, a.Hkv, a.B, a.vsb, a.vsh, a.vss, kDqTcBK);
  if (rc != 0) return rc;
  const int smem = dq_tc_smem_bytes(D);
  auto kern = flash_dq_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Sq + kDqTcBQ - 1) / kDqTcBQ, a.H, a.B);
  kern<<<grid, flash_tc::kThreads, smem, stream>>>(tq, tk, tv, tdo, a.lse, a.delta, static_cast<__nv_bfloat16*>(a.dq),
                                                   a.H, a.H / a.Hkv, a.Sq, a.Sk, a.kind, a.window, a.softcap,
                                                   a.scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_dq_tc_dim(int D, const Args& a, cudaStream_t stream) {
#define FLASH_DQ_TC_CASE(DD) \
  case DD:                   \
    return launch_dq_tc<DD>(a, stream);
  switch (D) {
    FLASH_DQ_TC_CASE(16)
    FLASH_DQ_TC_CASE(32)
    FLASH_DQ_TC_CASE(64)
    FLASH_DQ_TC_CASE(128)
    FLASH_DQ_TC_CASE(256)
    default:
      return -1;
  }
#undef FLASH_DQ_TC_CASE
}

// ---- bfloat16 I/O, dK/dV: the tensor-core route (flash_tc.cuh) --------------
//
// One block per (b, kv head, 64-key tile), the lowest key tiles first (the
// block index runs over kv heads and batches fastest, so every head's
// heaviest causal tiles start in the first wave). K and V of the block's keys
// stay in shared memory; the 64-row Q and dO tiles of every query head of
// the GQA group stream through the two-stage ring (flash_tc.cuh), each with
// its rows' lse or delta, over the q tiles of the float32 kernel's range
// (from the causal diagonal to the window's last row, or every tile where a
// sliding row sees no key). The GQA sum runs in that fixed order, with no
// atomics.
//
// The two warpgroups split the work by accumulator. At D = 256 a 64-key dV
// (or dK) in float32 is 128 registers a thread, so one warpgroup cannot hold
// both:
//  - warpgroup 0 forms S^T = K.Q^T (wgmma m64n64k16, keys x q rows, 32
//    float32 registers a thread), then p and p * (1 - tanh^2) as pair_grad
//    does (0 where masked or out of bounds), writes the latter to an
//    exchange tile in shared memory and adds P^T.dO into dV;
//  - warpgroup 1 forms dP^T = V.dO^T, reads the exchange tile in the same
//    fragment layout (value r of thread t at float 128 r + t: conflict-free),
//    forms dS^T = p (1 - tanh^2) (dP^T - delta) and adds dS^T.Q into dK.
// The exchange tile is double-buffered under named barriers (full: 0 passes
// it to 1; empty: 1 gives it back), so warpgroup 0 runs up to one q tile
// ahead. Thread 0 of warpgroup 1 issues the TMA loads of q tile i + 1: Q
// before its warpgroup's iteration i (its stage's last reader, dK of i - 1,
// is then done) and dO once dP^T of i is issued.
//
// Numerics. P and dS go to the tensor cores as hi + lo bfloat16 parts, two
// wgmma into the same float32 accumulator: dv = sum_q P dO and dk = sum_q dS
// q both cancel (dO and dS take both signs), and either rounded once to
// bfloat16 (2^-9 relative per entry) breaks the 2^-8 relative + 1e-5 of the
// largest entry that dK/dV is held to wherever the sum cancels
// (tests/test_torch_flash_tc.py); hi + lo carries them to about 2^-17. q's
// scale is applied in float32, to S^T and in dK's epilogue. So the kernel
// issues 12 D flops per pair where 8 D are needed.
//
// Shared memory at D = 256: K and V 32 KB each, 2 stages x (Q 32 KB + dO
// 32 KB), 2 exchange tiles of 16 KB, 2 stages x (lse + delta) 512 B, plus the
// alignment slack and the barriers: 231,552 B of the 232,448 B a block may
// opt into. Keep in step with flash_dkv_tc_smem_bytes in
// kernels/flash_attention.py.

constexpr int kDkvTcBQ = 64;  // query rows per ring stage (the N of the score products)
constexpr int kDkvTcBK = 64;  // keys per block (wgmma's M)
constexpr int kXFull = 1;     // named barriers of the exchange tiles: full s = kXFull + s,
constexpr int kXEmpty = 3;    // empty s = kXEmpty + s

constexpr int dkv_tc_smem_bytes(int D) {
  return flash_tc::kSmemAlign + 2 * flash_tc::tile_bytes(kDkvTcBK, D) +
         flash_tc::kStages * 2 * flash_tc::tile_bytes(kDkvTcBQ, D) + flash_tc::kStages * kDkvTcBK * kDkvTcBQ * 4 +
         flash_tc::kStages * 2 * kDkvTcBQ * 4 + flash_tc::kBarrierBytes;
}

// lse and delta of the bfloat16 dK/dV kernel: (B, H, Sr) with Sr = Sq
// rounded up to a multiple of 4, since TMA reads a box from a 16-byte-aligned
// start.
__host__ __device__ constexpr int tma_rows(int Sq) { return (Sq + 3) & ~3; }

// Where ring tile i of a block lies: q rows [q0, q0 + 64) of query head h,
// whose lse and delta start at flat index row of (B, H, Sr).
struct RingTile {
  int q0, h, row;
};
__device__ __forceinline__ RingTile ring_tile(int i, int per_head, int lo, int hk, int G, int b, int H, int Sr) {
  const int h = hk * G + i / per_head;
  const int q0 = (lo + i % per_head) * kDkvTcBQ;
  return {q0, h, (b * H + h) * Sr + q0};
}

template <int D>
__global__ void __launch_bounds__(flash_tc::kThreads, 1)
flash_dkv_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tlse, const __grid_constant__ CUtensorMap tdelta,
                    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int B, int H, int Hkv, int Sq,
                    int Sk, int kind, int window, float softcap, float scale) {
  using namespace flash_tc;
  static_assert(kDkvTcBQ == 64 && kDkvTcBK == 64, "the score products are wgmma m64n64k16");
  constexpr int DC = chunks(D);
  constexpr uint32_t kTile = tile_bytes(64, D);  // K, V, and each stage's Q and dO
  constexpr uint32_t kChunk = 64 * 128;          // bytes of one 64-column chunk of a 64-row tile
  constexpr uint32_t kXFloats = kDkvTcBK * kDkvTcBQ;
  constexpr uint32_t kRows = kDkvTcBQ * 4;  // bytes of one q tile's lse (or delta)
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sK = (smem_u32(smem_raw) + kSmemAlign - 1) & ~static_cast<uint32_t>(kSmemAlign - 1);
  const uint32_t sV = sK + kTile;
  const uint32_t sRing = sV + kTile;                      // stage s: Q at sRing + 2 s kTile, dO right after
  const uint32_t sX = sRing + kStages * 2 * kTile;        // exchange tile s: kXFloats floats from sX + 4 s kXFloats
  const uint32_t sRows = sX + kStages * kXFloats * 4;     // stage s: lse at sRows + 2 s kRows, delta right after
  const Barriers bar{sRows + kStages * 2 * kRows};        // q_full(): K and V; the ring: k_*: Q, v_*: dO
  uint8_t* const smem = smem_raw + (sK - smem_u32(smem_raw));
  float* const xs = reinterpret_cast<float*>(smem + (sX - sK));
  const float* const rows = reinterpret_cast<const float*>(smem + (sRows - sK));

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const int tw = threadIdx.x & 127;  // thread within its warpgroup
  const int hk = blockIdx.x % Hkv;
  const int b = (blockIdx.x / Hkv) % B;
  const int k0 = blockIdx.x / (Hkv * B) * kDkvTcBK;
  const int k1 = min(k0 + kDkvTcBK, Sk);
  const int G = H / Hkv;

  // q tiles [lo, hi) that can hold a row with an unmasked key of this tile,
  // as in flash_bwd_dkv_kernel
  const int nq = (Sq + kDkvTcBQ - 1) / kDkvTcBQ;
  int lo = 0, hi = nq;
  if (kind != kBidirectional) {
    lo = k0 / kDkvTcBQ;
    if (kind == kSliding) {
      const bool empty_row = window < 1 || Sq - 1 > static_cast<long long>(Sk) + window - 2;
      if (empty_row) {
        lo = 0;
      } else {
        hi = static_cast<int>(
            min(static_cast<long long>(nq), (static_cast<long long>(k1) + window - 2) / kDkvTcBQ + 1));
      }
    }
  }
  const int per_head = max(hi - lo, 0);
  const int n = G * per_head;
  const int Sr = tma_rows(Sq);

  init_barriers(bar);
  constexpr int kIssuer = kThreads / 2;  // thread 0 of warpgroup 1
  const bool issuer = threadIdx.x == kIssuer;
  if (issuer && n > 0) {  // K, V and ring tile 0; the loop loads the rest
    mbar_expect_tx(bar.q_full(), 2 * kTile);
    for (int c = 0; c < DC; ++c) {
      tma_load_4d(sK + c * kChunk, &tk, bar.q_full(), c * kChunkCols, k0, hk, b);
      tma_load_4d(sV + c * kChunk, &tv, bar.q_full(), c * kChunkCols, k0, hk, b);
    }
    const RingTile t = ring_tile(0, per_head, lo, hk, G, b, H, Sr);
    load_stage_rows<DC>(&tq, &tlse, bar.k_full(0), bar.k_empty(0), sRing, sRows, 0, kDkvTcBQ, t.q0, t.h, b, t.row);
    load_stage_rows<DC>(&tdo, &tdelta, bar.v_full(0), bar.v_empty(0), sRing + kTile, sRows + kRows, 0, kDkvTcBQ,
                        t.q0, t.h, b, t.row);
  }
  __syncwarp();
  if (n > 0) mbar_wait(bar.q_full(), 0);

  // this thread's accumulator rows are keys ka and ka + 8; its columns of
  // a score tile are q rows frag_col(r, lane) of the ring tile
  const int ka = k0 + frag_row(0, warp & 3, lane);
  float acc[DC][32];  // warpgroup 0: dV; warpgroup 1: dK
#pragma unroll
  for (int c = 0; c < DC; ++c)
#pragma unroll
    for (int r = 0; r < 32; ++r) acc[c][r] = 0.f;

  if (wg == 0) {
    const float inv_cap = softcap != 0.f ? 1.f / softcap : 0.f;
    for (int i = 0; i < n; ++i) {
      const int s = i % kStages;
      const uint32_t phase = (i / kStages) & 1;
      const uint32_t sQ = sRing + 2 * s * kTile;
      const uint32_t sdO = sQ + kTile;
      const int q0 = ring_tile(i, per_head, lo, hk, G, b, H, Sr).q0;

      float sc[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) sc[r] = 0.f;
      mbar_wait(bar.k_full(s), phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;  // 16 columns further along the chunk's 128-byte rows
        wgmma_ss_n64(sc, smem_desc(sK + (kk >> 2) * kChunk + off, 16, 1024),
                     smem_desc(sQ + (kk >> 2) * kChunk + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      mbar_arrive(bar.k_empty(s));

      // p, and p (1 - tanh^2) into the exchange tile; a tile whose every
      // pair is in bounds and unmasked skips the mask and bounds
      const float* lse = rows + 2 * s * kDkvTcBQ;
      float* x = xs + s * kXFloats;
      const bool whole = k0 + kDkvTcBK <= Sk && q0 + kDkvTcBQ <= Sq &&
                         (kind == kBidirectional ||
                          (k0 + kDkvTcBK - 1 <= q0 && (kind == kCausal || k0 > q0 + kDkvTcBQ - 1 - window)));
      if (i >= kStages) named_sync(kXEmpty + s);
      uint32_t phi[4][4], plo[4][4];  // P in bfloat16, hi and lo, the A operand of k-step t
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int col = frag_col(r, lane);
        const float s_raw = sc[r] * scale;
        float y = s_raw, dcap = 1.f;
        if (softcap != 0.f) {
          const float th = tanhf(s_raw * inv_cap);
          y = softcap * th;
          dcap = 1.f - th * th;
        }
        float p, pd;
        if (whole) {
          p = expf(y - lse[col]);
          pd = p * dcap;
        } else {
          const int qi = q0 + col;
          const int kj = ka + 8 * ((r >> 1) & 1);
          const bool in = qi < Sq && kj < Sk;
          const bool keep = in && unmasked(qi, kj, kind, window);
          p = in ? expf((keep ? y : kNegInf) - lse[col]) : 0.f;
          pd = keep ? p * dcap : 0.f;
        }
        x[r * 128 + tw] = pd;
        sc[r] = p;
      }
      named_arrive(kXFull + s);
#pragma unroll
      for (int r = 0; r < 32; r += 2) {
        const __nv_bfloat162 hi2 = __floats2bfloat162_rn(sc[r], sc[r + 1]);
        const float2 hif = __bfloat1622float2(hi2);
        phi[r >> 3][(r >> 1) & 3] = *reinterpret_cast<const uint32_t*>(&hi2);
        plo[r >> 3][(r >> 1) & 3] = pack_bf16(sc[r] - hif.x, sc[r + 1] - hif.y);
      }

      mbar_wait(bar.v_full(s), phase);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const uint64_t od = smem_desc(sdO + t * 16 * 128, kChunk, 1024);
        wgmma_rs(acc, phi[t], od);
        wgmma_rs(acc, plo[t], od);
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < DC; ++c) fence_regs(acc[c]);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        fence_regs(phi[t]);
        fence_regs(plo[t]);
      }
      mbar_arrive(bar.v_empty(s));
    }
  } else {
    for (int i = 0; i < n; ++i) {
      const int s = i % kStages;
      const uint32_t phase = (i / kStages) & 1;
      const uint32_t sQ = sRing + 2 * s * kTile;
      const uint32_t sdO = sQ + kTile;
      // ring tile i + 1 goes into the stage tile i - 1 held: Q now (this
      // warpgroup read it last, in dK of i - 1), dO once dP^T of i is issued
      const bool next = issuer && i + 1 < n;
      const int sn = (i + 1) % kStages;
      const uint32_t sQn = sRing + 2 * sn * kTile;
      const RingTile tn = ring_tile(i + 1, per_head, lo, hk, G, b, H, Sr);
      if (next)
        load_stage_rows<DC>(&tq, &tlse, bar.k_full(sn), bar.k_empty(sn), sQn, sRows + 2 * sn * kRows, i + 1,
                            kDkvTcBQ, tn.q0, tn.h, b, tn.row);
      __syncwarp();

      float dp[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) dp[r] = 0.f;
      mbar_wait(bar.v_full(s), phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        wgmma_ss_n64(dp, smem_desc(sV + (kk >> 2) * kChunk + off, 16, 1024),
                     smem_desc(sdO + (kk >> 2) * kChunk + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      if (next)
        load_stage_rows<DC>(&tdo, &tdelta, bar.v_full(sn), bar.v_empty(sn), sQn + kTile,
                            sRows + (2 * sn + 1) * kRows, i + 1, kDkvTcBQ, tn.q0, tn.h, b, tn.row);
      __syncwarp();
      wgmma_wait_all();
      fence_regs(dp);
      mbar_arrive(bar.v_empty(s));

      // dS^T = p (1 - tanh^2) (dP^T - delta), 0 wherever the exchange tile is
      const float* delta = rows + (2 * s + 1) * kDkvTcBQ;
      const float* x = xs + s * kXFloats;
      named_sync(kXFull + s);
#pragma unroll
      for (int r = 0; r < 32; ++r) dp[r] = x[r * 128 + tw] * (dp[r] - delta[frag_col(r, lane)]);
      if (i + kStages < n) named_arrive(kXEmpty + s);
      uint32_t dhi[4][4], dlo[4][4];  // dS in bfloat16, hi and lo, the A operand of k-step t
#pragma unroll
      for (int r = 0; r < 32; r += 2) {
        const __nv_bfloat162 hi2 = __floats2bfloat162_rn(dp[r], dp[r + 1]);
        const float2 hif = __bfloat1622float2(hi2);
        dhi[r >> 3][(r >> 1) & 3] = *reinterpret_cast<const uint32_t*>(&hi2);
        dlo[r >> 3][(r >> 1) & 3] = pack_bf16(dp[r] - hif.x, dp[r + 1] - hif.y);
      }

      mbar_wait(bar.k_full(s), phase);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const uint64_t qd = smem_desc(sQ + t * 16 * 128, kChunk, 1024);
        wgmma_rs(acc, dhi[t], qd);
        wgmma_rs(acc, dlo[t], qd);
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < DC; ++c) fence_regs(acc[c]);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        fence_regs(dhi[t]);
        fence_regs(dlo[t]);
      }
      mbar_arrive(bar.k_empty(s));
    }
  }

  // warpgroup 0 writes dv, warpgroup 1 dk * scale, both (B, Hkv, Sk, D)
  __nv_bfloat16* const out = wg == 0 ? dv : dk;
  const float mul = wg == 0 ? 1.f : scale;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int kj = ka + 8 * j;
    if (kj >= Sk) continue;
    __nv_bfloat16* row = out + ((static_cast<size_t>(b) * Hkv + hk) * Sk + kj) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int r = 2 * j; r < 32; r += 4) {
        const int col = c * kChunkCols + frag_col(r, lane);
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(acc[c][r] * mul, acc[c][r + 1] * mul);
      }
  }
}

template <int D>
int launch_dkv_tc(const Args& a, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo, tlse, tdelta;
  const long long rows = static_cast<long long>(a.B) * a.H * tma_rows(a.Sq);
  int rc = flash_tc::make_tensor_map(&tq, a.q, D, a.Sq, a.H, a.B, a.qsb, a.qsh, a.qss, kDkvTcBQ);
  if (rc == 0) rc = flash_tc::make_tensor_map(&tdo, a.dout, D, a.Sq, a.H, a.B, a.dsb, a.dsh, a.dss, kDkvTcBQ);
  if (rc == 0) rc = flash_tc::make_tensor_map(&tk, a.k, D, a.Sk, a.Hkv, a.B, a.ksb, a.ksh, a.kss, kDkvTcBK);
  if (rc == 0) rc = flash_tc::make_tensor_map(&tv, a.v, D, a.Sk, a.Hkv, a.B, a.vsb, a.vsh, a.vss, kDkvTcBK);
  if (rc == 0) rc = flash_tc::make_row_map(&tlse, a.lse, rows, kDkvTcBQ);
  if (rc == 0) rc = flash_tc::make_row_map(&tdelta, a.delta, rows, kDkvTcBQ);
  if (rc != 0) return rc;
  const int smem = dkv_tc_smem_bytes(D);
  auto kern = flash_dkv_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (a.Sk + kDkvTcBK - 1) / kDkvTcBK * a.Hkv * a.B;
  kern<<<grid, flash_tc::kThreads, smem, stream>>>(tq, tk, tv, tdo, tlse, tdelta, static_cast<__nv_bfloat16*>(a.dk),
                                                   static_cast<__nv_bfloat16*>(a.dv), a.B, a.H, a.Hkv, a.Sq, a.Sk,
                                                   a.kind, a.window, a.softcap, a.scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_dkv_tc_dim(int D, const Args& a, cudaStream_t stream) {
#define FLASH_DKV_TC_CASE(DD) \
  case DD:                    \
    return launch_dkv_tc<DD>(a, stream);
  switch (D) {
    FLASH_DKV_TC_CASE(16)
    FLASH_DKV_TC_CASE(32)
    FLASH_DKV_TC_CASE(64)
    FLASH_DKV_TC_CASE(128)
    FLASH_DKV_TC_CASE(256)
    default:
      return -1;
  }
#undef FLASH_DKV_TC_CASE
}

enum Which { kDq = 0, kDkv = 1 };

template <int D>
int launch_typed(int which, const Args& a, cudaStream_t stream) {
  if (which == kDq) {
    const int smem = static_cast<int>(dq_smem_floats(D) * sizeof(float));
    auto kern = flash_bwd_dq_kernel<D>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, a.B);
    kern<<<grid, kThreads, smem, stream>>>(a);
  } else {
    const int smem = static_cast<int>(dkv_smem_floats(D) * sizeof(float));
    auto kern = flash_bwd_dkv_kernel<D>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((a.Sk + kBK - 1) / kBK, a.Hkv, a.B);
    kern<<<grid, kThreads, smem, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_dim(int which, int D, const Args& a, cudaStream_t stream) {
#define FLASH_BWD_CASE(DD) \
  case DD:                 \
    return launch_typed<DD>(which, a, stream);
  switch (D) {
    FLASH_BWD_CASE(16)
    FLASH_BWD_CASE(32)
    FLASH_BWD_CASE(64)
    FLASH_BWD_CASE(128)
    FLASH_BWD_CASE(256)
    default:
      return -1;
  }
#undef FLASH_BWD_CASE
}

int launch(int which, int dtype, int D, const Args& a, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dim(which, D, a, st);
  if (dtype == 1) return which == kDq ? launch_dq_tc_dim(D, a, st) : launch_dkv_tc_dim(D, a, st);
  return -1;
}

}  // namespace

// C entry points, loaded with ctypes by kernels/flash_attention.py. q, k, v
// and dout are in one dtype (0 float32, 1 bfloat16) and take any strides
// with a contiguous head dimension; lse and delta are contiguous float32
// (B, H, Sq); dq is written contiguous (B, H, Sq, D) and dk, dv contiguous
// (B, Hkv, Sk, D), in the inputs' dtype. The bfloat16 dK/dV kernel reads lse
// and delta as contiguous (B, H, tma_rows(Sq)) instead, 16-byte aligned. Each
// returns the cudaError_t of its launch, or -1 for a head dimension or dtype
// that the file has no instance of.
extern "C" int flash_bwd_dq_launch(const void* q, const void* k, const void* v, const void* dout,
                                   const float* lse, const float* delta, void* dq,
                                   int B, int H, int Hkv, int Sq, int Sk, int D,
                                   long long qsb, long long qsh, long long qss,
                                   long long ksb, long long ksh, long long kss,
                                   long long vsb, long long vsh, long long vss,
                                   long long dsb, long long dsh, long long dss,
                                   int kind, int window, float softcap, float scale, int dtype,
                                   void* stream) {
  const Args a{q,   k,   v,   dout, lse, delta, dq,  nullptr, nullptr, B,   H,   Hkv,  Sq,     Sk,   qsb,
               qsh, qss, ksb, ksh,  kss, vsb,   vsh, vss,     dsb,     dsh, dss, kind, window, softcap, scale};
  return launch(kDq, dtype, D, a, stream);
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k, const void* v, const void* dout,
                                    const float* lse, const float* delta, void* dk, void* dv,
                                    int B, int H, int Hkv, int Sq, int Sk, int D,
                                    long long qsb, long long qsh, long long qss,
                                    long long ksb, long long ksh, long long kss,
                                    long long vsb, long long vsh, long long vss,
                                    long long dsb, long long dsh, long long dss,
                                    int kind, int window, float softcap, float scale, int dtype,
                                    void* stream) {
  const Args a{q,   k,   v,   dout, lse, delta, nullptr, dk,  dv,  B,   H,   Hkv,  Sq,     Sk,   qsb,
               qsh, qss, ksb, ksh,  kss, vsb,   vsh,     vss, dsb, dsh, dss, kind, window, softcap, scale};
  return launch(kDkv, dtype, D, a, stream);
}
