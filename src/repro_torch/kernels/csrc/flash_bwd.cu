// Flash-attention backward (FlashAttention-2 style) for Hopper (sm_90a): two
// kernels, launched one after the other for one attention layer. Both run on
// the CUDA cores in float32; for bfloat16 I/O the dQ kernel has a
// tensor-core route instead (flash_dq_tc_kernel further down, built from
// flash_tc.cuh), while dK/dV keeps the CUDA-core kernel.
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
// Design. Both kernels use 64 query rows by 32 keys per score tile and 256
// threads: thread (ty, tx) = (tid / 16, tid % 16) owns rows 4*ty .. 4*ty+3 of
// the tile and keys tx and tx + 16, and forms their s and dO.v in one pass
// over D (12 shared reads per 16 FMAs). Rows of Q, dO, K and V are padded to
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
// dQ route runs on the tensor cores, and dK/dV's move there is later work.
//
// Numerics. Everything is float32 from the widened inputs; expf and tanhf
// are the IEEE-accurate versions (no --use_fast_math). Sums run in another
// order than the reference's, so results agree to float32 rounding, not bit
// for bit; they are the same from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_tc.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 32;        // keys per tile
constexpr int kThreads = 256;  // 16 row groups x 16 key lanes
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
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, long long row_stride, int r0, int rows, int S,
                                      float mul) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = r0 + r < S ? to_float(src[(r0 + r) * row_stride + c]) * mul : 0.f;
  }
}

template <typename T, int D>
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
  const T* kp = static_cast<const T*>(a.k) + b * a.ksb + (h / G) * a.ksh;
  const T* vp = static_cast<const T*>(a.v) + b * a.vsb + (h / G) * a.vsh;

  stage<T, D>(sQ, static_cast<const T*>(a.q) + b * a.qsb + h * a.qsh, a.qss, q0, kBQ, a.Sq, a.scale);
  stage<T, D>(sdO, static_cast<const T*>(a.dout) + b * a.dsb + h * a.dsh, a.dss, q0, kBQ, a.Sq, 1.f);
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
    stage<T, D>(sK, kp, a.kss, k0, kBK, a.Sk, 1.f);
    stage<T, D>(sV, vp, a.vss, k0, kBK, a.Sk, 1.f);
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

  T* dq = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    if (qi >= a.Sq) continue;
    T* row = dq + (row0 + qi) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) row[tx + 16 * c] = from_float<T>(acc[i][c] * a.scale);
  }
}

template <typename T, int D>
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

  stage<T, D>(sK, static_cast<const T*>(a.k) + b * a.ksb + hk * a.ksh, a.kss, k0, kBK, a.Sk, 1.f);
  stage<T, D>(sV, static_cast<const T*>(a.v) + b * a.vsb + hk * a.vsh, a.vss, k0, kBK, a.Sk, 1.f);

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
    const T* qp = static_cast<const T*>(a.q) + b * a.qsb + h * a.qsh;
    const T* dop = static_cast<const T*>(a.dout) + b * a.dsb + h * a.dsh;
    const size_t row0 = (static_cast<size_t>(b) * a.H + h) * a.Sq;
    for (int it = lo; it < hi; ++it) {
      const int q0 = it * kBQ;
      __syncthreads();  // the previous tile's readers of sQ, sdO, sP, sdS, sL and sD are done
      stage<T, D>(sQ, qp, a.qss, q0, kBQ, a.Sq, a.scale);
      stage<T, D>(sdO, dop, a.dss, q0, kBQ, a.Sq, 1.f);
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

  T* dkp = static_cast<T*>(a.dk);
  T* dvp = static_cast<T*>(a.dv);
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const int kj = k0 + 2 * ty + kk;
    if (kj >= a.Sk) continue;
    const size_t row = ((static_cast<size_t>(b) * a.Hkv + hk) * a.Sk + kj) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dkp[row + tx + 16 * c] = from_float<T>(dk[kk][c]);
      dvp[row + tx + 16 * c] = from_float<T>(dv[kk][c]);
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

enum Which { kDq = 0, kDkv = 1 };

template <typename T, int D>
int launch_typed(int which, const Args& a, cudaStream_t stream) {
  if (which == kDq) {
    const int smem = static_cast<int>(dq_smem_floats(D) * sizeof(float));
    auto kern = flash_bwd_dq_kernel<T, D>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, a.B);
    kern<<<grid, kThreads, smem, stream>>>(a);
  } else {
    const int smem = static_cast<int>(dkv_smem_floats(D) * sizeof(float));
    auto kern = flash_bwd_dkv_kernel<T, D>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((a.Sk + kBK - 1) / kBK, a.Hkv, a.B);
    kern<<<grid, kThreads, smem, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dim(int which, int D, const Args& a, cudaStream_t stream) {
#define FLASH_BWD_CASE(DD) \
  case DD:                 \
    return launch_typed<T, DD>(which, a, stream);
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
  if (dtype == 0) return launch_dim<float>(which, D, a, st);
  if (dtype == 1) return which == kDq ? launch_dq_tc_dim(D, a, st) : launch_dim<__nv_bfloat16>(which, D, a, st);
  return -1;
}

}  // namespace

// C entry points, loaded with ctypes by kernels/flash_attention.py. q, k, v
// and dout are in one dtype (0 float32, 1 bfloat16) and take any strides
// with a contiguous head dimension; lse and delta are contiguous float32
// (B, H, Sq); dq is written contiguous (B, H, Sq, D) and dk, dv contiguous
// (B, Hkv, Sk, D), in the inputs' dtype. Each returns the cudaError_t of its
// launch, or -1 for a head dimension or dtype that the file has no instance
// of.
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
