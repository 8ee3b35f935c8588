// Flash-attention forward (FlashAttention-2 style online softmax) for Hopper
// (sm_90a), on CUDA cores in float32. One launch is one attention layer:
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
// So it is bound by operations. This kernel does those operations on the
// float32 CUDA cores (67 TFLOP/s), so it cannot come within about 15x of
// that bound; it is the simple, exact first port, and the redesign onto
// wgmma, TMA and warp specialisation is later work.
//
// What the design does about it. Every score lives only in registers and
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
    return launch_dim<__nv_bfloat16>(D, q, k, v, o, lse, B, H, Hkv, Sq, Sk, qsb, qsh, qss, ksb,
                                     ksh, kss, vsb, vsh, vss, kind, window, softcap, scale, st);
  return -1;
}
