// The exact solver's device path for Hopper (sm_90a): the banded min-plus
// (tropical) row update with first-minimum argmin, the whole class scan in
// one host call, and the backtrack through the argmin slab.
//
//   kout[b, t] = min_{0 <= j < W, j <= t} sat(kprev[b, t - j] + cost[b, j])
//   iout[b, t] = the first j (ascending) that reaches that minimum, 0 if none
//   sat(x)     = BIG if x >= BIG else x,  BIG = 1e30f
//
// The row kernel replaces two Pallas kernels of the JAX package that compute
// this function:
//   src/repro/kernels/minplus.py:76  _minplus_batch_kernel  (TPU)
//   src/repro/kernels/gpu.py:40      _minplus_gpu_kernel    (Pallas-GPU, BT x BW blocks)
// The TPU kernel keeps the whole padded previous row in VMEM; a T = 1M row is
// 4 MB, far above the 227 KB of shared memory a Hopper block gets, so a block
// stages only the (span + BW - 1)-entry row window that one band chunk of its
// output tile reads. The scan and the backtrack replace the reference's two
// lax.scans (src/repro/core/jax_dp.py:_dp_scan_from, _backtrack_batch), which
// are plain jnp, not Pallas.
//
// What bounds the row kernel. At the main path's shape (B = 16, T+1 = 10,001,
// W = 1,001) one step has B * sum_t min(t + 1, W) = 152,168,016 candidates.
// Keeping the first minimum and its argmin takes at least four lane
// instructions per candidate: an add, a compare, a select of the value and a
// select of the index. The card issues 132 SMs x 4 schedulers x 32 lanes x
// 1.98 GHz = 3.345e13 lane instructions a second, so the step takes at least
// 18.19 us. It moves 4*B*(T+1) + 4*B*W bytes in and 8*B*(T+1) out, 1.98 MB,
// or 0.6 us at 3.35 TB/s: memory is not the limit, so TMA and wgmma have
// nothing to do here. Hopper's DPX instructions (__viaddmin_s32 and the like)
// are integer-only and cannot reproduce an IEEE float32 add.
//
// What the design does about it.
//   * No saturation in the inner loop. The running best starts at BIG and
//     takes a candidate only if it is strictly '<'. A candidate >= BIG (or
//     inf, or NaN) can never win, with or without sat, so best and idx come
//     out as the oracle's: 4 instructions per candidate, not 5.
//   * Both selects stay, as selects: fminf(best, cand) may return -0 for a
//     (+0, -0) tie, where the strict '<' keeps the first. But they are not
//     issued as FSEL/SEL. Those run on the ALU pipe, which takes a warp
//     instruction every other cycle, so three ALU instructions a candidate
//     (compare, two selects) would cost 6 cycles where 4 issue. Instead each
//     select is a predicated add of -0.0 (keep_if_less), an exact copy that
//     runs on the FP32 pipe, and the index is kept as an exact float. That
//     leaves the compare as the only ALU instruction per candidate: an add,
//     a compare and two predicated adds.
//   * A register sliding window. A thread owns R = 8 consecutive outputs.
//     From band offset j to j + 1 its window of row entries shifts by one, so
//     each step of j reads one new row entry from shared memory, and the
//     costs are read four at a time (float4 broadcasts): 1.25 shared reads
//     per 8 candidates instead of 2 per candidate. The window is a ring of 8
//     registers, unrolled over 8 steps of j so the rotation is renaming.
//   * A bank-conflict-free row layout. Lane l reads window entry 8l + c; a
//     plain layout would give 8-way conflicts, so one pad word follows every
//     8 entries (entry k lives at k + k/8) and lane l reads word 9l + c'.
//     Each thread's 8 reads of a unit of 8 steps fall in one such group of 8,
//     so they are one base register and constant offsets.
//   * Balance. A warp covers 256 outputs; a block of 4 warps covers BT <= 256
//     outputs with the band split 4 ways (or 512 split 2 ways, 1024 unsplit),
//     and the partial (best, idx) pairs are merged in shared memory, lowest j
//     first on ties. At the main shape that is 40 x 16 = 640 blocks of 128
//     threads, all resident at once (4.85 per SM), each SM sub-partition
//     holding about 5 warps of 8 independent min chains.
//
// Exactness, bit for bit against the dense PyTorch oracle (kernels/ref.py):
//   * each candidate is one IEEE float32 add (__fadd_rn, no contraction; the
//     file must not be built with --use_fast_math, whose flush-to-zero would
//     change sums);
//   * each thread visits its j in ascending order with a strict '<' from
//     (BIG, 0), so it keeps the first minimum of its part of the band, and an
//     all-BIG column keeps 0;
//   * the parts of the band are merged by (value, then lower j): the global
//     first minimum is the part minimum with the lowest j among those equal
//     to the global minimum, so the merge keeps it, bits and all (a tie of
//     +0 and -0 keeps the first of them, as the reference's strict-'<' scan
//     does; the dense oracle's amin may return the other zero there);
//   * each select is x + -0.0, which is x bit for bit, and each j < 2^24 is
//     exact as a float;
//   * positions outside the row (t - j < 0) and outside the band (j >= W)
//     are staged as +inf: inf + c is inf, which never beats BIG, exactly as
//     the oracle's BIG there never wins.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float kBig = 1e30f;
constexpr int kThreads = 128;          // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kLogR = 3;
constexpr int kR = 1 << kLogR;         // consecutive outputs per thread
constexpr int kGroup = 32 * kR;        // outputs one warp covers
constexpr int kMaxBT = kWarps * kGroup;
constexpr int kPartWords = 2 * kThreads;  // merge buffer: one value and index a thread
constexpr int kMaxW = 1 << 24;  // every j is exact as a float

// one pad word after every kR window entries
__device__ __forceinline__ int pad(int k) { return k + (k >> kLogR); }

// if (cand < best) { best = cand; jbest = j; } with a strict '<': the select
// of both, issued as two predicated adds of -0.0, which copy exactly
// (x + -0.0 == x bit for bit, signed zeros included) and run on the FP32
// pipe. nz_v and nz_j hold -0.0 but come from a kernel argument, so ptxas
// cannot fold the adds back into ALU-pipe selects; nz_j differs per output,
// so the index adds (the same j for all outputs) cannot be merged into one
// add and eight selects.
__device__ __forceinline__ void keep_if_less(float& best, float& jbest, float cand, float j, float nz_v,
                                             float nz_j) {
  asm("{\n\t.reg .pred p;\n\tsetp.lt.f32 p, %2, %0;\n\t@p add.rn.f32 %0, %2, %4;\n\t@p add.rn.f32 %1, %3, %5;\n\t}"
      : "+f"(best), "+f"(jbest)
      : "f"(cand), "f"(j), "f"(nz_v), "f"(nz_j));
}

// Output groups of a BT-output tile: 1, 2 or 4 warps side by side along t.
__host__ __device__ __forceinline__ int tile_groups(int BT) {
  return BT <= kGroup ? 1 : (BT <= 2 * kGroup ? 2 : 4);
}

// Shared memory words: the padded row window (rounded to a float4) plus the
// band chunk's costs, or the merge buffer, whichever is larger.
__host__ __device__ __forceinline__ int window_words(int BT, int BWr) {
  const int nk = tile_groups(BT) * kGroup + BWr - 1;
  return ((nk - 1) + ((nk - 1) >> kLogR) + 1 + 3) & ~3;
}

int smem_words(int BT, int BWr) {
  const int w = window_words(BT, BWr) + BWr;
  return w > kPartWords ? w : kPartWords;
}

__global__ void __launch_bounds__(kThreads)
minplus_row_kernel(const float* __restrict__ kprev, const float* __restrict__ cost,
                   float* __restrict__ kout, int* __restrict__ iout,
                   int Tp, int W, long long cost_sb, long long cost_sj, int BT, int BWr, float neg_zero) {
  extern __shared__ __align__(16) float smem[];
  const int groups = tile_groups(BT);
  const int splits = kWarps / groups;
  const int nk = groups * kGroup + BWr - 1;  // window entries per chunk
  float* s_row = smem;
  float* s_cost = smem + window_words(BT, BWr);

  const int b = blockIdx.y;
  const int base = blockIdx.x * BT;  // absolute t of this tile's first output
  const float* row = kprev + static_cast<size_t>(b) * Tp;
  const float* crow = cost + b * cost_sb;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = warp / splits;  // which 256 outputs
  const int s = warp % splits;  // which part of each band chunk
  const int dt0 = g * kGroup + lane * kR;

  float best[kR];
  float jbest[kR];  // the j of best, as an exact float (j < 2^24)
  float nz_j[kR];   // -0.0 per output, so no two index updates can be merged
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    best[r] = kBig;
    jbest[r] = 0.0f;
    nz_j[r] = neg_zero * static_cast<float>(r + 1);
  }

  // j <= t: no j beyond the tile's last output can hold a valid candidate
  const int j_end = min(W, min(base + BT, Tp));
  for (int j0 = 0; j0 < j_end; j0 += BWr) {
    // window entry k = row[base - j0 - (BWr - 1) + k], +inf outside [0, Tp),
    // stored at word pad(k)
    const int off = base - j0 - (BWr - 1);
    for (int k = threadIdx.x; k < nk; k += kThreads) {
      const int src = off + k;
      s_row[pad(k)] = (src >= 0 && src < Tp) ? row[src] : CUDART_INF_F;
    }
    for (int k = threadIdx.x; k < BWr; k += kThreads) {
      const int j = j0 + k;
      s_cost[k] = j < W ? crow[j * cost_sj] : CUDART_INF_F;
    }
    __syncthreads();
    // this warp's units of 8 steps of j
    const int units = (min(BWr, j_end - j0) + kR - 1) / kR;
    const int per = (units + splits - 1) / splits;
    const int u_lo = s * per;
    const int u_hi = min(units, u_lo + per);
    if (u_lo < u_hi) {
      // K: window entry of output r = 0 at the unit's first step; K % kR ==
      // kR - 1, so entries K - kR + 1 .. K share one pad group and
      // K + 1 .. K + kR the next
      const int K = (BWr - 1) - u_lo * kR + dt0;
      const float* p = s_row + pad(K);
      // ring: x[m mod kR] holds window entry K + m, m in [-jj, kR - 1 - jj] at step jj
      float x[kR];
#pragma unroll
      for (int r = 1; r < kR; ++r) x[r] = p[r + 1];
      for (int u = u_lo; u < u_hi; ++u) {
        float c[kR];
#pragma unroll
        for (int q = 0; q < kR; q += 4) {
          const float4 v = *reinterpret_cast<const float4*>(s_cost + u * kR + q);
          c[q] = v.x;
          c[q + 1] = v.y;
          c[q + 2] = v.z;
          c[q + 3] = v.w;
        }
        const float jb = __int2float_rn(j0 + u * kR);
#pragma unroll
        for (int jj = 0; jj < kR; ++jj) {
          x[(kR - jj) & (kR - 1)] = p[-jj];
          const float j = __fadd_rn(jb, static_cast<float>(jj));
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            const float cand = __fadd_rn(x[(r - jj) & (kR - 1)], c[jj]);
            keep_if_less(best[r], jbest[r], cand, j, neg_zero, nz_j[r]);
          }
        }
        p -= kR + 1;  // the next unit's K is kR lower: one pad group of kR + 1 words
      }
    }
    __syncthreads();
  }

  int idx[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) idx[r] = __float2int_rn(jbest[r]);

  if (splits > 1) {  // merge the parts of the band, one output slot at a time; the window is dead now
    float* pv = smem;
    int* pi = reinterpret_cast<int*>(smem + kThreads);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      pv[threadIdx.x] = best[r];
      pi[threadIdx.x] = idx[r];
      __syncthreads();
      if (s == 0) {
        for (int s2 = 1; s2 < splits; ++s2) {
          const int from = (g * splits + s2) * 32 + lane;
          const float v = pv[from];
          const int i = pi[from];
          if (v < best[r] || (v == best[r] && i < idx[r])) {
            best[r] = v;
            idx[r] = i;
          }
        }
      }
      __syncthreads();
    }
  }

  if (s == 0) {
    float* orow = kout + static_cast<size_t>(b) * Tp;
    int* irow = iout + static_cast<size_t>(b) * Tp;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int dt = dt0 + r;
      const int t = base + dt;
      if (dt < BT && t < Tp) {
        orow[t] = best[r];
        irow[t] = idx[r];
      }
    }
  }
}

// One thread per instance walks the classes in reverse: x_i = I[i, b, t_b];
// t_b -= x_i. n dependent loads from a slab larger than L2, so it is bound by
// the latency of n device-memory round trips. A t_b outside [0, Tp) reads
// nothing and gives x_i = 0 (the plain version raises there; the host checks
// t_star's range where it knows it).
__global__ void minplus_backtrack_kernel(const int* __restrict__ I, const long long* __restrict__ t_star,
                                         int* __restrict__ X, int n, int B, int Tp) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  long long t = t_star[b];
  for (int i = n - 1; i >= 0; --i) {
    int x = 0;
    if (t >= 0 && t < Tp) x = I[(static_cast<size_t>(i) * B + b) * Tp + t];
    X[static_cast<size_t>(b) * n + i] = x;
    t -= x;
  }
}

// The band chunk: BW rounded up to whole units of kR steps of j.
int round_bw(int BW) { return (BW + kR - 1) & ~(kR - 1); }

bool bad_tiles(int B, int Tp, int W, int BT, int BW) {
  return B < 1 || B > 65535 || Tp < 1 || W < 1 || W > kMaxW || BT < 1 || BT > kMaxBT || BW < 1;
}

cudaError_t launch_row(const float* kprev, const float* cost, float* kout, int* iout, int B, int Tp, int W,
                       long long cost_sb, long long cost_sj, int BT, int BWr, cudaStream_t stream) {
  const dim3 grid((Tp + BT - 1) / BT, B);
  const size_t smem = sizeof(float) * static_cast<size_t>(smem_words(BT, BWr));
  minplus_row_kernel<<<grid, kThreads, smem, stream>>>(kprev, cost, kout, iout, Tp, W, cost_sb, cost_sj, BT, BWr,
                                                        -0.0f);
  return cudaGetLastError();
}

}  // namespace

// Launches one row update on `stream` (a cudaStream_t) and returns
// cudaGetLastError(). All pointers are device pointers to contiguous
// row-major arrays: kprev (B, Tp) and cost (B, W) float32, kout (B, Tp)
// float32 and iout (B, Tp) int32. A block of 128 threads computes a tile of
// BT <= 1024 outputs; the band is staged in chunks of BW rounded up to a
// multiple of kR = 8. Shared memory: see smem_words. Allocates nothing, does
// not sync.
extern "C" int minplus_band_launch(const void* kprev, const void* cost, void* kout, void* iout,
                                   int B, int Tp, int W, int BT, int BW, void* stream) {
  if (bad_tiles(B, Tp, W, BT, BW)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_row(static_cast<const float*>(kprev), static_cast<const float*>(cost),
                                     static_cast<float*>(kout), static_cast<int*>(iout), B, Tp, W, W, 1, BT,
                                     round_bw(BW), static_cast<cudaStream_t>(stream)));
}

// The backtrack alone on `stream`: per instance b, from t_star[b] (int64),
// x_i = I[i, b, t]; t -= x_i for i = n-1 .. 0, into X (B, n) int32, reading
// the (n, B, Tp) int32 slab I. Launches nothing when n == 0. Returns
// cudaGetLastError().
extern "C" int minplus_backtrack_launch(const void* I, const void* t_star, void* X, int n, int B, int Tp,
                                        void* stream) {
  if (n < 0 || B < 1 || Tp < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  minplus_backtrack_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(I), static_cast<const long long*>(t_star), static_cast<int*>(X), n, B, Tp);
  return static_cast<int>(cudaGetLastError());
}

// The whole class scan in one host call: n row launches on `stream`, class i
// reading row (i % 2 ? kbuf : k0) and writing the other, with its argmins in
// I[i] of the (n, B, Tp) int32 slab. costs is float32 (B, n, W) read with
// element strides (cost_sb, cost_sn, cost_sj), so a transposed or sliced
// view needs no copy. k0 is overwritten when n > 1; the last row is in k0
// when n is even and in kbuf when n is odd. With X non-null it then launches
// the backtrack from t_star (B,) int64 into X (B, n) int32. Returns the first
// non-zero cudaGetLastError(), after which nothing more is launched.
extern "C" int minplus_scan_launch(void* k0, void* kbuf, const void* costs, void* I, const void* t_star, void* X,
                                   int n, int B, int Tp, int W, long long cost_sb, long long cost_sn,
                                   long long cost_sj, int BT, int BW, void* stream) {
  if (n < 0 || bad_tiles(B, Tp, W, BT, BW)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* rows[2] = {static_cast<float*>(k0), static_cast<float*>(kbuf)};
  const float* cs = static_cast<const float*>(costs);
  int* slab = static_cast<int*>(I);
  const int BWr = round_bw(BW);
  for (int i = 0; i < n; ++i) {
    const cudaError_t err = launch_row(rows[i & 1], cs + i * cost_sn, rows[(i + 1) & 1],
                                       slab + static_cast<size_t>(i) * B * Tp, B, Tp, W, cost_sb, cost_sj,
                                       BT, BWr, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (X == nullptr || n == 0) return 0;
  return minplus_backtrack_launch(slab, t_star, X, n, B, Tp, stream);
}
