// Banded min-plus (tropical) row update with first-minimum argmin, for Hopper
// (sm_90a). One launch is one class step of the (MC)^2MKP dynamic program:
//
//   kout[b, t] = min_{0 <= j < W, j <= t} sat(kprev[b, t - j] + cost[b, j])
//   iout[b, t] = the first j (ascending) that reaches that minimum, 0 if none
//   sat(x)     = BIG if x >= BIG else x,  BIG = 1e30f
//
// Replaces two Pallas kernels of the JAX package that compute this function:
//   src/repro/kernels/minplus.py:76  _minplus_batch_kernel  (TPU)
//   src/repro/kernels/gpu.py:40      _minplus_gpu_kernel    (Pallas-GPU, BT x BW blocks)
// The TPU kernel keeps the whole padded previous row in VMEM; a T = 1M row is
// 4 MB, far above the 227 KB of shared memory a Hopper block gets, so this
// kernel stages only the (span + BW - 1)-entry row window that one band chunk
// of one output tile reads, as the Pallas-GPU kernel's layout does.
//
// What bounds it. At the main path's shape (B = 16, T+1 = 10,001, W = 1,001)
// one step has B * sum_t min(t + 1, W) = 1.52e8 valid candidates. Each costs
// an add, a saturating min, a compare and two selects (about 5 lane
// operations) plus one shared-memory read: 7.6e8 lane operations against
// 132 SMs x 128 FP32 lanes x 1.98 GHz (the H100 SXM's clocks.max.sm, as
// nvidia-smi reads it on the card) = 3.3e13 per second, about 23 us. The
// step moves 4*B*(T+1) + 4*B*W bytes in and 8*B*(T+1) out, 1.98 MB, or
// 0.6 us at 3.35 TB/s. So it is bound by the ALU, some 40x above the memory
// bound.
//
// What the design does about it. Every candidate lives in registers and
// shared memory: per band chunk a block reads span + 2*BW - 1 floats from
// device memory and does span * BW candidates on them. Each thread owns R
// outputs strided by blockDim.x, so neighbouring lanes read neighbouring
// shared words (no bank conflicts) and one broadcast cost read serves R
// outputs. Saturation is one fminf (equal to the select for non-NaN input).
// Chunks whose every j exceeds the tile's last t are skipped. Later work:
// a register sliding window to cut the shared reads, cp.async/TMA double
// buffering of the window, a wider strip per thread.
//
// Exactness, bit for bit against the dense PyTorch oracle (kernels/ref.py):
//   * each candidate is one IEEE float32 add (__fadd_rn, no contraction; the
//     file must not be built with --use_fast_math, whose flush-to-zero would
//     change sums) followed by the same saturation;
//   * each thread visits j in ascending order with a strict '<' from
//     (BIG, 0), so it keeps the first minimum, and an all-BIG column keeps 0;
//   * positions outside the row (t - j < 0) and outside the band (j >= W)
//     are staged as +inf: inf + c = inf saturates to BIG, which never beats
//     the BIG start, exactly as the oracle's BIG there never wins.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float kBig = 1e30f;
constexpr int kMaxThreads = 256;

template <int R>
__global__ void __launch_bounds__(kMaxThreads)
minplus_band_kernel(const float* __restrict__ kprev, const float* __restrict__ cost,
                    float* __restrict__ kout, int* __restrict__ iout,
                    int Tp, int W, int BT, int BW) {
  extern __shared__ float smem[];
  const int nt = blockDim.x;
  const int span = nt * R;          // outputs computed per block (>= BT)
  float* s_row = smem;              // span + BW - 1 row entries
  float* s_cost = smem + span + BW - 1;  // BW cost entries

  const int b = blockIdx.y;
  const int base = blockIdx.x * BT;  // absolute t of this tile's first output
  const float* row = kprev + static_cast<size_t>(b) * Tp;
  const float* crow = cost + static_cast<size_t>(b) * W;

  float best[R];
  int idx[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    best[r] = kBig;
    idx[r] = 0;
  }

  // j <= t: no j beyond the tile's last output can hold a valid candidate
  const int j_end = min(W, min(base + BT, Tp));
  for (int j0 = 0; j0 < j_end; j0 += BW) {
    // s_row[k] = row[base - j0 - (BW - 1) + k], +inf outside [0, Tp)
    const int off = base - j0 - (BW - 1);
    for (int k = threadIdx.x; k < span + BW - 1; k += nt) {
      const int s = off + k;
      s_row[k] = (s >= 0 && s < Tp) ? row[s] : CUDART_INF_F;
    }
    for (int k = threadIdx.x; k < BW; k += nt) {
      const int j = j0 + k;
      s_cost[k] = j < W ? crow[j] : CUDART_INF_F;
    }
    __syncthreads();
    const int nj = min(BW, j_end - j0);
    for (int jj = 0; jj < nj; ++jj) {
      const float c = s_cost[jj];
      const float* w = s_row + (BW - 1) - jj + threadIdx.x;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        // candidate for output dt = threadIdx.x + r * nt at band offset j0 + jj
        const float cand = fminf(__fadd_rn(w[r * nt], c), kBig);
        if (cand < best[r]) {
          best[r] = cand;
          idx[r] = j0 + jj;
        }
      }
    }
    __syncthreads();
  }

  float* orow = kout + static_cast<size_t>(b) * Tp;
  int* irow = iout + static_cast<size_t>(b) * Tp;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int dt = threadIdx.x + r * nt;
    const int t = base + dt;
    if (dt < BT && t < Tp) {
      orow[t] = best[r];
      irow[t] = idx[r];
    }
  }
}

template <int R>
cudaError_t launch(const float* kprev, const float* cost, float* kout, int* iout,
                   int B, int Tp, int W, int BT, int BW, int nt, cudaStream_t stream) {
  const dim3 grid((Tp + BT - 1) / BT, B);
  const size_t smem = sizeof(float) * (static_cast<size_t>(nt) * R + 2 * BW - 1);
  minplus_band_kernel<R><<<grid, nt, smem, stream>>>(kprev, cost, kout, iout, Tp, W, BT, BW);
  return cudaGetLastError();
}

}  // namespace

// Launches one row update on `stream` (a cudaStream_t) and returns
// cudaGetLastError(). All pointers are device pointers to contiguous
// row-major arrays: kprev (B, Tp) and cost (B, W) float32, kout (B, Tp)
// float32 and iout (B, Tp) int32. The block has min(BT, 256) threads, each
// owning R = ceil(BT / threads) outputs, R in {1, 2, 4, 8}; shared memory is
// 4 * (threads * R + 2 * BW - 1) bytes. Allocates nothing, does not sync.
extern "C" int minplus_band_launch(const void* kprev, const void* cost, void* kout, void* iout,
                                   int B, int Tp, int W, int BT, int BW, void* stream) {
  if (B < 1 || B > 65535 || Tp < 1 || W < 1 || BT < 1 || BW < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nt = BT < kMaxThreads ? BT : kMaxThreads;
  const int r = (BT + nt - 1) / nt;
  const float* kp = static_cast<const float*>(kprev);
  const float* cs = static_cast<const float*>(cost);
  float* ko = static_cast<float*>(kout);
  int* io = static_cast<int*>(iout);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (r == 1) {
    err = launch<1>(kp, cs, ko, io, B, Tp, W, BT, BW, nt, st);
  } else if (r == 2) {
    err = launch<2>(kp, cs, ko, io, B, Tp, W, BT, BW, nt, st);
  } else if (r <= 4) {
    err = launch<4>(kp, cs, ko, io, B, Tp, W, BT, BW, nt, st);
  } else if (r <= 8) {
    err = launch<8>(kp, cs, ko, io, B, Tp, W, BT, BW, nt, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
