// AdamW's update of one leaf in one streaming pass, for Hopper (sm_90a).
//
// Per element, with the constants already rounded by the caller as the
// optimizer rounds them (optim/optimizers.py::adamw):
//
//   m' = M(M(m * b1) + T(c1 * g))            first moment, kept in M
//   v' = v * b2 + c2 * (g * g)               second moment, float32
//   u  = T(neg_lr * ((m' / bc1) / (sqrt(v' / bc2) + eps) + T(wd * p)))
//
// where T is the parameters' and gradients' dtype, M the first moment's
// (each bfloat16 or float32), X(x) rounds the float32 x to X to nearest even,
// and every operation is one float32 operation rounded to nearest. That is
// the order and the rounding of the ATen ops the plain version
// (kernels/adamw.py::adamw_leaf_ref) runs, one full pass each, so the
// kernel's results equal theirs bit for bit. The intrinsics (__fmul_rn,
// __fadd_rn, __fdiv_rn, __fsqrt_rn) keep nvcc from contracting a product
// and a sum into an FMA, which would round once where the ATen ops round
// twice; NVCC_FLAGS has no -fmad=false. bc1 and bc2 (1 - b1^t, 1 - b2^t) are
// float32 scalars in device memory, computed by ATen from the device step,
// so the step needs no host-to-device copy.
//
// It replaces no TPU kernel: the reference's AdamW is jnp under jit, which
// XLA fuses into one pass. In the port the same arithmetic ran as about 18
// eager ATen ops a leaf, each a full pass, most writing a float32 temporary.
//
// What bounds it: memory. It reads g, p, m and v and writes m', v' and u
// once: 2+2+2+4 bytes in and 2+4+2 out a bfloat16 parameter with a bfloat16
// m, 18 bytes, against about 16 float32 operations. At 3.35 TB/s a 4.08e9-
// parameter step takes at least 21.9 ms; the 102,400 x 4,096 head leaf 2.25.
//
// What the design does about it: one launch a leaf, a grid-stride loop of
// 8 elements a thread an iteration, so every access is a 16-byte load or
// store (8 bfloat16, or two float4 of float32) by neighbouring threads on
// neighbouring addresses; streaming cache hints (__ldcs/__stcs: every byte
// is touched once, so nothing is worth keeping in L2); at most
// kBlocksPerSM blocks an SM, so the loop, not the grid, covers a large
// leaf; no shared memory. The n % 8 elements after the last whole group
// take a scalar path with the same arithmetic, and so does every element of
// a leaf with an array off the 16-byte grid (a view at an odd offset: the
// update is a fresh allocation, so such a leaf has no index at which every
// array is aligned, save for float32 parameters with a bfloat16 mu shifted
// by 4 elements).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
// 2 blocks of 256 threads an SM: at the head and w1 leaves on an H100, 83.8%
// of the bound, against 82.2% with 8 and 81.8% with 4
constexpr int kBlocksPerSM = 2;
constexpr int kVec = 8;  // elements a thread handles an iteration

struct Consts {
  float b1, c1, b2, c2, eps, wd, neg_lr;
};

// X(x): a float32 rounded to X and back (exact for float32).
template <typename X>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float to_float(float x) { return x; }
  static __device__ __forceinline__ float from_float(float x) { return x; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
  static __device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ __nv_bfloat16 from_float(float x) { return __float2bfloat16_rn(x); }
};

// One element: updates m and v (as float32 values already rounded to their
// dtypes) and returns u before its rounding to T.
template <typename T, typename M>
__device__ __forceinline__ float adamw_element(float g, float p, float& m, float& v, const Consts& c, float bc1,
                                               float bc2) {
  m = Num<M>::round(__fadd_rn(Num<M>::round(__fmul_rn(m, c.b1)), Num<T>::round(__fmul_rn(c.c1, g))));
  v = __fadd_rn(__fmul_rn(v, c.b2), __fmul_rn(c.c2, __fmul_rn(g, g)));
  const float q = __fdiv_rn(__fdiv_rn(m, bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), c.eps));
  // wd * p is computed even when wd == 0: 0 * p is part of the arithmetic
  // (its sign, and NaN for an infinite p)
  return __fmul_rn(c.neg_lr, __fadd_rn(q, Num<T>::round(__fmul_rn(c.wd, p))));
}

// 8 consecutive elements at x + i (16-byte aligned) as float32, and back.
__device__ __forceinline__ void load8(const float* x, int64_t i, float out[kVec]) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(x + i));
  const float4 b = __ldcs(reinterpret_cast<const float4*>(x + i) + 1);
  out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
  out[4] = b.x, out[5] = b.y, out[6] = b.z, out[7] = b.w;
}

// A 32-bit word holds two bfloat16, the lower index in its low half; a
// bfloat16 is the high half of the float32 of the same value.
__device__ __forceinline__ void unpack2(unsigned w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

__device__ __forceinline__ void load8(const __nv_bfloat16* x, int64_t i, float out[kVec]) {
  const uint4 w = __ldcs(reinterpret_cast<const uint4*>(x + i));
  unpack2(w.x, out[0], out[1]);
  unpack2(w.y, out[2], out[3]);
  unpack2(w.z, out[4], out[5]);
  unpack2(w.w, out[6], out[7]);
}

__device__ __forceinline__ void store8(float* x, int64_t i, const float in[kVec]) {
  __stcs(reinterpret_cast<float4*>(x + i), make_float4(in[0], in[1], in[2], in[3]));
  __stcs(reinterpret_cast<float4*>(x + i) + 1, make_float4(in[4], in[5], in[6], in[7]));
}

__device__ __forceinline__ void store8(__nv_bfloat16* x, int64_t i, const float in[kVec]) {
  __stcs(reinterpret_cast<uint4*>(x + i),
         make_uint4(pack2(in[0], in[1]), pack2(in[2], in[3]), pack2(in[4], in[5]), pack2(in[6], in[7])));
}

// The first `groups` runs of 8 elements one a thread an iteration, the rest
// (n % 8, or all n when an array is off the 16-byte grid) one a thread.
template <typename T, typename M>
__global__ void __launch_bounds__(kThreads) adamw_kernel(const T* __restrict__ g, const T* __restrict__ p,
                                                         M* __restrict__ m, float* __restrict__ v,
                                                         T* __restrict__ u, const float* __restrict__ bc1_ptr,
                                                         const float* __restrict__ bc2_ptr, Consts c, int64_t n,
                                                         int64_t groups) {
  const float bc1 = *bc1_ptr, bc2 = *bc2_ptr;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;

  for (int64_t j = tid; j < groups; j += stride) {
    const int64_t i = j * kVec;
    float gf[kVec], pf[kVec], mf[kVec], vf[kVec], uf[kVec];
    load8(g, i, gf);
    load8(p, i, pf);
    load8(m, i, mf);
    load8(v, i, vf);
#pragma unroll
    for (int k = 0; k < kVec; ++k) uf[k] = adamw_element<T, M>(gf[k], pf[k], mf[k], vf[k], c, bc1, bc2);
    store8(m, i, mf);
    store8(v, i, vf);
    store8(u, i, uf);
  }

  for (int64_t i = groups * kVec + tid; i < n; i += stride) {
    float mi = Num<M>::to_float(m[i]), vi = v[i];
    const float ui = adamw_element<T, M>(Num<T>::to_float(g[i]), Num<T>::to_float(p[i]), mi, vi, c, bc1, bc2);
    m[i] = Num<M>::from_float(mi);
    v[i] = vi;
    u[i] = Num<T>::from_float(ui);
  }
}

int max_blocks() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return sms * kBlocksPerSM;
}

template <typename T, typename M>
cudaError_t launch(const void* g, const void* p, void* m, void* v, void* u, const void* bc1, const void* bc2,
                   const Consts& c, int64_t n, cudaStream_t stream) {
  const uintptr_t grid16 = reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(p) |
                           reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(v) |
                           reinterpret_cast<uintptr_t>(u);
  const int64_t groups = grid16 % 16 == 0 ? n / kVec : 0;
  const int64_t scalar = n - groups * kVec;
  const int64_t work = groups > scalar ? groups : scalar;
  const int64_t blocks = (work + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(blocks < max_blocks() ? blocks : max_blocks());
  adamw_kernel<T, M><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(p), static_cast<M*>(m), static_cast<float*>(v),
      static_cast<T*>(u), static_cast<const float*>(bc1), static_cast<const float*>(bc2), c, n, groups);
  return cudaGetLastError();
}

}  // namespace

// One leaf's update on `stream`: g and p (dtype code t_bf16: 1 bfloat16, 0
// float32), m (m_bf16 likewise), v float32, the output u in p's dtype, n
// elements each, contiguous and not overlapping; bc1 and bc2 point to
// float32 scalars on the device. m and v are updated in place. Launches
// nothing when n == 0. Returns cudaGetLastError() after the launch.
extern "C" int adamw_launch(const void* g, const void* p, void* m, void* v, void* u, const void* bc1,
                            const void* bc2, int t_bf16, int m_bf16, float b1, float c1, float b2, float c2,
                            float eps, float wd, float neg_lr, long long n, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const Consts c{b1, c1, b2, c2, eps, wd, neg_lr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (t_bf16 && m_bf16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(g, p, m, v, u, bc1, bc2, c, n, st);
  else if (t_bf16)
    err = launch<__nv_bfloat16, float>(g, p, m, v, u, bc1, bc2, c, n, st);
  else if (m_bf16)
    err = launch<float, __nv_bfloat16>(g, p, m, v, u, bc1, bc2, c, n, st);
  else
    err = launch<float, float>(g, p, m, v, u, bc1, bc2, c, n, st);
  return static_cast<int>(err);
}
