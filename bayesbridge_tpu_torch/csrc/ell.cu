// Row-ELL matvec for up to 8 vectors (the ell design backend's product):
//
//   out[c, r] = sum_s val[r, s]^power * x[c, idx[r, s]]
//
// idx (m, width) int32 and val (m, width) float32 or float64, row-major,
// every row padded to `width` slots with (index 0, value 0), so a padded
// slot adds 0 * x[c, 0], exactly 0 for finite x. The k = 1..8 vectors
// (the chains, or the pre-solve's right-hand sides) come interleaved,
// xt = x' of shape (n_in, k), so that one index's k values share one or
// two 32-byte sectors; out is (k, m). power 1 (X v on the row-ELL, X' u
// on the col-ELL) or 2 (the Fisher diagonal's second moment on the
// col-ELL).
//
// Replaces the XLA gathers at bayesbridge_tpu/design/sparse.py:1006-1008,
// :1033-1036 (no Pallas kernel): `jnp.take(v, idx)` then a row sum, and
// the moments at :1535-1537. Written by hand because the plain form
// writes an (m, width) gathered copy to device memory, twice the bytes of
// the ELL arrays, and no PyTorch call reads the row-padded layout
// (cuSPARSE needs a CSR copy, which would double the design on the card).
//
// What bounds it on the H100: bytes. Each launch reads the ELL arrays
// once, m * width * (4 + itemsize) bytes, plus the k vectors and the k
// outputs, over 3,350 GB/s; 2 k operations per slot are far below the
// card's rate in either type. One warp per ELL row: lane l takes slots
// l, l + 32, ... in order, reads idx / val once (coalesced across the
// warp) and gathers the k values of its index through the read-only path
// (the vectors stay in the 50 MB L2: 128 KB and 2 MB per vector in
// float64 at the 262,144 x 16,384 design). A gather moves a 32-byte
// sector whatever it uses of it, so the k vectors are interleaved: with
// them side by side (k, n_in), k gathers a slot moved k sectors, and a
// launch for 8 vectors took longer than 8 single launches (PERF.md); a
// lane loads its index's k values with 16-byte (or 8-byte) vector loads
// where k allows. The lanes' partial sums meet in a fixed xor-shuffle tree, with no atomics:
// chain c's sum is the same bits as its single-vector launch, and reruns
// give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr int kMaxVectors = 8;

template <typename T>
__device__ __forceinline__ T fma_t(T a, T b, T c);
template <>
__device__ __forceinline__ float fma_t<float>(float a, float b, float c) {
  return fmaf(a, b, c);
}
template <>
__device__ __forceinline__ double fma_t<double>(double a, double b,
                                                double c) {
  return fma(a, b, c);
}

// x[0..K) = p[0..K), in 16-byte loads where K * sizeof(T) allows, else
// 8-byte, else one value at a time. p is aligned to K * sizeof(T) (an
// index's values in the interleaved vectors).
template <int K>
__device__ __forceinline__ void load_k(const float* p, float (&x)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int i = 0; i < K / 4; ++i) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p) + i);
      x[4 * i] = q.x;
      x[4 * i + 1] = q.y;
      x[4 * i + 2] = q.z;
      x[4 * i + 3] = q.w;
    }
  } else if constexpr (K % 2 == 0) {
#pragma unroll
    for (int i = 0; i < K / 2; ++i) {
      const float2 q = __ldg(reinterpret_cast<const float2*>(p) + i);
      x[2 * i] = q.x;
      x[2 * i + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) x[i] = __ldg(p + i);
  }
}

template <int K>
__device__ __forceinline__ void load_k(const double* p, double (&x)[K]) {
  if constexpr (K % 2 == 0) {
#pragma unroll
    for (int i = 0; i < K / 2; ++i) {
      const double2 q = __ldg(reinterpret_cast<const double2*>(p) + i);
      x[2 * i] = q.x;
      x[2 * i + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) x[i] = __ldg(p + i);
  }
}

template <typename T, int K, int kPower>
__global__ void __launch_bounds__(kThreads) ell_kernel(
    const int32_t* __restrict__ idx, const T* __restrict__ val, int64_t m,
    int width, const T* __restrict__ xt, T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= m) return;  // whole warps leave together
  const int32_t* ir = idx + row * width;
  const T* vr = val + row * width;
  T acc[K];
#pragma unroll
  for (int c = 0; c < K; ++c) acc[c] = T(0);
#pragma unroll 4
  for (int s = lane; s < width; s += 32) {
    T xj[K];
    load_k<K>(xt + (int64_t)__ldg(ir + s) * K, xj);
    T a = __ldg(vr + s);
    if (kPower == 2) a = a * a;
#pragma unroll
    for (int c = 0; c < K; ++c) acc[c] = fma_t<T>(a, xj[c], acc[c]);
  }
#pragma unroll
  for (int c = 0; c < K; ++c) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < K; ++c) out[c * m + row] = acc[c];
  }
}

template <typename T, int K>
cudaError_t launch_k(const int32_t* idx, const T* val, int64_t m, int width,
                     const T* xt, int power, T* out, cudaStream_t s) {
  const int64_t grid = (m + kRowsPerBlock - 1) / kRowsPerBlock;
  if (grid > 0x7fffffff) return cudaErrorInvalidConfiguration;
  if (power == 2)
    ell_kernel<T, K, 2><<<(unsigned)grid, kThreads, 0, s>>>(
        idx, val, m, width, xt, out);
  else
    ell_kernel<T, K, 1><<<(unsigned)grid, kThreads, 0, s>>>(
        idx, val, m, width, xt, out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const int32_t* idx, const T* val, int64_t m, int width,
                   const T* xt, int k, int power, T* out, cudaStream_t s) {
  switch (k) {
    case 1: return launch_k<T, 1>(idx, val, m, width, xt, power, out, s);
    case 2: return launch_k<T, 2>(idx, val, m, width, xt, power, out, s);
    case 3: return launch_k<T, 3>(idx, val, m, width, xt, power, out, s);
    case 4: return launch_k<T, 4>(idx, val, m, width, xt, power, out, s);
    case 5: return launch_k<T, 5>(idx, val, m, width, xt, power, out, s);
    case 6: return launch_k<T, 6>(idx, val, m, width, xt, power, out, s);
    case 7: return launch_k<T, 7>(idx, val, m, width, xt, power, out, s);
    case 8: return launch_k<T, 8>(idx, val, m, width, xt, power, out, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface (ctypes). idx: m * width int32 in [0, n_in); val: m *
// width values, float64 when f64 != 0, else float32; xt: n_in * k values
// of the same type (index j's k values side by side); out: k * m values.
// k in 1..8, power 1 or 2, width >= 1, m >= 1. Returns the CUDA error of
// the launch (0 = ok).
extern "C" int bb_ell(const int32_t* idx, const void* val, long long m,
                      int width, const void* xt, int k, int power, int f64,
                      void* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || width <= 0 || k < 1 || k > kMaxVectors ||
      (power != 1 && power != 2))
    return (int)cudaErrorInvalidValue;
  if (f64)
    return (int)launch<double>(idx, static_cast<const double*>(val), m,
                               width, static_cast<const double*>(xt), k,
                               power, static_cast<double*>(out), s);
  return (int)launch<float>(idx, static_cast<const float*>(val), m, width,
                            static_cast<const float*>(xt), k, power,
                            static_cast<float*>(out), s);
}
