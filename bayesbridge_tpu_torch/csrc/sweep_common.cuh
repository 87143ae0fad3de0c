// Shared pieces of the design sweeps (ne_sweep.cu, tdots_sweep.cu,
// ne_oneread.cu).
//
// Storage contract (checked by the Python wrappers): each design block is
// a row-major (n, ld) array of int8, bf16 (raw uint16 bits) or f32 whose
// row stride ld * sizeof(T) is a multiple of 16 bytes and whose base is
// 16-byte aligned, so every thread reads whole 16-byte vectors. Only the
// first p <= ld columns are logical; the kernels mask columns >= p by
// index and never read rows >= n, so padding may hold any bits.
//
// Every reduction runs in a fixed order (warp butterflies, per-segment
// partials, an ordered second pass). There are no float atomics, so two
// runs on the same inputs give the same bits: the sampler's promise that
// a resumed chain equals an uninterrupted one rests on this.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bbsweep {
namespace {  // internal linkage: each .cu file gets its own copy

enum DType { DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2 };

constexpr int kThreads = 256;      // threads per block, both passes
constexpr int kUrows = 128;        // rows of u staged in shared memory

// A 16-byte vector of stored elements and its up-convert to float.
template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void cvt(uint4 q, float (&o)[N]) {
    o[0] = __uint_as_float(q.x); o[1] = __uint_as_float(q.y);
    o[2] = __uint_as_float(q.z); o[3] = __uint_as_float(q.w);
  }
};

// bf16 is the upper half of an f32: widening is a 16-bit shift.
template <> struct Vec<uint16_t> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void cvt(uint4 q, float (&o)[N]) {
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o[2 * j] = __uint_as_float(w[j] << 16);
      o[2 * j + 1] = __uint_as_float(w[j] & 0xFFFF0000u);
    }
  }
};

template <> struct Vec<int8_t> {
  static constexpr int N = 16;
  __device__ __forceinline__ static void cvt(uint4 q, float (&o)[N]) {
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k)  // byte k to the top, then sign-extend
        o[4 * j + k] = (float)((int32_t)(w[j] << (24 - 8 * k)) >> 24);
  }
};

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// The sweeps' per-row maps from t = (X v)[row] + c[row] and the row's
// operands a, b to the phase-B value u, with the log-likelihood row in
// `lp` (0 unless with_logp): 'ne' u = b t (the CG operator), 'logit'
// u = a - b sigmoid(t), 'linear' u = b (a - t); MID_ROWS: u = t (the row
// pass alone).
enum Mid { MID_NE = 0, MID_LOGIT = 1, MID_LINEAR = 2, MID_ROWS = 3 };

__device__ __forceinline__ float row_map(int mid, float t, float a, float b,
                                         bool with_logp, float& lp) {
  lp = 0.f;
  if (mid == MID_ROWS) return t;
  if (mid == MID_NE) return b * t;
  if (mid == MID_LOGIT) {
    // y t - n log(1 + e^t), the softplus written stably.
    if (with_logp)
      lp = a * t - b * (fmaxf(t, 0.f) + log1pf(expf(-fabsf(t))));
    return a - b * (1.f / (1.f + expf(-t)));
  }
  const float resid = a - t;
  if (with_logp) lp = -0.5f * b * resid * resid;
  return b * resid;
}

template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// acc += x * u_row for the staged row i. K = 1: X'u0. K = 4 adds X'u1,
// X'u2 and the square moment (X.X)'u2. K = 5 adds X'u3 after those.
template <int K> struct NumU {
  static constexpr int value = K == 1 ? 1 : K - 1;
};

template <int K, int N>
__device__ __forceinline__ void accumulate(float (&acc)[K][N],
                                           const float (&xs)[N],
                                           const float* su, int i) {
  const float w0 = su[i];
  if constexpr (K == 1) {
#pragma unroll
    for (int e = 0; e < N; ++e) acc[0][e] = fmaf(xs[e], w0, acc[0][e]);
  } else {
    const float w1 = su[kUrows + i], w2 = su[2 * kUrows + i];
#pragma unroll
    for (int e = 0; e < N; ++e) {
      acc[0][e] = fmaf(xs[e], w0, acc[0][e]);
      acc[1][e] = fmaf(xs[e], w1, acc[1][e]);
      acc[2][e] = fmaf(xs[e], w2, acc[2][e]);
      acc[3][e] = fmaf(xs[e] * xs[e], w2, acc[3][e]);
    }
    if constexpr (K == 5) {
      const float w3 = su[3 * kUrows + i];
#pragma unroll
      for (int e = 0; e < N; ++e) acc[4][e] = fmaf(xs[e], w3, acc[4][e]);
    }
  }
}

// Column pass over one block: this thread owns N consecutive columns of
// tile `tile` and sums rows [r0, r1) of X' [u0 (u1 u2 (u3))] into
// registers, then writes them to its segment's partial row (the K
// reductions of `accumulate`). `su` is kUrows * NumU<K> floats of shared
// memory.
template <typename T, int K>
__device__ __forceinline__ void col_tile(
    const T* __restrict__ X, int64_t ld, int p, int tile, int64_t r0,
    int64_t r1, const float* __restrict__ u0, const float* __restrict__ u1,
    const float* __restrict__ u2, const float* __restrict__ u3, float* su,
    float* __restrict__ part, int64_t p_total, int col_off) {
  constexpr int N = Vec<T>::N;
  constexpr int NU = NumU<K>::value;
  const int c0 = tile * (kThreads * N) + threadIdx.x * N;
  float acc[K][N];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int e = 0; e < N; ++e) acc[k][e] = 0.f;

  for (int64_t rb = r0; rb < r1; rb += kUrows) {
    const int cnt = (int)min64(kUrows, r1 - rb);
    __syncthreads();
    for (int i = threadIdx.x; i < cnt; i += kThreads) {
      su[i] = u0[rb + i];
      if constexpr (NU >= 3) {
        su[kUrows + i] = u1[rb + i];
        su[2 * kUrows + i] = u2[rb + i];
      }
      if constexpr (NU == 4) su[3 * kUrows + i] = u3[rb + i];
    }
    __syncthreads();
    if (c0 < p) {
      const T* xp = X + rb * ld + c0;
      int i = 0;
      // Four rows' loads in flight before their arithmetic.
      for (; i + 4 <= cnt; i += 4, xp += 4 * ld) {
        uint4 q[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) q[j] = load16(xp + j * ld);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float xs[N];
          Vec<T>::cvt(q[j], xs);
          accumulate<K, N>(acc, xs, su, i + j);
        }
      }
      for (; i < cnt; ++i, xp += ld) {
        float xs[N];
        Vec<T>::cvt(load16(xp), xs);
        accumulate<K, N>(acc, xs, su, i);
      }
    }
  }
  if (c0 < p) {
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int e = 0; e < N; ++e)
        if (c0 + e < p) part[k * p_total + col_off + c0 + e] = acc[k][e];
  }
}

// Column pass over one or two row-aligned blocks. Grid: x = column tiles
// of block 0 then of block 1, y = row segments of `rows_per_seg` rows.
// partial: (n_seg, K, p0 + p1) floats.
template <typename T0, typename T1, int K>
__global__ void __launch_bounds__(kThreads) colpass_kernel(
    const T0* __restrict__ X0, int64_t ld0, int p0, int tiles0,
    const T1* __restrict__ X1, int64_t ld1, int p1, int64_t n,
    int64_t rows_per_seg, const float* __restrict__ u0,
    const float* __restrict__ u1, const float* __restrict__ u2,
    const float* __restrict__ u3, float* __restrict__ partial) {
  __shared__ float su[kUrows * NumU<K>::value];
  const int64_t p_total = (int64_t)p0 + p1;
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_seg;
  const int64_t r1 = min64(n, r0 + rows_per_seg);
  float* part = partial + (int64_t)blockIdx.y * K * p_total;
  if ((int)blockIdx.x < tiles0)
    col_tile<T0, K>(X0, ld0, p0, blockIdx.x, r0, r1, u0, u1, u2, u3, su,
                    part, p_total, 0);
  else
    col_tile<T1, K>(X1, ld1, p1, blockIdx.x - tiles0, r0, r1, u0, u1, u2,
                    u3, su, part, p_total, p0);
}

// Second pass: out[j] = sum over segments s, in order, of partial[s, j]
// for j < width (width = K * p_total).
__global__ void __launch_bounds__(kThreads) reduce_segments_kernel(
    const float* __restrict__ partial, int n_seg, int64_t width,
    float* __restrict__ out) {
  for (int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x; j < width;
       j += (int64_t)gridDim.x * kThreads) {
    float s = 0.f;
    for (int g = 0; g < n_seg; ++g) s += partial[(int64_t)g * width + j];
    out[j] = s;
  }
}

inline int tiles_of(int p, int vec) {
  const int w = kThreads * vec;
  return (p + w - 1) / w;
}

template <typename T> constexpr int vec_of() { return Vec<T>::N; }

// Launch the column pass and its reduction for blocks (X0: T0, X1: T1).
template <typename T0, typename T1, int K>
void launch_colpass(const void* X0, int64_t ld0, int p0, const void* X1,
                    int64_t ld1, int p1, int64_t n, int n_seg,
                    int64_t rows_per_seg, const float* u0, const float* u1,
                    const float* u2, const float* u3, float* partial,
                    float* out, cudaStream_t stream) {
  const int tiles0 = tiles_of(p0, vec_of<T0>());
  const int tiles1 = p1 > 0 ? tiles_of(p1, vec_of<T1>()) : 0;
  dim3 grid(tiles0 + tiles1, n_seg);
  colpass_kernel<T0, T1, K><<<grid, kThreads, 0, stream>>>(
      static_cast<const T0*>(X0), ld0, p0, tiles0,
      static_cast<const T1*>(X1), ld1, p1, n, rows_per_seg, u0, u1, u2, u3,
      partial);
  const int64_t width = (int64_t)K * ((int64_t)p0 + p1);
  const int rgrid = (int)min64((width + kThreads - 1) / kThreads, 4096);
  reduce_segments_kernel<<<rgrid, kThreads, 0, stream>>>(partial, n_seg,
                                                         width, out);
}

// BB_DISPATCH(dt, T, stmt): run `stmt` with T bound to the storage type
// named by the DType code `dt`; an unknown code returns an error.
#define BB_DISPATCH(dt, T, ...)                       \
  switch (dt) {                                       \
    case ::bbsweep::DT_F32: { using T = float; __VA_ARGS__; }      \
    case ::bbsweep::DT_BF16: { using T = uint16_t; __VA_ARGS__; }  \
    case ::bbsweep::DT_I8: { using T = int8_t; __VA_ARGS__; }      \
    default: return cudaErrorInvalidValue;            \
  }

}  // namespace
}  // namespace bbsweep
