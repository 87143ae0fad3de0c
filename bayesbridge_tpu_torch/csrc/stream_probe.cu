// Streaming probe: what caps a pass over a stored block on this card.
// For X (n, p) it returns the scalar
//
//   sum over rows i of ( sum_j g(X_ij) + 128 * seed )
//
// with g by kind:
//   i32 : X is int32; each row sums into a wrapping int32 (the seed
//         truncated to int32 first), then widens to f32   (the stream)
//   cvt : X is int8, up-converted to f32 and summed        (+ convert)
//   mul : X is int8, up-converted and multiplied by v      (+ multiply)
//
// Replaces the TPU kernel of baselines/dev_ne_variants.py:make_probe, which
// ran the same reductions through the fused sweep's BlockSpec pipeline:
// per row panel an (r, 128) accumulator initialised to the seed, so each
// row carries 128 seeds. `seed` is read from device memory, so a chain of
// calls whose seeds come from the previous results forms a real
// dependency.
//
// What bounds it on the H100: bytes (one read of X, a few operations per
// element). A warp owns a row and streams it in 16-byte vectors, four in
// flight per lane; the row total is a butterfly sum, written per row, and
// one block sums the rows in a fixed order. No atomics.

#include "sweep_common.cuh"

namespace bbprobe {
namespace {

using bbsweep::kThreads;
using bbsweep::load16;

enum Kind { K_I32 = 0, K_CVT = 1, K_MUL = 2 };

template <int KIND>
__global__ void __launch_bounds__(kThreads) probe_rows_kernel(
    const uint8_t* __restrict__ X, int64_t row_bytes, int64_t n,
    const float* __restrict__ v, const float* __restrict__ seed,
    float* __restrict__ rows) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (kThreads / 32);
  const int64_t units = row_bytes / 16;
  const float sd = *seed;
  for (int64_t row = (int64_t)blockIdx.x * (kThreads / 32) +
                     (threadIdx.x >> 5);
       row < n; row += warps) {
    const uint8_t* xr = X + row * row_bytes;
    uint32_t iacc = 0;
    float facc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int64_t k0 = lane; k0 < units; k0 += 4 * 32) {
      uint4 q[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t k = k0 + 32 * j;
        q[j] = k < units ? load16(xr + 16 * k) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t k = k0 + 32 * j;
        if (k >= units) continue;
        if constexpr (KIND == K_I32) {
          iacc += q[j].x + q[j].y + q[j].z + q[j].w;
        } else {
          float x[16];
          bbsweep::Vec<int8_t>::cvt(q[j], x);
          if constexpr (KIND == K_MUL) {
            const float4* vp = reinterpret_cast<const float4*>(v + 16 * k);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float4 f = __ldg(vp + e);
              facc[0] = fmaf(x[4 * e], f.x, facc[0]);
              facc[1] = fmaf(x[4 * e + 1], f.y, facc[1]);
              facc[2] = fmaf(x[4 * e + 2], f.z, facc[2]);
              facc[3] = fmaf(x[4 * e + 3], f.w, facc[3]);
            }
          } else {
#pragma unroll
            for (int e = 0; e < 16; ++e) facc[e & 3] += x[e];
          }
        }
      }
    }
    if constexpr (KIND == K_I32) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        iacc += __shfl_xor_sync(0xffffffffu, iacc, off);
      if (lane == 0) {
        // Wrapping int32 arithmetic, done on the unsigned bits.
        const uint32_t s32 = (uint32_t)(int32_t)sd;
        rows[row] = (float)(int32_t)(iacc + 128u * s32);
      }
    } else {
      float f = (facc[0] + facc[1]) + (facc[2] + facc[3]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        f += __shfl_xor_sync(0xffffffffu, f, off);
      if (lane == 0) rows[row] = f + 128.f * sd;
    }
  }
}

// out[0] = sum of rows[0..n), in a fixed order (one block).
__global__ void __launch_bounds__(kThreads) sum_rows_kernel(
    const float* __restrict__ rows, int64_t n, float* __restrict__ out) {
  __shared__ float sm[kThreads];
  float s = 0.f;
  for (int64_t i = threadIdx.x; i < n; i += kThreads) s += rows[i];
  sm[threadIdx.x] = s;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if ((int)threadIdx.x < w) sm[threadIdx.x] += sm[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = sm[0];
}

}  // namespace
}  // namespace bbprobe

// C interface (ctypes). kind 0 i32, 1 cvt, 2 mul. X: n rows of row_bytes
// bytes (a multiple of 16), 16-byte aligned; v: row_bytes floats (mul
// only); seed: one float on the device; rows: n floats of scratch; out:
// one float. grid: blocks of the row pass. Returns the CUDA error (0 = ok).
extern "C" int bb_stream_probe(const void* X, long long row_bytes,
                               long long n, int kind, const float* v,
                               const float* seed, float* rows, float* out,
                               int grid, void* stream) {
  using namespace bbprobe;
  auto s = static_cast<cudaStream_t>(stream);
  auto Xb = static_cast<const uint8_t*>(X);
  switch (kind) {
    case K_I32:
      probe_rows_kernel<K_I32><<<grid, kThreads, 0, s>>>(Xb, row_bytes, n, v,
                                                         seed, rows);
      break;
    case K_CVT:
      probe_rows_kernel<K_CVT><<<grid, kThreads, 0, s>>>(Xb, row_bytes, n, v,
                                                         seed, rows);
      break;
    case K_MUL:
      probe_rows_kernel<K_MUL><<<grid, kThreads, 0, s>>>(Xb, row_bytes, n, v,
                                                         seed, rows);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_rows_kernel<<<1, kThreads, 0, s>>>(rows, n, out);
  return (int)cudaGetLastError();
}
