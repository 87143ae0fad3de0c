// Fused normal-equations / GLM-link sweep over one or two row-aligned
// design blocks (int8, bf16 or f32 storage, f32 accumulation):
//
//   t     = sum_b X_b v_b + c                       (phase A, row pass)
//   u     = mid(t; a, b)       ne:     u = b * t
//                              logit:  u = a - b * sigmoid(t)
//                              linear: u = b * (a - t)
//   logp  = sum_i logit:  a t - b softplus(t)       (optional)
//                 linear: -b (a - t)^2 / 2
//   out_b = X_b' u                                  (phase B, column pass)
//
// Replaces the TPU kernel bayesbridge_tpu/design/fusedne.py:_ne_kernel
// (launched by _run), which kept one row panel in VMEM and ran both phases on
// it, accumulating out_b across a sequential grid.
//
// What bounds it on the H100: bytes. Each element is read at its stored
// width (1 B int8, 2 B bf16, 4 B f32) and costs two FMAs per pass, far
// below the card's FLOP/byte balance, so the time floor is the stored
// bytes over 3.35 TB/s. Hopper blocks run unordered, so nothing carries
// across the grid the way the TPU's VMEM accumulator did. This first
// design therefore reads X twice: phase A is a row-owning GEMV (each warp
// owns 4 rows, so one read of v serves four rows) whose epilogue applies
// the row map, masks rows >= n by never touching them, and writes u and
// per-block logp partials; phase B is the column pass of sweep_common.cuh
// over u, with per-segment partials and an ordered second pass. Reading
// X once (row panels kept in shared memory or L2 between the phases) is
// later performance work.

#include "sweep_common.cuh"

namespace bbsweep {
namespace {

enum Mid { MID_NE = 0, MID_LOGIT = 1, MID_LINEAR = 2 };

constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = (kThreads / 32) * kRowsPerWarp;

// acc[r] += X[row0 + r, :p] . v[:p] for r < nvalid, this lane's share.
template <typename T>
__device__ __forceinline__ void rows_dot(const T* __restrict__ X,
                                         int64_t ld, int p,
                                         const float* __restrict__ v,
                                         int64_t row0, int nvalid,
                                         float (&acc)[kRowsPerWarp],
                                         int lane) {
  constexpr int N = Vec<T>::N;
  const T* base = X + row0 * ld;
  for (int k = lane * N; k < p; k += 32 * N) {
    float vv[N];
#pragma unroll
    for (int e = 0; e < N; e += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(v + k + e));
      vv[e] = q.x; vv[e + 1] = q.y; vv[e + 2] = q.z; vv[e + 3] = q.w;
    }
    uint4 q[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
      q[r] = r < nvalid ? load16(base + r * ld + k) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      if (r < nvalid) {
        float xs[N];
        Vec<T>::cvt(q[r], xs);
        if (k + N > p) {  // ragged lane tail: select, so padding bits vanish
#pragma unroll
          for (int e = 0; e < N; ++e) if (k + e >= p) xs[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < N; ++e) acc[r] = fmaf(xs[e], vv[e], acc[r]);
      }
    }
  }
}

template <typename T0, typename T1>
__global__ void __launch_bounds__(kThreads) ne_rows_kernel(
    const T0* __restrict__ X0, int64_t ld0, int p0,
    const float* __restrict__ v0, const T1* __restrict__ X1, int64_t ld1,
    int p1, const float* __restrict__ v1, int64_t n,
    const float* __restrict__ c, int c_stride, const float* __restrict__ a,
    const float* __restrict__ b, int mid, int with_logp,
    float* __restrict__ u, float* __restrict__ lp_partial) {
  __shared__ float warp_lp[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t row0 =
      (int64_t)blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp;
  const int nvalid = (int)min64(kRowsPerWarp, n - row0 > 0 ? n - row0 : 0);
  float acc[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) acc[r] = 0.f;
  if (nvalid > 0) {
    rows_dot<T0>(X0, ld0, p0, v0, row0, nvalid, acc, lane);
    if (p1 > 0) rows_dot<T1>(X1, ld1, p1, v1, row0, nvalid, acc, lane);
  }
  // Butterfly sums: every lane ends with every row's total, same order.
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);

  float lp = 0.f;
  if (lane < nvalid) {  // lane r finishes row r
    float t = acc[0];
#pragma unroll
    for (int r = 1; r < kRowsPerWarp; ++r) if (lane == r) t = acc[r];
    const int64_t row = row0 + lane;
    t += c[c_stride * row];
    const float bb = b[row];
    float uu;
    if (mid == MID_NE) {
      uu = bb * t;
    } else if (mid == MID_LOGIT) {
      const float aa = a[row];
      uu = aa - bb * (1.f / (1.f + expf(-t)));
      // y t - n log(1 + e^t), the softplus written stably.
      if (with_logp)
        lp = aa * t - bb * (fmaxf(t, 0.f) + log1pf(expf(-fabsf(t))));
    } else {
      const float resid = a[row] - t;
      uu = bb * resid;
      if (with_logp) lp = -0.5f * bb * resid * resid;
    }
    u[row] = uu;
  }
  if (with_logp) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      lp += __shfl_xor_sync(0xffffffffu, lp, off);
    if (lane == 0) warp_lp[warp] = lp;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) s += warp_lp[w];
      lp_partial[blockIdx.x] = s;
    }
  }
}

// logp = sum of the per-block partials, in a fixed order (one block).
__global__ void __launch_bounds__(kThreads) sum_partials_kernel(
    const float* __restrict__ part, int count, float* __restrict__ out) {
  __shared__ float sm[kThreads];
  float s = 0.f;
  for (int i = threadIdx.x; i < count; i += kThreads) s += part[i];
  sm[threadIdx.x] = s;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if ((int)threadIdx.x < w) sm[threadIdx.x] += sm[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = sm[0];
}

template <typename T0, typename T1>
cudaError_t ne_sweep_impl(const void* X0, int64_t ld0, int p0,
                          const float* v0, const void* X1, int64_t ld1,
                          int p1, const float* v1, int64_t n,
                          const float* c, int c_stride, const float* a,
                          const float* b, int mid, int with_logp, float* u,
                          int n_seg, int64_t rows_per_seg, float* partial,
                          float* out, float* lp_partial, float* lp,
                          cudaStream_t stream) {
  const int grid_a = (int)((n + kRowsPerBlock - 1) / kRowsPerBlock);
  ne_rows_kernel<T0, T1><<<grid_a, kThreads, 0, stream>>>(
      static_cast<const T0*>(X0), ld0, p0, v0, static_cast<const T1*>(X1),
      ld1, p1, v1, n, c, c_stride, a, b, mid, with_logp, u, lp_partial);
  if (with_logp)
    sum_partials_kernel<<<1, kThreads, 0, stream>>>(lp_partial, grid_a, lp);
  launch_colpass<T0, T1, 1>(X0, ld0, p0, X1, ld1, p1, n, n_seg,
                            rows_per_seg, u, nullptr, nullptr, partial, out,
                            stream);
  return cudaGetLastError();
}

}  // namespace
}  // namespace bbsweep

// C interface (ctypes). dt*: 0 f32, 1 bf16, 2 int8; p1 == 0 means one
// block (X1/v1 unused). c is read as c[c_stride * row] (0: a scalar).
// Scratch sizes: partial n_seg * (p0 + p1) floats, lp_partial
// ceil(n / 32) floats. Returns the CUDA error of the launches (0 = ok).
extern "C" int bb_ne_sweep(int dt0, const void* X0, long long ld0, int p0,
                           const float* v0, int dt1, const void* X1,
                           long long ld1, int p1, const float* v1,
                           long long n, const float* c, int c_stride,
                           const float* a, const float* b, int mid,
                           int with_logp, float* u, int n_seg,
                           long long rows_per_seg, float* partial,
                           float* out, float* lp_partial, float* lp,
                           void* stream) {
  using namespace bbsweep;
  auto s = static_cast<cudaStream_t>(stream);
  BB_DISPATCH(dt0, T0, BB_DISPATCH(dt1, T1,
      return (int)ne_sweep_impl<T0, T1>(
          X0, ld0, p0, v0, X1, ld1, p1, v1, n, c, c_stride, a, b, mid,
          with_logp, u, n_seg, rows_per_seg, partial, out, lp_partial, lp,
          s)));
}

extern "C" int bb_rows_per_block() { return bbsweep::kRowsPerBlock; }

extern "C" const char* bb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
