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
// The two passes are also entries of their own, the hybrid design's
// composed products: bb_ne_rows returns t (the row pass with the
// identity map, X v + c), bb_colpass returns X_b' u (the column pass).
// Their chain-batched forms bb_ne_rows_k and bb_colpass_k serve several
// Markov chains from one read of X: T = X V + c and X' U for up to 8
// chains' vectors, each chain's result equal to its single-vector launch
// bit for bit (the same per-row and per-column arithmetic in the same
// order). They replace what the JAX package gets from jax.vmap over its
// chains (the batched XLA dots of bayesbridge_tpu/multichain.py), and
// are bound by bytes like the single pass until the FMAs per element
// (C chains: C per element, plus one conversion) reach the card's
// arithmetic rate; the row pass keeps C chains' slices of v in
// registers (kRowVecBudget floats), the column pass C chains'
// accumulators (sweep_common.cuh, ColPlan).
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
    const float aa = mid == MID_LOGIT || mid == MID_LINEAR ? a[row] : 0.f;
    const float bb = mid == MID_ROWS ? 0.f : b[row];
    u[row] = row_map(mid, t, aa, bb, with_logp, lp);
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

// ---- The chain-batched row pass: T = X V + c for nc chains ----

constexpr int kRowVecBudget = 64;  // floats of v in registers per thread
// Rows per warp of the batched row pass (the per-row sums do not depend
// on it: a row's lane partials and butterfly are those of rows_dot).
constexpr int kRowsPerWarpK = 4;
constexpr int kRowsPerBlockK = (kThreads / 32) * kRowsPerWarpK;

template <typename T> struct RowPlan {
  static constexpr int chains = floor_pow2(kRowVecBudget / Vec<T>::N);
};

// rows_dot for C chains: chain c's v at V + c * ld; acc[r][c] takes the
// fmaf sequence of rows_dot's acc[r] for that chain.
template <typename T, int C>
__device__ __forceinline__ void rows_dot_k(const T* __restrict__ X,
                                           int64_t ld, int p,
                                           const float* __restrict__ V,
                                           int nc, int64_t row0, int nvalid,
                                           float (&acc)[kRowsPerWarpK][C],
                                           int lane) {
  constexpr int N = Vec<T>::N;
  const T* base = X + row0 * ld;
  for (int k = lane * N; k < p; k += 32 * N) {
    float vv[C][N];
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int e = 0; e < N; e += 4) {
        const float4 q = c < nc ? __ldg(reinterpret_cast<const float4*>(
                                      V + c * ld + k + e))
                                : make_float4(0.f, 0.f, 0.f, 0.f);
        vv[c][e] = q.x; vv[c][e + 1] = q.y;
        vv[c][e + 2] = q.z; vv[c][e + 3] = q.w;
      }
    uint4 q[kRowsPerWarpK];
#pragma unroll
    for (int r = 0; r < kRowsPerWarpK; ++r)
      q[r] = r < nvalid ? load16(base + r * ld + k) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int r = 0; r < kRowsPerWarpK; ++r) {
      if (r < nvalid) {
        float xs[N];
        Vec<T>::cvt(q[r], xs);
        if (k + N > p) {  // ragged lane tail: select, so padding bits vanish
#pragma unroll
          for (int e = 0; e < N; ++e) if (k + e >= p) xs[e] = 0.f;
        }
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
          for (int e = 0; e < N; ++e)
            acc[r][c] = fmaf(xs[e], vv[c][e], acc[r][c]);
      }
    }
  }
}

// Row pass for nc <= C chains over a T0 block and an optional f32 block:
// t[c * n + row] = X0 V0_c + X1 V1_c + cc[c * c_chain + c_stride * row].
template <typename T0, int C>
__global__ void __launch_bounds__(kThreads) ne_rows_k_kernel(
    const T0* __restrict__ X0, int64_t ld0, int p0,
    const float* __restrict__ V0, const float* __restrict__ X1, int64_t ld1,
    int p1, const float* __restrict__ V1, int64_t n, int nc,
    const float* __restrict__ cc, int64_t c_chain, int c_stride,
    float* __restrict__ t) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t row0 =
      (int64_t)blockIdx.x * kRowsPerBlockK + warp * kRowsPerWarpK;
  const int nvalid = (int)min64(kRowsPerWarpK, n - row0 > 0 ? n - row0 : 0);
  float acc[kRowsPerWarpK][C];
#pragma unroll
  for (int r = 0; r < kRowsPerWarpK; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
  if (nvalid > 0) {
    rows_dot_k<T0, C>(X0, ld0, p0, V0, nc, row0, nvalid, acc, lane);
    if (p1 > 0) rows_dot_k<float, C>(X1, ld1, p1, V1, nc, row0, nvalid, acc,
                                     lane);
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarpK; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], off);
  if (lane < nvalid) {  // lane r finishes row r
    const int64_t row = row0 + lane;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (c >= nc) break;
      float v = acc[0][c];
#pragma unroll
      for (int r = 1; r < kRowsPerWarpK; ++r) if (lane == r) v = acc[r][c];
      v += cc[c * c_chain + c_stride * row];
      t[c * n + row] = v;
    }
  }
}

template <typename T0>
cudaError_t ne_rows_k(const void* X0, int64_t ld0, int p0, const float* V0,
                      const float* X1, int64_t ld1, int p1, const float* V1,
                      int64_t n, int nc, const float* cc, int64_t c_chain,
                      int c_stride, float* t, cudaStream_t stream) {
  constexpr int cmax = RowPlan<T0>::chains;
  static_assert(RowPlan<float>::chains >= cmax, "f32 block plan");
  if (nc < 1 || nc > cmax) return cudaErrorInvalidValue;
  const int grid = (int)((n + kRowsPerBlockK - 1) / kRowsPerBlockK);
#define BB_ROWS_K(C)                                                       \
  ne_rows_k_kernel<T0, C><<<grid, kThreads, 0, stream>>>(                 \
      static_cast<const T0*>(X0), ld0, p0, V0, X1, ld1, p1, V1, n, nc, cc, \
      c_chain, c_stride, t)
  if (nc == 1) {
    BB_ROWS_K(1);
  } else if (nc == 2) {
    BB_ROWS_K(2);
  } else if (nc <= 4) {
    if constexpr (cmax >= 4) BB_ROWS_K(4);
  } else {
    if constexpr (cmax >= 8) BB_ROWS_K(8);
  }
#undef BB_ROWS_K
  return cudaGetLastError();
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
                            rows_per_seg, u, nullptr, nullptr, nullptr,
                            partial, out, stream);
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

// The row pass alone: t = X0 v0 (+ X1 v1) + c, written to t (n floats).
extern "C" int bb_ne_rows(int dt0, const void* X0, long long ld0, int p0,
                          const float* v0, int dt1, const void* X1,
                          long long ld1, int p1, const float* v1,
                          long long n, const float* c, int c_stride,
                          float* t, void* stream) {
  using namespace bbsweep;
  auto s = static_cast<cudaStream_t>(stream);
  const int grid_a = (int)((n + kRowsPerBlock - 1) / kRowsPerBlock);
  BB_DISPATCH(dt0, T0, BB_DISPATCH(dt1, T1,
      ne_rows_kernel<T0, T1><<<grid_a, kThreads, 0, s>>>(
          static_cast<const T0*>(X0), ld0, p0, v0,
          static_cast<const T1*>(X1), ld1, p1, v1, n, c, c_stride, nullptr,
          nullptr, MID_ROWS, 0, t, nullptr);
      return (int)cudaGetLastError()));
}

// The column pass alone: out = [X0' u ; X1' u] ((p0 + p1) floats), with
// partial n_seg * (p0 + p1) floats of scratch.
extern "C" int bb_colpass(int dt0, const void* X0, long long ld0, int p0,
                          int dt1, const void* X1, long long ld1, int p1,
                          long long n, const float* u, int n_seg,
                          long long rows_per_seg, float* partial, float* out,
                          void* stream) {
  using namespace bbsweep;
  auto s = static_cast<cudaStream_t>(stream);
  BB_DISPATCH(dt0, T0, BB_DISPATCH(dt1, T1,
      launch_colpass<T0, T1, 1>(X0, ld0, p0, X1, ld1, p1, n, n_seg,
                                rows_per_seg, u, nullptr, nullptr, nullptr,
                                partial, out, s);
      return (int)cudaGetLastError()));
}

// The chain-batched row pass: t (nc, n) floats, t[c] = X0 V0[c] (+ X1
// V1[c]) + c-offset, with V0 (nc, ld0) and V1 (nc, ld1) zero-padded
// rows. X1 is f32 (or p1 == 0). The offset of chain c, row i is
// cc[c * c_chain + c_stride * i] (a scalar per chain: c_chain 1,
// c_stride 0). nc at most bb_max_chains(0, dt0).
extern "C" int bb_ne_rows_k(int dt0, const void* X0, long long ld0, int p0,
                            const float* V0, const float* X1, long long ld1,
                            int p1, const float* V1, long long n, int nc,
                            const float* cc, long long c_chain,
                            int c_stride, float* t, void* stream) {
  using namespace bbsweep;
  auto s = static_cast<cudaStream_t>(stream);
  BB_DISPATCH(dt0, T0,
      return (int)ne_rows_k<T0>(X0, ld0, p0, V0, X1, ld1, p1, V1, n, nc, cc,
                                c_chain, c_stride, t, s));
}

// The chain-batched column pass: out (nc, p0 + p1) floats, out[c] = [X0'
// u[c] ; X1' u[c]] with u (nc, n); partial n_seg * nc * (p0 + p1) floats
// of scratch; the segments those of the single-vector launch. X1 is f32
// (or p1 == 0). nc at most bb_max_chains(1, dt0).
extern "C" int bb_colpass_k(int dt0, const void* X0, long long ld0, int p0,
                            const float* X1, long long ld1, int p1,
                            long long n, int nc, const float* u, int n_seg,
                            long long rows_per_seg, float* partial,
                            float* out, void* stream) {
  using namespace bbsweep;
  auto s = static_cast<cudaStream_t>(stream);
  BB_DISPATCH(dt0, T0,
      return (int)colpass_k<T0, 1>(X0, ld0, p0, X1, ld1, p1, n, nc, n_seg,
                                   rows_per_seg, u, nullptr, nullptr,
                                   nullptr, partial, out, s));
}

// Chains one launch of a batched kernel serves for an exact block of
// DType dt0 (beside an f32 block): kind 0 the row pass, 1 the column
// pass, 4 or 5 the pre-solve reductions (tdots_sweep.cu).
extern "C" int bb_max_chains(int kind, int dt0) {
  using namespace bbsweep;
  switch (kind) {
    case 0: BB_DISPATCH(dt0, T, return RowPlan<T>::chains);
    case 1: BB_DISPATCH(dt0, T, return ColPlan<T, 1>::chains);
    case 4: BB_DISPATCH(dt0, T, return ColPlan<T, 4>::chains);
    case 5: BB_DISPATCH(dt0, T, return ColPlan<T, 5>::chains);
    default: return 0;
  }
}

extern "C" int bb_rows_per_block() { return bbsweep::kRowsPerBlock; }

extern "C" const char* bb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
