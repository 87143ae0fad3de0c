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

// The col-ELL (X' u, 262,144 observations against 16,384 predictors) is
// where that last choice fails: u is 2 MB in float64, lives only in L2,
// and each column's row indices lie about 93 apart, so every gather moves
// its own 32-byte sector to use 8 bytes of it (42% of the bound). So a
// sorted col-ELL takes a second traversal, ell_win_kernel below: each
// CTA owns a contiguous range of ELL rows, one warp per row as before,
// and walks the input axis in windows of W inputs that a producer warp
// stages in shared memory with bulk copies (double-buffered, mbarriers);
// the gathers then read shared memory, and each CTA reads u once from L2
// in whole lines. A lane still adds slots l, l + 32, ... in order, each
// with one FMA, and the same xor-shuffle tree joins the lanes, so its
// results are the first traversal's bits: a window holds the slots of
// each row whose indices lie in it (precomputed per-(row, window) slot
// pointers; indices ascend within a row), and skipping a row's trailing
// (0, 0.0) padding adds nothing (fma(0, x, acc) == acc for finite x).
//
#include <cuda_runtime.h>
#include <stdint.h>

#include "mbarrier.cuh"

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


// ---- The windowed traversal of a sorted col-ELL ----------------------------
//
// Layout (built once per design on the host, kernels/ell.py EllLayout):
// wptr (m, ld_ptr) int32 at a grain of G = W / stride inputs, wptr[r, g] =
// the first slot of row r whose index is >= g * G (ascending indices),
// wptr[r, ld_ptr - 1] = the row's valid slots (one plus the last slot
// whose index or value is non-zero). A window of W = stride * G inputs
// spans slots [wptr[r, w * stride], wptr[r, (w + 1) * stride]) of row r. xt holds n_win * W rows of k values
// (the wrapper pads it), so every window is one bulk copy of W * k *
// sizeof(T) bytes, a multiple of 16.

constexpr int kWinWarps = 16;    // consumer warps a CTA, one producer warp
constexpr int kWinThreads = (kWinWarps + 1) * 32;
constexpr int kStages = 2;       // windows of u staged at once
constexpr int kMaxSmem = 232448; // dynamic shared memory a CTA may take
// By vectors k = 1..8: the ELL rows a consumer warp owns (their k sums
// stay in registers across the windows) and the 32-slot groups of each
// row it loads at once, float64 and float32; from the timings in turns of
// baselines/ell_variants.py. A CTA of 17 warps gets 96 registers a
// thread; more rows or groups spilled (float64 k = 2 at 6 rows, k = 8 at
// 4), and the copies issued by a lane of a consumer warp instead (16
// warps, 128 registers) ran slower.
constexpr int kRowsF64[kMaxVectors + 1] = {0, 8, 4, 4, 4, 3, 3, 3, 2};
constexpr int kUnrollF64[kMaxVectors + 1] = {0, 4, 4, 2, 2, 2, 2, 2, 2};
constexpr int kRowsF32[kMaxVectors + 1] = {0, 8, 8, 4, 4, 4, 4, 4, 4};
constexpr int kUnrollF32[kMaxVectors + 1] = {0, 2, 2, 2, 4, 2, 2, 2, 2};

template <typename T, int K>
__host__ __device__ constexpr int win_rows() {
  return sizeof(T) == 8 ? kRowsF64[K] : kRowsF32[K];
}

template <typename T, int K>
__host__ __device__ constexpr int win_unroll() {
  return sizeof(T) == 8 ? kUnrollF64[K] : kUnrollF32[K];
}

// x[0..K) = p[0..K) from shared memory, in 16- or 8-byte loads where K
// allows (p is aligned to K * sizeof(T)).
template <int K>
__device__ __forceinline__ void load_ks(const float* p, float (&x)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int i = 0; i < K / 4; ++i) {
      const float4 q = reinterpret_cast<const float4*>(p)[i];
      x[4 * i] = q.x;
      x[4 * i + 1] = q.y;
      x[4 * i + 2] = q.z;
      x[4 * i + 3] = q.w;
    }
  } else if constexpr (K % 2 == 0) {
#pragma unroll
    for (int i = 0; i < K / 2; ++i) {
      const float2 q = reinterpret_cast<const float2*>(p)[i];
      x[2 * i] = q.x;
      x[2 * i + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) x[i] = p[i];
  }
}

template <int K>
__device__ __forceinline__ void load_ks(const double* p, double (&x)[K]) {
  if constexpr (K % 2 == 0) {
#pragma unroll
    for (int i = 0; i < K / 2; ++i) {
      const double2 q = reinterpret_cast<const double2*>(p)[i];
      x[2 * i] = q.x;
      x[2 * i + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) x[i] = p[i];
  }
}

// Grid: one CTA per rows_cta ELL rows; block: kWinWarps consumer warps and
// one producer warp. Consumer warp v owns rows r0 + v + j * kWinWarps, j <
// win_rows. For each window, it loads win_unroll aligned 32-slot groups of
// each of its rows at once (lane l holds slot 32 t + l of group t, kept
// when it lies in the row's slots of the window), then adds them in
// order.
template <typename T, int K, int kPower>
__global__ void __launch_bounds__(kWinThreads, 1) ell_win_kernel(
    const int32_t* __restrict__ idx, const T* __restrict__ val, int64_t m,
    int width, const int32_t* __restrict__ wptr, int ld_ptr, int stride,
    const T* __restrict__ xt, int W, int n_win, int rows_cta,
    T* __restrict__ out) {
  using namespace bbasync;
  constexpr int R = win_rows<T, K>();
  constexpr int kUnroll = win_unroll<T, K>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* buf = reinterpret_cast<T*>(smem_raw);
  __shared__ uint64_t full[kStages], empty[kStages];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t r0 = (int64_t)blockIdx.x * rows_cta;
  const int64_t r1 = min(m, r0 + rows_cta);
  const int64_t win_elems = (int64_t)W * K;

  if (warp == kWinWarps) {  // the producer warp
    if (lane == 0) {
      for (int i = 0; i < kStages; ++i) {
        bar_init(&full[i], 1);
        bar_init(&empty[i], kWinWarps);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (lane != 0) return;
    const uint32_t bytes = (uint32_t)(win_elems * sizeof(T));
    for (int w = 0; w < n_win; ++w) {  // once window w - kStages is done
      const int st = w % kStages;
      if (w >= kStages)
        bar_wait<false>(&empty[st], (uint32_t)((w / kStages - 1) & 1));
      bar_expect(&full[st], bytes);
      bulk_copy(buf + st * win_elems, xt + w * win_elems, bytes, &full[st]);
    }
    return;
  }
  __syncthreads();  // the barriers are initialised

  int a[R], b[R];
  T acc[R][K];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    a[j] = b[j] = 0;
#pragma unroll
    for (int c = 0; c < K; ++c) acc[j][c] = T(0);
  }
  const int last = ld_ptr - 1;
  for (int w = 0; w < n_win; ++w) {
    const int st = w % kStages;
    const int pe = min((w + 1) * stride, last);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int64_t row = r0 + warp + j * kWinWarps;
      b[j] = row < r1 ? __ldg(wptr + row * ld_ptr + pe) : 0;
    }
    bar_wait<false>(&full[st], (uint32_t)((w / kStages) & 1));
    const T* us = buf + st * win_elems;
    const int base = w * W;
    int g[R];
#pragma unroll
    for (int j = 0; j < R; ++j) g[j] = a[j] & ~31;
    for (;;) {
      bool more = false;
#pragma unroll
      for (int j = 0; j < R; ++j) more |= g[j] < b[j];
      if (!more) break;  // warp-uniform: a, b, g are the same in every lane
      int32_t ii[R][kUnroll];
      T vv[R][kUnroll];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int64_t off = (r0 + warp + j * kWinWarps) * width;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int s = g[j] + 32 * u + lane;
          const bool in = s >= a[j] && s < b[j];
          ii[j][u] = in ? __ldg(idx + off + s) : base;
          vv[j][u] = in ? __ldg(val + off + s) : T(0);
        }
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int s = g[j] + 32 * u + lane;
          if (s >= a[j] && s < b[j]) {
            T xj[K];
            load_ks<K>(us + (int64_t)(ii[j][u] - base) * K, xj);
            T av = vv[j][u];
            if (kPower == 2) av = av * av;
#pragma unroll
            for (int c = 0; c < K; ++c) acc[j][c] = fma_t<T>(av, xj[c], acc[j][c]);
          }
        }
        g[j] += 32 * kUnroll;
      }
    }
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[st]);
#pragma unroll
    for (int j = 0; j < R; ++j) a[j] = b[j];
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int64_t row = r0 + warp + j * kWinWarps;
    if (row >= r1) continue;  // warp-uniform
#pragma unroll
    for (int c = 0; c < K; ++c) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[j][c] += __shfl_xor_sync(0xffffffffu, acc[j][c], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < K; ++c) out[c * m + row] = acc[j][c];
    }
  }
}

template <typename T, int K, int kPower>
cudaError_t launch_win_p(const int32_t* idx, const T* val, int64_t m,
                         int width, const int32_t* wptr, int ld_ptr,
                         int stride, const T* xt, int W, int n_win,
                         int rows_cta, T* out, cudaStream_t s) {
  const int64_t grid = (m + rows_cta - 1) / rows_cta;
  const size_t smem = (size_t)kStages * W * K * sizeof(T);
  if (grid > 0x7fffffff || smem > (size_t)kMaxSmem)
    return cudaErrorInvalidConfiguration;
  auto kern = ell_win_kernel<T, K, kPower>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<(unsigned)grid, kWinThreads, smem, s>>>(
      idx, val, m, width, wptr, ld_ptr, stride, xt, W, n_win, rows_cta, out);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t launch_win_k(const int32_t* idx, const T* val, int64_t m,
                         int width, const int32_t* wptr, int ld_ptr,
                         int stride, const T* xt, int power, int W,
                         int n_win, int rows_cta, T* out, cudaStream_t s) {
  if (rows_cta > kWinWarps * win_rows<T, K>())
    return cudaErrorInvalidValue;
  if (power == 2)
    return launch_win_p<T, K, 2>(idx, val, m, width, wptr, ld_ptr, stride,
                                 xt, W, n_win, rows_cta, out, s);
  return launch_win_p<T, K, 1>(idx, val, m, width, wptr, ld_ptr, stride, xt,
                               W, n_win, rows_cta, out, s);
}

template <typename T>
cudaError_t launch_win(const int32_t* idx, const T* val, int64_t m,
                       int width, const int32_t* wptr, int ld_ptr,
                       int stride, const T* xt, int k, int power, int W,
                       int n_win, int rows_cta, T* out, cudaStream_t s) {
#define BB_WIN_K(KK)                                                       \
  case KK:                                                                 \
    return launch_win_k<T, KK>(idx, val, m, width, wptr, ld_ptr, stride,  \
                               xt, power, W, n_win, rows_cta, out, s);
  switch (k) {
    BB_WIN_K(1) BB_WIN_K(2) BB_WIN_K(3) BB_WIN_K(4)
    BB_WIN_K(5) BB_WIN_K(6) BB_WIN_K(7) BB_WIN_K(8)
    default: return cudaErrorInvalidValue;
  }
#undef BB_WIN_K
}

// ---- The staged traversal of a row-ELL at several vectors ------------------
//
// A row-ELL's rows each span the whole input axis, so once the k vectors
// outgrow an SM's L1 (k >= 2 in float64, k >= 4 in float32 at the ell
// slice's 16,384 inputs) nearly every gather of the first traversal goes
// to L2 and moves a 32-byte sector: it runs at L2's sector rate, 22-48%
// of its bound. Here each CTA holds a prefix of the interleaved vectors
// in its shared memory for the whole launch (as many inputs as its
// stage takes, n_staged, copied once by bulk copies on an mbarrier), and
// a slot whose index lies in it gathers from shared memory; the rest go
// through L2 as in the first traversal, so L2 serves the staged share
// fewer sectors. The CTAs are persistent (one or two an SM): CTA b owns
// ELL rows [b rows_cta, (b + 1) rows_cta), one warp a row, and a warp
// keeps the idx / val of its next kStAhead groups of kStUnroll 32-slot
// runs (its row's or its next rows') in flight while it gathers and adds
// the current one, so the stream from device memory stays busy. Lane l adds
// slots l, l + 32, ... in order with one FMA each, and the lanes meet in
// the same xor tree as ell_kernel: each vector is the first traversal's
// bits (and its single launch's).
//
// (Spreading the whole vectors over the shared memory of a thread-block
// cluster instead, every other CTA's inputs gathered over the SM-to-SM
// network, lost to this traversal on the H100: the network served those
// gathers at a third of L2's rate. That design is kept for the harness in
// baselines/ell_cluster.cu.)

constexpr int kStWarps = 16;
constexpr int kStThreads = kStWarps * 32;
// The stage a CTA takes at most: the dynamic shared memory less room for
// the static (its mbarrier).
constexpr int kStMaxSmem = kMaxSmem - 1024;
constexpr uint32_t kStCopy = 16384;  // bytes a bulk copy of the stage
constexpr int kStAhead = 2;  // groups of idx / val a warp has in flight
// 32-slot runs a warp loads at once, by k = 1..8, float64 and float32
// (6: a row of the ell slice's 164 slots in one group).
constexpr int kStUnrollF64[kMaxVectors + 1] = {0, 6, 6, 4, 6, 2, 2, 2, 2};
constexpr int kStUnrollF32[kMaxVectors + 1] = {0, 6, 6, 6, 6, 4, 4, 4, 6};

template <typename T, int K>
__host__ __device__ constexpr int st_unroll() {
  return sizeof(T) == 8 ? kStUnrollF64[K] : kStUnrollF32[K];
}

// Grid: n_cta CTAs of kStThreads. xt: the interleaved vectors, at least
// n_staged rows (the wrapper pads them to a whole stage); inputs below
// n_staged are gathered from this CTA's copy.
template <typename T, int K, int kPower>
__global__ void __launch_bounds__(kStThreads, 1) ell_st_kernel(
    const int32_t* __restrict__ idx, const T* __restrict__ val, int64_t m,
    int width, const T* __restrict__ xt, int n_staged, int64_t rows_cta,
    T* __restrict__ out) {
  using namespace bbasync;
  constexpr int U = st_unroll<T, K>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const T* xs = reinterpret_cast<const T*>(smem_raw);
  __shared__ uint64_t full;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t bytes = (uint32_t)n_staged * K * sizeof(T);

  if (threadIdx.x == 0) {
    bar_init(&full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 0) {  // the stage, in copies of kStCopy bytes
    if (lane == 0) bar_expect(&full, bytes);
    __syncwarp();
    for (uint32_t off = lane * kStCopy; off < bytes; off += 32 * kStCopy)
      bulk_copy(smem_raw + off, reinterpret_cast<const char*>(xt) + off,
                min(kStCopy, bytes - off), &full);
  }
  bar_wait<false>(&full, 0);

  const int64_t r0 = (int64_t)blockIdx.x * rows_cta;
  const int64_t r1 = min(m, r0 + rows_cta);
  const int groups = (width + 32 * U - 1) / (32 * U);  // per row
  // The warp's groups in order: (row, group) to load next and to add
  // next; kStAhead groups in flight, in a ring of register buffers
  // (static indices: the ring is walked by an unrolled loop).
  int64_t ld_row = r0 + warp, pr_row = ld_row;
  int ld_grp = 0, pr_grp = 0;
  int32_t ii[kStAhead][U];
  T vv[kStAhead][U];
  auto load_group = [&](int32_t (&gi)[U], T (&gv)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = ld_grp * 32 * U + 32 * u + lane;
      const bool in = ld_row < r1 && s < width;
      gi[u] = in ? __ldg(idx + ld_row * width + s) : 0;
      gv[u] = in ? __ldg(val + ld_row * width + s) : T(0);
    }
    if (++ld_grp == groups) {
      ld_grp = 0;
      ld_row += kStWarps;
    }
  };
#pragma unroll
  for (int d = 0; d < kStAhead; ++d) load_group(ii[d], vv[d]);
  T acc[K];
#pragma unroll
  for (int c = 0; c < K; ++c) acc[c] = T(0);
  for (;;) {
#pragma unroll
    for (int d = 0; d < kStAhead; ++d) {
      if (pr_row >= r1) goto done;  // warp-uniform
      T xj[U][K];
#pragma unroll
      for (int u = 0; u < U; ++u)  // the L2 gathers first, then the stage's
        if (ii[d][u] >= n_staged)
          load_k<K>(xt + (int64_t)ii[d][u] * K, xj[u]);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (ii[d][u] < n_staged)
          load_ks<K>(xs + (int64_t)ii[d][u] * K, xj[u]);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (pr_grp * 32 * U + 32 * u + lane < width) {
          T a = vv[d][u];
          if (kPower == 2) a = a * a;
#pragma unroll
          for (int c = 0; c < K; ++c) acc[c] = fma_t<T>(a, xj[u][c], acc[c]);
        }
      }
      load_group(ii[d], vv[d]);  // kStAhead groups on, into this buffer
      if (pr_grp == groups - 1) {  // the row's last group: the lanes meet
#pragma unroll
        for (int c = 0; c < K; ++c) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
        }
        if (lane == 0) {
#pragma unroll
          for (int c = 0; c < K; ++c) out[c * m + pr_row] = acc[c];
        }
#pragma unroll
        for (int c = 0; c < K; ++c) acc[c] = T(0);
        pr_grp = 0;
        pr_row += kStWarps;
      } else {
        ++pr_grp;
      }
    }
  }
done:;
}

template <typename T, int K, int kPower>
cudaError_t st_attr(size_t smem) {
  return cudaFuncSetAttribute(ell_st_kernel<T, K, kPower>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T, int K>
cudaError_t launch_st_k(const int32_t* idx, const T* val, int64_t m,
                        int width, const T* xt, int power, int n_staged,
                        int n_cta, T* out, cudaStream_t s) {
  const size_t smem = (size_t)n_staged * K * sizeof(T);
  if (smem > (size_t)kStMaxSmem || smem % 16 != 0)
    return cudaErrorInvalidConfiguration;
  const int64_t rows_cta = (m + n_cta - 1) / n_cta;
  cudaError_t err = power == 2 ? st_attr<T, K, 2>(smem)
                               : st_attr<T, K, 1>(smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // not left for the next launch's check
    return err;
  }
  if (power == 2)
    ell_st_kernel<T, K, 2><<<n_cta, kStThreads, smem, s>>>(
        idx, val, m, width, xt, n_staged, rows_cta, out);
  else
    ell_st_kernel<T, K, 1><<<n_cta, kStThreads, smem, s>>>(
        idx, val, m, width, xt, n_staged, rows_cta, out);
  return cudaGetLastError();
}

template <typename T, int K>
int fit_st(size_t smem) {
  int fit = 0;
  if (smem > (size_t)kStMaxSmem || st_attr<T, K, 1>(smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &fit, ell_st_kernel<T, K, 1>, kStThreads, smem) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return fit;
}

template <typename T>
cudaError_t launch_st(const int32_t* idx, const T* val, int64_t m,
                      int width, const T* xt, int k, int power,
                      int n_staged, int n_cta, T* out, cudaStream_t s) {
#define BB_ST_K(KK)                                                     \
  case KK:                                                              \
    return launch_st_k<T, KK>(idx, val, m, width, xt, power, n_staged, \
                              n_cta, out, s);
  switch (k) {
    BB_ST_K(1) BB_ST_K(2) BB_ST_K(3) BB_ST_K(4)
    BB_ST_K(5) BB_ST_K(6) BB_ST_K(7) BB_ST_K(8)
    default: return cudaErrorInvalidValue;
  }
#undef BB_ST_K
}

template <typename T>
int fit_st_of(int k, size_t smem) {
  switch (k) {
    case 1: return fit_st<T, 1>(smem);
    case 2: return fit_st<T, 2>(smem);
    case 3: return fit_st<T, 3>(smem);
    case 4: return fit_st<T, 4>(smem);
    case 5: return fit_st<T, 5>(smem);
    case 6: return fit_st<T, 6>(smem);
    case 7: return fit_st<T, 7>(smem);
    case 8: return fit_st<T, 8>(smem);
    default: return -1;
  }
}

template <typename T>
int win_rows_of(int k) {
  switch (k) {
    case 1: return win_rows<T, 1>();
    case 2: return win_rows<T, 2>();
    case 3: return win_rows<T, 3>();
    case 4: return win_rows<T, 4>();
    case 5: return win_rows<T, 5>();
    case 6: return win_rows<T, 6>();
    case 7: return win_rows<T, 7>();
    case 8: return win_rows<T, 8>();
    default: return 0;
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

// The windowed traversal of a sorted col-ELL (see ell_win_kernel). wptr:
// m * ld_ptr int32 window pointers at W / stride inputs a step;
// xt: n_win * W rows of k values (rows past n_in are never gathered);
// rows_cta: ELL rows a CTA, at most bb_ell_win_rows(k, f64). Returns the
// CUDA error of the launch (0 = ok).
extern "C" int bb_ell_win(const int32_t* idx, const void* val, long long m,
                          int width, const int32_t* wptr, int ld_ptr,
                          int stride, const void* xt, int k, int power,
                          int f64, int W, int n_win, int rows_cta, void* out,
                          void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || width <= 0 || k < 1 || k > kMaxVectors ||
      (power != 1 && power != 2) || ld_ptr < 2 || stride < 1 ||
      W < stride || W % stride != 0 || n_win < 1 || rows_cta < 1 ||
      (long long)n_win * W > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (f64)
    return (int)launch_win<double>(
        idx, static_cast<const double*>(val), m, width, wptr, ld_ptr, stride,
        static_cast<const double*>(xt), k, power, W, n_win, rows_cta,
        static_cast<double*>(out), s);
  return (int)launch_win<float>(
      idx, static_cast<const float*>(val), m, width, wptr, ld_ptr, stride,
      static_cast<const float*>(xt), k, power, W, n_win, rows_cta,
      static_cast<float*>(out), s);
}

// The most ELL rows a CTA of the windowed traversal takes for k vectors
// (kWinWarps * win_rows), 0 for a k it does not take.
extern "C" int bb_ell_win_rows(int k, int f64) {
  return kWinWarps * (f64 ? win_rows_of<double>(k) : win_rows_of<float>(k));
}

// The staged traversal (see ell_st_kernel): n_cta CTAs, each staging the
// first n_staged rows of xt (n_staged * k * itemsize bytes, a multiple of
// 16, at most kStMaxSmem). Returns the CUDA error
// of the launch (0 = ok).
extern "C" int bb_ell_st(const int32_t* idx, const void* val, long long m,
                         int width, const void* xt, int k, int power,
                         int f64, int n_staged, int n_cta, void* out,
                         void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || width <= 0 || k < 1 || k > kMaxVectors ||
      (power != 1 && power != 2) || n_staged < 1 || n_cta < 1)
    return (int)cudaErrorInvalidValue;
  if (f64)
    return (int)launch_st<double>(
        idx, static_cast<const double*>(val), m, width,
        static_cast<const double*>(xt), k, power, n_staged, n_cta,
        static_cast<double*>(out), s);
  return (int)launch_st<float>(
      idx, static_cast<const float*>(val), m, width,
      static_cast<const float*>(xt), k, power, n_staged, n_cta,
      static_cast<float*>(out), s);
}

// CTAs of the staged traversal an SM holds with a stage of n_staged
// inputs of k vectors (cudaOccupancyMaxActiveBlocksPerMultiprocessor); 0
// or less where the stage does not fit.
extern "C" int bb_ell_st_fit(int k, int f64, int n_staged) {
  if (k < 1 || k > kMaxVectors || n_staged < 1) return -1;
  const size_t smem = (size_t)n_staged * k * (f64 ? 8 : 4);
  return f64 ? fit_st_of<double>(k, smem) : fit_st_of<float>(k, smem);
}
