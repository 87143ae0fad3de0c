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
// order). They replace the TPU kernel _ne_kernel under jax.vmap over the
// chains (the batched XLA dots of bayesbridge_tpu/multichain.py). The
// row pass stages the chains' v in shared memory a chunk at a time and
// shares it across a CTA's 96 or 128 rows (below, ne_rows_k); the column
// pass keeps C chains' accumulators in registers (sweep_common.cuh,
// ColPlan).
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

// Rows a warp owns: 4, and 8 over a packed int4 block, whose lane reads
// half of int8's bytes a step for the same 16 columns of v: 8 rows keep
// int8's bytes of v read per byte of X (and its 64 bytes in flight).
template <typename T> constexpr int rows_per_warp() {
  return is_nib<T> ? 2 * kRowsPerWarp : kRowsPerWarp;
}

// acc[r] += X[row0 + r, :p] . v[:p] for r < nvalid, this lane's share:
// its units (16-byte vectors; 8 bytes, 16 columns, of a packed int4
// block) lane, lane + 32, ..., element by element.
template <typename T, int RW>
__device__ __forceinline__ void rows_dot(const T* __restrict__ X,
                                         int64_t ld, int p,
                                         const float* __restrict__ v,
                                         int64_t row0, int nvalid,
                                         float (&acc)[RW], int lane) {
  constexpr bool kNib = is_nib<T>;
  constexpr int N = vec_of<T>();
  using Q = std::conditional_t<kNib, uint2, uint4>;
  const T* base = X + row0 * ld;
  for (int k = lane * N; k < p; k += 32 * N) {
    float vv[N];
#pragma unroll
    for (int e = 0; e < N; e += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(v + k + e));
      vv[e] = q.x; vv[e + 1] = q.y; vv[e + 2] = q.z; vv[e + 3] = q.w;
    }
    Q q[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      if constexpr (kNib)
        q[r] = r < nvalid ? load8(reinterpret_cast<const uint8_t*>(
                                base + r * ld) + k / 2)
                          : make_uint2(0, 0);
      else
        q[r] = r < nvalid ? load16(base + r * ld + k)
                          : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      if (r < nvalid) {
        float xs[N];
        if constexpr (kNib)
          Nib4::cvt(q[r], xs);
        else
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

// RW rows a warp (rows_per_warp<T0>), (kThreads / 32) * RW a block.
template <typename T0, typename T1, int RW>
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
      (int64_t)blockIdx.x * (kThreads / 32) * RW + warp * RW;
  const int nvalid = (int)min64(RW, n - row0 > 0 ? n - row0 : 0);
  float acc[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) acc[r] = 0.f;
  if (nvalid > 0) {
    rows_dot<T0, RW>(X0, ld0, p0, v0, row0, nvalid, acc, lane);
    if (p1 > 0) rows_dot<T1, RW>(X1, ld1, p1, v1, row0, nvalid, acc, lane);
  }
  // Butterfly sums: every lane ends with every row's total, same order.
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);

  float lp = 0.f;
  if (lane < nvalid) {  // lane r finishes row r
    float t = acc[0];
#pragma unroll
    for (int r = 1; r < RW; ++r) if (lane == r) t = acc[r];
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
//
// Replaces the TPU kernel _ne_kernel's row phase under jax.vmap over the
// chains (bayesbridge_tpu/multichain.py). Each chain's row sum is
// rows_dot's: lane slot l's partial runs over the 16-byte units l, l +
// 32, ... of block 0, then of block 1, element by element as fmaf(x, v,
// acc); then the xor butterfly, then + c. What bounds it on the H100:
// the bytes of X up to about 4 chains; at 8 chains its 8 FMAs per int8
// byte and the conversions come within reach of the SM's issue rate. A
// design that fetches each warp's share of every chain's v through L1
// moves about 4 bytes of v on chip per byte of X. Here a warp owns
// kRowsPerWarpK rows, its lane l slot l of each, and a CTA of
// row_warps(C) warps stages each chunk of the C chains' v in shared
// memory once (cp.async) and reads it there for all its rows: the v
// traffic falls by the CTA's row count, and 8 chains fit one launch.
// Each lane stages its own share of the warp's next rows in shared
// memory too, so rows' loads stay in flight without holding registers.

// Elements 4j .. 4j + 3 of the 16-byte unit q of T, as floats.
template <typename T, int J>
__device__ __forceinline__ void cvt_group(const uint4& q, float (&x)[4]) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
  if constexpr (sizeof(T) == 4) {
    x[0] = __uint_as_float(w[0]); x[1] = __uint_as_float(w[1]);
    x[2] = __uint_as_float(w[2]); x[3] = __uint_as_float(w[3]);
  } else if constexpr (sizeof(T) == 2) {
    x[0] = __uint_as_float(w[2 * J] << 16);
    x[1] = __uint_as_float(w[2 * J] & 0xFFFF0000u);
    x[2] = __uint_as_float(w[2 * J + 1] << 16);
    x[3] = __uint_as_float(w[2 * J + 1] & 0xFFFF0000u);
  } else {
    // int8: a byte permute into the float 2^23 + (b + 128), less 2^23 +
    // 128 (exact; integer and FMA pipes, not the conversion unit).
    const uint32_t b = w[J] ^ 0x80808080u;  // each byte to b + 128
#pragma unroll
    for (int k = 0; k < 4; ++k)
      x[k] = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7540 + k)) -
             8388736.f;
  }
}

// The CTA's ring of staged v chunks. Chunk g of the launch is chunk g of
// block 0 or, past its nch0 chunks, of block 1 (f32). Within a stage,
// the 16-byte piece j of unit u of chain c sits at ((c * G + j) * U + u)
// * 4 floats (G pieces a unit, U units a chunk), so a warp's 32 lanes
// read 32 consecutive pieces: no bank conflicts.
template <typename T0, int C>
struct RowRing {
  const float* V0;
  const float* V1;
  int64_t ld0, ld1;
  int cov0, cov1;  // columns covered by each block's units
  int nch0, nch;
  int nc;
  float* sv;

  template <typename T>
  __device__ __forceinline__ void stage(const float* V, int64_t ld, int cov,
                                        int col0, float* dst) const {
    constexpr int N = Vec<T>::N, G = N / 4, U = kRowChunkK / N;
    constexpr int P = kRowChunkK / 4;  // pieces a chain
#pragma unroll
    for (int q = threadIdx.x; q < C * P; q += row_warps(C) * 32) {
      const int c = q / P, w = q % P, col = col0 + 4 * w;
      if (c < nc && col < cov)
        cp_async16(dst + ((c * G + w % G) * U + w / G) * 4, V + c * ld + col);
    }
  }

  __device__ __forceinline__ float* buf(int g) const {
    return sv + (g % kRowStagesK) * (C * kRowChunkK);
  }

  // The chunk's copies join the thread's next committed group (that of
  // a step of X rows, rows_block_k).
  __device__ __forceinline__ void issue(int g) const {
    if (g < nch0)
      stage<T0>(V0, ld0, cov0, g * kRowChunkK, buf(g));
    else if (g < nch)
      stage<float>(V1, ld1, cov1, (g - nch0) * kRowChunkK, buf(g));
  }

  __device__ __forceinline__ void prologue() const {
#pragma unroll
    for (int g = 0; g < kRowStagesK - 1; ++g) issue(g);
  }

  // Chunk g landed for every thread (its copies joined a group at least
  // (kRowStagesK - 1) chunks of steps old, which the caller's wait has
  // retired), every warp done with chunk g - 1; start chunk g +
  // kRowStagesK - 1 into the buffer chunk g - 1 held.
  __device__ __forceinline__ void begin(int g) const {
    __syncthreads();
    issue(g + kRowStagesK - 1);
  }
};

// Elements 4J .. 4J + 3 of every row's unit q[r] against the staged v of
// each chain (vb: this lane's unit in the chunk), in element order.
template <typename T, int J, int C>
__device__ __forceinline__ void rows_group(const uint4 (&q)[kRowsPerWarpK],
                                           const float* vb, int lim,
                                           float (&acc)[kRowsPerWarpK][C]) {
  constexpr int N = Vec<T>::N, G = N / 4, U = kRowChunkK / N;
  // Every chain's v first: the shared loads' latency runs under the
  // conversions.
  float4 v[C];
#pragma unroll
  for (int c = 0; c < C; ++c)
    v[c] = *reinterpret_cast<const float4*>(vb + (c * G + J) * U * 4);
  float x[kRowsPerWarpK][4];
#pragma unroll
  for (int r = 0; r < kRowsPerWarpK; ++r) cvt_group<T, J>(q[r], x[r]);
  if (lim < N) {  // ragged unit: select, so padding bits vanish
#pragma unroll
    for (int r = 0; r < kRowsPerWarpK; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * J + e >= lim) x[r][e] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int r = 0; r < kRowsPerWarpK; ++r) {
      acc[r][c] = fmaf(x[r][0], v[c].x, acc[r][c]);
      acc[r][c] = fmaf(x[r][1], v[c].y, acc[r][c]);
      acc[r][c] = fmaf(x[r][2], v[c].z, acc[r][c]);
      acc[r][c] = fmaf(x[r][3], v[c].w, acc[r][c]);
    }
}

// One block's share of the row pass: acc[r][c] += this lane's slot of
// row r . v_c over the block's units, chunk by chunk (its first chunk is
// the ring's chunk g0). Each lane stages its own 16 bytes of the warp's
// rows kRowXStagesK - 1 steps ahead in shared memory (`xs`: the warp's
// ring of steps, 512 bytes a row), so it reads back only what it copied
// and needs no barrier for X: one committed group a step, which the
// chunks of v staged meanwhile join.
template <typename T, typename T0, int C>
__device__ __forceinline__ void rows_block_k(
    const T* __restrict__ X, int64_t ld, int p, int64_t row0, int nvalid,
    const RowRing<T0, C>& ring, int g0, char* xs,
    float (&acc)[kRowsPerWarpK][C], int lane) {
  constexpr int N = Vec<T>::N, G = N / 4, U = kRowChunkK / N;
  constexpr int S = U / 32;  // warp steps a chunk
  constexpr int RW = kRowsPerWarpK, D = kRowXStagesK;
  static_assert((kRowStagesK - 1) * S >= D - 1, "a chunk lands in time");
  const int units = (p + N - 1) / N;
  const int steps = (units + 31) / 32;
  const T* base = X + row0 * ld;
  auto issue = [&](int m) {
    const int ug = m * 32 + lane;
    if (m < steps && ug < units) {
      char* dst = xs + (m % D) * (RW * 512) + lane * 16;
#pragma unroll
      for (int r = 0; r < RW; ++r)
        if (r < nvalid) cp_async16(dst + r * 512, base + r * ld + ug * N);
    }
    cp_async_commit();  // also when empty: one group a step
  };
#pragma unroll
  for (int m = 0; m < D - 1; ++m) issue(m);
  for (int m = 0; m < steps; ++m) {
    cp_async_wait<D - 2>();  // step m's rows (and older groups) landed
    if (m % S == 0) ring.begin(g0 + m / S);
    issue(m + D - 1);
    const int ug = m * 32 + lane;
    if (ug < units) {
      const char* src = xs + (m % D) * (RW * 512) + lane * 16;
      uint4 q[RW];
#pragma unroll
      for (int r = 0; r < RW; ++r)
        q[r] = *reinterpret_cast<const uint4*>(src + r * 512);
      const float* vb = ring.buf(g0 + m / S) + ((m % S) * 32 + lane) * 4;
      const int lim = p - ug * N;  // valid elements of this unit
      rows_group<T, 0, C>(q, vb, lim, acc);
      if constexpr (G > 1) rows_group<T, 1, C>(q, vb, lim, acc);
      if constexpr (G > 2) {
        rows_group<T, 2, C>(q, vb, lim, acc);
        rows_group<T, 3, C>(q, vb, lim, acc);
      }
    }
  }
}

// Row pass for nc <= C chains over a T0 block and an optional f32 block:
// t[c * n + row] = X0 V0_c + X1 V1_c + cc[c * c_chain + c_stride * row].
// Dynamic shared memory: rows_k_smem(C) bytes.
template <typename T0, int C>
__global__ void __launch_bounds__(row_warps(C) * 32, 1) ne_rows_k_kernel(
    const T0* __restrict__ X0, int64_t ld0, int p0,
    const float* __restrict__ V0, const float* __restrict__ X1, int64_t ld1,
    int p1, const float* __restrict__ V1, int64_t n, int nc,
    const float* __restrict__ cc, int64_t c_chain, int c_stride,
    float* __restrict__ t) {
  extern __shared__ __align__(16) float sv[];
  constexpr int RW = kRowsPerWarpK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t row0 =
      (int64_t)blockIdx.x * row_warps(C) * RW + warp * RW;
  const int nvalid = (int)min64(RW, n - row0 > 0 ? n - row0 : 0);
  constexpr int N0 = Vec<T0>::N;
  RowRing<T0, C> ring;
  ring.V0 = V0; ring.V1 = V1; ring.ld0 = ld0; ring.ld1 = ld1;
  ring.cov0 = (p0 + N0 - 1) / N0 * N0;
  ring.cov1 = (p1 + 3) / 4 * 4;
  ring.nch0 = (p0 + kRowChunkK - 1) / kRowChunkK;
  ring.nch = ring.nch0 + (p1 + kRowChunkK - 1) / kRowChunkK;
  ring.nc = nc;
  ring.sv = sv;
  ring.prologue();
  float acc[RW][C];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
  char* xs = reinterpret_cast<char*>(sv + kRowStagesK * C * kRowChunkK) +
             warp * (kRowXStagesK * RW * 512);
  rows_block_k<T0, T0, C>(X0, ld0, p0, row0, nvalid, ring, 0, xs, acc,
                          lane);
  if (p1 > 0)
    rows_block_k<float, T0, C>(X1, ld1, p1, row0, nvalid, ring, ring.nch0,
                               xs, acc, lane);
  cp_async_wait<0>();  // only empty groups are left; retire them all
#pragma unroll
  for (int r = 0; r < RW; ++r)
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
      for (int r = 1; r < RW; ++r) if (lane == r) v = acc[r][c];
      v += cc[c * c_chain + c_stride * row];
      t[c * n + row] = v;
    }
  }
}

template <typename T0, int C>
cudaError_t launch_rows_k(const void* X0, int64_t ld0, int p0,
                          const float* V0, const float* X1, int64_t ld1,
                          int p1, const float* V1, int64_t n, int nc,
                          const float* cc, int64_t c_chain, int c_stride,
                          float* t, cudaStream_t stream) {
  auto kern = ne_rows_k_kernel<T0, C>;
  constexpr int smem = rows_k_smem(C);
  static_assert(smem <= 232448, "a CTA's shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  constexpr int rows = row_warps(C) * kRowsPerWarpK;  // a CTA's
  const int grid = (int)((n + rows - 1) / rows);
  kern<<<grid, row_warps(C) * 32, smem, stream>>>(
      static_cast<const T0*>(X0), ld0, p0, V0, X1, ld1, p1, V1, n, nc, cc,
      c_chain, c_stride, t);
  return cudaGetLastError();
}

template <typename T0>
cudaError_t ne_rows_k(const void* X0, int64_t ld0, int p0, const float* V0,
                      const float* X1, int64_t ld1, int p1, const float* V1,
                      int64_t n, int nc, const float* cc, int64_t c_chain,
                      int c_stride, float* t, cudaStream_t stream) {
  if (nc < 1 || nc > kMaxChains) return cudaErrorInvalidValue;
#define BB_ROWS_K(C)                                                      \
  return launch_rows_k<T0, C>(X0, ld0, p0, V0, X1, ld1, p1, V1, n, nc,   \
                              cc, c_chain, c_stride, t, stream)
  switch (batched_chains(nc)) {
    case 2: BB_ROWS_K(2);
    case 4: BB_ROWS_K(4);
    default: BB_ROWS_K(8);
  }
#undef BB_ROWS_K
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
  ne_rows_kernel<T0, T1, kRowsPerWarp><<<grid_a, kThreads, 0, stream>>>(
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
// dt0 may be 3, a packed int4 block (ld0 in bytes): its nibble mode,
// which replaces the JAX package's XLA dot over the packed-s4 block
// (bayesbridge_tpu/design/sparse.py:984-1001). Bound by bytes as the
// int8 mode: half its exact block's bytes, the same FMAs.
extern "C" int bb_ne_rows(int dt0, const void* X0, long long ld0, int p0,
                          const float* v0, int dt1, const void* X1,
                          long long ld1, int p1, const float* v1,
                          long long n, const float* c, int c_stride,
                          float* t, void* stream) {
  using namespace bbsweep;
  auto s = static_cast<cudaStream_t>(stream);
  BB_DISPATCH_I4(dt0, T0, BB_DISPATCH(dt1, T1,
      constexpr int RW = rows_per_warp<T0>();
      constexpr int rows = (kThreads / 32) * RW;  // a block's
      ne_rows_kernel<T0, T1, RW><<<(int)((n + rows - 1) / rows), kThreads,
                                   0, s>>>(
          static_cast<const T0*>(X0), ld0, p0, v0,
          static_cast<const T1*>(X1), ld1, p1, v1, n, c, c_stride, nullptr,
          nullptr, MID_ROWS, 0, t, nullptr);
      return (int)cudaGetLastError()));
}

// The column pass alone: out = [X0' u ; X1' u] ((p0 + p1) floats), with
// partial n_seg * (p0 + p1) floats of scratch. dt0 may be 3, a packed
// int4 block: its nibble mode (col_tile_i4), which replaces the XLA dot
// Xe.T @ u over the packed-s4 block (sparse.py:1003-1037), with int8's
// tiles and row segments.
extern "C" int bb_colpass(int dt0, const void* X0, long long ld0, int p0,
                          int dt1, const void* X1, long long ld1, int p1,
                          long long n, const float* u, int n_seg,
                          long long rows_per_seg, float* partial, float* out,
                          void* stream) {
  using namespace bbsweep;
  auto s = static_cast<cudaStream_t>(stream);
  BB_DISPATCH_I4(dt0, T0, BB_DISPATCH(dt1, T1,
      launch_colpass<T0, T1, 1>(X0, ld0, p0, X1, ld1, p1, n, n_seg,
                                rows_per_seg, u, nullptr, nullptr, nullptr,
                                partial, out, s);
      return (int)cudaGetLastError()));
}

// The chain-batched row pass: t (nc, n) floats, t[c] = X0 V0[c] (+ X1
// V1[c]) + c-offset, with V0 (nc, ld0) and V1 (nc, ld1) zero-padded
// rows. X1 is f32 (or p1 == 0). The offset of chain c, row i is
// cc[c * c_chain + c_stride * i] (a scalar per chain: c_chain 1,
// c_stride 0). nc at most bb_max_chains(0, dt0), 8: one launch.
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
    case 0: case 4: case 5: BB_DISPATCH(dt0, T, return kMaxChains);
    case 1: BB_DISPATCH(dt0, T, return ColPlan<T, 1>::chains);
    default: return 0;
  }
}

// Shared memory (bytes) of a batched launch for nc chains: kinds as for
// bb_max_chains; -1 for an invalid kind or count. kernels/layout.py
// batched_plan computes the same.
extern "C" int bb_batched_smem(int kind, int dt0, int nc) {
  using namespace bbsweep;
  if (nc < 1 || nc > bb_max_chains(kind, dt0)) return -1;
  switch (kind) {
    case 0: return rows_k_smem(batched_chains(nc));
    case 1: return kUrows * chains_for(nc) * 4;
    case 4:
    case 5:
      if (nc <= 4) return kUrows * (kind - 1) * chains_for(nc) * 4;
      if (kind == 4) BB_DISPATCH(dt0, T, return td_smem<T, 4, 8>());
      BB_DISPATCH(dt0, T, return td_smem<T, 5, 8>());
    default: return -1;
  }
}

extern "C" int bb_tdots_k_occupancy(int R, int dt0, int nc);

// CTAs of a batched launch for nc chains that one SM holds at once (the
// occupancy calculator at the launch's threads and shared memory), kinds
// as for bb_max_chains; -1 for an invalid kind or count.
extern "C" int bb_batched_occupancy(int kind, int dt0, int nc) {
  using namespace bbsweep;
  if (nc < 1 || nc > bb_max_chains(kind, dt0)) return -1;
  if (kind == 4 || kind == 5) return bb_tdots_k_occupancy(kind, dt0, nc);
  int blocks = -1;
  auto fit = [&](auto kern, int threads, int smem) {
    if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, threads,
                                                      smem) != cudaSuccess)
      blocks = -1;
  };
  const int C = kind == 1 ? chains_for(nc) : batched_chains(nc);
  if (kind == 0) {
    BB_DISPATCH(dt0, T,
        if (C == 2) fit(ne_rows_k_kernel<T, 2>, 32 * row_warps(2),
                        rows_k_smem(2));
        else if (C == 4) fit(ne_rows_k_kernel<T, 4>, 32 * row_warps(4),
                             rows_k_smem(4));
        else fit(ne_rows_k_kernel<T, 8>, 32 * row_warps(8), rows_k_smem(8));
        return blocks);
  }
  if (kind == 1) {
    BB_DISPATCH(dt0, T,
        if (C == 1) fit(colpass_k_kernel<T, 1, 1>, kThreads, 0);
        else if (C == 2) fit(colpass_k_kernel<T, 1, 2>, kThreads, 0);
        else if (C == 4) fit(colpass_k_kernel<T, 1, 4>, kThreads, 0);
        else fit(colpass_k_kernel<T, 1, 8>, kThreads, 0);
        return blocks);
  }
  return -1;
}

extern "C" int bb_rows_per_block() { return bbsweep::kRowsPerBlock; }

// Whether this library has the nibble modes of the row pass, the column
// pass and the pre-solve (a packed int4 first block, DType 3): the
// design's int4 capability probe asks it.
extern "C" int bb_has_int4() { return 1; }

extern "C" const char* bb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
