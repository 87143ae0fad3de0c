// Shared pieces of the design sweeps (ne_sweep.cu, tdots_sweep.cu,
// ne_oneread.cu).
//
// Storage contract (checked by the Python wrappers): each design block is
// a row-major (n, ld) array of int8, bf16 (raw uint16 bits) or f32 whose
// row stride ld * sizeof(T) is a multiple of 16 bytes and whose base is
// 16-byte aligned, so every thread reads whole 16-byte vectors. Only the
// first p <= ld columns are logical; the kernels mask columns >= p by
// index and never read rows >= n, so padding may hold any bits. A packed
// int4 block (DT_I4, Nib4 below) holds two columns a byte and its ld
// counts bytes; only the row pass, the column pass (BB_DISPATCH_I4) and
// the pre-solve (its nibble kernel, tdots_sweep.cu) take one.
//
// Every reduction runs in a fixed order (warp butterflies, per-segment
// partials, an ordered second pass). There are no float atomics, so two
// runs on the same inputs give the same bits: the sampler's promise that
// a resumed chain equals an uninterrupted one rests on this.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace bbsweep {
namespace {  // internal linkage: each .cu file gets its own copy

enum DType { DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2, DT_I4 = 3 };

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

// A packed int4 block: two's-complement nibbles in [-8, 7], two columns
// a byte, the even column in the low nibble. Replaces the JAX package's
// packed-s4 exact block (bayesbridge_tpu/design/sparse.py:492-493),
// which XLA widened inside its dots. A thread reads 8 bytes, 16 columns,
// at a time: the int8 kernels' columns per thread, so the nibble modes
// keep int8's column tiles, row segments, per-lane column order and
// accumulator count, and with them int8's sums on the same values, at
// half the bytes. (Whole 16-byte units would give a thread 32 columns:
// twice the column pass's accumulators, 160 at five reductions.)
struct Nib4 {
  static constexpr int N = 16;  // columns of an 8-byte load
  // Each nibble + 8 ((w >> 4k) & 0x0F0F0F0F ^ 0x08080808), byte-permuted
  // into the float 2^23 + (x + 8), less 2^23 + 8: exact, on the integer
  // and FMA pipes (not the conversion unit), as cvt_group does int8.
  __device__ __forceinline__ static void cvt(uint2 q, float (&o)[N]) {
    const uint32_t w[2] = {q.x, q.y};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const uint32_t lo = (w[j] & 0x0F0F0F0Fu) ^ 0x08080808u;
      const uint32_t hi = ((w[j] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        o[8 * j + 2 * k] =
            __uint_as_float(__byte_perm(lo, 0x4B000000u, 0x7540 + k)) -
            8388616.f;
        o[8 * j + 2 * k + 1] =
            __uint_as_float(__byte_perm(hi, 0x4B000000u, 0x7540 + k)) -
            8388616.f;
      }
    }
  }
  // The 8 columns of one 32-bit word (column e in bits 4e .. 4e + 3):
  // cvt's first half; the second half's arithmetic is dead code.
  __device__ __forceinline__ static void cvt_word(uint32_t w,
                                                  float (&o)[8]) {
    float t[N];
    cvt(make_uint2(w, 0u), t);
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = t[e];
  }
};

template <typename T>
constexpr bool is_nib = std::is_same<T, Nib4>::value;

__device__ __forceinline__ uint2 load8(const uint8_t* p) {
  return __ldg(reinterpret_cast<const uint2*>(p));
}

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

// Stage rows rb .. rb + cnt of u0 (u1 u2 (u3)) in `su` for a block's
// threads (the barriers on both sides included).
template <int K>
__device__ __forceinline__ void stage_u(float* su, int64_t rb, int cnt,
                                        const float* __restrict__ u0,
                                        const float* __restrict__ u1,
                                        const float* __restrict__ u2,
                                        const float* __restrict__ u3) {
  constexpr int NU = NumU<K>::value;
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
}

// A thread's K x N column sums, from column c0, to its segment's partial
// rows (columns >= p dropped).
template <int K, int N>
__device__ __forceinline__ void write_part(const float (&acc)[K][N], int c0,
                                           int p, float* __restrict__ part,
                                           int64_t p_total, int col_off) {
  if (c0 < p) {
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int e = 0; e < N; ++e)
        if (c0 + e < p) part[k * p_total + col_off + c0 + e] = acc[k][e];
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
  const int c0 = tile * (kThreads * N) + threadIdx.x * N;
  float acc[K][N];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int e = 0; e < N; ++e) acc[k][e] = 0.f;

  for (int64_t rb = r0; rb < r1; rb += kUrows) {
    const int cnt = (int)min64(kUrows, r1 - rb);
    stage_u<K>(su, rb, cnt, u0, u1, u2, u3);
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
  write_part<K, N>(acc, c0, p, part, p_total, col_off);
}

// col_tile over a packed int4 block (ld in bytes): 16 columns a thread,
// 8 rows' 8-byte loads in flight (int8's 64 bytes), the same staging,
// accumulation and partial rows.
template <int K>
__device__ __forceinline__ void col_tile_i4(
    const uint8_t* __restrict__ X, int64_t ld, int p, int tile, int64_t r0,
    int64_t r1, const float* __restrict__ u0, const float* __restrict__ u1,
    const float* __restrict__ u2, const float* __restrict__ u3, float* su,
    float* __restrict__ part, int64_t p_total, int col_off) {
  constexpr int N = Nib4::N, ROWS = 8;
  const int c0 = tile * (kThreads * N) + threadIdx.x * N;
  float acc[K][N];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int e = 0; e < N; ++e) acc[k][e] = 0.f;

  for (int64_t rb = r0; rb < r1; rb += kUrows) {
    const int cnt = (int)min64(kUrows, r1 - rb);
    stage_u<K>(su, rb, cnt, u0, u1, u2, u3);
    if (c0 < p) {
      const uint8_t* xp = X + rb * ld + c0 / 2;
      int i = 0;
      for (; i + ROWS <= cnt; i += ROWS, xp += ROWS * ld) {
        uint2 q[ROWS];
#pragma unroll
        for (int j = 0; j < ROWS; ++j) q[j] = load8(xp + j * ld);
#pragma unroll
        for (int j = 0; j < ROWS; ++j) {
          float xs[N];
          Nib4::cvt(q[j], xs);
          accumulate<K, N>(acc, xs, su, i + j);
        }
      }
      for (; i < cnt; ++i, xp += ld) {
        float xs[N];
        Nib4::cvt(load8(xp), xs);
        accumulate<K, N>(acc, xs, su, i);
      }
    }
  }
  write_part<K, N>(acc, c0, p, part, p_total, col_off);
}

// col_tile, or col_tile_i4 for a packed int4 block.
template <typename T, int K>
__device__ __forceinline__ void col_tile_of(
    const T* __restrict__ X, int64_t ld, int p, int tile, int64_t r0,
    int64_t r1, const float* __restrict__ u0, const float* __restrict__ u1,
    const float* __restrict__ u2, const float* __restrict__ u3, float* su,
    float* __restrict__ part, int64_t p_total, int col_off) {
  if constexpr (is_nib<T>)
    col_tile_i4<K>(reinterpret_cast<const uint8_t*>(X), ld, p, tile, r0,
                   r1, u0, u1, u2, u3, su, part, p_total, col_off);
  else
    col_tile<T, K>(X, ld, p, tile, r0, r1, u0, u1, u2, u3, su, part,
                   p_total, col_off);
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
    col_tile_of<T0, K>(X0, ld0, p0, blockIdx.x, r0, r1, u0, u1, u2, u3, su,
                       part, p_total, 0);
  else
    col_tile_of<T1, K>(X1, ld1, p1, blockIdx.x - tiles0, r0, r1, u0, u1,
                       u2, u3, su, part, p_total, p0);
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

template <typename T> __host__ __device__ constexpr int vec_of() {
  if constexpr (is_nib<T>) return Nib4::N;  // a thread's 8 bytes
  else return Vec<T>::N;
}

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

// ---- Chain-batched forms: several Markov chains' vectors per read ----
//
// Every batched kernel serves up to kMaxChains chains from one read of X
// in one launch, each chain's result equal to its single-vector launch
// bit for bit. A launch for nc chains is compiled for C = nc rounded up
// to 1, 2, 4 or 8 (chains_for; at least 2 for the row pass, batched_
// chains); the chains past nc compute on zeros or on whatever their
// staging holds and are never written. kernels/layout.py `batched_plan`
// mirrors the geometry below (chains, panels, chunks, shared memory),
// and bb_batched_smem reports it to the tests on the card.

constexpr int kMaxChains = 8;

__host__ __device__ constexpr int floor_pow2(int x) {
  return x >= 8 ? 8 : x >= 4 ? 4 : x >= 2 ? 2 : 1;
}

// The compiled chain count for nc chains (1 <= nc <= kMaxChains).
__host__ __device__ constexpr int chains_for(int nc) {
  return nc <= 1 ? 1 : nc == 2 ? 2 : nc <= 4 ? 4 : 8;
}

// The compiled chain count of the row pass, which has no one-chain
// form (a lone chain takes the single-vector kernel).
__host__ __device__ constexpr int batched_chains(int nc) {
  return nc <= 2 ? 2 : chains_for(nc);
}

// Asynchronous global -> shared copies (cp.async): 16 bytes through L2
// only, or 4 bytes; committed in groups and waited for per thread.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `kPending` of this thread's committed groups are
// still in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// -- The batched row pass (ne_sweep.cu ne_rows_k): a CTA of row_warps(C)
// warps owns row_warps(C) * kRowsPerWarpK rows and walks the columns in
// chunks of kRowChunkK columns; each chunk of the C chains' v is staged
// in shared memory once per CTA (kRowStagesK buffers, cp.async) and read
// there by every warp; each lane stages its own share of its warp's next
// rows (kRowXStagesK steps). Fewer chains hold fewer registers, so their
// CTAs take more warps and keep more rows' loads in flight.
constexpr int kRowWarpsK2 = 16;  // warps a CTA at 2 chains
constexpr int kRowWarpsK4 = 12;  // at 4
constexpr int kRowWarpsK8 = 12;  // at 8
constexpr int kRowsPerWarpK = 8;
constexpr int kRowChunkK = 512;   // columns (v floats per chain) a chunk
constexpr int kRowStagesK = 3;    // chunks of v staged at once
constexpr int kRowXStagesK = 3;   // steps of a warp's rows staged at once

__host__ __device__ constexpr int row_warps(int C) {
  return C <= 2 ? kRowWarpsK2 : C == 4 ? kRowWarpsK4 : kRowWarpsK8;
}

// The v chunks' ring, then each warp's ring of steps (512 bytes a row).
__host__ __device__ constexpr int rows_k_smem(int C) {
  return kRowStagesK * C * kRowChunkK * 4 +
         row_warps(C) * kRowXStagesK * kRowsPerWarpK * 512;
}

// -- The batched pre-solve for 5 to 8 chains (tdots_sweep.cu, R = 4 or 5
// reductions): a CTA owns a column tile and a row segment; row panels of
// the tile (kTdPanelBytes of X) and the C = 8 chains' u's for those
// rows, chains interleaved, are staged in shared memory (kTdStages
// buffers, cp.async). Two warp groups of 4 chains each read the same
// panel, each thread owning 4 columns of its group's chains.
constexpr int kTdThreads = 256;
constexpr int kTdPanelBytes = 16384;
constexpr int kTdStages = 4;
constexpr int kTdMinBlocks = 2;  // CTAs an SM is compiled to hold
constexpr int kTdUnroll = 4;  // panel rows a thread's loop body holds

template <int C> struct TdSplit {
  static constexpr int sub = 4;                        // chains a group
  static constexpr int groups = C / sub;
  static constexpr int cols = 4;                       // a thread's
  static constexpr int threads = kTdThreads / groups;  // a group's
  static constexpr int tile_cols = threads * cols;
};

template <typename T, int C> __host__ __device__ constexpr int td_rows() {
  return kTdPanelBytes / (TdSplit<C>::tile_cols * (int)sizeof(T));
}

// Floats of staged u per stage: R - 1 vectors of C chains over the panel
// rows of a T0 tile (an f32 tile has fewer rows).
template <typename T0, int R, int C>
__host__ __device__ constexpr int td_ufloats() {
  return (R - 1) * td_rows<T0, C>() * C;
}

template <typename T0, int R, int C>
__host__ __device__ constexpr int td_smem() {
  return kTdStages * (kTdPanelBytes + 4 * td_ufloats<T0, R, C>());
}

// -- The batched column pass (colpass_k, R = 1) and the pre-solve at up
// to 4 chains (R = 4 or 5): for each of C chains, the R reductions of
// col_tile (R = 1: X'u; R = 4 or 5: those of `accumulate`), from one read
// of X for all C chains. Each (chain, reduction, column) sum runs in one
// register, row by row, with the fmaf of the single-vector pass, over the
// row segments of the single-vector launch (the caller passes them), and
// the ordered second pass sums the segments: so each chain's column
// equals its single-vector launch bit for bit, whatever the batch. A
// thread owns UNIT bytes of a row (16, 8 or 4: the column ownership does
// not enter a column's sum), chosen so that its C * R * UNIT / sizeof(T)
// accumulators fit in registers: kAccBudget floats, the five-reduction
// int8 pass's 80 that the single-vector kernel holds without spills.
constexpr int kAccBudget = 80;
// Bytes of the next rows each column-pass thread keeps in flight: 64 for
// one or four reductions, 128 for the five-reduction pre-solve, whose
// threads hold so many accumulators that a block of them fills an SM
// (baselines/batched_variants.py times the alternatives).
constexpr int kColBytesInFlight = 64;
constexpr int kColBytesInFlight5 = 128;

// The widest load unit that keeps kMaxChains chains' accumulators in
// the budget, else 4 bytes; and the chains that then fit.
template <typename T, int R> struct ColPlan {
  static constexpr int acc_at(int unit) {
    return R * kMaxChains * unit / (int)sizeof(T);
  }
  static constexpr int unit = acc_at(16) <= kAccBudget ? 16
                              : acc_at(8) <= kAccBudget ? 8 : 4;
  static constexpr int chains =
      floor_pow2(kAccBudget / (R * unit / (int)sizeof(T)));
};

// A load of UNIT bytes as 32-bit words.
template <int UNIT>
__device__ __forceinline__ void load_words(const void* p,
                                           uint32_t (&w)[UNIT / 4]) {
  if constexpr (UNIT == 16) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
  } else if constexpr (UNIT == 8) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = q.x; w[1] = q.y;
  } else {
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  }
}

// Up-convert W words of stored elements, as Vec<T>::cvt does per word.
template <typename T, int W>
__device__ __forceinline__ void cvt_words(const uint32_t (&w)[W],
                                          float (&o)[W * 4 / sizeof(T)]) {
#pragma unroll
  for (int j = 0; j < W; ++j) {
    if constexpr (sizeof(T) == 4) {
      o[j] = __uint_as_float(w[j]);
    } else if constexpr (sizeof(T) == 2) {
      o[2 * j] = __uint_as_float(w[j] << 16);
      o[2 * j + 1] = __uint_as_float(w[j] & 0xFFFF0000u);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        o[4 * j + k] = (float)((int32_t)(w[j] << (24 - 8 * k)) >> 24);
    }
  }
}

// `accumulate` for C chains: staged u j of chain c at su[(j * C + c) *
// kUrows + i].
template <int R, int C, int N>
__device__ __forceinline__ void accumulate_k(float (&acc)[C][R][N],
                                             const float (&xs)[N],
                                             const float* su, int i) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float w0 = su[c * kUrows + i];
    if constexpr (R == 1) {
#pragma unroll
      for (int e = 0; e < N; ++e) acc[c][0][e] = fmaf(xs[e], w0, acc[c][0][e]);
    } else {
      const float w1 = su[(C + c) * kUrows + i];
      const float w2 = su[(2 * C + c) * kUrows + i];
#pragma unroll
      for (int e = 0; e < N; ++e) {
        acc[c][0][e] = fmaf(xs[e], w0, acc[c][0][e]);
        acc[c][1][e] = fmaf(xs[e], w1, acc[c][1][e]);
        acc[c][2][e] = fmaf(xs[e], w2, acc[c][2][e]);
        acc[c][3][e] = fmaf(xs[e] * xs[e], w2, acc[c][3][e]);
      }
      if constexpr (R == 5) {
        const float w3 = su[(3 * C + c) * kUrows + i];
#pragma unroll
        for (int e = 0; e < N; ++e)
          acc[c][4][e] = fmaf(xs[e], w3, acc[c][4][e]);
      }
    }
  }
}

// col_tile for nc <= C chains: u j of chain c is uj[c * n + row]; the
// partial row of (chain c, reduction r) is part[(c * R + r) * p_total].
// `su` holds kUrows * NumU<R> * C floats.
template <typename T, int R, int C>
__device__ __forceinline__ void col_tile_k(
    const T* __restrict__ X, int64_t ld, int p, int tile, int64_t r0,
    int64_t r1, int nc, int64_t n, const float* __restrict__ u0,
    const float* __restrict__ u1, const float* __restrict__ u2,
    const float* __restrict__ u3, float* su, float* __restrict__ part,
    int64_t p_total, int col_off) {
  constexpr int UNIT = ColPlan<T, R>::unit;
  constexpr int W = UNIT / 4;                  // words per load
  constexpr int N = UNIT / (int)sizeof(T);     // columns per thread
  constexpr int NU = NumU<R>::value;
  constexpr int ROWS =  // rows' loads in flight
      (R == 5 ? kColBytesInFlight5 : kColBytesInFlight) / UNIT;
  const int c0 = tile * (kThreads * N) + threadIdx.x * N;
  float acc[C][R][N];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int e = 0; e < N; ++e) acc[c][r][e] = 0.f;

  for (int64_t rb = r0; rb < r1; rb += kUrows) {
    const int cnt = (int)min64(kUrows, r1 - rb);
    __syncthreads();
    if ((int)threadIdx.x < cnt) {  // kThreads >= kUrows
      const int64_t row = rb + threadIdx.x;
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        const float* uj = j == 0 ? u0 : j == 1 ? u1 : j == 2 ? u2 : u3;
#pragma unroll
        for (int c = 0; c < C; ++c)
          su[(j * C + c) * kUrows + threadIdx.x] =
              c < nc ? uj[c * n + row] : 0.f;
      }
    }
    __syncthreads();
    if (c0 < p) {
      const T* xp = X + rb * ld + c0;
      int i = 0;
      for (; i + ROWS <= cnt; i += ROWS, xp += ROWS * ld) {
        uint32_t q[ROWS][W];
#pragma unroll
        for (int j = 0; j < ROWS; ++j) load_words<UNIT>(xp + j * ld, q[j]);
#pragma unroll
        for (int j = 0; j < ROWS; ++j) {
          float xs[N];
          cvt_words<T, W>(q[j], xs);
          accumulate_k<R, C, N>(acc, xs, su, i + j);
        }
      }
      for (; i < cnt; ++i, xp += ld) {
        uint32_t q[W];
        load_words<UNIT>(xp, q);
        float xs[N];
        cvt_words<T, W>(q, xs);
        accumulate_k<R, C, N>(acc, xs, su, i);
      }
    }
  }
  if (c0 < p) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (c >= nc) break;
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int e = 0; e < N; ++e)
          if (c0 + e < p)
            part[(int64_t)(c * R + r) * p_total + col_off + c0 + e] =
                acc[c][r][e];
    }
  }
}

// The batched column pass over a block of T0 and an optional f32 block.
// Grid: x = column tiles of block 0 then of block 1 (at each block's
// unit), y = the row segments. partial: (n_seg, nc * R, p0 + p1).
template <typename T0, int R, int C>
__global__ void __launch_bounds__(kThreads) colpass_k_kernel(
    const T0* __restrict__ X0, int64_t ld0, int p0, int tiles0,
    const float* __restrict__ X1, int64_t ld1, int p1, int64_t n,
    int64_t rows_per_seg, int nc, const float* __restrict__ u0,
    const float* __restrict__ u1, const float* __restrict__ u2,
    const float* __restrict__ u3, float* __restrict__ partial) {
  __shared__ float su[kUrows * NumU<R>::value * C];
  const int64_t p_total = (int64_t)p0 + p1;
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_seg;
  const int64_t r1 = min64(n, r0 + rows_per_seg);
  float* part = partial + (int64_t)blockIdx.y * nc * R * p_total;
  if ((int)blockIdx.x < tiles0)
    col_tile_k<T0, R, C>(X0, ld0, p0, blockIdx.x, r0, r1, nc, n, u0, u1,
                         u2, u3, su, part, p_total, 0);
  else
    col_tile_k<float, R, C>(X1, ld1, p1, blockIdx.x - tiles0, r0, r1, nc,
                            n, u0, u1, u2, u3, su, part, p_total, p0);
}

template <typename T0, int R, int C>
void launch_colpass_k(const void* X0, int64_t ld0, int p0, const float* X1,
                      int64_t ld1, int p1, int64_t n, int nc, int n_seg,
                      int64_t rows_per_seg, const float* u0, const float* u1,
                      const float* u2, const float* u3, float* partial,
                      float* out, cudaStream_t stream) {
  const int tiles0 =
      tiles_of(p0, ColPlan<T0, R>::unit / (int)sizeof(T0));
  const int tiles1 = p1 > 0 ? tiles_of(p1, ColPlan<float, R>::unit / 4) : 0;
  dim3 grid(tiles0 + tiles1, n_seg);
  colpass_k_kernel<T0, R, C><<<grid, kThreads, 0, stream>>>(
      static_cast<const T0*>(X0), ld0, p0, tiles0, X1, ld1, p1, n,
      rows_per_seg, nc, u0, u1, u2, u3, partial);
  const int64_t width = (int64_t)nc * R * ((int64_t)p0 + p1);
  const int rgrid = (int)min64((width + kThreads - 1) / kThreads, 4096);
  reduce_segments_kernel<<<rgrid, kThreads, 0, stream>>>(partial, n_seg,
                                                         width, out);
}

// The batched column pass for nc chains (1 <= nc <= the plan's chains):
// out (nc, R, p0 + p1). C is nc rounded up to 1, 2, 4 or 8; the chains
// past nc compute on zeros and are not written.
template <typename T0, int R>
cudaError_t colpass_k(const void* X0, int64_t ld0, int p0, const float* X1,
                      int64_t ld1, int p1, int64_t n, int nc, int n_seg,
                      int64_t rows_per_seg, const float* u0, const float* u1,
                      const float* u2, const float* u3, float* partial,
                      float* out, cudaStream_t stream) {
  constexpr int cmax = ColPlan<T0, R>::chains;
  static_assert(ColPlan<float, R>::chains >= cmax, "f32 block plan");
  if (nc < 1 || nc > cmax) return cudaErrorInvalidValue;
#define BB_COLPASS_K(C)                                                     \
  launch_colpass_k<T0, R, C>(X0, ld0, p0, X1, ld1, p1, n, nc, n_seg,       \
                             rows_per_seg, u0, u1, u2, u3, partial, out,   \
                             stream)
  if (nc == 1) {
    BB_COLPASS_K(1);
  } else if (nc == 2) {
    BB_COLPASS_K(2);
  } else if (nc <= 4) {
    if constexpr (cmax >= 4) BB_COLPASS_K(4);
  } else {
    if constexpr (cmax >= 8) BB_COLPASS_K(8);
  }
#undef BB_COLPASS_K
  return cudaGetLastError();
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

// BB_DISPATCH with the packed int4 block too (DT_I4: T = Nib4), for the
// first block of the single-vector row pass and column pass;
// `stmt` must return.
#define BB_DISPATCH_I4(dt, T, ...)                                    \
  if ((dt) == ::bbsweep::DT_I4) {                                     \
    using T = ::bbsweep::Nib4;                                        \
    __VA_ARGS__;                                                      \
  }                                                                   \
  BB_DISPATCH(dt, T, __VA_ARGS__)

}  // namespace
}  // namespace bbsweep
