// Pre-solve reductions over one or two row-aligned design blocks (int8,
// bf16 or f32 storage, f32 accumulation): per block, from one read of X,
//
//   X'u1,  X'u2,  X'u3,  (X.X)'u3  [,  X'u4]
//
// the collapsed-observation Tdot, the CG b-vector noise Tdot, the weighted
// column sums and the Jacobi preconditioner's second moment; with u4 (the
// composed path's pre-solve) also the warm start's residual reduction
// X'(w * X coef_init), so the initial CG residual needs no X' pass.
//
// Replaces the TPU kernel bayesbridge_tpu/design/fusedne.py:_tdots_kernel
// (launched by fused_tdots), which accumulated the four (1, p) outputs in VMEM
// across a sequential grid of row panels.
//
// What bounds it on the H100: bytes. Each element is read once at its
// stored width for 4 FMAs and a multiply, far below the card's FLOP/byte
// balance, so the floor is the stored bytes over 3.35 TB/s. Hopper blocks
// run unordered, so the sequential-grid accumulator becomes the column
// pass of sweep_common.cuh: blocks own column tiles (each thread 16 bytes
// of a row, so a warp reads 512 contiguous bytes), loop over a row
// segment with u1..u3 staged in shared memory, and write per-segment
// partials that an ordered second pass sums. One read of X; no atomics.
// The square moment is computed from the loaded values, also for 0/1
// blocks (the composed JAX path reuses X'u3 there; the fused kernel
// never did), except in the binary mode of the nibble pre-solve below.
// With u4, an int8 thread holds 5 x 16 float accumulators (80 registers
// against 64 for four reductions); -Xptxas -v reports the build's
// registers and spills.
//
// bb_tdots_sweep_k runs the same reductions for up to 8 Markov chains
// from one read of X, in one launch. It replaces the TPU kernel
// _tdots_kernel under jax.vmap over the chains
// (bayesbridge_tpu/multichain.py), each chain's columns equal to its
// single-vector launch bit for bit. What bounds it on the H100:
// operations. With R reductions it does 2 R k FLOPs per element of X, so
// from k = 4 (R = 5) the float32 FMA rate (2 n p k R / 67 TFLOP/s) lies
// above the bytes' time. The FMAs themselves are what holds it: with the
// u and X loads and the barriers cut out of the loop it still runs at
// about half the FMA rate (baselines/batched_variants.py,
// cut-u+cut-x+cut-sync); each FMA takes its multiplicand, a broadcast u
// and an accumulator from the register file.
// The design for 5 to 8 chains: a CTA owns a column tile and one of the
// single-vector launch's row segments; panels of the tile's rows
// (kTdPanelBytes of X) and the 8 chains' u's for those rows, chains
// interleaved, are staged in shared memory (kTdStages buffers, cp.async),
// so X comes from HBM once for all chains where the register-tiled pass
// took two launches. Two warp groups of 4 chains read the same panel; a
// thread owns 4 columns of its group's chains, so per row it issues one
// shared load of X, one conversion and one square per column, one
// 16-byte shared load per u (4 chains' values), and 4 R FMAs per column.
// Up to 4 chains take the register-tiled column pass of sweep_common.cuh
// (colpass_k with R = 4 or 5), which is faster there than this staged
// design, timed in turns on the H100 (PERF.md).

#include "sweep_common.cuh"

namespace bbsweep {
namespace {

// Stage one panel: rows rb .. rb + cnt of a tile's columns col0 .. col0
// + tile_cols of block X, and the C chains' u's for those rows. X rows
// at `xs` one after another (tile_cols * sizeof(T) bytes each); u j of
// chain c for panel row i at us[(j * PR + i) * C + c].
template <typename T, int R, int C>
__device__ __forceinline__ void td_issue(
    const T* __restrict__ X, int64_t ld, int col0, int64_t rb, int cnt,
    int nc, int64_t n, const float* u0, const float* u1, const float* u2,
    const float* u3, char* xs, float* us) {
  constexpr int PR = td_rows<T, C>(), NU = R - 1;
  constexpr int ROWB = TdSplit<C>::tile_cols * (int)sizeof(T);
  constexpr int PPR = ROWB / 16;  // 16-byte pieces a row
  const int64_t ldb = ld * (int64_t)sizeof(T);
  const int64_t cb0 = (int64_t)col0 * sizeof(T);
  const char* base = reinterpret_cast<const char*>(X) + rb * ldb + cb0;
#pragma unroll
  for (int q = threadIdx.x; q < PR * PPR; q += kTdThreads) {
    const int i = q / PPR, w = q % PPR;
    if (i < cnt && cb0 + 16 * w < ldb)
      cp_async16(xs + q * 16, base + i * ldb + 16 * w);
  }
#pragma unroll
  for (int q = threadIdx.x; q < NU * C * PR; q += kTdThreads) {
    const int i = q % PR, c = (q / PR) % C, j = q / (PR * C);
    if (i < cnt && c < nc) {
      const float* uj = j == 0 ? u0 : j == 1 ? u1 : j == 2 ? u2 : u3;
      cp_async4(us + (j * PR + i) * C + c, uj + c * n + rb + i);
    }
  }
}

// N stored elements at p (16-byte aligned runs of N * sizeof(T) bytes),
// up-converted as Vec<T>::cvt does.
template <typename T, int N>
__device__ __forceinline__ void td_load(const char* p, float (&x)[N]) {
  constexpr int W = N * (int)sizeof(T) / 4;
  uint32_t w[W];
  if constexpr (W == 1) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (W == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else {
#pragma unroll
    for (int h = 0; h < W / 4; ++h) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + 16 * h);
      w[4 * h] = v.x; w[4 * h + 1] = v.y;
      w[4 * h + 2] = v.z; w[4 * h + 3] = v.w;
    }
  }
  cvt_words<T, W>(w, x);
}

// One tile of one segment: rows r0 .. r1 of the tile's columns, the
// partial rows of (chain c, reduction r) at part[(c * R + r) * p_total].
// UF: floats of staged u a stage (the T0 tile's, the most rows).
template <typename T, int R, int C, int UF>
__device__ __forceinline__ void td_tile(
    const T* __restrict__ X, int64_t ld, int p, int tile, int64_t r0,
    int64_t r1, int nc, int64_t n, const float* u0, const float* u1,
    const float* u2, const float* u3, char* smem, float* __restrict__ part,
    int64_t p_total, int col_off) {
  using S = TdSplit<C>;
  constexpr int N = S::cols, CS = S::sub, PR = td_rows<T, C>(), NU = R - 1;
  constexpr int ROWB = S::tile_cols * (int)sizeof(T);
  float* us_all = reinterpret_cast<float*>(smem + kTdStages * kTdPanelBytes);
  const int g = threadIdx.x / S::threads, tg = threadIdx.x % S::threads;
  const int col0 = tile * S::tile_cols;
  const int cth = col0 + tg * N;  // this thread's first column
  const int64_t rows = r1 - r0;
  const int np = (int)((rows + PR - 1) / PR);
  auto issue = [&](int pn) {
    if (pn < np) {
      const int64_t rb = r0 + (int64_t)pn * PR;
      td_issue<T, R, C>(X, ld, col0, rb, (int)min64(PR, r1 - rb), nc, n, u0,
                        u1, u2, u3, smem + (pn % kTdStages) * kTdPanelBytes,
                        us_all + (pn % kTdStages) * UF);
    }
    cp_async_commit();  // also when empty: one group per panel
  };
  float acc[CS][R][N];
#pragma unroll
  for (int c = 0; c < CS; ++c)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int e = 0; e < N; ++e) acc[c][r][e] = 0.f;
#pragma unroll
  for (int s = 0; s < kTdStages - 1; ++s) issue(s);
  for (int pn = 0; pn < np; ++pn) {
    // Panel pn landed for every thread, every warp done with pn - 1,
    // whose buffers take panel pn + kTdStages - 1.
    cp_async_wait<kTdStages - 2>();
    __syncthreads();
    issue(pn + kTdStages - 1);
    const char* xp = smem + (pn % kTdStages) * kTdPanelBytes +
                     tg * N * (int)sizeof(T);
    const float* up = us_all + (pn % kTdStages) * UF + g * CS;
    const int cnt = (int)min64(PR, rows - (int64_t)pn * PR);
#pragma unroll kTdUnroll
    for (int i = 0; i < cnt; ++i) {
      float x[N], xx[N];
      td_load<T, N>(xp + i * ROWB, x);
#pragma unroll
      for (int e = 0; e < N; ++e) xx[e] = x[e] * x[e];
      float w[NU][CS];  // the group's 4 chains' u j, one shared load each
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        const float4 q = *reinterpret_cast<const float4*>(
            up + (j * PR + i) * C);
        w[j][0] = q.x; w[j][1] = q.y; w[j][2] = q.z; w[j][3] = q.w;
      }
      // Element by element, so that consecutive FMAs share x[e].
#pragma unroll
      for (int e = 0; e < N; ++e) {
#pragma unroll
        for (int c = 0; c < CS; ++c) {
          acc[c][0][e] = fmaf(x[e], w[0][c], acc[c][0][e]);
          acc[c][1][e] = fmaf(x[e], w[1][c], acc[c][1][e]);
          acc[c][2][e] = fmaf(x[e], w[2][c], acc[c][2][e]);
          if constexpr (R == 5)
            acc[c][4][e] = fmaf(x[e], w[3][c], acc[c][4][e]);
        }
#pragma unroll
        for (int c = 0; c < CS; ++c)
          acc[c][3][e] = fmaf(xx[e], w[2][c], acc[c][3][e]);
      }
    }
  }
  cp_async_wait<0>();  // only empty groups are left; retire them all
#pragma unroll
  for (int c = 0; c < CS; ++c) {
    const int cg = g * CS + c;
    if (cg >= nc) break;
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int e = 0; e < N; ++e)
        if (cth + e < p)
          part[(int64_t)(cg * R + r) * p_total + col_off + cth + e] =
              acc[c][r][e];
  }
}

// The batched pre-solve over a block of T0 and an optional f32 block.
// Grid: x = column tiles of block 0 then of block 1 (TdSplit<C>::tile_cols
// columns each), y = the row segments. partial: (n_seg, nc * R, p0 + p1).
// Dynamic shared memory: td_smem<T0, R, C>() bytes.
template <typename T0, int R, int C>
__global__ void __launch_bounds__(kTdThreads, kTdMinBlocks) tdots_k_kernel(
    const T0* __restrict__ X0, int64_t ld0, int p0, int tiles0,
    const float* __restrict__ X1, int64_t ld1, int p1, int64_t n,
    int64_t rows_per_seg, int nc, const float* __restrict__ u0,
    const float* __restrict__ u1, const float* __restrict__ u2,
    const float* __restrict__ u3, float* __restrict__ partial) {
  extern __shared__ __align__(16) char smem[];
  constexpr int UF = td_ufloats<T0, R, C>();
  const int64_t p_total = (int64_t)p0 + p1;
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_seg;
  const int64_t r1 = min64(n, r0 + rows_per_seg);
  float* part = partial + (int64_t)blockIdx.y * nc * R * p_total;
  if ((int)blockIdx.x < tiles0)
    td_tile<T0, R, C, UF>(X0, ld0, p0, blockIdx.x, r0, r1, nc, n, u0, u1,
                          u2, u3, smem, part, p_total, 0);
  else
    td_tile<float, R, C, UF>(X1, ld1, p1, blockIdx.x - tiles0, r0, r1, nc,
                             n, u0, u1, u2, u3, smem, part, p_total, p0);
}

template <typename T0, int R, int C>
cudaError_t launch_tdots_k(const void* X0, int64_t ld0, int p0,
                           const float* X1, int64_t ld1, int p1, int64_t n,
                           int nc, int n_seg, int64_t rows_per_seg,
                           const float* u0, const float* u1, const float* u2,
                           const float* u3, float* partial,
                           cudaStream_t stream) {
  auto kern = tdots_k_kernel<T0, R, C>;
  constexpr int smem = td_smem<T0, R, C>();
  static_assert(smem <= 232448, "a CTA's shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  constexpr int tc = TdSplit<C>::tile_cols;
  const int tiles0 = (p0 + tc - 1) / tc;
  const int tiles1 = (p1 + tc - 1) / tc;
  kern<<<dim3(tiles0 + tiles1, n_seg), kTdThreads, smem, stream>>>(
      static_cast<const T0*>(X0), ld0, p0, tiles0, X1, ld1, p1, n,
      rows_per_seg, nc, u0, u1, u2, u3, partial);
  return cudaGetLastError();
}

// The batched pre-solve for 1 <= nc <= kMaxChains chains, one launch and
// the ordered reduction of the segments: out (nc, R, p0 + p1). Up to 4
// chains take the register-tiled column pass of sweep_common.cuh
// (colpass_k), which is the faster there; 5 to 8 the staged kernel above.
template <typename T0, int R>
cudaError_t tdots_k(const void* X0, int64_t ld0, int p0, const float* X1,
                    int64_t ld1, int p1, int64_t n, int nc, int n_seg,
                    int64_t rows_per_seg, const float* u0, const float* u1,
                    const float* u2, const float* u3, float* partial,
                    float* out, cudaStream_t stream) {
  if (nc < 1 || nc > kMaxChains) return cudaErrorInvalidValue;
  if (nc <= 4)
    return colpass_k<T0, R>(X0, ld0, p0, X1, ld1, p1, n, nc, n_seg,
                            rows_per_seg, u0, u1, u2, u3, partial, out,
                            stream);
  cudaError_t err = launch_tdots_k<T0, R, 8>(
      X0, ld0, p0, X1, ld1, p1, n, nc, n_seg, rows_per_seg, u0, u1, u2, u3,
      partial, stream);
  if (err != cudaSuccess) return err;
  const int64_t width = (int64_t)nc * R * ((int64_t)p0 + p1);
  const int rgrid = (int)min64((width + kThreads - 1) / kThreads, 4096);
  reduce_segments_kernel<<<rgrid, kThreads, 0, stream>>>(partial, n_seg,
                                                         width, out);
  return cudaGetLastError();
}

// ---- The nibble pre-solve: a packed int4 first block (Nib4) beside an
// optional f32 block ----
//
// It replaces the JAX package's _presolve_multirhs over its packed-s4
// block (bayesbridge_tpu/design/sparse.py:1325-1368). The first nibble
// design ran the column pass's tiles (colpass_kernel<Nib4, float, K>:
// 16 columns a lane, u staged 128 rows at a time);
// baselines/presolve_i4_variants.py --baseline times it against this one.
//
// What bounds it on the H100: bytes (the flagship's 4.25 GB, 1.27 ms),
// with the issue slots close behind: the first design spent about 8.4
// instructions an element at five reductions (its 8-byte conversion, 5
// FMAs and the square) and held 217-221 registers, so an SM ran one
// 256-thread CTA and nothing covered the loads that each of its barriers
// (one per 128 rows of u) emptied. The design:
//   - a lane owns 4 bytes (8 columns) of a nibble row and kI4FUnit bytes
//     of an f32 row, at most 5 x 8 accumulators, so the kernel is compiled
//     for kI4MinBlocks CTAs an SM; the f32 tiles share its launch, their
//     memory-bound CTAs beside the nibble tiles' issue-bound ones;
//   - a lane issues the loads of its next kI4Bytes (f32: kI4FBytes) of
//     rows before the arithmetic of the current ones, so its loads stay
//     in flight while it computes;
//   - u1..u4 are staged interleaved (one 16-byte shared load a row)
//     kI4Urows rows at a time: a pair of barriers per kI4Urows rows;
//   - binary (a 0/1 block): the square row is X'u3 (0/1 values are their
//     own squares, as the JAX package reuses its column 3), and an
//     element adds its row's u's under a predicate on its nibble's low
//     bit: fmaf(1, w, a) is a + w rounded, and fmaf(0, w, a) is a for a
//     finite w (a sum that starts at +0 is never -0). About 5
//     instructions an element at five reductions; a non-finite u value
//     reaches only the columns with a 1 in its row.
// Bits: the row segments are the int8 mode's (the caller passes them,
// from the 16-column tiling), each column sums its segment's rows in
// order with the int8 mode's arithmetic, and the ordered second pass
// sums the segments, so both modes give the int8 mode's bits on the
// same values. kernels/layout.py presolve_i4_plan mirrors the geometry;
// bb_tdots_i4_plan reports it.
constexpr int kI4Urows = 1024;   // rows of u staged at a time
constexpr int kI4MinBlocks = 2;  // CTAs an SM is compiled to hold
constexpr int kI4FUnit = 8;      // bytes of an f32 row a lane owns
constexpr int kI4Bytes = 64;     // bytes of the next rows a nibble lane loads
constexpr int kI4FBytes = 128;   // the same for an f32 lane

// A lane's share of a row: `unit` bytes, `cols` columns; `rows` rows a
// load group.
template <typename T> struct I4Lane;
template <> struct I4Lane<Nib4> {
  static constexpr int unit = 4, cols = 8, rows = kI4Bytes / unit;
};
template <> struct I4Lane<float> {
  static constexpr int unit = kI4FUnit, cols = kI4FUnit / 4,
                       rows = kI4FBytes / kI4FUnit;
};

// a_j += b_j for each j where m != 0: predicated adds (add.rn, never
// contracted), one predicate for the row's reductions of one column.
__device__ __forceinline__ void add_if(uint32_t m, float& a0, float& a1,
                                       float& a2, float b0, float b1,
                                       float b2) {
  asm("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %3, 0;\n\t"
      "@p add.rn.f32 %0, %0, %4;\n\t@p add.rn.f32 %1, %1, %5;\n\t"
      "@p add.rn.f32 %2, %2, %6;\n\t}"
      : "+f"(a0), "+f"(a1), "+f"(a2)
      : "r"(m), "f"(b0), "f"(b1), "f"(b2));
}

__device__ __forceinline__ void add_if(uint32_t m, float& a0, float& a1,
                                       float& a2, float& a3, float b0,
                                       float b1, float b2, float b3) {
  asm("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %4, 0;\n\t"
      "@p add.rn.f32 %0, %0, %5;\n\t@p add.rn.f32 %1, %1, %6;\n\t"
      "@p add.rn.f32 %2, %2, %7;\n\t@p add.rn.f32 %3, %3, %8;\n\t}"
      : "+f"(a0), "+f"(a1), "+f"(a2), "+f"(a3)
      : "r"(m), "f"(b0), "f"(b1), "f"(b2), "f"(b3));
}

// Accumulators a lane holds: K, or K - 1 when binary (no square).
template <int K, bool BIN> struct I4Acc {
  static constexpr int value = BIN ? K - 1 : K;
};

// One row of a lane's columns: acc += x * u (u = (u1, u2, u3, u4) of the
// row), the square (X.X)'u3 unless binary.
template <typename T, int K, bool BIN>
__device__ __forceinline__ void i4_row(
    float (&acc)[I4Acc<K, BIN>::value][I4Lane<T>::cols],
    const uint32_t (&q)[I4Lane<T>::unit / 4], float4 w) {
  constexpr int N = I4Lane<T>::cols;
  if constexpr (BIN) {
    static_assert(is_nib<T>, "binary is a nibble block's mode");
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const uint32_t m = q[0] & (1u << (4 * e));
      if constexpr (K == 5)
        add_if(m, acc[0][e], acc[1][e], acc[2][e], acc[3][e], w.x, w.y,
               w.z, w.w);
      else
        add_if(m, acc[0][e], acc[1][e], acc[2][e], w.x, w.y, w.z);
    }
  } else {
    float xs[N];
    if constexpr (is_nib<T>) {
      Nib4::cvt_word(q[0], xs);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) xs[e] = __uint_as_float(q[e]);
    }
#pragma unroll
    for (int e = 0; e < N; ++e) {
      acc[0][e] = fmaf(xs[e], w.x, acc[0][e]);
      acc[1][e] = fmaf(xs[e], w.y, acc[1][e]);
      acc[2][e] = fmaf(xs[e], w.z, acc[2][e]);
      acc[3][e] = fmaf(xs[e] * xs[e], w.z, acc[3][e]);
      if constexpr (K == 5) acc[4][e] = fmaf(xs[e], w.w, acc[4][e]);
    }
  }
}

// One tile of one segment: rows [r0, r1) of the tile's columns of a block
// with row stride `ldb` bytes, to the segment's partial rows (reduction k
// of column j at part[k * p_total + col_off + j]).
template <typename T, int K, bool BIN>
__device__ __forceinline__ void i4_tile(
    const char* __restrict__ X, int64_t ldb, int p, int tile, int64_t r0,
    int64_t r1, const float* __restrict__ u0, const float* __restrict__ u1,
    const float* __restrict__ u2, const float* __restrict__ u3, float4* su,
    float* __restrict__ part, int64_t p_total, int col_off) {
  using L = I4Lane<T>;
  constexpr int N = L::cols, W = L::unit / 4, ROWS = L::rows;
  constexpr int A = I4Acc<K, BIN>::value;
  const int c0 = tile * (kThreads * N) + threadIdx.x * N;
  const char* xb = X + (int64_t)c0 * L::unit / N;  // the lane's column
  float acc[A][N];
#pragma unroll
  for (int a = 0; a < A; ++a)
#pragma unroll
    for (int e = 0; e < N; ++e) acc[a][e] = 0.f;

  for (int64_t rb = r0; rb < r1; rb += kI4Urows) {
    const int cnt = (int)min64(kI4Urows, r1 - rb);
    __syncthreads();
    for (int i = threadIdx.x; i < cnt; i += kThreads) {
      float4 s = make_float4(u0[rb + i], u1[rb + i], u2[rb + i], 0.f);
      if constexpr (K == 5) s.w = u3[rb + i];
      su[i] = s;
    }
    __syncthreads();
    if (c0 < p) {
      // The next group's loads go out before this group's arithmetic, so
      // a lane always has ROWS rows in flight (the chunk's last group
      // loads itself again, from L1).
      const char* xp = xb + rb * ldb;
      const int full = cnt - cnt % ROWS;
      uint32_t q[ROWS][W];
      if (full > 0) {
#pragma unroll
        for (int j = 0; j < ROWS; ++j) load_words<L::unit>(xp + j * ldb, q[j]);
      }
      for (int i = 0; i < full; i += ROWS) {
        const char* nx = i + ROWS < full ? xp + ROWS * ldb : xp;
        uint32_t qn[ROWS][W];
#pragma unroll
        for (int j = 0; j < ROWS; ++j) load_words<L::unit>(nx + j * ldb, qn[j]);
#pragma unroll
        for (int j = 0; j < ROWS; ++j)
          i4_row<T, K, BIN>(acc, q[j], su[i + j]);
#pragma unroll
        for (int j = 0; j < ROWS; ++j)
#pragma unroll
          for (int w = 0; w < W; ++w) q[j][w] = qn[j][w];
        xp = nx;
      }
      for (int i = full; i < cnt; ++i) {
        uint32_t qt[W];
        load_words<L::unit>(xb + (rb + i) * ldb, qt);
        i4_row<T, K, BIN>(acc, qt, su[i]);
      }
    }
  }
  if (c0 < p) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      // Binary: rows 0-2 and 4 from acc 0-2 and 3, the square row from
      // X'u3 (acc 2).
      const int a = !BIN ? k : k < 3 ? k : k == 3 ? 2 : 3;
#pragma unroll
      for (int e = 0; e < N; ++e)
        if (c0 + e < p) part[k * p_total + col_off + c0 + e] = acc[a][e];
    }
  }
}

// Grid: x = the nibble tiles (kThreads * 8 columns each) then the f32
// tiles, y = the row segments. partial: (n_seg, K, p0 + p1) floats.
template <int K, bool BIN>
__global__ void __launch_bounds__(kThreads, kI4MinBlocks) tdots_i4_kernel(
    const uint8_t* __restrict__ X0, int64_t ld0, int p0, int tiles0,
    const float* __restrict__ X1, int64_t ld1, int p1, int64_t n,
    int64_t rows_per_seg, const float* __restrict__ u0,
    const float* __restrict__ u1, const float* __restrict__ u2,
    const float* __restrict__ u3, float* __restrict__ partial) {
  __shared__ float4 su[kI4Urows];
  const int64_t p_total = (int64_t)p0 + p1;
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_seg;
  const int64_t r1 = min64(n, r0 + rows_per_seg);
  float* part = partial + (int64_t)blockIdx.y * K * p_total;
  if ((int)blockIdx.x < tiles0)
    i4_tile<Nib4, K, BIN>(reinterpret_cast<const char*>(X0), ld0, p0,
                          blockIdx.x, r0, r1, u0, u1, u2, u3, su, part,
                          p_total, 0);
  else
    i4_tile<float, K, false>(reinterpret_cast<const char*>(X1), ld1 * 4,
                             p1, blockIdx.x - tiles0, r0, r1, u0, u1, u2,
                             u3, su, part, p_total, p0);
}

constexpr int kI4TileCols0 = kThreads * I4Lane<Nib4>::cols;
constexpr int kI4TileCols1 = kThreads * I4Lane<float>::cols;

// The nibble pre-solve and the ordered reduction of its segments: X0
// packed int4 (ld0 bytes), X1 f32 (ld1 floats) or p1 == 0.
template <int K, bool BIN>
cudaError_t launch_tdots_i4(const void* X0, int64_t ld0, int p0,
                            const float* X1, int64_t ld1, int p1, int64_t n,
                            int n_seg, int64_t rows_per_seg, const float* u0,
                            const float* u1, const float* u2,
                            const float* u3, float* partial, float* out,
                            cudaStream_t stream) {
  const int tiles0 = (p0 + kI4TileCols0 - 1) / kI4TileCols0;
  const int tiles1 = p1 > 0 ? (p1 + kI4TileCols1 - 1) / kI4TileCols1 : 0;
  tdots_i4_kernel<K, BIN><<<dim3(tiles0 + tiles1, n_seg), kThreads, 0,
                            stream>>>(
      static_cast<const uint8_t*>(X0), ld0, p0, tiles0, X1, ld1, p1, n,
      rows_per_seg, u0, u1, u2, u3, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t width = (int64_t)K * ((int64_t)p0 + p1);
  const int rgrid = (int)min64((width + kThreads - 1) / kThreads, 4096);
  reduce_segments_kernel<<<rgrid, kThreads, 0, stream>>>(partial, n_seg,
                                                         width, out);
  return cudaGetLastError();
}

}  // namespace
}  // namespace bbsweep

// C interface (ctypes). dt*: 0 f32, 1 bf16, 2 int8; dt0 also 3, a packed
// int4 block (ld0 in bytes), whose reductions take the nibble pre-solve
// above, beside an f32 X1 (or p1 == 0); `binary` 1 (a 0/1 packed block
// only) takes its binary mode, whose square row is X'u3, and must be 0
// for other blocks. p1 == 0 means one block; u4 == NULL means four
// reductions (K = 4), else five. The segments (n_seg of rows_per_seg
// rows) are the int8 mode's. partial: n_seg * K * (p0 + p1) floats; out:
// (K, p0 + p1) floats, row k holding reduction k for block 0's columns
// then block 1's.
// Returns the CUDA error of the launches (0 = ok).
extern "C" int bb_tdots_sweep(int dt0, const void* X0, long long ld0,
                              int p0, int dt1, const void* X1,
                              long long ld1, int p1, long long n,
                              const float* u1, const float* u2,
                              const float* u3, const float* u4, int binary,
                              int n_seg, long long rows_per_seg,
                              float* partial, float* out, void* stream) {
  using namespace bbsweep;
  auto s = static_cast<cudaStream_t>(stream);
  if (binary < 0 || binary > 1 || (binary && dt0 != DT_I4))
    return (int)cudaErrorInvalidValue;
  if (dt0 == DT_I4) {
    if (p1 > 0 && dt1 != DT_F32) return (int)cudaErrorInvalidValue;
    const auto* X1f = static_cast<const float*>(X1);
#define BB_TD_I4(K, BIN)                                                   \
  return (int)launch_tdots_i4<K, BIN>(X0, ld0, p0, X1f, ld1, p1, n, n_seg, \
                                      rows_per_seg, u1, u2, u3, u4,        \
                                      partial, out, s)
    if (u4 == nullptr) {
      if (binary) BB_TD_I4(4, true);
      BB_TD_I4(4, false);
    }
    if (binary) BB_TD_I4(5, true);
    BB_TD_I4(5, false);
#undef BB_TD_I4
  }
  if (u4 == nullptr) {
    BB_DISPATCH(dt0, T0, BB_DISPATCH(dt1, T1,
        launch_colpass<T0, T1, 4>(X0, ld0, p0, X1, ld1, p1, n, n_seg,
                                  rows_per_seg, u1, u2, u3, nullptr,
                                  partial, out, s);
        return (int)cudaGetLastError()));
  }
  BB_DISPATCH(dt0, T0, BB_DISPATCH(dt1, T1,
      launch_colpass<T0, T1, 5>(X0, ld0, p0, X1, ld1, p1, n, n_seg,
                                rows_per_seg, u1, u2, u3, u4, partial, out,
                                s);
      return (int)cudaGetLastError()));
}

// The nibble pre-solve's geometry (kernels/layout.py presolve_i4_plan
// mirrors it): field 0 the rows of u staged at a time, 1 the columns of
// a nibble tile, 2 of an f32 tile, 3 the CTAs an SM is compiled for, 4
// the static shared memory of a CTA in bytes; -1 for another field.
extern "C" int bb_tdots_i4_plan(int field) {
  using namespace bbsweep;
  switch (field) {
    case 0: return kI4Urows;
    case 1: return kI4TileCols0;
    case 2: return kI4TileCols1;
    case 3: return kI4MinBlocks;
    case 4: return (int)(kI4Urows * sizeof(float4));
    default: return -1;
  }
}

// The chain-batched pre-solve reductions for nc chains: u1..u4 (nc, n)
// each (u4 NULL: four reductions, R = 4, else R = 5); out (nc, R, p0 +
// p1), out[c, r] holding reduction r of chain c for block 0's columns
// then block 1's; partial n_seg * nc * R * (p0 + p1) floats, the segments
// those of the single-vector launch. X1 is f32 (or p1 == 0). nc at most
// bb_max_chains(R, dt0), 8: one launch.
extern "C" int bb_tdots_sweep_k(int dt0, const void* X0, long long ld0,
                                int p0, const float* X1, long long ld1,
                                int p1, long long n, int nc, const float* u1,
                                const float* u2, const float* u3,
                                const float* u4, int n_seg,
                                long long rows_per_seg, float* partial,
                                float* out, void* stream) {
  using namespace bbsweep;
  auto s = static_cast<cudaStream_t>(stream);
  if (u4 == nullptr) {
    BB_DISPATCH(dt0, T0,
        return (int)tdots_k<T0, 4>(X0, ld0, p0, X1, ld1, p1, n, nc, n_seg,
                                   rows_per_seg, u1, u2, u3, nullptr,
                                   partial, out, s));
  }
  BB_DISPATCH(dt0, T0,
      return (int)tdots_k<T0, 5>(X0, ld0, p0, X1, ld1, p1, n, nc, n_seg,
                                 rows_per_seg, u1, u2, u3, u4, partial, out,
                                 s));
}

// CTAs of the batched pre-solve (R = 4 or 5 reductions) for nc chains
// that one SM holds at once; -1 for an invalid count.
extern "C" int bb_tdots_k_occupancy(int R, int dt0, int nc) {
  using namespace bbsweep;
  if (nc < 1 || nc > kMaxChains || (R != 4 && R != 5)) return -1;
  int blocks = -1;
  auto fit = [&](auto kern, int threads, int smem) {
    if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, threads,
                                                      smem) != cudaSuccess)
      blocks = -1;
  };
  const int C = chains_for(nc);
#define BB_TD_FIT(RR)                                                      \
  BB_DISPATCH(dt0, T,                                                      \
      if (C == 1) fit(colpass_k_kernel<T, RR, 1>, kThreads, 0);            \
      else if (C == 2) fit(colpass_k_kernel<T, RR, 2>, kThreads, 0);       \
      else if (C == 4) fit(colpass_k_kernel<T, RR, 4>, kThreads, 0);       \
      else fit(tdots_k_kernel<T, RR, 8>, kTdThreads, td_smem<T, RR, 8>()); \
      return blocks)
  if (R == 4) BB_TD_FIT(4);
  BB_TD_FIT(5);
#undef BB_TD_FIT
}
