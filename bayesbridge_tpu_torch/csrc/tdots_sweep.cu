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
// The square moment is always computed from the loaded values, also for
// 0/1 blocks (the composed JAX path reuses X'u3 there; the fused kernel
// never did). With u4, an int8 thread holds 5 x 16 float accumulators
// (80 registers against 64 for four reductions); -Xptxas -v reports the
// build's registers and spills.
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

}  // namespace
}  // namespace bbsweep

// C interface (ctypes). dt*: 0 f32, 1 bf16, 2 int8; dt0 also 3, a packed
// int4 block (ld0 in bytes), the nibble mode: col_tile_i4 with int8's
// tiles, segments and 80 accumulators at five reductions, which replaces
// the JAX package's _presolve_multirhs over the packed-s4 block
// (bayesbridge_tpu/design/sparse.py:1325-1368; its squares, at most 64,
// exact here as in f32). p1 == 0 means one
// block; u4 == NULL means four reductions (K = 4), else five. partial:
// n_seg * K * (p0 + p1) floats; out: (K, p0 + p1) floats, row k holding
// reduction k for block 0's columns then block 1's.
// Returns the CUDA error of the launches (0 = ok).
extern "C" int bb_tdots_sweep(int dt0, const void* X0, long long ld0,
                              int p0, int dt1, const void* X1,
                              long long ld1, int p1, long long n,
                              const float* u1, const float* u2,
                              const float* u3, const float* u4, int n_seg,
                              long long rows_per_seg, float* partial,
                              float* out, void* stream) {
  using namespace bbsweep;
  auto s = static_cast<cudaStream_t>(stream);
  if (u4 == nullptr) {
    BB_DISPATCH_I4(dt0, T0, BB_DISPATCH(dt1, T1,
        launch_colpass<T0, T1, 4>(X0, ld0, p0, X1, ld1, p1, n, n_seg,
                                  rows_per_seg, u1, u2, u3, nullptr,
                                  partial, out, s);
        return (int)cudaGetLastError()));
  }
  BB_DISPATCH_I4(dt0, T0, BB_DISPATCH(dt1, T1,
      launch_colpass<T0, T1, 5>(X0, ld0, p0, X1, ld1, p1, n, n_seg,
                                rows_per_seg, u1, u2, u3, u4, partial, out,
                                s);
      return (int)cudaGetLastError()));
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
