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
// bb_tdots_sweep_k runs the same reductions for up to 8 Markov chains per
// read of X (the JAX package's vmap of fused_tdots over its chains): the
// column pass of sweep_common.cuh with R = 4 or 5 reductions for each of
// C chains, each chain's columns equal to its single-vector launch bit
// for bit. Its threads own narrower units of a row (8 bytes of f32, 4 of
// bf16 or int8) so that C * R accumulators per column fit; an int8 block
// takes 4 chains per read, bf16 and f32 blocks 8 (ColPlan).

#include "sweep_common.cuh"

// C interface (ctypes). dt*: 0 f32, 1 bf16, 2 int8; p1 == 0 means one
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

// The chain-batched pre-solve reductions for nc chains: u1..u4 (nc, n)
// each (u4 NULL: four reductions, R = 4, else R = 5); out (nc, R, p0 +
// p1), out[c, r] holding reduction r of chain c for block 0's columns
// then block 1's; partial n_seg * nc * R * (p0 + p1) floats, the segments
// those of the single-vector launch. X1 is f32 (or p1 == 0). nc at most
// bb_max_chains(R, dt0).
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
        return (int)colpass_k<T0, 4>(X0, ld0, p0, X1, ld1, p1, n, nc, n_seg,
                                     rows_per_seg, u1, u2, u3, nullptr,
                                     partial, out, s));
  }
  BB_DISPATCH(dt0, T0,
      return (int)colpass_k<T0, 5>(X0, ld0, p0, X1, ld1, p1, n, nc, n_seg,
                                   rows_per_seg, u1, u2, u3, u4, partial,
                                   out, s));
}
