// Pre-solve reductions over one or two row-aligned design blocks (int8,
// bf16 or f32 storage, f32 accumulation): per block, from one read of X,
//
//   X'u1,  X'u2,  X'u3,  (X.X)'u3
//
// the collapsed-observation Tdot, the CG b-vector noise Tdot, the weighted
// column sums and the Jacobi preconditioner's second moment.
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
// never did).

#include "sweep_common.cuh"

// C interface (ctypes). dt*: 0 f32, 1 bf16, 2 int8; p1 == 0 means one
// block. partial: n_seg * 4 * (p0 + p1) floats; out: (4, p0 + p1) floats,
// row k holding reduction k for block 0's columns then block 1's.
// Returns the CUDA error of the launches (0 = ok).
extern "C" int bb_tdots_sweep(int dt0, const void* X0, long long ld0,
                              int p0, int dt1, const void* X1,
                              long long ld1, int p1, long long n,
                              const float* u1, const float* u2,
                              const float* u3, int n_seg,
                              long long rows_per_seg, float* partial,
                              float* out, void* stream) {
  using namespace bbsweep;
  auto s = static_cast<cudaStream_t>(stream);
  BB_DISPATCH(dt0, T0, BB_DISPATCH(dt1, T1,
      launch_colpass<T0, T1, 4>(X0, ld0, p0, X1, ld1, p1, n, n_seg,
                                rows_per_seg, u1, u2, u3, partial, out, s);
      return (int)cudaGetLastError()));
}
