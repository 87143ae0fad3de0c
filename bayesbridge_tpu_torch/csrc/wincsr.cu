// Windowed-CSR matvec (the winell backend's product on the card):
//
//   out[row] = sum_w sum_{e in seg(w, row)} x_e * v[w * window + idx_e]
//   seg(w, row) = entries ptr[w * n_out + row] .. ptr[w * n_out + row + 1]
//   x = val (or val^2 with square)
//
// idx is a uint16 window-local input position, val f32; every segment is
// padded with (0, 0.f) to a multiple of 8 entries and starts on a
// multiple of 8, so eight indices are one aligned 16-byte load and eight
// values two (bayesbridge_tpu_torch/design/wincsr.py builds the layout).
//
// Replaces, on the winell design's path, the TPU kernel
// bayesbridge_tpu/design/winell.py:_winell_kernel (csrc/winell.cu keeps
// its port). That packing pads every (1,024-input window, 128-output
// tile) cell to K slots for Mosaic's in-register gather: 6 B per slot at
// 32% occupancy on the 131,072 x 16,384 design, a floor above cuSPARSE's
// 8 B per nonzero. Here a window spans up to 65,536 inputs (a 16-bit
// local index), so each nonzero costs 6 B and the padding to 8 entries a
// few percent.
//
// What bounds it on the H100: bytes (6 B per nonzero for one gather and
// one FMA). Blocks of 256 threads own contiguous rows; a group of G
// lanes (4..32, from the mean segment length) owns one row at a time and
// walks its segment in 8-entry chunks, two chunks in flight per lane,
// and gathers the window's inputs through the L2 cache with __ldg (v
// stays resident in the 50 MB L2; staging each window in shared memory
// instead was slower on both orientations, PERF.md). Blocks are as many
// as fit on the card at once. A row's windows are summed in window
// order by the same lanes, the lanes' shares by a fixed butterfly: no
// float atomics, and two runs give the same bits.

#include "sweep_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRowsPerGroup = 16;

// sum += x . v[idx] over one 8-entry chunk at entry k.
template <bool kSquare>
__device__ __forceinline__ float chunk_dot(const uint16_t* __restrict__ idx,
                                           const float* __restrict__ val,
                                           const float* src, int64_t k,
                                           float sum) {
  const uint4 iq = __ldg(reinterpret_cast<const uint4*>(idx + k));
  const float4 a = __ldg(reinterpret_cast<const float4*>(val + k));
  const float4 b = __ldg(reinterpret_cast<const float4*>(val + k + 4));
  const uint32_t w[4] = {iq.x, iq.y, iq.z, iq.w};
  const float x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t i = (w[j >> 1] >> (16 * (j & 1))) & 0xFFFFu;
    const float xv = kSquare ? x[j] * x[j] : x[j];
    sum = fmaf(xv, __ldg(src + i), sum);
  }
  return sum;
}

// Grid: blocks of `rows_per_block` contiguous rows. Group g of G lanes
// takes rows r0 + g + j * (kThreads / G), j < kMaxRowsPerGroup.
template <int G, bool kSquare>
__global__ void __launch_bounds__(kThreads) wincsr_kernel(
    const int64_t* __restrict__ ptr, const uint16_t* __restrict__ idx,
    const float* __restrict__ val, const float* __restrict__ v,
    int window, int n_win, int n_out, int rows_per_block,
    float* __restrict__ out) {
  constexpr int NG = kThreads / G;
  const int lane = threadIdx.x % G, grp = threadIdx.x / G;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(n_out, r0 + rows_per_block);
  float acc[kMaxRowsPerGroup];
#pragma unroll
  for (int j = 0; j < kMaxRowsPerGroup; ++j) acc[j] = 0.f;

  for (int w = 0; w < n_win; ++w) {
    const float* src = v + (int64_t)w * window;
    const int64_t* p = ptr + (int64_t)w * n_out;
#pragma unroll
    for (int j = 0; j < kMaxRowsPerGroup; ++j) {
      const int row = r0 + grp + j * NG;
      if (r0 + j * NG >= r1) break;  // uniform over the block
      int64_t s = 0, e = 0;
      if (row < r1) {
        s = p[row];
        e = p[row + 1];
      }
      float sum = 0.f;
      for (int64_t k = s + 8 * lane; k < e; k += 16 * G) {
        sum = chunk_dot<kSquare>(idx, val, src, k, sum);
        if (k + 8 * G < e)
          sum = chunk_dot<kSquare>(idx, val, src, k + 8 * G, sum);
      }
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off, G);
      acc[j] += sum;
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxRowsPerGroup; ++j) {
    const int row = r0 + grp + j * NG;
    if (lane == 0 && row < r1) out[row] = acc[j];
  }
}

template <int G, bool kSquare>
cudaError_t launch(const int64_t* ptr, const uint16_t* idx, const float* val,
                   const float* v, int window, int n_win, int n_out,
                   float* out, cudaStream_t s) {
  auto kern = wincsr_kernel<G, kSquare>;
  // The occupancy query costs the host more than this kernel takes on
  // the card: keep it per device of this instantiation.
  static int last_dev = -1, sms = 0, per_sm = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != last_dev) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        kThreads, 0);
    if (err != cudaSuccess) return err;
    last_dev = dev;
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // As many blocks as the card holds at once, each with at most
  // kMaxRowsPerGroup rows per group.
  const int max_rows = (kThreads / G) * kMaxRowsPerGroup;
  int grid = per_sm * sms;
  int rows = (n_out + grid - 1) / grid;
  if (rows > max_rows) rows = max_rows;
  grid = (n_out + rows - 1) / rows;
  kern<<<grid, kThreads, 0, s>>>(ptr, idx, val, v, window, n_win, n_out,
                                 rows, out);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_g(const int64_t* ptr, const uint16_t* idx,
                     const float* val, const float* v, int window, int n_win,
                     int n_out, int square, float* out, cudaStream_t s) {
  return square ? launch<G, true>(ptr, idx, val, v, window, n_win, n_out,
                                  out, s)
                : launch<G, false>(ptr, idx, val, v, window, n_win, n_out,
                                   out, s);
}

}  // namespace

// C interface (ctypes). ptr: n_win * n_out + 1 int64 entry offsets (each
// a multiple of 8); idx / val: the entries; v: n_in floats, read up to
// the last window's stored indices (padding reads v[window start]);
// out: n_out floats. lanes: 4, 8, 16 or 32 per row. Returns the CUDA
// error of the launch (0 = ok).
extern "C" int bb_wincsr(const int64_t* ptr, const int16_t* idx,
                         const float* val, const float* v, int window,
                         int n_win, int n_out, int lanes, int square,
                         float* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto ix = reinterpret_cast<const uint16_t*>(idx);
  if (window <= 0 || window > 65536 || window % 8 || n_out <= 0)
    return (int)cudaErrorInvalidValue;
  switch (lanes) {
    case 4: return (int)launch_g<4>(ptr, ix, val, v, window, n_win, n_out,
                                     square, out, s);
    case 8: return (int)launch_g<8>(ptr, ix, val, v, window, n_win, n_out,
                                     square, out, s);
    case 16: return (int)launch_g<16>(ptr, ix, val, v, window, n_win, n_out,
                                       square, out, s);
    case 32: return (int)launch_g<32>(ptr, ix, val, v, window, n_win, n_out,
                                       square, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
