// Windowed-ELL matvec (the winell backend):
//
//   out[tile*128 + lane] = sum_w sum_slot x[r, lane] * v[w*W + idx[r, lane]]
//   r = (w * T + tile) * K + slot,   x = val (or val^2 with square)
//
// idx (int16, window-local input position) and val (f32) are (Wn*T*K, 128)
// row-major, as the host packer lays them out; empty slots hold idx 0 and
// val 0 and add 0 * v[window*W], exactly 0 for finite v. The design keeps
// two packings, so this one kernel serves X v, X' u and, with `square`,
// the Fisher diagonal's second moment.
//
// Replaces the TPU kernel bayesbridge_tpu/design/winell.py:_winell_kernel
// (launched by winell_matvec), whose per-128-lane dynamic_gather and
// select chain existed only for Mosaic's in-register gather.
//
// What bounds it on the H100: bytes. Each slot is 6 stored bytes for one
// gather and one FMA, so the floor is the packing's bytes over 3.35 TB/s.
// A block of 256 threads owns two output tiles, one thread per
// (tile, lane), and walks a contiguous range of input windows in order:
// it stages v[window] (W <= 1,024 floats) in shared memory, then each
// thread loads its K slots' idx and val (a warp reads 64 + 128 contiguous
// bytes per slot), gathers from the staged window and accumulates. The
// X' u orientation has few output tiles (128 at the 131,072 x 16,384
// design), so the windows are split over blocks too: each split writes a
// partial and an ordered second pass sums them. No float atomics, so two
// runs give the same bits.

#include "sweep_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLane = 128;
constexpr int kTiles = kThreads / kLane;  // output tiles per block
constexpr int kMaxW = 1024;
constexpr int kUnroll = 16;               // K is a multiple of this

// Grid: x = groups of kTiles output tiles, y = window splits of
// `win_per_split` windows. Writes out[y * ld_out + m] for m < n_out.
template <bool kSquare>
__global__ void __launch_bounds__(kThreads) winell_kernel(
    const int16_t* __restrict__ idx, const float* __restrict__ val,
    const float* __restrict__ v, int64_t n_in, int W, int K, int T, int Wn,
    int win_per_split, int n_out, float* __restrict__ out, int64_t ld_out) {
  __shared__ float vs[kMaxW];
  const int tile = blockIdx.x * kTiles + threadIdx.x / kLane;
  const int lane = threadIdx.x % kLane;
  const bool active = tile < T;
  const int w0 = blockIdx.y * win_per_split;
  const int w1 = min(Wn, w0 + win_per_split);
  float acc = 0.f;
  for (int w = w0; w < w1; ++w) {
    const int64_t base = (int64_t)w * W;
    __syncthreads();  // the previous window's gathers are done
    for (int j = threadIdx.x; j < W; j += kThreads)
      vs[j] = base + j < n_in ? v[base + j] : 0.f;
    __syncthreads();
    if (!active) continue;
    const int64_t r0 = ((int64_t)w * T + tile) * K;
    const int16_t* ip = idx + r0 * kLane + lane;
    const float* xp = val + r0 * kLane + lane;
    float s = 0.f;  // this window's sum over slots, then added to acc
    for (int k = 0; k < K; k += kUnroll) {
      int16_t ii[kUnroll];
      float xx[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        ii[j] = __ldg(ip + (int64_t)(k + j) * kLane);
        xx[j] = __ldg(xp + (int64_t)(k + j) * kLane);
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const float x = kSquare ? xx[j] * xx[j] : xx[j];
        s = fmaf(x, vs[ii[j]], s);
      }
    }
    acc += s;
  }
  if (!active) return;
  const int m = tile * kLane + lane;
  if (m < n_out) out[(int64_t)blockIdx.y * ld_out + m] = acc;
}

}  // namespace

// C interface (ctypes). idx/val: (Wn * T * K, 128); v: n_in floats; out:
// n_out floats, n_out <= T * 128. W <= 1024, K a multiple of 16. With
// n_split > 1, partial holds n_split * n_out floats summed in order into
// out by a second pass; with n_split == 1 the kernel writes out directly.
// Returns the CUDA error of the launches (0 = ok).
extern "C" int bb_winell(const int16_t* idx, const float* val,
                         const float* v, long long n_in, int W, int K,
                         int T, int Wn, int square, int n_out, int n_split,
                         int win_per_split, float* partial, float* out,
                         void* stream) {
  if (W > kMaxW || W <= 0 || K % kUnroll != 0)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  dim3 grid((T + kTiles - 1) / kTiles, n_split);
  float* dst = n_split > 1 ? partial : out;
  if (square)
    winell_kernel<true><<<grid, kThreads, 0, s>>>(
        idx, val, v, n_in, W, K, T, Wn, win_per_split, n_out, dst, n_out);
  else
    winell_kernel<false><<<grid, kThreads, 0, s>>>(
        idx, val, v, n_in, W, K, T, Wn, win_per_split, n_out, dst, n_out);
  if (n_split > 1) {
    const int rgrid = (int)bbsweep::min64((n_out + 255) / 256, 4096);
    bbsweep::reduce_segments_kernel<<<rgrid, bbsweep::kThreads, 0, s>>>(
        partial, n_split, n_out, out);
  }
  return (int)cudaGetLastError();
}
