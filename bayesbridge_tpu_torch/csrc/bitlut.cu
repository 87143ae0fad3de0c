// Byte-LUT matvec over a bitpacked 0/1 matrix (the bitpack backend):
//
//   lut[g, B] = sum_b bit_b(B) * v[8g + b]      (b ascending)
//   out[m]    = sum_g lut[g, bits[g, m]]
//
// bits is (g_pad, m_pad) uint8, row-major, one byte per (byte-group g,
// output m); the design keeps it in two orientations, so this one kernel
// serves both X v (bits_col) and X' u (bits_row).
//
// Replaces the TPU kernel bayesbridge_tpu/design/bitlut.py:_lut_kernel
// (launched by bitpacked_matvec), whose lo/hi 128-lane split of the table
// existed only for Mosaic's in-register gather.
//
// What bounds it on the H100: bytes. Each stored byte (8 matrix elements)
// is read once for one shared-memory lookup and one add, far below the
// card's operation rate per byte, so the floor is the bytes of the
// bitmap's live columns (m < n_out; the padding past them is never read)
// over 3.35 TB/s. A block owns 4,096 consecutive outputs (16 per thread,
// one 16-byte load per byte-group row, a warp reading 512 contiguous bytes)
// and a contiguous range of byte-groups, taken 32 at a time: the block
// builds those 32 groups' tables in shared memory (32 KB), then streams
// their rows of bits. Lookups land on random banks; the conflicts are
// accepted. The group ranges of one output tile are summed by an ordered
// second pass, so there are no float atomics and two runs give the same
// bits. Offsets are 64-bit: one bitmap can exceed 2^31 bytes.

#include "sweep_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kOutPerThread = 16;                    // one uint4 of bytes
constexpr int kTileOut = kThreads * kOutPerThread;   // outputs per block
constexpr int kGroups = 32;                          // tables per chunk

__device__ __forceinline__ uint4 load_row(const uint8_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// acc[4k + s] += L[byte s of word k]: one table row, 16 outputs.
__device__ __forceinline__ void add_row(const float* L, uint4 q,
                                        float (&acc)[kOutPerThread]) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int s = 0; s < 4; ++s) acc[4 * k + s] += L[(w[k] >> (8 * s)) & 0xFF];
}

// Grid: x = output tiles of kTileOut, y = group splits of
// `chunks_per_split` chunks of kGroups groups. Writes out[y * ld_out + m]
// for m < n_out.
__global__ void __launch_bounds__(kThreads) bitlut_kernel(
    const uint8_t* __restrict__ bits, int64_t m_pad, int g_pad,
    const float* __restrict__ v, int chunks_per_split, int n_out,
    float* __restrict__ out, int64_t ld_out) {
  __shared__ float lut[kGroups * 256];
  __shared__ float vs[kGroups * 8];
  const int64_t m0 =
      (int64_t)blockIdx.x * kTileOut + (int64_t)threadIdx.x * kOutPerThread;
  // Only threads with a live output read: m0 is a multiple of 16 and
  // n_out <= m_pad, a multiple of 128, so their 16 bytes lie in the row.
  const bool active = m0 < n_out;
  float acc[kOutPerThread];
#pragma unroll
  for (int e = 0; e < kOutPerThread; ++e) acc[e] = 0.f;

  const int n_chunks = (g_pad + kGroups - 1) / kGroups;
  const int c0 = blockIdx.y * chunks_per_split;
  const int c1 = min(n_chunks, c0 + chunks_per_split);
  for (int c = c0; c < c1; ++c) {
    const int g0 = c * kGroups;
    const int cnt = min(kGroups, g_pad - g0);
    __syncthreads();  // the previous chunk's lookups are done
    if (threadIdx.x < cnt * 8)
      vs[threadIdx.x] = v[(int64_t)g0 * 8 + threadIdx.x];
    __syncthreads();
    // Thread t builds entry B = t of every table, summing its set bits in
    // ascending b from 0 (the plain version's order).
    const int B = threadIdx.x;
    for (int gl = 0; gl < cnt; ++gl) {
      float s = 0.f;
#pragma unroll
      for (int b = 0; b < 8; ++b)
        if ((B >> b) & 1) s += vs[gl * 8 + b];
      lut[gl * 256 + B] = s;
    }
    __syncthreads();
    if (!active) continue;
    const uint8_t* bp = bits + (int64_t)g0 * m_pad + m0;
    int gl = 0;
    // Four rows' loads in flight before their lookups.
    for (; gl + 4 <= cnt; gl += 4) {
      uint4 q[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        q[j] = load_row(bp + (int64_t)(gl + j) * m_pad);
#pragma unroll
      for (int j = 0; j < 4; ++j) add_row(lut + (gl + j) * 256, q[j], acc);
    }
    for (; gl < cnt; ++gl)
      add_row(lut + gl * 256, load_row(bp + (int64_t)gl * m_pad), acc);
  }
  if (!active) return;
  float* o = out + (int64_t)blockIdx.y * ld_out;
#pragma unroll
  for (int e = 0; e < kOutPerThread; ++e)
    if (m0 + e < n_out) o[m0 + e] = acc[e];
}

}  // namespace

// C interface (ctypes). bits: (g_pad, m_pad) uint8 with m_pad a multiple
// of 128 and a 16-byte aligned base; v: 8 * g_pad floats; out: n_out
// floats. With n_split > 1, partial holds n_split * n_out floats and an
// ordered second pass sums the splits into out; with n_split == 1 the
// kernel writes out directly. Returns the CUDA error of the launches.
extern "C" int bb_bitlut(const uint8_t* bits, long long g_pad,
                         long long m_pad, const float* v, int n_out,
                         int n_split, int chunks_per_split, float* partial,
                         float* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int m_tiles = (n_out + kTileOut - 1) / kTileOut;  // live tiles
  dim3 grid(m_tiles, n_split);
  float* dst = n_split > 1 ? partial : out;
  bitlut_kernel<<<grid, kThreads, 0, s>>>(bits, m_pad, (int)g_pad, v,
                                          chunks_per_split, n_out, dst,
                                          n_out);
  if (n_split > 1) {
    const int rgrid = (int)bbsweep::min64((n_out + 255) / 256, 4096);
    bbsweep::reduce_segments_kernel<<<rgrid, bbsweep::kThreads, 0, s>>>(
        partial, n_split, n_out, out);
  }
  return (int)cudaGetLastError();
}
