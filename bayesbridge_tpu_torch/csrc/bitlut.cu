// LUT matvec over a bitpacked 0/1 matrix (the bitpack backend):
//
//   lo[g, i]  = sum_b bit_b(i) * v[8g + b]          (b = 0..3 ascending)
//   hi[g, i]  = sum_b bit_b(i) * v[8g + 4 + b]      (i < 16)
//   out[m]    = sum_g (lo[g, B & 15] + hi[g, B >> 4]),  B = bits[g, m]
//
// bits is (g_pad, m_pad) uint8, row-major, one byte per (byte-group g,
// output m); the design keeps it in two orientations, so this one kernel
// serves both X v (bits_col) and X' u (bits_row).
//
// Replaces the TPU kernel bayesbridge_tpu/design/bitlut.py:_lut_kernel
// (launched by bitpacked_matvec), whose lo/hi 128-lane split of a byte's
// 256-entry table existed only for Mosaic's in-register gather.
//
// What bounds it on the H100: bytes. Each stored byte (8 matrix elements)
// is read once for two table lookups and two adds, so the floor is the
// bytes of the bitmap's live columns (m < n_out; the padding past them is
// never read) over 3.35 TB/s. A block owns 4,096 consecutive outputs (16
// per consumer thread, one 16-byte load per byte-group row, a warp
// reading 512 contiguous bytes) and a contiguous range of byte-groups.
// What the design does about the rest:
//
// * Lookups without bank conflicts. A byte's 256-entry table (the first
//   design, kept below as the 'byte' mode) sits entry B on bank B mod 32,
//   and 0/1 data at low density makes most bytes 0 or a single bit (1,
//   2, ..., 128): 0, 32, 64 and 128 pile onto bank 0 and a warp's lookup
//   replays once per distinct address on its busiest bank. Here each
//   group has two 16-entry nibble tables, lo on banks 0-15 and hi on
//   16-31; a warp's 32 lookups into one table hit distinct banks or the
//   same word, whatever the data: 2 wavefronts per 32 bytes, the address
//   of each formed by one byte permute. At the flagship bitmaps on the
//   H100 this took 0.27 ms against the byte table's 0.34-0.36 in turns
//   (PERF.md; baselines/bitlut_ablation.py times each part).
// * Tables built once per call. A pre-pass writes every group's 32
//   floats (128 B) to global memory; blocks copy them, 32 groups (4 KB)
//   at a time, instead of rebuilding a 32 KB table chunk per output tile.
// * The byte stream stays in flight. A producer warp keeps a ring of
//   kStages table chunks in flight with bulk asynchronous copies (TMA),
//   counted on a "full" mbarrier per stage; each consumer warp releases a
//   stage on its "empty" mbarrier when done with it. The consumers keep
//   kAhead rows' 16-byte loads in flight across chunk boundaries, issued
//   before they wait for the next chunk's tables. No block-wide barrier
//   after the start.
//
// The group ranges of one output tile are summed by an ordered second
// pass, so there are no float atomics and two runs give the same bits.
// Offsets are 64-bit: one bitmap can exceed 2^31 bytes.
//
// Modes (bb_bitlut's `mode`): 0 the design's kernel; the rest exist for
// baselines/bitlut_ablation.py and the smoke's in-turns timing only: 1
// the first design's byte-table kernel; 2 the nibble tables read through
// L1/L2 by __ldg instead of staged (no producer work); 3 no lookup (the
// bytes loaded and summed as floats, the staging kept): its results mean
// nothing, only its time.

#include "mbarrier.cuh"
#include "sweep_common.cuh"

namespace bbbitlut {
namespace {

using namespace bbasync;

constexpr int kThreads = 256;                        // consumer threads
constexpr int kOutPerThread = 16;                    // one uint4 of bytes
constexpr int kTileOut = kThreads * kOutPerThread;   // outputs per block
constexpr int kGroups = 32;                          // groups per chunk
constexpr int kNib = 32;            // floats per group: lo[16], hi[16]
constexpr int kChunk = kGroups * kNib;               // floats per chunk
constexpr int kStages = 4;                           // staged chunks
constexpr int kAhead = 4;                            // rows loaded ahead
static_assert(kGroups % kAhead == 0 && kAhead % 2 == 0,
              "a chunk holds whole steps of row pairs");

enum Mode { kStaged = 0, kByte = 1, kFromL2 = 2, kNoLookup = 3 };

__device__ __forceinline__ uint4 load_row(const uint8_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// Every group's two nibble tables, entry i of each summed over its set
// bits in ascending order from 0 (the plain version's order).
__global__ void __launch_bounds__(256) nibble_tables_kernel(
    const float* __restrict__ v, int64_t g_pad, float* __restrict__ tab) {
  const int64_t i = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= g_pad * kNib) return;
  const int e = (int)(i % kNib);
  const float* vg = v + (i / kNib) * 8 + (e >= 16 ? 4 : 0);
  float s = 0.f;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if ((e >> b) & 1) s += vg[b];
  tab[i] = s;
}

__device__ __forceinline__ float lds(uint32_t addr) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x) : "r"(addr));
  return x;
}

// acc[4k + s] += lo[byte & 15] + hi[byte >> 4] for byte s of word k: one
// table row, 16 outputs. Staged (kStaged): `base` is the shared address
// of the row's lo table (hi follows at +64 B); the ring is 256-byte
// aligned and a row takes 128 B, so base's low byte is kOdd * 128 and
// each lookup's address is base's upper three bytes beside one byte
// permuted out of the word (the nibble times 4 plus that low byte): one
// PRMT per address. kFromL2: T points at the row's tables in global
// memory. kNoLookup: each byte as a float (one byte permute) instead.
template <int kMode, int kOdd>
__device__ __forceinline__ void add_row(const float* T, uint32_t base,
                                        uint4 q,
                                        float (&acc)[kOutPerThread]) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (kMode == kNoLookup) {
#pragma unroll
      for (int s = 0; s < 4; ++s)  // 2^23 + byte
        acc[4 * k + s] +=
            __int_as_float(__byte_perm(w[k], 0x4B000000u, 0x7540u + s));
    } else if constexpr (kMode == kFromL2) {
      const uint32_t lo = w[k] & 0x0F0F0F0Fu;
      const uint32_t hi = (w[k] >> 4) & 0x0F0F0F0Fu;
#pragma unroll
      for (int s = 0; s < 4; ++s)
        acc[4 * k + s] += __ldg(T + ((lo >> (8 * s)) & 0xFF)) +
                          __ldg(T + 16 + ((hi >> (8 * s)) & 0xFF));
    } else {
      constexpr uint32_t kLo = kOdd ? 0x80808080u : 0u;
      constexpr uint32_t kHi = kLo | 0x40404040u;
      const uint32_t lo = ((w[k] << 2) & 0x3C3C3C3Cu) | kLo;
      const uint32_t hi = ((w[k] >> 2) & 0x3C3C3C3Cu) | kHi;
#pragma unroll
      for (int s = 0; s < 4; ++s)
        acc[4 * k + s] += lds(__byte_perm(lo, base, 0x7650u + s)) +
                          lds(__byte_perm(hi, base, 0x7650u + s));
    }
  }
}

// Row r's lookups from its bytes in q, whose register then takes the
// load of row r + kAhead.
template <int kMode, int kOdd>
__device__ __forceinline__ void row_step(uint4& q, const uint8_t* bp,
                                         int64_t m_pad, int r, int rows,
                                         bool active, const float* T,
                                         uint32_t base,
                                         float (&acc)[kOutPerThread]) {
  const uint4 cur = q;
  q = active && r + kAhead < rows ? load_row(bp + (r + kAhead) * m_pad)
                                  : make_uint4(0, 0, 0, 0);
  if (active && r < rows) add_row<kMode, kOdd>(T, base, cur, acc);
}

// Grid: x = output tiles of kTileOut, y = group splits of
// `chunks_per_split` chunks of kGroups groups. Block: kThreads consumers
// and one producer warp. Writes out[y * ld_out + m] for m < n_out.
template <int kMode>
__global__ void __launch_bounds__(kThreads + 32, 4) nibble_kernel(
    const uint8_t* __restrict__ bits, int64_t m_pad, int g_pad,
    const float* __restrict__ tab, int chunks_per_split, int n_out,
    float* __restrict__ out, int64_t ld_out) {
  constexpr bool kStage = kMode != kFromL2;
  __shared__ __align__(256) float ring[kStage ? kStages * kChunk : 1];
  __shared__ uint64_t full[kStages], empty[kStages];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_chunks = (g_pad + kGroups - 1) / kGroups;
  const int c0 = blockIdx.y * chunks_per_split;
  const int c1 = min(n_chunks, c0 + chunks_per_split);
  const int g0 = c0 * kGroups;
  const int rows = max(0, min(g_pad, c1 * kGroups) - g0);

  if (warp == kThreads / 32) {  // the producer warp
    if (kStage && lane == 0) {
      for (int i = 0; i < kStages; ++i) {
        bar_init(&full[i], 1);
        bar_init(&empty[i], kThreads / 32);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      if (saddr(ring) & 255) __trap();  // the lookups' addresses need it
    }
    __syncthreads();
    if (!kStage || lane != 0) return;
    for (int c = c0; c < c1; ++c) {
      const int k = c - c0, st = k % kStages;
      if (k >= kStages)
        bar_wait<false>(&empty[st], (uint32_t)((k / kStages - 1) & 1));
      const uint32_t bytes = (uint32_t)min(kGroups, g_pad - c * kGroups) *
                             kNib * sizeof(float);
      bar_expect(&full[st], bytes);
      bulk_copy(ring + st * kChunk, tab + (int64_t)c * kChunk, bytes,
                &full[st]);
    }
    return;
  }

  const int64_t m0 =
      (int64_t)blockIdx.x * kTileOut + (int64_t)threadIdx.x * kOutPerThread;
  // Only threads with a live output read: m0 is a multiple of 16 and
  // n_out <= m_pad, a multiple of 128, so their 16 bytes lie in the row.
  // The others still take part in the stage barriers.
  const bool active = m0 < n_out;
  const uint8_t* bp = bits + (int64_t)g0 * m_pad + m0;
  float acc[kOutPerThread];
#pragma unroll
  for (int e = 0; e < kOutPerThread; ++e) acc[e] = 0.f;
  uint4 q[kAhead];
#pragma unroll
  for (int j = 0; j < kAhead; ++j)
    q[j] = active && j < rows ? load_row(bp + (int64_t)j * m_pad)
                              : make_uint4(0, 0, 0, 0);
  __syncthreads();  // the barriers are initialised

  for (int r0 = 0; r0 < rows; r0 += kAhead) {
    const int k = r0 / kGroups, st = k % kStages;
    if (kStage && r0 % kGroups == 0)
      bar_wait<false>(&full[st], (uint32_t)((k / kStages) & 1));
    const float* T = kStage ? ring + st * kChunk + (r0 % kGroups) * kNib
                            : tab + (int64_t)(g0 + r0) * kNib;
    const uint32_t base = kStage ? saddr(T) : 0u;
#pragma unroll
    for (int j = 0; j < kAhead; j += 2) {  // rows of even, then odd rank
      row_step<kMode, 0>(q[j], bp, m_pad, r0 + j, rows, active,
                         T + j * kNib, base + j * kNib * 4, acc);
      row_step<kMode, 1>(q[j + 1], bp, m_pad, r0 + j + 1, rows, active,
                         T + (j + 1) * kNib, base + (j + 1) * kNib * 4, acc);
    }
    if (kStage && ((r0 + kAhead) % kGroups == 0 || r0 + kAhead >= rows)) {
      __syncwarp();
      if (lane == 0) bar_arrive(&empty[st]);
    }
  }
  if (!active) return;
  float* o = out + (int64_t)blockIdx.y * ld_out;
#pragma unroll
  for (int e = 0; e < kOutPerThread; ++e)
    if (m0 + e < n_out) o[m0 + e] = acc[e];
}

// The first design's kernel (mode 1), for the ablation: a 256-entry
// table per group, rebuilt by every block for every chunk of kGroups
// groups it covers (thread B sums entry B's set bits in ascending order
// from 0), then the chunk's rows looked up, four rows' loads in flight;
// lookups land on random banks.
__device__ __forceinline__ void add_row_byte(const float* L, uint4 q,
                                             float (&acc)[kOutPerThread]) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int s = 0; s < 4; ++s) acc[4 * k + s] += L[(w[k] >> (8 * s)) & 0xFF];
}

__global__ void __launch_bounds__(kThreads) byte_kernel(
    const uint8_t* __restrict__ bits, int64_t m_pad, int g_pad,
    const float* __restrict__ v, int chunks_per_split, int n_out,
    float* __restrict__ out, int64_t ld_out) {
  __shared__ float lut[kGroups * 256];
  __shared__ float vs[kGroups * 8];
  const int64_t m0 =
      (int64_t)blockIdx.x * kTileOut + (int64_t)threadIdx.x * kOutPerThread;
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
    for (; gl + 4 <= cnt; gl += 4) {
      uint4 q[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        q[j] = load_row(bp + (int64_t)(gl + j) * m_pad);
#pragma unroll
      for (int j = 0; j < 4; ++j) add_row_byte(lut + (gl + j) * 256, q[j], acc);
    }
    for (; gl < cnt; ++gl)
      add_row_byte(lut + gl * 256, load_row(bp + (int64_t)gl * m_pad), acc);
  }
  if (!active) return;
  float* o = out + (int64_t)blockIdx.y * ld_out;
#pragma unroll
  for (int e = 0; e < kOutPerThread; ++e)
    if (m0 + e < n_out) o[m0 + e] = acc[e];
}

}  // namespace
}  // namespace bbbitlut

// C interface (ctypes). bits: (g_pad, m_pad) uint8 with m_pad a multiple
// of 128 and a 16-byte aligned base; v: 8 * g_pad floats; out: n_out
// floats; tables: g_pad * 32 floats of scratch (the nibble tables; unused
// by mode 1). With n_split > 1, partial holds n_split * n_out floats and
// an ordered second pass sums the splits into out; with n_split == 1 the
// kernel writes out directly. mode: see the header (0 the design's).
// Returns the CUDA error of the launches.
extern "C" int bb_bitlut(const uint8_t* bits, long long g_pad,
                         long long m_pad, const float* v, int n_out,
                         int n_split, int chunks_per_split, float* tables,
                         float* partial, float* out, int mode,
                         void* stream) {
  using namespace bbbitlut;
  auto s = static_cast<cudaStream_t>(stream);
  const int m_tiles = (n_out + kTileOut - 1) / kTileOut;  // live tiles
  dim3 grid(m_tiles, n_split);
  float* dst = n_split > 1 ? partial : out;
  if (mode != kByte) {
    const int64_t entries = g_pad * kNib;
    nibble_tables_kernel<<<(unsigned)((entries + 255) / 256), 256, 0, s>>>(
        v, g_pad, tables);
  }
  switch (mode) {
    case kStaged:
      nibble_kernel<kStaged><<<grid, kThreads + 32, 0, s>>>(
          bits, m_pad, (int)g_pad, tables, chunks_per_split, n_out, dst,
          n_out);
      break;
    case kByte:
      byte_kernel<<<grid, kThreads, 0, s>>>(bits, m_pad, (int)g_pad, v,
                                            chunks_per_split, n_out, dst,
                                            n_out);
      break;
    case kFromL2:
      nibble_kernel<kFromL2><<<grid, kThreads + 32, 0, s>>>(
          bits, m_pad, (int)g_pad, tables, chunks_per_split, n_out, dst,
          n_out);
      break;
    case kNoLookup:
      nibble_kernel<kNoLookup><<<grid, kThreads + 32, 0, s>>>(
          bits, m_pad, (int)g_pad, tables, chunks_per_split, n_out, dst,
          n_out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (n_split > 1) {
    const int rgrid = (int)bbsweep::min64((n_out + 255) / 256, 4096);
    bbsweep::reduce_segments_kernel<<<rgrid, bbsweep::kThreads, 0, s>>>(
        partial, n_split, n_out, out);
  }
  return (int)cudaGetLastError();
}
