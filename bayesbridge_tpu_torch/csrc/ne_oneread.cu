// The hybrid CG operator, and the GLM score with its log-likelihood,
// from one read of X:
//
//   t     = X0 v0 (+ X1 v1) + c        (phase A)
//   u     = mid(t; a, w), 0 past row n   'ne': w t (the CG operator)
//                                        'logit': a - w sigmoid(t)
//                                        'linear': w (a - t)
//   out_b = X_b' u                     (phase B)
//   logp  = sum of the rows' log-likelihood (link modes, with_logp)
//
// over one or two row-aligned blocks (int8, bf16 or f32 storage, f32
// accumulation), every stored byte of the logical columns read from
// device memory once per call.
//
// Replaces the TPU kernel bayesbridge_tpu/design/fusedne.py:_ne_kernel
// (mid='ne', launched by fused_ne_matvec / fused_ne_matvec2; mid='logit' /
// 'linear' with or without logp, launched by fused_link_matvec), which
// kept a row panel in VMEM for both phases. csrc/ne_sweep.cu computes the
// same function from two reads (row pass, column pass) and
// csrc/ne_onepass.cu is the harness's one-read port; this is the design
// behind kernels/ne_sweep.py ne_sweep(...) on the card, every mode.
//
// What bounds it on the H100: bytes (1 B int8 / 2 B bf16 / 4 B f32 per
// element for two FMAs). ne_onepass's ablation showed its stream and its
// arithmetic adding up instead of overlapping, behind five block- or
// cluster-wide serialisation points per panel. This design has none on
// the consumers' path:
//
// * Clusters of C = 8 CTAs share a row panel of kRows rows: CTA q
//   owns 1/C of the 16-byte column units of each
//   block. Each consumer thread owns one unit for the whole launch: its
//   slice of v and its phase-B column sums live in registers across all
//   panels, written once at the end into the cluster's row of `partial`
//   (an ordered second pass sums the clusters).
// * One producer warp keeps a ring of `stages` panels in flight with
//   bulk asynchronous copies (TMA), counted in bytes on a "full"
//   mbarrier per stage; consumers release a stage on its "empty"
//   mbarrier as soon as they hold its bytes in registers.
// * A unit's staged bytes are read from shared memory once per panel
//   into registers and serve both phases. The software pipeline runs
//   phase A of panel k+1 before phase B of panel k.
// * That reduction runs on two warps of its own: the consumer warps
//   write their butterfly-summed row partials and arrive on a local
//   mbarrier; the pusher warp sums the warps in order and pushes the
//   CTA's R partials into every peer's shared memory (DSMEM stores, each
//   followed by a release arrive on the peer's mbarrier); the finisher
//   warp waits on its own mbarrier, sums the C ranks in rank order
//   (every CTA gets the same u bits), forms u and signals the consumers.
//   Split so, panel k+1's push never waits for panel k's round trip,
//   which set the pace on one warp (baselines/oneread_ablation.py
//   'onewarp', PERF.md). No cluster-wide barrier per panel.
// * int8 converts without I2F: the byte, xor 0x80, is permuted into the
//   mantissa of 2^23 and one subtract restores its value (integer and
//   FMA pipes), once per phase.
//
// Clusters of 16 took 5.56 ms at the flagship blocks against 2.84 for
// clusters of 8, slower than the two-pass sweep; clusters of 4 do not fit
// there (PERF.md). So the cluster size is fixed at 8: block pairs whose
// units do not fit 8 CTAs take the two-pass route (kernels/ne_oneread.py).
//
// The link modes' log-likelihood: every CTA of a cluster forms the same
// u, so only rank 0's finisher warp sums the rows, per lane in panel
// order, then over its lanes in lane order into the cluster's slot of
// `partial` (one column past the output columns), which the ordered
// second pass sums over the clusters with the outputs.
//
// Padding: a unit's columns past p are masked in phase A (f32 / bf16
// padding may hold NaN) and dropped in the output; rows past n are not
// copied, get u = 0 and lp = 0 and add exact zeros (the stage ring
// starts zeroed and then holds finite design values). No float atomics:
// two runs give the same bits.

#include <cooperative_groups.h>

#include "mbarrier.cuh"
#include "sweep_common.cuh"

namespace cg = cooperative_groups;

namespace bboneread {
namespace {

using namespace bbasync;
using bbsweep::Vec;

constexpr int kRows = 4;            // rows per panel
constexpr int kMaxConsumers = 512;  // consumer threads per CTA
constexpr int kMaxWarps = kMaxConsumers / 32;
constexpr int kMaxThreads = kMaxConsumers + 96;  // + producer, pusher,
                                                  // finisher
constexpr int kCluster = 8;      // CTAs per cluster
constexpr int kMaxStages = 8;
// Row-partial slots: with phase A one panel ahead, a peer pushes panel
// k+4 only after this CTA has finished panel k, so 4 slots suffice.
constexpr int kSlots = 4;
constexpr int kFixedSmem = 4096;    // barriers and row partials
// A pair of blocks takes at least this much shared memory, more than half
// of an SM's 228 KB, so that no two CTAs share an SM: where a small plan
// let two share one, runs on the same inputs gave different results
// (baselines/oneread_reruns.py; the cause is not found). A lone block's
// plans share SMs and resumed exactly in every smoke.
constexpr size_t kPairMinSmem = 116 * 1024;

struct Args {
  const char* X0; int64_t ldb0; int p0; const float* v0;  // ldb: bytes
  const char* X1; int64_t ldb1; int p1; const float* v1;
  const float* c; int c_stride; const float* w; int64_t n;
  const float* a;  // (n,) the link modes' first operand; unused for 'ne'
  int mid;         // bbsweep::Mid: MID_NE, MID_LOGIT or MID_LINEAR
  int with_logp;
  int U0, U1;      // live 16-byte units of each block
  int ue, uf;      // units per CTA of each block
  int ue_pad;      // consumer threads of block 0 (ue rounded up to 32)
  int n_cons;      // consumer threads (a multiple of 32)
  int stages;
  int64_t n_panels;
  float* u;        // (n,)
  float* partial;  // (clusters, width)
  int64_t width;   // p0 + p1, + 1 (the logp column) with with_logp
};

struct Smem {
  uint64_t* full;   // [kMaxStages]
  uint64_t* empty;  // [kMaxStages]
  uint64_t* lbar;   // [kSlots] consumer warps' row partials written
  uint64_t* cbar;   // [kSlots] the cluster's CTA partials arrived
  uint64_t* ubar;   // [kSlots] u of the panel staged
  float* wpart;     // [kSlots][kMaxWarps][kRows]
  float* cpart;     // [kSlots][kCluster][kRows]
  float* su;        // [kSlots][kRows]
  char* stage;      // [stages][kRows][row_bytes]
};

__device__ inline Smem carve(char* base) {
  Smem s;
  auto* bars = reinterpret_cast<uint64_t*>(base);
  s.full = bars;
  s.empty = bars + kMaxStages;
  s.lbar = bars + 2 * kMaxStages;
  s.cbar = s.lbar + kSlots;
  s.ubar = s.cbar + kSlots;
  s.wpart = reinterpret_cast<float*>(base + 256);
  s.cpart = s.wpart + kSlots * kMaxWarps * kRows;
  s.su = s.cpart + kSlots * kCluster * kRows;
  s.stage = base + kFixedSmem;
  return s;
}

// This CTA's shared address `a` as the same offset in CTA `rank` of the
// cluster.
__device__ __forceinline__ uint32_t peer_addr(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void peer_store(uint32_t a, float x) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(a), "f"(x)
               : "memory");
}

__device__ __forceinline__ void peer_arrive(uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          bar)
      : "memory");
}

// A 16-byte unit's elements as floats; int8 by byte permute into the
// mantissa of 2^23 (2^23 + 128 + x exactly) and one subtract.
template <typename T> struct Cvt {
  static constexpr int N = Vec<T>::N;
  __device__ __forceinline__ static void run(uint4 q, float (&o)[N]) {
    Vec<T>::cvt(q, o);
  }
};

template <> struct Cvt<int8_t> {
  static constexpr int N = 16;
  __device__ __forceinline__ static void run(uint4 q, float (&o)[N]) {
    const uint32_t w[4] = {q.x ^ 0x80808080u, q.y ^ 0x80808080u,
                           q.z ^ 0x80808080u, q.w ^ 0x80808080u};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        o[4 * j + k] =
            __int_as_float(__byte_perm(w[j], 0x4B000000u, 0x7540u + k)) -
            8388736.f;
  }
};

// The consumer threads of one block type: this thread's unit `unit`
// (-1: none) at 16-byte slot `slot` of each staged row.
template <typename T>
__device__ void consumer(const Args& a, const Smem& s, int64_t K, int p,
                         const float* __restrict__ vpad, int unit, int slot,
                         float* __restrict__ part_out) {
  constexpr int N = Cvt<T>::N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool live = unit >= 0;
  const int col0 = live ? unit * N : 0;
  const int nlive = live ? min(N, p - col0) : 0;
  const int64_t row_bytes = (int64_t)(a.ue + a.uf) * 16;
  float v[N], acc[N];
#pragma unroll
  for (int e = 0; e < N; ++e) {
    v[e] = live ? __ldg(vpad + col0 + e) : 0.f;
    acc[e] = 0.f;
  }
  // nxt: the bytes of panel k + 1, whose phase A has run.
  uint4 cur[kRows], nxt[kRows];

  // Panel k's bytes into `regs`; the stage is released right after.
  auto load = [&](int64_t k, uint4 (&regs)[kRows]) {
    const int st = (int)(k % a.stages);
    bar_wait<false>(&s.full[st], (uint32_t)((k / a.stages) & 1));
    const char* base = s.stage + (int64_t)st * kRows * row_bytes + slot * 16;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      regs[r] = live ? *reinterpret_cast<const uint4*>(base + r * row_bytes)
                     : make_uint4(0, 0, 0, 0);
    __syncwarp();
    if (lane == 0) bar_arrive(&s.empty[st]);
  };
  // Phase A of the panel in `regs` into row-partial buffer j.
  auto phase_a = [&](const uint4 (&regs)[kRows], int j) {
    float part[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float x[N];
      Cvt<T>::run(regs[r], x);
      if (nlive < N) {
#pragma unroll
        for (int e = 0; e < N; ++e) x[e] = e < nlive ? x[e] : 0.f;
      }
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int e = 0; e < N; e += 2) {
        s0 = fmaf(x[e], v[e], s0);
        s1 = fmaf(x[e + 1], v[e + 1], s1);
      }
      part[r] = s0 + s1;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        part[r] += __shfl_xor_sync(0xffffffffu, part[r], off);
    float mine = part[0];
#pragma unroll
    for (int r = 1; r < kRows; ++r) mine = lane == r ? part[r] : mine;
    if (lane < kRows) s.wpart[(j * kMaxWarps + warp) * kRows + lane] = mine;
    __syncwarp();
    if (lane == 0) bar_arrive(&s.lbar[j]);
  };

  if (K > 0) {
    load(0, nxt);
    phase_a(nxt, 0);
  }
  for (int64_t k = 0; k < K; ++k) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) cur[r] = nxt[r];
    if (k + 1 < K) {
      load(k + 1, nxt);
      phase_a(nxt, (int)((k + 1) % kSlots));
    }
    const int j = (int)(k % kSlots);
    bar_wait<false>(&s.ubar[j], (uint32_t)((k / kSlots) & 1));
    float uu[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) uu[r] = s.su[j * kRows + r];
    if (live) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float x[N];
        Cvt<T>::run(cur[r], x);
#pragma unroll
        for (int e = 0; e < N; ++e) acc[e] = fmaf(x[e], uu[r], acc[e]);
      }
    }
  }
  if (live) {
#pragma unroll
    for (int e = 0; e < N; ++e)
      if (e < nlive) part_out[col0 + e] = acc[e];
  }
}

// The producer warp: panel k of this cluster into stage k % stages.
__device__ void producer(const Args& a, const Smem& s, int64_t cid,
                         int64_t ncl, int64_t K, int my_ue, int my_uf,
                         int ue0, int uf0) {
  const int lane = threadIdx.x & 31;
  const int64_t row_bytes = (int64_t)(a.ue + a.uf) * 16;
  for (int64_t k = 0; k < K; ++k) {
    const int st = (int)(k % a.stages);
    if (k >= a.stages)
      bar_wait<false>(&s.empty[st], (uint32_t)((k / a.stages - 1) & 1));
    const int64_t row0 = (cid + k * ncl) * kRows;
    const int live = (int)bbsweep::min64(kRows, a.n - row0);
    if (lane == 0)
      bar_expect(&s.full[st], (uint32_t)(live * (my_ue + my_uf) * 16));
    __syncwarp();
    char* dst = s.stage + (int64_t)st * kRows * row_bytes;
    if (lane < live) {
      const int64_t row = row0 + lane;
      if (my_ue)
        bulk_copy(dst + lane * row_bytes,
                  a.X0 + row * a.ldb0 + (int64_t)ue0 * 16, my_ue * 16,
                  &s.full[st]);
      if (my_uf)
        bulk_copy(dst + lane * row_bytes + (int64_t)a.ue * 16,
                  a.X1 + row * a.ldb1 + (int64_t)uf0 * 16, my_uf * 16,
                  &s.full[st]);
    }
  }
}

// This CTA's row partials of panel k, summed over its warps in order,
// into every rank's slot (lane q feeds rank q), once the consumers have
// them.
__device__ __forceinline__ void push_panel(const Smem& s, int rank, int C,
                                           int64_t k, int ncw) {
  const int lane = threadIdx.x & 31;
  const int j = (int)(k % kSlots);
  bar_wait<false>(&s.lbar[j], (uint32_t)((k / kSlots) & 1));
  float pr = 0.f;
  if (lane < kRows)
    for (int w = 0; w < ncw; ++w)
      pr += s.wpart[(j * kMaxWarps + w) * kRows + lane];
  float vals[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) vals[r] = __shfl_sync(0xffffffffu, pr, r);
  if (lane < C) {
    const uint32_t dst = peer_addr(
        saddr(s.cpart + (j * kCluster + rank) * kRows), lane);
#pragma unroll
    for (int r = 0; r < kRows; ++r) peer_store(dst + 4 * r, vals[r]);
    peer_arrive(peer_addr(saddr(&s.cbar[j]), lane));
  }
}

// The cluster's partials of panel k summed in rank order (every CTA gets
// the same bits) -> u, staged for phase B. Returns this lane's row's
// log-likelihood (0 past row n, on lanes without a row and without
// with_logp).
__device__ __forceinline__ float finish_panel(const Args& a, const Smem& s,
                                              int rank, int C, int64_t cid,
                                              int64_t ncl, int64_t k) {
  const int lane = threadIdx.x & 31;
  const int j = (int)(k % kSlots);
  // The row's operands load while the exchange is in flight.
  const int64_t row = (cid + k * ncl) * kRows + lane;
  float wr = 0.f, cr = 0.f, ar = 0.f;
  if (lane < kRows && row < a.n) {
    wr = __ldg(a.w + row);
    cr = __ldg(a.c + (int64_t)a.c_stride * row);
    if (a.mid != bbsweep::MID_NE) ar = __ldg(a.a + row);
  }
  bar_wait<true>(&s.cbar[j], (uint32_t)((k / kSlots) & 1));
  float lp = 0.f;
  if (lane < kRows) {
    float t = 0.f;
    for (int q = 0; q < C; ++q)
      t += s.cpart[(j * kCluster + q) * kRows + lane];
    float uu = 0.f;
    if (row < a.n) {
      uu = bbsweep::row_map(a.mid, t + cr, ar, wr, a.with_logp, lp);
      if (rank == 0) a.u[row] = uu;
    }
    s.su[j * kRows + lane] = uu;
  }
  __syncwarp();
  if (lane == 0) bar_arrive(&s.ubar[j]);
  return lp;
}

// The pusher warp and the finisher warp.
__device__ void pusher(const Smem& s, int rank, int C, int64_t K, int ncw) {
  for (int64_t k = 0; k < K; ++k) push_panel(s, rank, C, k, ncw);
}

// With with_logp, rank 0's finisher also sums the cluster's rows'
// log-likelihood: per lane in panel order, then lanes 0..kRows-1 in order,
// into the cluster's logp slot.
__device__ void finisher(const Args& a, const Smem& s, int rank, int C,
                         int64_t cid, int64_t ncl, int64_t K) {
  float lp = 0.f;
  for (int64_t k = 0; k < K; ++k)
    lp += finish_panel(a, s, rank, C, cid, ncl, k);
  if (a.with_logp && rank == 0) {
    float rows[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) rows[r] = __shfl_sync(0xffffffffu, lp, r);
    if ((threadIdx.x & 31) == 0) {
      float sum = 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) sum += rows[r];
      a.partial[cid * a.width + a.p0 + a.p1] = sum;
    }
  }
}

template <typename T0, typename T1>
__global__ void __launch_bounds__(kMaxThreads, 1) oneread_kernel(Args a) {
  extern __shared__ __align__(128) char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int C = (int)cluster.num_blocks();
  const int64_t cid = blockIdx.x / C;
  const int64_t ncl = gridDim.x / C;
  const Smem s = carve(smem_raw);
  const int ncw = a.n_cons / 32;
  const int64_t row_bytes = (int64_t)(a.ue + a.uf) * 16;

  // Zeroed stages (generic writes) ordered before the bulk copies (async
  // proxy) that will overwrite them; barriers visible to the cluster
  // before any peer arrives on them.
  const int64_t words = (int64_t)a.stages * kRows * row_bytes / 16;
  for (int64_t i = threadIdx.x; i < words; i += blockDim.x)
    reinterpret_cast<uint4*>(s.stage)[i] = make_uint4(0, 0, 0, 0);
  if (threadIdx.x == 0) {
    for (int i = 0; i < a.stages; ++i) {
      bar_init(&s.full[i], 1);
      bar_init(&s.empty[i], ncw);
    }
    for (int i = 0; i < kSlots; ++i) {
      bar_init(&s.lbar[i], ncw);
      bar_init(&s.cbar[i], C);
      bar_init(&s.ubar[i], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  cluster.sync();

  const int64_t K = cid < a.n_panels ? (a.n_panels - 1 - cid) / ncl + 1 : 0;
  const int ue0 = rank * a.ue, uf0 = rank * a.uf;
  const int my_ue = max(0, min(a.ue, a.U0 - ue0));
  const int my_uf = max(0, min(a.uf, a.U1 - uf0));
  const int warp = threadIdx.x >> 5;
  float* part_row = a.partial + cid * a.width;
  if (warp < ncw) {
    const int t = threadIdx.x;
    if (t < a.ue_pad)
      consumer<T0>(a, s, K, a.p0, a.v0, t < my_ue ? ue0 + t : -1, t,
                   part_row);
    else
      consumer<T1>(a, s, K, a.p1, a.v1,
                   t - a.ue_pad < my_uf ? uf0 + t - a.ue_pad : -1,
                   a.ue + t - a.ue_pad, part_row + a.p0);
  } else if (warp == ncw) {
    producer(a, s, cid, ncl, K, my_ue, my_uf, ue0, uf0);
  } else if (warp == ncw + 1) {
    pusher(s, rank, C, K, ncw);
  } else {
    finisher(a, s, rank, C, cid, ncl, K);
  }
  // No CTA may exit while a peer can still write into its shared memory.
  cluster.sync();
}

template <typename T0, typename T1>
cudaError_t config(const Args& a, int clusters, cudaLaunchConfig_t* cfg,
                   cudaLaunchAttribute* attr) {
  auto kern = oneread_kernel<T0, T1>;
  size_t smem = kFixedSmem + (size_t)a.stages * kRows * (a.ue + a.uf) * 16;
  if (a.uf > 0 && smem < kPairMinSmem) smem = kPairMinSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->gridDim = dim3(kCluster * clusters);
  cfg->blockDim = dim3(a.n_cons + 96);
  cfg->dynamicSmemBytes = smem;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <typename T0, typename T1>
int fit_clusters(const Args& a) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  if (config<T0, T1>(a, 1, &cfg, attr) != cudaSuccess) return -1;
  int fit = 0;
  if (cudaOccupancyMaxActiveClusters(&fit, oneread_kernel<T0, T1>, &cfg) !=
      cudaSuccess)
    return -1;
  return fit;
}

template <typename T0, typename T1>
cudaError_t launch(const Args& a, int clusters, float* out,
                   cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t err = config<T0, T1>(a, clusters, &cfg, attr);
  if (err != cudaSuccess) return err;
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, oneread_kernel<T0, T1>, a);
  if (err != cudaSuccess) return err;
  const int rgrid = (int)bbsweep::min64(
      (a.width + bbsweep::kThreads - 1) / bbsweep::kThreads, 4096);
  bbsweep::reduce_segments_kernel<<<rgrid, bbsweep::kThreads, 0, stream>>>(
      a.partial, clusters, a.width, out);
  return cudaGetLastError();
}

Args make_args(const void* X0, long long ld0, int p0, const float* v0,
               const void* X1, long long ld1, int p1, const float* v1,
               long long n, const float* c, int c_stride, const float* w,
               const float* link_a, int mid, int with_logp, int U0, int U1,
               int ue, int uf, int n_cons, int stages, int esz0, int esz1,
               float* u, float* partial) {
  Args a;
  a.X0 = static_cast<const char*>(X0); a.ldb0 = ld0 * esz0; a.p0 = p0;
  a.v0 = v0;
  a.X1 = static_cast<const char*>(X1); a.ldb1 = ld1 * esz1; a.p1 = p1;
  a.v1 = v1;
  a.c = c; a.c_stride = c_stride; a.w = w; a.n = n;
  a.a = link_a; a.mid = mid; a.with_logp = with_logp;
  a.U0 = U0; a.U1 = U1; a.ue = ue; a.uf = uf;
  a.ue_pad = (ue + 31) / 32 * 32;
  a.n_cons = n_cons; a.stages = stages;
  a.n_panels = (n + kRows - 1) / kRows;
  a.u = u; a.partial = partial;
  a.width = (int64_t)p0 + p1 + (with_logp ? 1 : 0);
  return a;
}

bool valid(int ue, int uf, int n_cons, int stages) {
  return n_cons % 32 == 0 &&
         n_cons <= kMaxConsumers && (ue + 31) / 32 * 32 + uf <= n_cons &&
         stages >= 2 && stages <= kMaxStages &&
         kFixedSmem + (long long)stages * kRows * (ue + uf) * 16 <= 232448;
}

int esize(int dt) {
  return dt == bbsweep::DT_F32 ? 4 : dt == bbsweep::DT_BF16 ? 2 : 1;
}

}  // namespace
}  // namespace bboneread

// BB_DISPATCH2(dt0, dt1, T0, T1, stmt): the storage types of the two
// blocks (dt1 < 0: no second block, T1 = float unused).
#define BB_DISPATCH2(dt0, dt1, T0, T1, ...)                          \
  BB_DISPATCH(dt0, T0, if (dt1 < 0) { using T1 = float; __VA_ARGS__; } \
              BB_DISPATCH(dt1, T1, __VA_ARGS__))

// Clusters of 8 CTAs that fit on the card at once for a plan (< 0: the
// plan is refused or the query failed).
extern "C" int bb_ne_oneread_fit(int dt0, int dt1, int ue, int uf,
                                 int n_cons, int stages) {
  using namespace bboneread;
  if (!valid(ue, uf, n_cons, stages)) return -1;
  Args a = make_args(nullptr, 0, 0, nullptr, nullptr, 0, 0, nullptr, 0,
                     nullptr, 0, nullptr, nullptr, bbsweep::MID_NE, 0, 0, 0,
                     ue, uf, n_cons, stages, 1, 1, nullptr, nullptr);
  BB_DISPATCH2(dt0, dt1, T0, T1, return fit_clusters<T0, T1>(a));
}

// C interface (ctypes). dt*: 0 f32, 1 bf16, 2 int8, dt1 = -1 for one
// block. ld*: row stride in elements; v*: padded with zeros to the live
// units' columns; c read as c[c_stride * row]; w: the row weights (b);
// a: the link modes' first operand (unused for mid 0). mid: 0 'ne',
// 1 'logit', 2 'linear'; with_logp (link modes): out gets the summed
// log-likelihood rows after the columns. U*: live 16-byte units
// (ceil(p / elements per unit)); ue / uf: units per CTA; n_cons consumer
// threads; clusters from bb_ne_oneread_fit (at most). partial: clusters *
// (p0 + p1 + with_logp) floats of scratch; out: p0 + p1 + with_logp
// floats; u: n floats. Returns the CUDA error of the launches (0 = ok).
extern "C" int bb_ne_oneread(int dt0, const void* X0, long long ld0, int p0,
                             const float* v0, int dt1, const void* X1,
                             long long ld1, int p1, const float* v1,
                             long long n, const float* c, int c_stride,
                             const float* w, const float* a, int mid,
                             int with_logp, int U0, int U1, int ue, int uf,
                             int n_cons, int stages, int clusters,
                             float* u, float* partial, float* out,
                             void* stream) {
  using namespace bboneread;
  if (!valid(ue, uf, n_cons, stages) || clusters < 1 || n <= 0 ||
      mid < bbsweep::MID_NE || mid > bbsweep::MID_LINEAR ||
      (mid != bbsweep::MID_NE && a == nullptr) ||
      (with_logp && mid == bbsweep::MID_NE))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  Args args = make_args(X0, ld0, p0, v0, X1, ld1, p1, v1, n, c, c_stride, w,
                        a, mid, with_logp, U0, U1, ue, uf, n_cons, stages,
                        esize(dt0), dt1 < 0 ? 4 : esize(dt1), u, partial);
  if (clusters > args.n_panels) clusters = (int)args.n_panels;
  BB_DISPATCH2(dt0, dt1, T0, T1,
               return (int)launch<T0, T1>(args, clusters, out, s));
}
