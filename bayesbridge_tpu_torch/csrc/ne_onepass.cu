// One-read normal-equations sweep over an int8 block Xe (n, lde) and an
// f32 block Xf (n, ldf):
//
//   t     = Xe ve + Xf vf + c                (phase A)
//   u     = w * t, 0 past row n
//   out_e = Xe' u,  out_f = Xf' u            (phase B)
//
// with every stored byte of X read from device memory once per call.
//
// Replaces the TPU kernel of baselines/dev_ne_variants.py:make_fused (the
// A/B harness's fused sweep: _phase_a / _phase_b variants), which held one
// row panel in VMEM for both phases and carried out_b across a sequential
// grid. csrc/ne_sweep.cu reads X twice (row pass, then column pass); this
// kernel is the one-read form the harness measures against it.
//
// What bounds it on the H100: bytes (one read of X at 1 B / 4 B per element
// for 4 flops). A flagship row is 45,008 int8 + 20,000 f32 bytes, too wide
// for one block's shared memory, so the row panel is spread over a thread
// block cluster of kCluster CTAs: CTA q owns 1/kCluster of the 16-byte
// column units of both blocks, stages R <= 16 rows of its slice in shared
// memory, and computes its partial row sums of t. After a cluster barrier
// every CTA reads the cluster's partials through distributed shared memory
// and sums them in rank order, so all hold the same u bits. Phase B then
// runs on the staged slice and adds X_slice' u into column accumulators in
// shared memory. Clusters loop over row panels (panel k goes to cluster
// k mod clusters); each writes its column sums to its row of `partial`,
// and an ordered second pass sums the clusters. No float atomics: two runs
// give the same bits.
//
// Staging is double-buffered with bulk asynchronous copies (the TMA
// engine, one copy per row slice, completion counted in bytes on an
// mbarrier per buffer): the copies of a cluster's next panel are in flight
// while it computes the current one, and issuing them costs a warp a few
// instructions rather than every thread a load per 16 bytes. The row
// partials are double-buffered by panel parity, so one cluster barrier per
// panel suffices: a CTA rewrites a parity's partials only after the whole
// cluster has passed the next panel's barrier, by which time every remote
// read of them is done.
//
// Padding: rows past n are not copied; their u is 0 and the buffers start
// zeroed, so their stale rows (finite design values, or zeros) add exact
// zeros. Padding columns of Xe multiply zeros of ve (int8 values are
// finite) and their outputs are dropped; padding columns of Xf (possibly
// NaN) are masked in phase A by index and their outputs dropped.
//
// Variants (template parameters; the harness maps the TPU specs onto
// them): phase A on the int8 block by CUDA-core FMAs, or by mma.sync
// m16n8k16 bf16 tensor-core products against v split into hi/lo bf16
// terms (A_MMA2) or rounded to one bf16 (A_MMA1, lossy); phase B on the
// int8 block by FMAs, or by mma.sync against u split into 2 (B_MMA2) or 3
// (B_MMA3) bf16 terms. int8 values are exact in bf16, and each product of
// an int8 value and a bf16 term is exact in the f32 accumulator. The f32
// block always takes FMAs. CVT converts the int8 slice to f32 in shared
// memory once per panel, so the up-convert runs once per element, not per
// phase.

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include "sweep_common.cuh"

namespace cg = cooperative_groups;

namespace bbonepass {
namespace {

using bbsweep::Vec;

constexpr int kCluster = 8;
constexpr int kMaxRows = 16;
// 12 warps: a flagship CTA slice has 352 int8 units, one per thread.
constexpr int kThreads = 384;
constexpr int kWarps = kThreads / 32;

enum AMode { A_FMA = 0, A_MMA2 = 1, A_MMA1 = 2 };
enum BMode { B_FMA = 0, B_MMA2 = 1, B_MMA3 = 2 };

struct Args {
  const int8_t* Xe; int64_t lde; int pe;
  const float* Xf; int64_t ldf; int pf;
  const float* ve; const float* vf;  // zero-padded to lde / ldf
  const float* c; const float* w; int64_t n;
  int R;           // rows per panel, 1..kMaxRows
  int ue, uf;      // 16-byte units of each block per CTA slice
  int64_t n_panels;
  float* u;        // (n,)
  float* partial;  // (clusters, pe + pf)
};

// One staged panel: R x ue units of int8 (raw bytes, or converted to f32
// under CVT) and R x uf units of f32.
struct Panel {
  const int8_t* e8;
  const float* ef;
  const float* f;
};

// Shared memory carve-up (all offsets multiples of 16 bytes).
struct Smem {
  char* raw[2];  // two panel buffers: R x ue x 16 int8, then R x uf x 4 f32
  float* cvt;    // CVT: R x ue x 16 f32
  float* acc_e;  // 16 x (ue + 1): element e of unit k at e * (ue + 1) + k
  float* acc_f;  // uf x 4
  float* we;     // kWarps x kMaxRows phase-A partials, int8 block
  float* wf;     // kWarps x kMaxRows phase-A partials, f32 block
  float* part;   // 2 x kMaxRows: this CTA's partials of t, by panel parity
  float* su;     // kMaxRows: u of the panel's rows
  __nv_bfloat16* us;  // 3 x kMaxRows: u split into bf16 terms
  uint64_t* bar;      // 2 mbarriers, one per panel buffer
};

__host__ __device__ inline size_t panel_bytes(int R, int ue, int uf) {
  return (size_t)R * ue * 16 + (size_t)R * uf * 16;
}

__host__ __device__ inline size_t smem_bytes(int R, int ue, int uf,
                                             bool cvt) {
  return 2 * panel_bytes(R, ue, uf) + (cvt ? (size_t)R * ue * 64 : 0) +
         (size_t)(ue + 1) * 64 + (size_t)uf * 16 + 2 * kWarps * kMaxRows * 4 +
         3 * kMaxRows * 4 + 3 * kMaxRows * 2 + 2 * 8;
}

__device__ inline Smem carve(char* base, int R, int ue, int uf, bool cvt) {
  Smem s;
  size_t off = 0;
  for (int b = 0; b < 2; ++b) {
    s.raw[b] = base + off;
    off += panel_bytes(R, ue, uf);
  }
  s.cvt = reinterpret_cast<float*>(base + off);
  off += cvt ? (size_t)R * ue * 64 : 0;
  s.acc_e = reinterpret_cast<float*>(base + off);
  off += (size_t)(ue + 1) * 64;
  s.acc_f = reinterpret_cast<float*>(base + off);
  off += (size_t)uf * 16;
  s.we = reinterpret_cast<float*>(base + off);
  off += kWarps * kMaxRows * 4;
  s.wf = reinterpret_cast<float*>(base + off);
  off += kWarps * kMaxRows * 4;
  s.part = reinterpret_cast<float*>(base + off);
  off += 2 * kMaxRows * 4;
  s.su = reinterpret_cast<float*>(base + off);
  off += kMaxRows * 4;
  s.us = reinterpret_cast<__nv_bfloat16*>(base + off);
  off += 3 * kMaxRows * 2;  // a multiple of 16
  s.bar = reinterpret_cast<uint64_t*>(base + off);
  return s;
}

__device__ __forceinline__ int acc_idx(int j, int ue) {
  return (j & 15) * (ue + 1) + (j >> 4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Arrive on `bar` and expect `bytes` of bulk copies in its current phase.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until `bar`'s phase of the given parity has completed. Bounded (at
// about ten seconds): a miscounted phase traps, a launch error, instead of
// hanging the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > 20000000000LL) __trap();
  }
}

// Bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// global to this CTA's shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// int8 element (r, local column j) of the staged slice as a float.
template <bool CVT>
__device__ __forceinline__ float xe_at(const Panel& P, int ue, int r, int j) {
  if constexpr (CVT) return P.ef[(size_t)r * ue * 16 + j];
  return (float)P.e8[(size_t)r * ue * 16 + j];
}

// The 16 int8 elements of unit k in row r, as floats.
template <bool CVT>
__device__ __forceinline__ void xe_unit(const Panel& P, int ue, int r, int k,
                                        float (&x)[16]) {
  if constexpr (CVT) {
    const float4* p =
        reinterpret_cast<const float4*>(P.ef + ((size_t)r * ue + k) * 16);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 f = p[q];
      x[4 * q] = f.x; x[4 * q + 1] = f.y; x[4 * q + 2] = f.z;
      x[4 * q + 3] = f.w;
    }
  } else {
    const uint4 q = reinterpret_cast<const uint4*>(P.e8)[(size_t)r * ue + k];
    Vec<int8_t>::cvt(q, x);
  }
}

// Warp 0 issues the copies of the panel at row0 into buffer `buf`, one per
// live row and block, counted on `bar` (not waited on).
__device__ void stage(const Args& a, char* buf, uint64_t* bar, int64_t row0,
                      int ue0, int my_ue, int uf0, int my_uf) {
  const int lane = threadIdx.x & 31;
  const int live = (int)bbsweep::min64(a.R, a.n - row0);
  const uint32_t be = my_ue * 16, bf = my_uf * 16;
  if (lane == 0) bar_expect(bar, live * (be + bf));
  __syncwarp();
  char* fbuf = buf + (size_t)a.R * a.ue * 16;
  for (int r = lane; r < live; r += 32) {
    const int64_t row = row0 + r;
    if (be)
      bulk_copy(buf + (size_t)r * a.ue * 16,
                a.Xe + row * a.lde + (int64_t)ue0 * 16, be, bar);
    if (bf)
      bulk_copy(fbuf + (size_t)r * a.uf * 16,
                a.Xf + row * a.ldf + (int64_t)uf0 * 4, bf, bar);
  }
}

// Butterfly-sum acc[r] over the warp, all rows at once (independent
// chains); lane 0 writes dst[warp][r].
__device__ __forceinline__ void warp_rows_out(float (&acc)[kMaxRows],
                                              float* dst) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r)
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
  if (lane == 0)
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) dst[warp * kMaxRows + r] = acc[r];
}

// Rows are taken four at a time so that their FMA chains interleave; a
// group's rows past R repeat row R - 1 (in bounds) and their partials are
// never read.
__device__ __forceinline__ void load_v16(const float* p, float (&v)[16]) {
  const float4* vp = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 f = __ldg(vp + q);
    v[4 * q] = f.x; v[4 * q + 1] = f.y; v[4 * q + 2] = f.z;
    v[4 * q + 3] = f.w;
  }
}

template <int AM, bool CVT>
__device__ void phase_a(const Args& a, const Smem& s, const Panel& P,
                        int ue0, int my_ue, int uf0, int my_uf) {
  const int R = a.R;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // FMA mode: the int8 and f32 blocks' partials share one accumulator.
  float acc[kMaxRows];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) acc[r] = 0.f;
  if constexpr (AM == A_FMA) {
    for (int k = threadIdx.x; k < my_ue; k += kThreads) {
      float v[16];
      load_v16(a.ve + (ue0 + k) * 16, v);
#pragma unroll
      for (int g = 0; g < kMaxRows / 4; ++g) {
        if (4 * g < R) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float x[16];
            xe_unit<CVT>(P, a.ue, min(4 * g + i, R - 1), k, x);
            float s0 = 0.f, s1 = 0.f;
#pragma unroll
            for (int e = 0; e < 16; e += 2) {
              s0 = fmaf(x[e], v[e], s0);
              s1 = fmaf(x[e + 1], v[e + 1], s1);
            }
            acc[4 * g + i] += s0 + s1;
          }
        }
      }
    }
  } else {
    // Tensor cores: rows 0..15 of the panel (zero past R) times the split
    // v, one 16-column unit per mma; warp w takes units w, w + kWarps, ...
    const int g = lane >> 2, tq = lane & 3;
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = warp; k < my_ue; k += kWarps) {
      const int j0 = k * 16 + 2 * tq, j1 = j0 + 8;
      auto x = [&](int r, int j) {
        return r < R ? xe_at<CVT>(P, a.ue, r, j) : 0.f;
      };
      const uint32_t a0 = pack_bf16(x(g, j0), x(g, j0 + 1));
      const uint32_t a1 = pack_bf16(x(g + 8, j0), x(g + 8, j0 + 1));
      const uint32_t a2 = pack_bf16(x(g, j1), x(g, j1 + 1));
      const uint32_t a3 = pack_bf16(x(g + 8, j1), x(g + 8, j1 + 1));
      // B[kk][col]: col 0 = hi(v), col 1 = lo(v) (A_MMA2 only), rest 0.
      const float* vb = a.ve + ue0 * 16 + k * 16;
      auto term = [&](int kk) {
        const float v = __ldg(vb + kk);
        const float hi = __bfloat162float(__float2bfloat16_rn(v));
        if (g == 0) return hi;
        if (AM == A_MMA2 && g == 1) return v - hi;
        return 0.f;
      };
      const uint32_t b0 = pack_bf16(term(2 * tq), term(2 * tq + 1));
      const uint32_t b1 = pack_bf16(term(2 * tq + 8), term(2 * tq + 9));
      mma_bf16(d, a0, a1, a2, a3, b0, b1);
    }
    // Lane 4g holds D[g][0..1] and D[g + 8][0..1]: t's share of rows g,
    // g + 8 (columns 0 and 1 are the hi and lo terms).
    if (tq == 0) {
      s.we[warp * kMaxRows + g] = d[0] + d[1];
      s.we[warp * kMaxRows + g + 8] = d[2] + d[3];
    }
  }
  // f32 block: FMAs, unit k of 4 columns per thread; padding columns
  // (past pf, possibly NaN) masked.
  for (int k = threadIdx.x; k < my_uf; k += kThreads) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(a.vf) + uf0 + k);
    const int live = a.pf - (uf0 + k) * 4;  // columns of this unit below pf
#pragma unroll
    for (int g = 0; g < kMaxRows / 4; ++g) {
      if (4 * g < R) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = min(4 * g + i, R - 1);
          float4 x =
              reinterpret_cast<const float4*>(P.f)[(size_t)r * a.uf + k];
          if (live < 4) {
            x.x = live > 0 ? x.x : 0.f;
            x.y = live > 1 ? x.y : 0.f;
            x.z = live > 2 ? x.z : 0.f;
            x.w = 0.f;
          }
          acc[4 * g + i] += fmaf(x.x, v.x, x.y * v.y) +
                            fmaf(x.z, v.z, x.w * v.w);
        }
      }
    }
  }
  warp_rows_out(acc, AM == A_FMA ? s.we : s.wf);
}

// Rows four at a time: a group's rows past R repeat row R - 1 and carry
// u = 0 (su is zero past R), so they add exact zeros.
template <int BM, bool CVT>
__device__ void phase_b(const Args& a, const Smem& s, const Panel& P,
                        int my_ue, int my_uf) {
  const int R = a.R;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if constexpr (BM == B_FMA) {
    for (int k = threadIdx.x; k < my_ue; k += kThreads) {
      float acc[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[e] = 0.f;
      for (int r0 = 0; r0 < R; r0 += 4) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x[16];
          xe_unit<CVT>(P, a.ue, min(r0 + i, R - 1), k, x);
          const float u = s.su[r0 + i];
#pragma unroll
          for (int e = 0; e < 16; ++e) acc[e] = fmaf(x[e], u, acc[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < 16; ++e) s.acc_e[e * (a.ue + 1) + k] += acc[e];
    }
  } else {
    // D[s][j] = sum_r U[s][r] X[r][j] over an 8-column tile: A = the u
    // split (rows 0..nsplit-1), B = the staged slice (rows past R zero).
    constexpr int nsplit = BM == B_MMA2 ? 2 : 3;
    const int g = lane >> 2, tq = lane & 3;
    auto uterm = [&](int r) {
      return g < nsplit ? __bfloat162float(s.us[g * kMaxRows + r]) : 0.f;
    };
    const uint32_t a0 = pack_bf16(uterm(2 * tq), uterm(2 * tq + 1));
    const uint32_t a2 = pack_bf16(uterm(2 * tq + 8), uterm(2 * tq + 9));
    for (int tile = warp; tile < 2 * my_ue; tile += kWarps) {
      const int j = tile * 8 + g;
      auto x = [&](int r) { return r < R ? xe_at<CVT>(P, a.ue, r, j) : 0.f; };
      const uint32_t b0 = pack_bf16(x(2 * tq), x(2 * tq + 1));
      const uint32_t b1 = pack_bf16(x(2 * tq + 8), x(2 * tq + 9));
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(d, a0, 0u, a2, 0u, b0, b1);
      // Lanes 0..3 hold D[0][2tq..2tq+1]; the other terms' rows sit 4 and
      // 8 lanes up.
      float s0 = d[0], s1 = d[1];
#pragma unroll
      for (int t = 1; t < nsplit; ++t) {
        s0 += __shfl_down_sync(0xffffffffu, d[0], 4 * t);
        s1 += __shfl_down_sync(0xffffffffu, d[1], 4 * t);
      }
      if (g == 0) {
        s.acc_e[acc_idx(tile * 8 + 2 * tq, a.ue)] += s0;
        s.acc_e[acc_idx(tile * 8 + 2 * tq + 1, a.ue)] += s1;
      }
    }
  }
  for (int k = threadIdx.x; k < my_uf; k += kThreads) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r0 = 0; r0 < R; r0 += 4) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 x = reinterpret_cast<const float4*>(
            P.f)[(size_t)min(r0 + i, R - 1) * a.uf + k];
        const float u = s.su[r0 + i];
        acc.x = fmaf(x.x, u, acc.x);
        acc.y = fmaf(x.y, u, acc.y);
        acc.z = fmaf(x.z, u, acc.z);
        acc.w = fmaf(x.w, u, acc.w);
      }
    }
    float4* dst = reinterpret_cast<float4*>(s.acc_f) + k;
    const float4 old = *dst;
    *dst = make_float4(old.x + acc.x, old.y + acc.y, old.z + acc.z,
                       old.w + acc.w);
  }
}

template <int AM, int BM, bool CVT>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    onepass_kernel(Args a) {
  extern __shared__ __align__(16) char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int64_t cid = blockIdx.x / kCluster;
  const int64_t n_clusters = gridDim.x / kCluster;
  const Smem s = carve(smem_raw, a.R, a.ue, a.uf, CVT);
  const int ue_tot = (int)(a.lde / 16), uf_tot = (int)(a.ldf / 4);
  const int ue0 = rank * a.ue, uf0 = rank * a.uf;
  const int my_ue = max(0, min(a.ue, ue_tot - ue0));
  const int my_uf = max(0, min(a.uf, uf_tot - uf0));
  for (int i = threadIdx.x; i < (a.ue + 1) * 16; i += kThreads)
    s.acc_e[i] = 0.f;
  for (int i = threadIdx.x; i < a.uf * 4; i += kThreads) s.acc_f[i] = 0.f;

  // Zeroed buffers (generic writes), ordered before the bulk copies
  // (async proxy) that will overwrite them.
  for (size_t i = threadIdx.x; i < 2 * panel_bytes(a.R, a.ue, a.uf) / 16;
       i += kThreads)
    reinterpret_cast<uint4*>(s.raw[0])[i] = make_uint4(0, 0, 0, 0);
  if (threadIdx.x == 0) {
    bar_init(&s.bar[0]);
    bar_init(&s.bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const bool producer = threadIdx.x < 32;
  if (producer && cid < a.n_panels)
    stage(a, s.raw[0], &s.bar[0], cid * a.R, ue0, my_ue, uf0, my_uf);
  int it = 0;
  for (int64_t panel = cid; panel < a.n_panels;
       panel += n_clusters, ++it) {
    const int cur = it & 1;
    // The next panel's copies go out before this one's arithmetic; its
    // buffer was last read by the previous panel's phase B, which every
    // thread finished at the barrier closing that iteration.
    const int64_t next = panel + n_clusters;
    if (producer && next < a.n_panels)
      stage(a, s.raw[cur ^ 1], &s.bar[cur ^ 1], next * a.R, ue0, my_ue,
            uf0, my_uf);
    bar_wait(&s.bar[cur], (it >> 1) & 1);  // this panel's bytes landed
    char* buf = s.raw[cur];
    Panel P;
    P.e8 = reinterpret_cast<const int8_t*>(buf);
    P.f = reinterpret_cast<const float*>(buf + (size_t)a.R * a.ue * 16);
    P.ef = s.cvt;
    if constexpr (CVT) {
      for (int idx = threadIdx.x; idx < a.R * a.ue; idx += kThreads) {
        float x[16];
        Vec<int8_t>::cvt(reinterpret_cast<const uint4*>(buf)[idx], x);
        float4* p = reinterpret_cast<float4*>(s.cvt + (size_t)idx * 16);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[e] = make_float4(x[4 * e], x[4 * e + 1], x[4 * e + 2],
                             x[4 * e + 3]);
      }
      __syncthreads();
    }
    phase_a<AM, CVT>(a, s, P, ue0, my_ue, uf0, my_uf);
    __syncthreads();
    float* part = s.part + cur * kMaxRows;
    if (threadIdx.x < kMaxRows) {
      float pe_sum = 0.f, pf_sum = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        pe_sum += s.we[w * kMaxRows + threadIdx.x];
        if (AM != A_FMA) pf_sum += s.wf[w * kMaxRows + threadIdx.x];
      }
      part[threadIdx.x] = pe_sum + pf_sum;
    }
    cluster.sync();  // every CTA's partials are visible to the cluster
    if (threadIdx.x < kMaxRows) {
      const int r = threadIdx.x;
      const int64_t row = panel * a.R + r;
      float u = 0.f;
      if (r < a.R && row < a.n) {
        float q_part[kCluster];
#pragma unroll
        for (int q = 0; q < kCluster; ++q)
          q_part[q] = cluster.map_shared_rank(part, q)[r];
        float t = 0.f;
#pragma unroll
        for (int q = 0; q < kCluster; ++q) t += q_part[q];
        u = a.w[row] * (t + a.c[row]);
        if (rank == 0) a.u[row] = u;
      }
      s.su[r] = u;
      const __nv_bfloat16 hi = __float2bfloat16_rn(u);
      const float res = u - __bfloat162float(hi);
      const __nv_bfloat16 mid = __float2bfloat16_rn(res);
      s.us[r] = hi;
      s.us[kMaxRows + r] = mid;
      s.us[2 * kMaxRows + r] = __float2bfloat16_rn(
          BM == B_MMA3 ? res - __bfloat162float(mid) : 0.f);
    }
    __syncthreads();  // u staged
    phase_b<BM, CVT>(a, s, P, my_ue, my_uf);
    __syncthreads();  // this buffer is free for the copies after next
  }
  // No CTA may exit while a cluster peer can still read its partials.
  cluster.sync();
  const int64_t width = (int64_t)a.pe + a.pf;
  float* out = a.partial + cid * width;
  for (int i = threadIdx.x; i < my_ue * 16; i += kThreads) {
    const int col = ue0 * 16 + i;
    if (col < a.pe) out[col] = s.acc_e[(i & 15) * (a.ue + 1) + (i >> 4)];
  }
  for (int i = threadIdx.x; i < my_uf * 4; i += kThreads) {
    const int col = uf0 * 4 + i;
    if (col < a.pf) out[a.pe + col] = s.acc_f[i];
  }
}

template <int AM, int BM, bool CVT>
cudaError_t launch(Args a, int max_clusters, float* out,
                   cudaStream_t stream) {
  auto kern = onepass_kernel<AM, BM, CVT>;
  const size_t smem = smem_bytes(a.R, a.ue, a.uf, CVT);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // As many clusters as the card holds at once (a second wave would
  // idle most SMs), capped by the caller's scratch and the panel count.
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * max_clusters);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  int fit = 0;
  err = cudaOccupancyMaxActiveClusters(&fit, kern, &cfg);
  if (err != cudaSuccess) return err;
  if (fit < 1) return cudaErrorInvalidConfiguration;
  int64_t clusters = fit < max_clusters ? fit : max_clusters;
  if (clusters > a.n_panels) clusters = a.n_panels;
  onepass_kernel<AM, BM, CVT>
      <<<(unsigned)(kCluster * clusters), kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t width = (int64_t)a.pe + a.pf;
  const int rgrid = (int)bbsweep::min64(
      (width + bbsweep::kThreads - 1) / bbsweep::kThreads, 4096);
  bbsweep::reduce_segments_kernel<<<rgrid, bbsweep::kThreads, 0, stream>>>(
      a.partial, (int)clusters, width, out);
  return cudaGetLastError();
}

template <int AM, int BM>
cudaError_t launch_cvt(Args a, int cvt, int max_clusters, float* out,
                       cudaStream_t s) {
  return cvt ? launch<AM, BM, true>(a, max_clusters, out, s)
             : launch<AM, BM, false>(a, max_clusters, out, s);
}

template <int AM>
cudaError_t launch_b(Args a, int b_mode, int cvt, int max_clusters,
                     float* out, cudaStream_t s) {
  switch (b_mode) {
    case B_FMA: return launch_cvt<AM, B_FMA>(a, cvt, max_clusters, out, s);
    case B_MMA2: return launch_cvt<AM, B_MMA2>(a, cvt, max_clusters, out, s);
    case B_MMA3: return launch_cvt<AM, B_MMA3>(a, cvt, max_clusters, out, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace bbonepass

// C interface (ctypes). a_mode 0 fma, 1 mma2, 2 mma1; b_mode 0 fma, 1
// mma2, 2 mma3; cvt 0/1. Xf may be NULL with pf = 0. ve / vf are padded
// with zeros to lde / ldf. partial: max_clusters * (pe + pf) floats of
// scratch; out: pe + pf floats (out_e then out_f); u: n floats. Returns
// the CUDA error of the launches (0 = ok).
extern "C" int bb_ne_onepass(const int8_t* Xe, long long lde, int pe,
                             const float* Xf, long long ldf, int pf,
                             const float* ve, const float* vf,
                             const float* c, const float* w, long long n,
                             int rows, int ue, int uf, int a_mode,
                             int b_mode, int cvt, int max_clusters,
                             float* u, float* partial, float* out,
                             void* stream) {
  using namespace bbonepass;
  Args a{Xe, lde, pe, Xf, ldf, pf, ve, vf, c, w, n, rows, ue, uf,
         (n + rows - 1) / rows, u, partial};
  auto s = static_cast<cudaStream_t>(stream);
  switch (a_mode) {
    case A_FMA: return (int)launch_b<A_FMA>(a, b_mode, cvt, max_clusters,
                                           out, s);
    case A_MMA2: return (int)launch_b<A_MMA2>(a, b_mode, cvt, max_clusters,
                                             out, s);
    case A_MMA1: return (int)launch_b<A_MMA1>(a, b_mode, cvt, max_clusters,
                                             out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of one CTA for a plan (the wrapper picks R).
extern "C" long long bb_ne_onepass_smem(int rows, int ue, int uf, int cvt) {
  return (long long)bbonepass::smem_bytes(rows, ue, uf, cvt != 0);
}
