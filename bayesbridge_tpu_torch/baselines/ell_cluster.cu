// The ell kernel's cluster traversal: a copy kept for the harness
// (baselines/ell_variants.py, routes cluster, cluster-c<C> and
// cluster-local), never built into the library. The harness appends it
// to csrc/ell.cu (whose helpers it uses) and builds the pair with nvcc.
//
// It is the first design of the row-ELL's k-vector product tried for the
// H100: the k vectors spread over the shared memory of a thread-block
// cluster, every gather of another CTA's inputs over the SM-to-SM network
// (mapa + ld.shared::cluster). On the H100 the network served these
// random 8-64 byte gathers at about 1.1 TB/s over the card, a third of
// L2's sector rate, so at the ell slice's 16,384 inputs every cluster of
// two or more CTAs lost to one CTA that stages what it can and gathers
// the rest through L2 (PERF.md section 6): the library ships that, the
// staged traversal (csrc/ell.cu ell_st_kernel).

namespace {

// A row-ELL's rows each span the whole input axis, so at k >= 2 vectors
// of the ell slice's 16,384 inputs (256 KB and more in float64) every
// gather of the first traversal goes to L2 and moves a 32-byte sector:
// it runs at L2's gather rate, 22-48% of its bound. Here a cluster of C
// CTAs (C = 1, 2, 4, 8 or 16) holds the k interleaved vectors in its
// shared memory for the whole launch: the inputs are cut into chunks of
// kChunk, and chunk g lies in CTA g % C of the cluster, at local chunk g
// / C, staged once by bulk copies on one mbarrier. A slot whose index j
// lies in a staged chunk reads its k values from the owning CTA's shared
// memory (mapa + ld.shared::cluster, 16-byte loads where k allows); a
// slot past the staged inputs (a plan whose vectors outgrow the cluster:
// the partial stage) reads them through L2 as the first traversal does.
// The clusters are persistent: CTA b of the grid owns ELL rows [b
// rows_cta, (b + 1) rows_cta), walked one warp a row; lane l adds slots
// l, l + 32, ... in order with one FMA each and the lanes meet in the
// same xor tree as ell_kernel, so each vector is the bits of the first
// traversal (and of its single launch) whichever CTA takes the row.
// A warp loads the next group of kClUnroll 32-slot runs (of the same row
// or the next) before the arithmetic of the current one.

constexpr int kChunkShift = 8;  // inputs a chunk: 256
constexpr int kClWarps = 16;
constexpr int kClThreads = kClWarps * 32;
// 32-slot runs a warp loads at once, by k = 1..8, float64 and float32.
constexpr int kClUnrollF64[kMaxVectors + 1] = {0, 4, 4, 2, 2, 2, 2, 2, 2};
constexpr int kClUnrollF32[kMaxVectors + 1] = {0, 4, 4, 4, 4, 2, 2, 2, 2};

template <typename T, int K>
__host__ __device__ constexpr int cl_unroll() {
  return sizeof(T) == 8 ? kClUnrollF64[K] : kClUnrollF32[K];
}

// This CTA's shared address `a` as the same offset in CTA `rank` of the
// cluster.
__device__ __forceinline__ uint32_t cl_peer(uint32_t a, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
}

// x[0..K) from the cluster's shared memory at `a`, in 16- or 8-byte
// loads where K allows (a is aligned to K * sizeof(T)).
template <int K>
__device__ __forceinline__ void load_kc(uint32_t a, float (&x)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int i = 0; i < K / 4; ++i)
      asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                   : "=f"(x[4 * i]), "=f"(x[4 * i + 1]), "=f"(x[4 * i + 2]),
                     "=f"(x[4 * i + 3])
                   : "r"(a + 16 * i));
  } else if constexpr (K % 2 == 0) {
#pragma unroll
    for (int i = 0; i < K / 2; ++i)
      asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
                   : "=f"(x[2 * i]), "=f"(x[2 * i + 1])
                   : "r"(a + 8 * i));
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i)
      asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
                   : "=f"(x[i])
                   : "r"(a + 4 * i));
  }
}

template <int K>
__device__ __forceinline__ void load_kc(uint32_t a, double (&x)[K]) {
  if constexpr (K % 2 == 0) {
#pragma unroll
    for (int i = 0; i < K / 2; ++i)
      asm volatile("ld.shared::cluster.v2.f64 {%0, %1}, [%2];\n"
                   : "=d"(x[2 * i]), "=d"(x[2 * i + 1])
                   : "r"(a + 16 * i));
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i)
      asm volatile("ld.shared::cluster.f64 %0, [%1];\n"
                   : "=d"(x[i])
                   : "r"(a + 8 * i));
  }
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}

// Grid: n_cl clusters of C CTAs; block kClThreads. xt holds chunks_cta
// * C chunks of k values (the wrapper pads it); inputs below n_staged are
// gathered from the cluster, the rest (never in a plan that stages all
// of them) from xt.
template <typename T, int K, int kPower>
__global__ void __launch_bounds__(kClThreads, 1) ell_cl_kernel(
    const int32_t* __restrict__ idx, const T* __restrict__ val, int64_t m,
    int width, const T* __restrict__ xt, int log2c, int chunks_cta,
    int n_staged, int64_t rows_cta, T* __restrict__ out) {
  using namespace bbasync;
  constexpr int U = cl_unroll<T, K>();
  constexpr int kChunk = 1 << kChunkShift;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ uint64_t full;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int C = 1 << log2c;
  const int rank = blockIdx.x & (C - 1);
  const uint32_t chunk_bytes = (uint32_t)(kChunk * K * sizeof(T));

  if (threadIdx.x == 0) {
    bar_init(&full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 0) {  // this CTA's chunks: rank, rank + C, ...
    if (lane == 0) bar_expect(&full, chunk_bytes * chunks_cta);
    __syncwarp();
    for (int t = lane; t < chunks_cta; t += 32)
      bulk_copy(smem_raw + (size_t)t * chunk_bytes,
                xt + ((int64_t)t * C + rank) * kChunk * K, chunk_bytes,
                &full);
  }
  bar_wait<true>(&full, 0);
  __syncwarp();
  cluster_barrier();  // every CTA's chunks are in place

  const uint32_t base = saddr(smem_raw);
  const int64_t r0 = (int64_t)blockIdx.x * rows_cta;
  const int64_t r1 = min(m, r0 + rows_cta);
  const int groups = (width + 32 * U - 1) / (32 * U);  // per row
  int64_t row = r0 + warp;
  int grp = 0;
  int32_t ii[U];
  T vv[U];
  auto load_group = [&](int64_t r, int g, int32_t (&gi)[U], T (&gv)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = g * 32 * U + 32 * u + lane;
      const bool in = r < r1 && s < width;
      gi[u] = in ? __ldg(idx + r * width + s) : 0;
      gv[u] = in ? __ldg(val + r * width + s) : T(0);
    }
  };
  load_group(row, grp, ii, vv);
  T acc[K];
#pragma unroll
  for (int c = 0; c < K; ++c) acc[c] = T(0);
  while (row < r1) {  // warp-uniform
    int32_t ci[U];
    T cv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ci[u] = ii[u];
      cv[u] = vv[u];
    }
    const int64_t cur = row;
    const int cg = grp;
    if (++grp == groups) {
      grp = 0;
      row += kClWarps;
    }
    load_group(row, grp, ii, vv);  // the next group's loads in flight
    T xj[U][K];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = ci[u];
      if (j < n_staged) {
        const int g = j >> kChunkShift;
        const int local = ((g >> log2c) << kChunkShift) | (j & (kChunk - 1));
        load_kc<K>(cl_peer(base + (uint32_t)(local * K * sizeof(T)),
                           (uint32_t)(g & (C - 1))),
                   xj[u]);
      } else {
        load_k<K>(xt + (int64_t)j * K, xj[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (cg * 32 * U + 32 * u + lane < width) {
        T a = cv[u];
        if (kPower == 2) a = a * a;
#pragma unroll
        for (int c = 0; c < K; ++c) acc[c] = fma_t<T>(a, xj[u][c], acc[c]);
      }
    }
    if (cg == groups - 1) {  // the row's last group: the lanes meet
#pragma unroll
      for (int c = 0; c < K; ++c) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
      }
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < K; ++c) out[c * m + cur] = acc[c];
      }
#pragma unroll
      for (int c = 0; c < K; ++c) acc[c] = T(0);
    }
  }
  __syncwarp();
  cluster_barrier();  // no CTA leaves while a peer may read its chunks
}

template <typename T, int K, int kPower>
cudaError_t cl_config(int log2c, int chunks_cta, int n_cl,
                      cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  const size_t smem = (size_t)chunks_cta * (K * sizeof(T)) << kChunkShift;
  if (smem > (size_t)kMaxSmem || log2c < 0 || log2c > 4)
    return cudaErrorInvalidConfiguration;
  auto kern = ell_cl_kernel<T, K, kPower>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && log2c > 3)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1u << log2c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->gridDim = dim3((unsigned)n_cl << log2c);
  cfg->blockDim = dim3(kClThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <typename T, int K, int kPower>
cudaError_t launch_cl_p(const int32_t* idx, const T* val, int64_t m,
                        int width, const T* xt, int log2c, int chunks_cta,
                        int n_staged, int n_cl, T* out, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t err = cl_config<T, K, kPower>(log2c, chunks_cta, n_cl, &cfg,
                                            attr);
  if (err != cudaSuccess) return err;
  cfg.stream = s;
  const int64_t ctas = (int64_t)n_cl << log2c;
  const int64_t rows_cta = (m + ctas - 1) / ctas;
  return cudaLaunchKernelEx(&cfg, ell_cl_kernel<T, K, kPower>, idx, val, m,
                            width, xt, log2c, chunks_cta, n_staged, rows_cta,
                            out);
}

template <typename T, int K>
int fit_cl(int log2c, int chunks_cta) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  if (cl_config<T, K, 1>(log2c, chunks_cta, 1, &cfg, attr) != cudaSuccess)
    return -1;
  int fit = 0;
  if (cudaOccupancyMaxActiveClusters(&fit, ell_cl_kernel<T, K, 1>, &cfg) !=
      cudaSuccess)
    return -1;
  return fit;
}

template <typename T>
cudaError_t launch_cl(const int32_t* idx, const T* val, int64_t m,
                      int width, const T* xt, int k, int power, int log2c,
                      int chunks_cta, int n_staged, int n_cl, T* out,
                      cudaStream_t s) {
#define BB_CL_K(KK)                                                         \
  case KK:                                                                  \
    return power == 2 ? launch_cl_p<T, KK, 2>(idx, val, m, width, xt,      \
                                              log2c, chunks_cta, n_staged, \
                                              n_cl, out, s)                \
                      : launch_cl_p<T, KK, 1>(idx, val, m, width, xt,      \
                                              log2c, chunks_cta, n_staged, \
                                              n_cl, out, s);
  switch (k) {
    BB_CL_K(1) BB_CL_K(2) BB_CL_K(3) BB_CL_K(4)
    BB_CL_K(5) BB_CL_K(6) BB_CL_K(7) BB_CL_K(8)
    default: return cudaErrorInvalidValue;
  }
#undef BB_CL_K
}

template <typename T>
int fit_cl_of(int k, int log2c, int chunks_cta) {
  switch (k) {
    case 1: return fit_cl<T, 1>(log2c, chunks_cta);
    case 2: return fit_cl<T, 2>(log2c, chunks_cta);
    case 3: return fit_cl<T, 3>(log2c, chunks_cta);
    case 4: return fit_cl<T, 4>(log2c, chunks_cta);
    case 5: return fit_cl<T, 5>(log2c, chunks_cta);
    case 6: return fit_cl<T, 6>(log2c, chunks_cta);
    case 7: return fit_cl<T, 7>(log2c, chunks_cta);
    case 8: return fit_cl<T, 8>(log2c, chunks_cta);
    default: return -1;
  }
}

}  // namespace

// The cluster traversal (see ell_cl_kernel): clusters of 2^log2c CTAs,
// n_cl of them; each CTA stages chunks_cta chunks of 256 inputs' k values
// from xt (chunks_cta * 2^log2c chunks, padded by the caller); inputs
// below n_staged are gathered from the cluster's shared memory. Returns
// the CUDA error of the launch (0 = ok).
extern "C" int bb_ell_cl(const int32_t* idx, const void* val, long long m,
                         int width, const void* xt, int k, int power,
                         int f64, int log2c, int chunks_cta, int n_staged,
                         int n_cl, void* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || width <= 0 || k < 1 || k > kMaxVectors ||
      (power != 1 && power != 2) || log2c < 0 || log2c > 4 ||
      chunks_cta < 1 || n_staged < 0 || n_cl < 1 ||
      ((long long)chunks_cta << (log2c + kChunkShift)) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (f64)
    return (int)launch_cl<double>(
        idx, static_cast<const double*>(val), m, width,
        static_cast<const double*>(xt), k, power, log2c, chunks_cta,
        n_staged, n_cl, static_cast<double*>(out), s);
  return (int)launch_cl<float>(
      idx, static_cast<const float*>(val), m, width,
      static_cast<const float*>(xt), k, power, log2c, chunks_cta, n_staged,
      n_cl, static_cast<float*>(out), s);
}

// The most clusters of 2^log2c CTAs, each staging chunks_cta chunks of k
// vectors, that the card holds at once (cudaOccupancyMaxActiveClusters);
// 0 or less where the launch does not fit.
extern "C" int bb_ell_cl_fit(int k, int f64, int log2c, int chunks_cta) {
  if (k < 1 || k > kMaxVectors || chunks_cta < 1) return -1;
  return f64 ? fit_cl_of<double>(k, log2c, chunks_cta)
             : fit_cl_of<float>(k, log2c, chunks_cta);
}
