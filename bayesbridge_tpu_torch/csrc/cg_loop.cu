// The CG solve's update, and the graph that loops it on the card.
//
// Replaces no Pallas kernel: the JAX package runs the prior-preconditioned
// CG solve (bayesbridge_tpu/ops/cg.py:173-210) as one lax.while_loop, a
// device loop with no host round trip, whose body is the operator's design
// products (the Pallas kernels of design/) and a few vector updates. Here
// the design products keep their own kernels, and the rest of the body,
// one iteration's update for every chain c (blockIdx.y) whose flag is set,
// is
//
//   Ap = d p + s out, alpha = rs / (p . Ap)
//   x += alpha p, r -= alpha Ap, yhat += alpha t,
//   rs' = r . r, beta = rs' / rs, n_iter += 1,
//   running = rs' > thresh && n_iter < maxiter
//   p = r + beta p, sp = s p (the next operator input), the loop's
//   condition any(running) where a graph runs the loop, and iters += 1
//   (the runs of the iteration, once a launch)
//
// on one of two routes, chosen by shape (bb_cg_iter_fits) and giving the
// same bits:
//
//   cg_iter   one kernel an iteration (bb_cg_iter): the chain's blocks
//             (512 threads each, up to 16: a non-portable cluster) as one
//             thread-block cluster, the three phases separated by cluster
//             barriers, the blocks' partial sums read through distributed
//             shared memory, each thread's p, Ap then r, x and s read once
//             into registers and kept from phase to phase (Ap never
//             touches memory); up to Keep elements a thread (m <= 65,536
//             in float32, 32,768 in float64);
//   three     cg_ap, cg_step, cg_dir (bb_cg_update), three launches an
//             iteration whose sums cross blocks by a threadfence and an
//             atomic ticket; any m. The first design, kept for the shapes
//             cg_iter does not take.
//
// A chain whose flag is clear is left untouched, as vmap of the JAX
// while_loop masks it. cg_start sets the loop up from the initial
// residual: p = r, sp = s r, rs = r . r, thresh = max(atol, 50 eps |b|)^2
// (the float32 floor of ops/cg.py:166-170, eps that of the inputs' type,
// floor_eps), n_iter = 0, iters = 0, the flags and the first condition.
//
// Sums over a chain's vector run in an order fixed by its length alone: a
// unit of 256 threads per 1,024 elements up to 32 units a chain, each
// thread's elements in index order (stride: the units' threads), the
// unit's threads by shuffles and then its warps in order, the units'
// partials summed in unit order. In the three-kernel route a unit is a
// block and the chain's last block adds the partials (after a threadfence
// and an atomic ticket); in cg_iter a block carries two units in order
// and every block of the cluster adds all the partials itself. So both
// routes give the same bits, chain c of a batch gets the bits it gets
// alone, and a rerun gets the same bits.
//
// The loop (bb_cg_graph_new, bb_cg_graph_finish): a CUDA graph whose root
// is the captured prologue (a child graph node: the warm start, the initial
// residual and cg_start), then a conditional WHILE node whose body is the
// captured iteration (a child graph node: the operator's design products,
// then the update). cg_start and the update set the node's condition from
// inside those child graphs (the handle is made first, with the graph that
// owns it, and the captures take it as an argument; on CUDA 12.9 over a
// 13.0 driver a kernel in a child graph sets it as one in the body graph
// itself does). One launch of the instantiated graph runs the whole solve;
// the host reads nothing until it ends.
//
// Inside the capture of a whole Gibbs step (kernels/step_graph.py) the loop
// is built in the graph being captured instead (bb_cg_capture_handle,
// bb_cg_capture_while, bb_cg_capture_end): the condition handle is made on
// that graph, the prologue is captured inline, then a WHILE node is added
// after everything captured so far, made the capture's only dependency,
// and a second stream captures the iteration into the node's body graph
// (cudaStreamBeginCaptureToGraph). The WHILE node sits in the step's graph
// itself, never in a child graph. bb_cg_cluster_while_probe checks that a
// cluster launch captures into such a body and loops.
//
// What bounds it on the H100: bytes, in principle: cg_iter reads p, d, s,
// out, x, r and writes x, r, p, sp (10 vectors of p, plus 3 of n with the
// linear predictor) a chain, under 0.001 ms at the flagship's p = 50,001
// in float32; the three kernels move 17 (Ap, p, r and s written by one
// kernel and read back by the next). In fact latency: each launch's start
// and drain, each cross-block sum, and the loads a few SMs can keep in
// flight. cg_iter pays one launch and two cluster barriers an iteration
// where the three kernels pay three launches and three ticket round trips
// through L2; a cluster of 16 blocks beat one of 8 (twice the SMs to load
// through), and the linear predictor goes to every thread of the cluster,
// batched, after the sums (PERF.md).

#include <atomic>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#if CUDART_VERSION >= 12030
#define BB_HAS_WHILE 1
#else
#define BB_HAS_WHILE 0
typedef unsigned long long cudaGraphConditionalHandle;
#endif

namespace bbcg {

// The arguments of every kernel, mirrored by kernels/cg_loop.py's CgArgs
// (outside the unnamed namespace: the C entries take it, and a type of
// internal linkage would hide them from the library's symbols):
// (k, m) row-major vectors x, r, p, sp, ap, out, s, d, b; (k, n) y and t
// (null without the linear predictor); (k,) per-chain scalars.
struct CgArgs {
  void* x;
  void* r;
  void* p;
  void* sp;
  void* ap;
  const void* out;
  const void* s;
  const void* d;
  const void* b;
  void* y;
  const void* t;
  void* rs;
  void* thresh;
  void* alpha;
  void* beta;
  const void* atol;      // one value of the vectors' type
  int* n_iter;
  int* running;
  int* moved;            // the chain stepped in this iteration
  void* partial;         // k * 2 * nb values of the vectors' type
  unsigned* ticket;      // k counters, zero between launches
  unsigned* done;        // one counter, zero between launches
  int* iters;            // runs of the iteration since cg_start
  long long m;           // the vectors' length (p)
  long long n;           // y's length (0: no y)
  unsigned long long handle;  // the WHILE node's condition
  double floor_eps;      // eps of the tolerance's float32 floor
  int k;
  int nb;                // blocks a chain
  int maxiter;
  int has_handle;
};

}  // namespace bbcg

using bbcg::CgArgs;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerBlock = 1024;  // elements a block's share starts at
constexpr int kMaxBlocks = 32;   // blocks a chain

__device__ void set_condition(const CgArgs& a, unsigned value) {
#if BB_HAS_WHILE
  if (a.has_handle)
    cudaGraphSetConditional((cudaGraphConditionalHandle)a.handle, value);
#endif
}

// any(running) over the k chains, as the loop's condition.
__device__ void set_any_running(const CgArgs& a) {
  const volatile int* run = a.running;
  unsigned any = 0;
  for (int c = 0; c < a.k; ++c) any |= run[c] != 0;
  set_condition(a, any);
}

// The block's sum of v in a fixed order: shuffles within each warp, then
// the warps' sums in warp order; valid in thread 0.
template <typename T>
__device__ T block_sum(T v, T* sh) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  T s = T(0);
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) s += sh[w];
  return s;
}

// Chain c's sums of the R per-thread values v: each block's partials, then
// in the chain's last block to arrive the partials in block order. True in
// thread 0 of that block, with the sums in `total`.
template <typename T, int R>
__device__ bool chain_sums(const CgArgs& a, int c, const T (&v)[R],
                           T (&total)[R]) {
  __shared__ T sh[R][kWarps];
  __shared__ bool last;
  T* part = static_cast<T*>(a.partial) + (long long)c * 2 * a.nb;
  T bs[R];
  for (int q = 0; q < R; ++q) bs[q] = block_sum(v[q], sh[q]);
  if (threadIdx.x == 0) {
    for (int q = 0; q < R; ++q) part[q * a.nb + blockIdx.x] = bs[q];
    __threadfence();
    last = atomicAdd(&a.ticket[c], 1u) == unsigned(a.nb - 1);
  }
  __syncthreads();
  if (!last || threadIdx.x != 0) return false;
  __threadfence();
  for (int q = 0; q < R; ++q) {
    T s = T(0);
    for (int b = 0; b < a.nb; ++b) s += __ldcg(part + q * a.nb + b);
    total[q] = s;
  }
  a.ticket[c] = 0;
  return true;
}

__device__ long long first_index() {
  return (long long)blockIdx.x * kThreads + threadIdx.x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) cg_start_kernel(CgArgs a) {
  const int c = blockIdx.y;
  const long long off = (long long)c * a.m;
  const long long stride = (long long)a.nb * kThreads;
  const T* r = static_cast<const T*>(a.r) + off;
  const T* b = static_cast<const T*>(a.b) + off;
  const T* s = static_cast<const T*>(a.s) + off;
  T* p = static_cast<T*>(a.p) + off;
  T* sp = static_cast<T*>(a.sp) + off;
  if (blockIdx.x == 0 && c == 0 && threadIdx.x == 0) *a.iters = 0;
  T v[2] = {T(0), T(0)};
  for (long long i = first_index(); i < a.m; i += stride) {
    const T ri = r[i], bi = b[i];
    p[i] = ri;
    sp[i] = s[i] * ri;
    v[0] += ri * ri;
    v[1] += bi * bi;
  }
  T tot[2];
  if (!chain_sums<T, 2>(a, c, v, tot)) return;
  const T atol = *static_cast<const T*>(a.atol);
  const T least = T(50) * T(a.floor_eps) * sqrt(tot[1]);
  const T tol = atol > least ? atol : least;
  const T th = tol * tol;
  static_cast<T*>(a.rs)[c] = tot[0];
  static_cast<T*>(a.thresh)[c] = th;
  a.n_iter[c] = 0;
  a.running[c] = tot[0] > th && a.maxiter > 0;
  a.moved[c] = 0;
  // The last chain to finish sets the loop's first condition.
  __threadfence();
  if (atomicAdd(a.done, 1u) == unsigned(a.k - 1)) {
    *a.done = 0;
    __threadfence();
    set_any_running(a);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) cg_ap_kernel(CgArgs a) {
  const int c = blockIdx.y;
  if (!a.running[c]) return;
  const long long off = (long long)c * a.m;
  const long long stride = (long long)a.nb * kThreads;
  const T* p = static_cast<const T*>(a.p) + off;
  const T* out = static_cast<const T*>(a.out) + off;
  const T* s = static_cast<const T*>(a.s) + off;
  const T* d = static_cast<const T*>(a.d) + off;
  T* ap = static_cast<T*>(a.ap) + off;
  T v[1] = {T(0)};
  for (long long i = first_index(); i < a.m; i += stride) {
    const T pi = p[i];
    const T api = d[i] * pi + s[i] * out[i];
    ap[i] = api;
    v[0] += pi * api;
  }
  T tot[1];
  if (chain_sums<T, 1>(a, c, v, tot))
    static_cast<T*>(a.alpha)[c] = static_cast<const T*>(a.rs)[c] / tot[0];
}

template <typename T>
__global__ void __launch_bounds__(kThreads) cg_step_kernel(CgArgs a) {
  const int c = blockIdx.y;
  if (!a.running[c]) {
    if (blockIdx.x == 0 && threadIdx.x == 0) a.moved[c] = 0;
    return;
  }
  const long long off = (long long)c * a.m;
  const long long stride = (long long)a.nb * kThreads;
  const T alpha = static_cast<const T*>(a.alpha)[c];
  const T* p = static_cast<const T*>(a.p) + off;
  const T* ap = static_cast<const T*>(a.ap) + off;
  T* x = static_cast<T*>(a.x) + off;
  T* r = static_cast<T*>(a.r) + off;
  T v[1] = {T(0)};
  for (long long i = first_index(); i < a.m; i += stride) {
    x[i] += alpha * p[i];
    const T ri = r[i] - alpha * ap[i];
    r[i] = ri;
    v[0] += ri * ri;
  }
  if (a.y != nullptr) {
    T* y = static_cast<T*>(a.y) + (long long)c * a.n;
    const T* t = static_cast<const T*>(a.t) + (long long)c * a.n;
    for (long long i = first_index(); i < a.n; i += stride)
      y[i] += alpha * t[i];
  }
  T tot[1];
  if (!chain_sums<T, 1>(a, c, v, tot)) return;
  T* rs = static_cast<T*>(a.rs);
  const T rs_new = tot[0];
  static_cast<T*>(a.beta)[c] = rs_new / rs[c];
  rs[c] = rs_new;
  const int it = a.n_iter[c] + 1;
  a.n_iter[c] = it;
  a.running[c] = rs_new > static_cast<const T*>(a.thresh)[c]
                 && it < a.maxiter;
  a.moved[c] = 1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) cg_dir_kernel(CgArgs a) {
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {
    set_any_running(a);
    ++*a.iters;
  }
  const int c = blockIdx.y;
  if (!a.moved[c]) return;
  const long long off = (long long)c * a.m;
  const long long stride = (long long)a.nb * kThreads;
  const T beta = static_cast<const T*>(a.beta)[c];
  const T* r = static_cast<const T*>(a.r) + off;
  const T* s = static_cast<const T*>(a.s) + off;
  T* p = static_cast<T*>(a.p) + off;
  T* sp = static_cast<T*>(a.sp) + off;
  for (long long i = first_index(); i < a.m; i += stride) {
    const T pi = r[i] + beta * p[i];
    p[i] = pi;
    sp[i] = s[i] * pi;
  }
}

// ---- cg_iter: one kernel an iteration, a cluster a chain ----------------

// 256-thread units a block of cg_iter: 2 (512 threads, clusters of up to
// 16 blocks, past the portable 8, and up to 128 registers a thread; four
// units, 1,024 threads in clusters of 8, spilled and ran slower).
constexpr int kUnits = 2;
constexpr int kIterThreads = kUnits * kThreads;
constexpr int kMaxCluster = kMaxBlocks / kUnits;

// Elements of each vector a thread keeps in registers (so m <= Keep x
// 8,192): 8 in float32, 4 in float64, five vectors of them (p, Ap then r,
// r, x, s) within the 128 registers a thread of a 512-thread block has.
template <typename T>
struct Keep {
  static constexpr int value = 32 / int(sizeof(T));
};

// The cluster's barrier in two halves: arrive (release) and wait
// (acquire), every thread of every block.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The loop's bookkeeping once every chain is through its step: the chain's
// flag was written before the threadfence; the last chain to arrive sets
// the condition any(running) and counts the iteration's run.
__device__ void arrive_done(const CgArgs& a) {
  __threadfence();
  if (atomicAdd(a.done, 1u) == unsigned(a.k - 1)) {
    *a.done = 0;
    __threadfence();
    set_any_running(a);
    ++*a.iters;
  }
}

// The chain's sum of the per-thread values v, in the three kernels' order:
// each unit's shuffles and warps in order into part[unit] (this block's
// shared memory), the cluster barrier, then warp 0 of every block reads
// the nb unit partials through distributed shared memory and adds them in
// unit order. Every thread returns the sum.
template <typename T>
__device__ T cluster_sum(T v, T (*sh)[kWarps], T* part, T* total, int nb) {
  namespace cgr = cooperative_groups;
  const int unit = threadIdx.x / kThreads;
  const int w = (threadIdx.x % kThreads) >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) sh[unit][w] = v;
  __syncthreads();
  if (threadIdx.x % kThreads == 0) {
    T s = T(0);
    for (int q = 0; q < kWarps; ++q) s += sh[unit][q];
    part[unit] = s;
  }
  cgr::this_cluster().sync();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    T mine = T(0);
    if (lane < nb)
      mine = *cgr::this_cluster().map_shared_rank(part + lane % kUnits,
                                                 lane / kUnits);
    T s = T(0);
    for (int b = 0; b < nb; ++b) s += __shfl_sync(0xffffffffu, mine, b);
    if (lane == 0) *total = s;
  }
  __syncthreads();
  return *total;
}

// Bytes of y and of t a thread of cg_iter has in flight at once.
constexpr int kYBytes = 32;

// y += alpha t over the chain's n elements, elementwise, by every thread
// of the cluster: kYBytes of each a thread in flight, all loads of a
// batch issued before its stores (y and t may alias as far as the
// compiler knows, so a plain loop waits a round trip an element).
template <typename T>
__device__ void axpy_cluster(T* y, const T* t, T alpha, long long n) {
  constexpr int U = kYBytes / int(sizeof(T));
  const long long all = (long long)gridDim.x * kIterThreads;
  for (long long base = (long long)blockIdx.x * kIterThreads + threadIdx.x;
       base < n; base += U * all) {
    T yv[U], tv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = base + u * all;
      if (i < n) {
        yv[u] = y[i];
        tv[u] = t[i];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = base + u * all;
      if (i < n) y[i] = yv[u] + alpha * tv[u];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kIterThreads, 1) cg_iter_kernel(CgArgs a) {
  constexpr int E = Keep<T>::value;
  __shared__ T sh[kUnits][kWarps];
  __shared__ T part[2][kUnits];
  __shared__ T total[2];
  const int c = blockIdx.y;
  const unsigned rank = blockIdx.x;  // the cluster spans the grid's x
  // Read before any block of the chain writes the flag (after the first
  // barrier), so every block takes the same branch.
  if (!a.running[c]) {
    if (rank == 0 && threadIdx.x == 0) {
      a.moved[c] = 0;
      arrive_done(a);
    }
    return;
  }
  const int unit = rank * kUnits + threadIdx.x / kThreads;
  const bool live = unit < a.nb;  // units past nb hold no elements
  const long long first = (long long)unit * kThreads + threadIdx.x % kThreads;
  const long long stride = (long long)a.nb * kThreads;
  const long long off = (long long)c * a.m;
  const T* out = static_cast<const T*>(a.out) + off;
  const T* s = static_cast<const T*>(a.s) + off;
  const T* d = static_cast<const T*>(a.d) + off;
  T* x = static_cast<T*>(a.x) + off;
  T* r = static_cast<T*>(a.r) + off;
  T* p = static_cast<T*>(a.p) + off;
  T* sp = static_cast<T*>(a.sp) + off;
  const T rs = static_cast<const T*>(a.rs)[c];
  T* y = a.y == nullptr ? nullptr : static_cast<T*>(a.y) + (long long)c * a.n;
  const T* t = a.y == nullptr ? nullptr
                              : static_cast<const T*>(a.t) + (long long)c * a.n;
  // This thread's elements: p, Ap then r, r, x and s in registers.
  T pk[E], vk[E], rk[E], xk[E], sk[E];

  // Phase 1: Ap = d p + s out and p . Ap; r, x and s read with them.
  T v = T(0);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const long long i = first + e * stride;
    if (live && i < a.m) {
      const T pi = p[i];
      const T si = s[i];
      const T api = d[i] * pi + si * out[i];
      pk[e] = pi;
      vk[e] = api;
      rk[e] = r[i];
      xk[e] = x[i];
      sk[e] = si;
      v += pi * api;
    }
  }
  const T alpha = rs / cluster_sum(v, sh, part[0], &total[0], a.nb);

  // Phase 2: x += alpha p, r -= alpha Ap, and r . r.
  v = T(0);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const long long i = first + e * stride;
    if (live && i < a.m) {
      x[i] = xk[e] + alpha * pk[e];
      const T ri = rk[e] - alpha * vk[e];
      r[i] = ri;
      vk[e] = ri;
      v += ri * ri;
    }
  }
  const T rs_new = cluster_sum(v, sh, part[1], &total[1], a.nb);
  // Every block has read the partials once it passes the wait: a block
  // may exit only then (its shared memory is read by the others).
  cluster_arrive();
  const T beta = rs_new / rs;
  if (rank == 0 && threadIdx.x == 0) {
    static_cast<T*>(a.alpha)[c] = alpha;
    static_cast<T*>(a.beta)[c] = beta;
    static_cast<T*>(a.rs)[c] = rs_new;
    const int it = a.n_iter[c] + 1;
    a.n_iter[c] = it;
    a.running[c] = rs_new > static_cast<const T*>(a.thresh)[c]
                   && it < a.maxiter;
    a.moved[c] = 1;
    arrive_done(a);
  }

  // Phase 3: p = r + beta p, sp = s p.
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const long long i = first + e * stride;
    if (live && i < a.m) {
      const T pi = vk[e] + beta * pk[e];
      p[i] = pi;
      sp[i] = sk[e] * pi;
    }
  }
  // The linear predictor, off the sums' path, beside the barrier's wait.
  if (y != nullptr) axpy_cluster(y, t, alpha, a.n);
  cluster_wait();
}

// Whether cg_iter takes vectors of length m.
bool iter_fits(int f64, long long m) {
  const long long most = (long long)kMaxBlocks * kThreads
                         * (f64 ? Keep<double>::value : Keep<float>::value);
  return m >= 1 && m <= most;
}

// cg_iter's blocks a chain (its cluster): enough for the nb units, and
// up to kMaxCluster for the linear predictor (n elements, a batch of
// kYBytes a thread in flight).
unsigned iter_blocks(int f64, int nb, long long n) {
  const long long units = (nb + kUnits - 1) / kUnits;
  const long long batch = (long long)kIterThreads * (kYBytes / (f64 ? 8 : 4));
  long long want = (n + batch - 1) / batch;
  want = want > kMaxCluster ? kMaxCluster : want;
  return unsigned(units > want ? units : want);
}

// cg_iter at `f64` in *fn, its non-portable cluster sizes allowed on the
// current device where its clusters outgrow 8 blocks. A function's
// attributes hold for one device: the attribute is set once a type and
// device (a bit each of the first 64 devices; past them, every call).
cudaError_t iter_kernel(int f64, const void** fn) {
  static std::atomic<unsigned long long> allowed[2];
  *fn = f64 ? reinterpret_cast<const void*>(cg_iter_kernel<double>)
            : reinterpret_cast<const void*>(cg_iter_kernel<float>);
  if (kMaxCluster <= 8) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ULL << dev : 0ULL;
  if (bit != 0ULL && (allowed[f64 ? 1 : 0].load() & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(*fn,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (err == cudaSuccess) allowed[f64 ? 1 : 0].fetch_or(bit);
  return err;
}

cudaError_t launch_iter(int f64, const CgArgs* a, cudaStream_t st) {
  CgArgs args = *a;
  void* params[] = {&args};
  const unsigned blocks = iter_blocks(f64, a->nb, a->n);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, unsigned(a->k));
  cfg.blockDim = dim3(kIterThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const void* fn = nullptr;
  cudaError_t err = iter_kernel(f64, &fn);
  return err == cudaSuccess ? cudaLaunchKernelExC(&cfg, fn, params) : err;
}

// The probe's kernel: a cluster of two blocks; after a cluster barrier
// block 0 counts a run and keeps the WHILE node looping until `want` runs.
__global__ void probe_kernel(int* count, int want,
                             unsigned long long handle) {
  cooperative_groups::this_cluster().sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const int n = ++*count;
#if BB_HAS_WHILE
    cudaGraphSetConditional((cudaGraphConditionalHandle)handle, n < want);
#else
    (void)n; (void)want; (void)handle;
#endif
  }
}

template <typename T>
void* kernel_of(int which) {
  switch (which) {
    case 0: return reinterpret_cast<void*>(cg_start_kernel<T>);
    case 1: return reinterpret_cast<void*>(cg_ap_kernel<T>);
    case 2: return reinterpret_cast<void*>(cg_step_kernel<T>);
    default: return reinterpret_cast<void*>(cg_dir_kernel<T>);
  }
}

void* kernel_of(int f64, int which) {
  return f64 ? kernel_of<double>(which) : kernel_of<float>(which);
}

cudaError_t launch(int f64, int which, const CgArgs* a, cudaStream_t st) {
  CgArgs args = *a;
  void* params[] = {&args};
  return cudaLaunchKernel(kernel_of(f64, which), dim3(a->nb, a->k),
                          dim3(kThreads), params, 0, st);
}

cudaError_t check_args(const CgArgs* a) {
  if (a->k < 1 || a->k > 65535 || a->m < 1 || a->nb < 1
      || a->nb > kMaxBlocks)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

#if BB_HAS_WHILE
cudaError_t add_while_node(cudaGraphNode_t* node, cudaGraph_t graph,
                           const cudaGraphNode_t* deps, size_t n_deps,
                           cudaGraphConditionalHandle handle,
                           cudaGraph_t* body) {
  cudaGraphNodeParams np = {};
  np.type = cudaGraphNodeTypeConditional;
  np.conditional.handle = handle;
  np.conditional.type = cudaGraphCondTypeWhile;
  np.conditional.size = 1;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaGraphAddNode(node, graph, deps, nullptr, n_deps,
                                     &np);
#else
  cudaError_t err = cudaGraphAddNode(node, graph, deps, n_deps, &np);
#endif
  if (err == cudaSuccess) *body = np.conditional.phGraph_out[0];
  return err;
}

// The graph `st` is capturing and the nodes the next captured work would
// depend on.
cudaError_t capture_info(cudaStream_t st, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* n_deps) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(st, &status, nullptr, graph,
                                             deps, nullptr, n_deps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(st, &status, nullptr, graph,
                                             deps, n_deps);
#endif
  if (err == cudaSuccess && status != cudaStreamCaptureStatusActive)
    err = cudaErrorIllegalState;
  return err;
}
#endif

}  // namespace

// Blocks a chain for vectors of length m (the reduction order's only
// input).
extern "C" int bb_cg_blocks(long long m) {
  long long nb = (m + kPerBlock - 1) / kPerBlock;
  return int(nb < 1 ? 1 : nb > kMaxBlocks ? kMaxBlocks : nb);
}

extern "C" int bb_cg_start(int f64, const CgArgs* a, void* stream) {
  cudaError_t err = check_args(a);
  if (err == cudaSuccess)
    err = launch(f64, 0, a, static_cast<cudaStream_t>(stream));
  return err == cudaSuccess ? int(cudaGetLastError()) : int(err);
}

// One iteration's update on the three-kernel route: cg_ap, cg_step,
// cg_dir.
extern "C" int bb_cg_update(int f64, const CgArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = check_args(a);
  for (int which = 1; err == cudaSuccess && which <= 3; ++which)
    err = launch(f64, which, a, st);
  return err == cudaSuccess ? int(cudaGetLastError()) : int(err);
}

// cg_iter's blocks a chain (its cluster's size) at nb units a chain and a
// linear predictor of n.
extern "C" int bb_cg_iter_blocks(int f64, int nb, long long n) {
  return int(iter_blocks(f64, nb, n));
}

// The clusters of cg_iter (at nb units a chain, a linear predictor of n)
// the current device holds at once (cudaOccupancyMaxActiveClusters), or
// minus a CUDA error.
extern "C" int bb_cg_iter_clusters(int f64, int nb, long long n) {
  const unsigned blocks = iter_blocks(f64, nb, n);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1);
  cfg.blockDim = dim3(kIterThreads);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  const void* fn = nullptr;
  cudaError_t err = iter_kernel(f64, &fn);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
  return err == cudaSuccess ? clusters : -int(err);
}

// Whether the one-kernel update (cg_iter) takes vectors of length m with
// a linear predictor of n on the current device: 1 where m is within its
// registers and the device holds at least one of its clusters, else 0
// (the three-kernel route takes them), or minus a CUDA error.
extern "C" int bb_cg_iter_fits(int f64, long long m, long long n) {
  if (!iter_fits(f64, m)) return 0;
  const int clusters = bb_cg_iter_clusters(f64, bb_cg_blocks(m), n);
  return clusters < 0 ? clusters : clusters > 0 ? 1 : 0;
}

// One iteration's update as one cluster launch (cg_iter).
extern "C" int bb_cg_iter(int f64, const CgArgs* a, void* stream) {
  cudaError_t err = check_args(a);
  if (err == cudaSuccess && !iter_fits(f64, a->m))
    err = cudaErrorInvalidValue;
  if (err == cudaSuccess)
    err = launch_iter(f64, a, static_cast<cudaStream_t>(stream));
  return err == cudaSuccess ? int(cudaGetLastError()) : int(err);
}

// The CUDA runtime this library was built against, the runtime and the
// driver it runs on, each as 1000 * major + 10 * minor.
extern "C" int bb_cg_versions(int* out) {
  out[0] = CUDART_VERSION;
  cudaError_t err = cudaRuntimeGetVersion(&out[1]);
  if (err == cudaSuccess) err = cudaDriverGetVersion(&out[2]);
  return int(err);
}

// A new graph and the condition handle of its WHILE node (made before the
// captures, whose cg_start and cg_dir take the handle).
extern "C" int bb_cg_graph_new(void** graph_out,
                               unsigned long long* handle_out) {
#if BB_HAS_WHILE
  cudaGraph_t graph = nullptr;
  cudaGraphConditionalHandle handle;
  cudaError_t err = cudaGraphCreate(&graph, 0);
  if (err == cudaSuccess)
    err = cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                           cudaGraphCondAssignDefault);
  if (err != cudaSuccess) {
    if (graph != nullptr) cudaGraphDestroy(graph);
    return int(err);
  }
  *graph_out = graph;
  *handle_out = (unsigned long long)handle;
  return 0;
#else
  (void)graph_out; (void)handle_out;
  return int(cudaErrorNotSupported);
#endif
}

// Fill and instantiate `graph` (from bb_cg_graph_new): the captured
// prologue, then WHILE(handle) { the captured iteration }. Both captures
// are cloned into it. Writes the executable graph to `exec_out`.
extern "C" int bb_cg_graph_finish(void* graph, unsigned long long handle,
                                  void* prologue, void* body,
                                  void** exec_out) {
#if BB_HAS_WHILE
  cudaGraph_t g = static_cast<cudaGraph_t>(graph), loop = nullptr;
  cudaGraphExec_t exec = nullptr;
  cudaGraphNode_t n_pro, n_while, n_body;
  cudaError_t err = cudaGraphAddChildGraphNode(
      &n_pro, g, nullptr, 0, static_cast<cudaGraph_t>(prologue));
  if (err == cudaSuccess)
    err = add_while_node(&n_while, g, &n_pro, 1,
                         (cudaGraphConditionalHandle)handle, &loop);
  if (err == cudaSuccess)
    err = cudaGraphAddChildGraphNode(&n_body, loop, nullptr, 0,
                                     static_cast<cudaGraph_t>(body));
  if (err == cudaSuccess) err = cudaGraphInstantiate(&exec, g, 0);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return int(err);
  }
  *exec_out = exec;
  return 0;
#else
  (void)graph; (void)handle; (void)prologue; (void)body; (void)exec_out;
  return int(cudaErrorNotSupported);
#endif
}

// A condition handle (default 0 at each launch) on the graph that `stream`
// is capturing.
extern "C" int bb_cg_capture_handle(void* stream,
                                    unsigned long long* handle_out) {
#if BB_HAS_WHILE
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaGraphConditionalHandle handle;
  cudaError_t err = capture_info(static_cast<cudaStream_t>(stream), &graph,
                                 &deps, &n_deps);
  if (err == cudaSuccess)
    err = cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                           cudaGraphCondAssignDefault);
  if (err == cudaSuccess) *handle_out = (unsigned long long)handle;
  return int(err);
#else
  (void)stream; (void)handle_out;
  return int(cudaErrorNotSupported);
#endif
}

// Append WHILE(handle) to the graph `stream` is capturing, after the
// capture's current dependencies; make the node its only dependency; begin
// capturing `body_stream` into the node's body graph.
extern "C" int bb_cg_capture_while(void* stream, unsigned long long handle,
                                   void* body_stream) {
#if BB_HAS_WHILE
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaGraph_t graph = nullptr, body = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaGraphNode_t node;
  cudaError_t err = capture_info(st, &graph, &deps, &n_deps);
  if (err == cudaSuccess)
    err = add_while_node(&node, graph, deps, n_deps,
                         (cudaGraphConditionalHandle)handle, &body);
  if (err == cudaSuccess)
#if CUDART_VERSION >= 13000
    err = cudaStreamUpdateCaptureDependencies(
        st, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
    err = cudaStreamUpdateCaptureDependencies(
        st, &node, 1, cudaStreamSetCaptureDependencies);
#endif
  if (err == cudaSuccess)
    err = cudaStreamBeginCaptureToGraph(
        static_cast<cudaStream_t>(body_stream), body, nullptr, nullptr, 0,
        cudaStreamCaptureModeThreadLocal);
  return int(err);
#else
  (void)stream; (void)handle; (void)body_stream;
  return int(cudaErrorNotSupported);
#endif
}

// Whether a graph that holds a conditional WHILE node can be another's
// child graph node: the error cudaGraphAddChildGraphNode returns (0: it
// can), or minus the error of the probe's own set-up.
extern "C" int bb_cg_child_while_probe(void) {
#if BB_HAS_WHILE
  cudaGraph_t inner = nullptr, outer = nullptr, body = nullptr;
  cudaGraphConditionalHandle handle;
  cudaGraphNode_t node, child;
  cudaError_t err = cudaGraphCreate(&inner, 0);
  if (err == cudaSuccess)
    err = cudaGraphConditionalHandleCreate(&handle, inner, 0,
                                           cudaGraphCondAssignDefault);
  if (err == cudaSuccess)
    err = add_while_node(&node, inner, nullptr, 0, handle, &body);
  if (err == cudaSuccess) err = cudaGraphCreate(&outer, 0);
  cudaError_t probe = err == cudaSuccess
      ? cudaGraphAddChildGraphNode(&child, outer, nullptr, 0, inner) : err;
  cudaGetLastError();
  if (outer != nullptr) cudaGraphDestroy(outer);
  if (inner != nullptr) cudaGraphDestroy(inner);
  return err == cudaSuccess ? int(probe) : -int(err);
#else
  return -int(cudaErrorNotSupported);
#endif
}

// Whether a cluster launch (cudaLaunchKernelEx with a cluster dimension)
// captured into a conditional WHILE node's body (by
// cudaStreamBeginCaptureToGraph, as the step graph captures the CG
// iteration) runs and loops: a body of one cluster kernel that counts its
// runs and sets the condition until `want`. Writes the runs counted to
// *runs; returns 0, or the first CUDA error.
extern "C" int bb_cg_cluster_while_probe(int want, int* runs) {
#if BB_HAS_WHILE
  cudaGraph_t graph = nullptr, body = nullptr, captured = nullptr;
  cudaGraphExec_t exec = nullptr;
  cudaStream_t st = nullptr;
  cudaGraphConditionalHandle handle;
  cudaGraphNode_t node;
  int* count = nullptr;
  *runs = -1;
  cudaError_t err = cudaStreamCreateWithFlags(&st, cudaStreamNonBlocking);
  if (err == cudaSuccess) err = cudaMalloc(&count, sizeof(int));
  if (err == cudaSuccess) err = cudaMemset(count, 0, sizeof(int));
  if (err == cudaSuccess) err = cudaGraphCreate(&graph, 0);
  if (err == cudaSuccess)
    err = cudaGraphConditionalHandleCreate(&handle, graph, 1,
                                           cudaGraphCondAssignDefault);
  if (err == cudaSuccess)
    err = add_while_node(&node, graph, nullptr, 0, handle, &body);
  if (err == cudaSuccess)
    err = cudaStreamBeginCaptureToGraph(st, body, nullptr, nullptr, 0,
                                        cudaStreamCaptureModeThreadLocal);
  if (err == cudaSuccess) {
    int n = want;
    unsigned long long h = (unsigned long long)handle;
    void* params[] = {&count, &n, &h};
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(2);
    cfg.blockDim = dim3(64);
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 2;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(
                                        probe_kernel), params);
    cudaError_t end = cudaStreamEndCapture(st, &captured);
    if (err == cudaSuccess) err = end;
  }
  if (err == cudaSuccess) err = cudaGraphInstantiate(&exec, graph, 0);
  if (err == cudaSuccess) err = cudaGraphLaunch(exec, st);
  if (err == cudaSuccess) err = cudaStreamSynchronize(st);
  if (err == cudaSuccess)
    err = cudaMemcpy(runs, count, sizeof(int), cudaMemcpyDeviceToHost);
  if (err != cudaSuccess) cudaGetLastError();
  if (exec != nullptr) cudaGraphExecDestroy(exec);
  if (graph != nullptr) cudaGraphDestroy(graph);
  if (count != nullptr) cudaFree(count);
  if (st != nullptr) cudaStreamDestroy(st);
  return int(err);
#else
  (void)want;
  *runs = -1;
  return int(cudaErrorNotSupported);
#endif
}

// End the capture of a WHILE node's body (the graph stays the node's).
extern "C" int bb_cg_capture_end(void* body_stream) {
  cudaGraph_t body = nullptr;
  return int(cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream),
                                  &body));
}

extern "C" int bb_cg_graph_launch(void* exec, void* stream) {
  cudaError_t err = cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                                    static_cast<cudaStream_t>(stream));
  return int(err);
}

extern "C" int bb_cg_graph_free(void* exec, void* graph) {
  cudaError_t err = cudaSuccess;
  if (exec != nullptr) err = cudaGraphExecDestroy(
      static_cast<cudaGraphExec_t>(exec));
  if (graph != nullptr) {
    cudaError_t e2 = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
    if (err == cudaSuccess) err = e2;
  }
  return int(err);
}
