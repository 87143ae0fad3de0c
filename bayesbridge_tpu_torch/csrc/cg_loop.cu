// The CG solve's update, and the graph that loops it on the card.
//
// Replaces no Pallas kernel: the JAX package runs the prior-preconditioned
// CG solve (bayesbridge_tpu/ops/cg.py:173-210) as one lax.while_loop, a
// device loop with no host round trip, whose body is the operator's design
// products (the Pallas kernels of design/) and a few vector updates. Here
// the design products keep their own kernels, and the rest of the body is
// three kernels:
//
//   cg_ap    Ap = d p + s out, alpha = rs / (p . Ap)
//   cg_step  x += alpha p, r -= alpha Ap, yhat += alpha t,
//            rs' = r . r, beta = rs' / rs, n_iter += 1,
//            running = rs' > thresh && n_iter < maxiter
//   cg_dir   p = r + beta p, sp = s p (the next operator input), the
//            loop's condition any(running) where a graph runs the loop,
//            and iters += 1 (the runs of the iteration, once a launch)
//
// for every chain c (blockIdx.y) whose flag is set; a chain whose flag is
// clear is left untouched, as vmap of the JAX while_loop masks it.
// cg_start sets the loop up from the initial residual: p = r, sp = s r,
// rs = r . r, thresh = max(atol, 50 eps |b|)^2 (the float32 floor of
// ops/cg.py:166-170, eps that of the inputs' type, floor_eps), n_iter = 0,
// iters = 0, the flags and the first condition.
//
// Sums over a chain's vector run in an order fixed by its length alone: a
// block per 1,024 elements up to 32 blocks a chain, each thread's elements
// in index order, the block's threads by shuffles and then its warps in
// order, the blocks' partials summed in block order by the chain's last
// block (after a threadfence and an atomic ticket). So chain c of a batch
// gets the bits it gets alone, and a rerun gets the same bits.
//
// The loop (bb_cg_graph_new, bb_cg_graph_finish): a CUDA graph whose root
// is the captured prologue (a child graph node: the warm start, the initial
// residual and cg_start), then a conditional WHILE node whose body is the
// captured iteration (a child graph node: the operator's design products,
// cg_ap, cg_step, cg_dir). cg_start and cg_dir set the node's condition
// from inside those child graphs (the handle is made first, with the graph
// that owns it, and the captures take it as an argument; on CUDA 12.9 over
// a 13.0 driver a kernel in a child graph sets it as one in the body graph
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
// itself, never in a child graph.
//
// What bounds it on the H100: bytes. Per iteration cg_ap reads p, d, s,
// out and writes Ap; cg_step reads x, p, r, Ap (and yhat, t) and writes x,
// r (and yhat); cg_dir reads r, p, s and writes p, sp: 17 vectors of p
// (plus 3 of n) a chain, under 0.1 ms at the flagship's p = 50,001 even
// in float64. The time is the launches' and the reductions' latency: the
// design is three launches with no host in between, in place of the eager
// loop's twenty-odd small kernels a chain.

#include <cstdint>

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

// One iteration's update: cg_ap, cg_step, cg_dir.
extern "C" int bb_cg_update(int f64, const CgArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = check_args(a);
  for (int which = 1; err == cudaSuccess && which <= 3; ++which)
    err = launch(f64, which, a, st);
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
