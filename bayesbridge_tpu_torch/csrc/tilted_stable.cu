// Exponentially tilted positive stable draws: out[c, j] has density
// proportional to exp(-tilt[c, j] x) p_alpha(x), p_alpha the positive
// stable density of characteristic exponent alpha < 1.
//
// Replaces the device loops that the JAX package runs on the TPU:
// bayesbridge_tpu/random/tilted_stable.py:311 sample_tilted_stable (jitted
// at :349-351) -> divide-and-conquer (:90) and double rejection (:240),
// each driven by bayesbridge_tpu/random/rejection.py:76 run_rejection
// (masked lax.while_loops with lane compaction). The port's plain version
// (random/tilted_stable.py, rounds of torch ops on the chain's generator)
// draws the same law.
//
// Each lane picks its method by the crossover tilt**alpha < 2
// (tilted_stable.pyx:103-112), or the caller forces one:
// - divide-and-conquer (Hofert 2011): the sum of m = max(1,
//   floor(tilt**alpha)) partitions (capped at max_partition), each a
//   stable draw scaled by m**(-1/alpha) and accepted with probability
//   exp(-tilt x); a lane capped at its rounds keeps its partial sum (the
//   'every_round' latch);
// - double rejection (Devroye 2009): one auxiliary proposal and, given
//   it, one final proposal a round, accepted iff both accept; a capped
//   lane keeps 0.
// Rounds are capped at max_rounds (256), and forced divide-and-conquer at
// dc_rounds (max(256, 3 max_partition + 64)). The plain version's guards
// stay: tilt clamped at float32's smallest normal, exp arguments clamped
// (safe_exp), the auxiliary draw clamped into (1e-10, pi (1 - 1e-7)),
// powers as exp(a log x).
//
// What bounds it on the H100: the longest lane of each warp, not bytes
// (tilt in, the draw out) nor the operations the lanes' rounds need (4.7
// rounds a lane on average at the flagship, 72 for the slowest): each
// round is a dependent chain of transcendentals, and a warp runs until
// its slowest lane is done. Round r of a lane draws from its own Philox
// blocks (RoundStream: key, lane, r B + b), so any thread can run any
// round of a lane, and the rounds are decided in round order: double
// rejection takes the first accepting round, divide-and-conquer the first
// m accepted rounds, their draws added in round order. A lane's value and
// rounds are thus a function of (key, lane, tilt) alone, whatever the
// threads, the chains or the launch. Two designs:
//
// - the regrouping sweep (ts_regroup_kernel, bb_ts_draw: the path's):
//   each warp owns 32 / T lanes and before every sweep shares its 32
//   threads among those still running, so a warp's last lanes run up to
//   32 rounds a sweep;
// - ts_kernel (bb_ts_draw_first, the first design): one thread a lane on
//   one sequential stream (Stream: key, lane), its rounds run serially;
//   other bits, the same law. Kept for timing in turns.
//
// Neither compacts lanes across warps, syncs with the host or sorts by
// method (lanes of both methods share a warp as they come). Capped lanes
// are counted with an integer atomic.

#include <cfloat>
#include <cmath>
#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int kThreads = 64;        // the first design's block
constexpr int kSweepThreads = 128;  // the regrouping design's block
constexpr double kPi = 3.14159265358979323846;
constexpr double kTiltPowerThreshold = 2.0;

template <typename T>
__device__ __forceinline__ T tiny() {
  return sizeof(T) == 4 ? T(FLT_MIN) : T(DBL_MIN);
}

// exp with its argument clamped at 0.9 log(max) of the type.
template <typename T>
__device__ __forceinline__ T safe_exp(T x) {
  const T m = sizeof(T) == 4 ? T(79.85055514686152) : T(638.8044416040456);
  return bbm::exp(bbm::fmin(bbm::fmax(x, -m), m));
}

// sin(x) / x with a Taylor guard near zero (tilted_stable.pyx:29-37).
template <typename T>
__device__ __forceinline__ T sinc(T x) {
  if (bbm::fabs(x) < T(0.01)) {
    const T x2 = x * x;
    return T(1) - x2 / T(6) * (T(1) - x2 / T(20));
  }
  return bbm::sin(x) / x;
}

// Zolotarev's A(x, alpha) (tilted_stable.pyx:326-332).
template <typename T>
__device__ T zolotarev(T x, T a) {
  const T val = bbm::pow_pos((T(1) - a) * sinc((T(1) - a) * x), T(1) - a) *
                bbm::pow_pos(a * sinc(a * x), a) / sinc(x);
  return bbm::pow_pos(val, T(1) / (T(1) - a));
}

// Proportional to a power of the Zolotarev density
// (tilted_stable.pyx:316-324).
template <typename T>
__device__ T zolotarev_pdf_exponentiated(T x, T a) {
  const T denom = bbm::pow_pos(sinc(a * x), a) *
                  bbm::pow_pos(sinc((T(1) - a) * x), T(1) - a);
  return sinc(x) / denom;
}

// One positive-stable draw by Kanter's method (tilted_stable.pyx:157-164).
template <typename T, class S>
__device__ T non_tilted(S& s, T a) {
  const T u = bbrng::uniform(s, T(0));
  const T v = bbrng::uniform(s, T(0));
  const T ratio = -zolotarev(T(kPi) * u, a) / bbm::log(v);
  return bbm::pow_pos(ratio, (T(1) - a) / a);
}

// One divide-and-conquer round: a partition draw c x (c = m**(-1/alpha))
// in *draw, accepted with probability exp(-tilt c x). Three uniforms.
template <typename T, class S>
__device__ bool dc_round(S& s, T a, T tilt, T c, T* draw) {
  *draw = c * non_tilted(s, a);
  const T accept = safe_exp(-tilt * *draw);
  return bbrng::uniform(s, T(0)) < accept;
}

// Divide-and-conquer on one stream: the sum of m accepted partition draws,
// or the partial sum after `cap` rounds (*capped set).
template <typename T, class S>
__device__ T divide_conquer(S& s, T a, T tilt, int m, int cap, int* rounds,
                            bool* capped) {
  const T c = bbm::pow_pos(T(1) / T(m), T(1) / a);
  T total = T(0);
  int done = 0;
  for (int r = 0; r < cap; ++r) {
    T draw;
    if (dc_round(s, a, tilt, c, &draw)) {
      total += draw;
      if (++done >= m) {
        *rounds = r + 1;
        return total;
      }
    }
  }
  *rounds = cap;
  *capped = true;
  return total;
}

// Draw X from the 3-piece reference density given U; returns X and sets
// its log acceptance probability (tilted_stable.pyx:258-314). Only the
// piece's own variable is drawn.
template <typename T, class S>
__device__ T reference_rv(S& s, T u, T a, T tp, T z, T* log_prob) {
  const T za = zolotarev(u, a);
  const T odds = (T(1) - a) / a;
  const T left = bbm::pow_pos((T(1) - a) / a / za, a) * tp;
  const T right = left + bbm::sqrt(left * a / za);
  const T expo_scale = z / za;
  const T width = right - left;
  const T mass_left = width * T(1.2533141373155002512);  // sqrt(pi / 2)
  const T mass_total = mass_left + width + expo_scale;
  const T v = bbrng::uniform(s, T(0));
  T x, extra = T(0);
  if (v < mass_left / mass_total) {
    const T n = bbrng::normal(s, T(0));
    x = left - width * bbm::fabs(n);
    if (x < left) extra = n * n / T(2);
  } else if (v < (mass_left + width) / mass_total) {
    x = left + width * bbrng::uniform(s, T(0));
  } else {
    const T e = -bbm::log(bbrng::uniform(s, T(0)));
    x = right + e * expo_scale;
    if (x > right) extra = e;
  }
  const T x_pos = bbm::fmax(x, tiny<T>());
  T lp = -(za * (x_pos - left) +
           safe_exp(bbm::log(tp) / a - odds * bbm::log(left)) *
               (bbm::pow_pos(left / x_pos, odds) - T(1)));
  lp += extra;
  *log_prob = x < T(0) ? -T(INFINITY) : lp;
  return x;
}

// A lane's double-rejection constants (tilted_stable.pyx:210-236).
template <typename T>
struct DrLane {
  T tp, gamma, sqrt_gamma, xi, psi, w2;

  __device__ void init(T a, T tilt) {
    const T pi = T(kPi);
    const T sqrt_half_pi = T(1.2533141373155002512);
    tp = bbm::pow_pos(tilt, a);
    gamma = tp * a * (T(1) - a);
    sqrt_gamma = bbm::sqrt(gamma);
    xi = (T(1) + bbm::sqrt(T(2) * gamma) * (T(2) + sqrt_half_pi)) / pi;
    psi = bbm::sqrt(gamma / pi) * (T(2) + sqrt_half_pi) *
          safe_exp(-gamma * pi * pi / T(8));
    w2 = T(2) * bbm::sqrt(pi) * psi;
  }
};

// One double-rejection round: the auxiliary proposal and its acceptance,
// then, given it, the final proposal; true (the draw in *value) iff both
// accept. At most eight uniforms.
template <typename T, class S>
__device__ bool dr_round(S& s, T a, const DrLane<T>& q, T* value) {
  const T pi = T(kPi);
  const T sqrt_half_pi = T(1.2533141373155002512);
  const T u_hi = pi * (T(1) - T(1e-7));
  // The auxiliary proposal (tilted_stable.pyx:210-236).
  const T v = bbrng::uniform(s, T(0));
  const T n = bbrng::normal(s, T(0));
  const T w = bbrng::uniform(s, T(0));
  T u_cand;
  if (q.gamma >= T(1)) {
    const T w1 = bbm::sqrt(T(0.5) * pi / q.gamma) * q.xi;
    u_cand = v < w1 / (w1 + q.w2) ? bbm::fabs(n) / q.sqrt_gamma
                                  : pi * (T(1) - w * w);
  } else {
    const T w3 = q.xi * pi;
    u_cand = v < w3 / (q.w2 + w3) ? pi * w : pi * (T(1) - w * w);
  }
  const bool u_ok = u_cand < pi;
  const T u = bbm::fmin(bbm::fmax(u_cand, T(1e-10)), u_hi);
  const T zeta = bbm::sqrt(zolotarev_pdf_exponentiated(u, a));
  const T z = T(1) / (T(1) - bbm::pow_pos(T(1) + a * zeta / q.sqrt_gamma,
                                          -T(1) / a));
  // Its acceptance probability (tilted_stable.pyx:238-256).
  const T inv_prob = pi * safe_exp(-q.tp * (T(1) - T(1) / (zeta * zeta))) /
                     ((T(1) + sqrt_half_pi) * q.sqrt_gamma / zeta + z);
  T d = T(0);
  if (u >= T(0) && q.gamma >= T(1))
    d += q.xi * safe_exp(-q.gamma * u * u / T(2));
  if (u > T(0) && u < pi)
    d += q.psi / bbm::sqrt(bbm::fmax(pi - u, tiny<T>()));
  if (u >= T(0) && u <= pi && q.gamma < T(1)) d += q.xi;
  const T accept = T(1) / (inv_prob * d);
  const T v_cand = bbrng::uniform(s, T(0)) / accept;
  if (!(u_ok && accept > T(0) && v_cand <= T(1))) return false;
  // The final proposal given the auxiliary draw.
  T log_prob;
  const T x = reference_rv(s, u, a, q.tp, z, &log_prob);
  if (!(log_prob > bbm::log(v_cand))) return false;
  *value = bbm::pow_pos(x, -(T(1) - a) / a);
  return true;
}

// Double rejection on one stream: the value of the first accepted round,
// or 0 after `cap` rounds (*capped set).
template <typename T, class S>
__device__ T double_rejection(S& s, T a, T tilt, int cap, int* rounds,
                              bool* capped) {
  DrLane<T> q;
  q.init(a, tilt);
  for (int r = 0; r < cap; ++r) {
    T value;
    if (dr_round(s, a, q, &value)) {
      *rounds = r + 1;
      return value;
    }
  }
  *rounds = cap;
  *capped = true;
  return T(0);
}

// Each lane's method and partitions: mode 0 by tilt**alpha < 2, 1
// divide-and-conquer, 2 double rejection; m clamped in float before the
// integer cast (0 for double rejection).
template <typename T>
__device__ bool lane_method(T a, T tilt, int mode, int max_partition,
                            int* m) {
  const T tp = bbm::pow_pos(tilt, a);
  const bool dc = mode == 0 ? tp < T(kTiltPowerThreshold) : mode == 1;
  *m = dc ? max(1, static_cast<int>(
                       bbm::floor(bbm::fmin(tp, T(max_partition)))))
          : 0;
  return dc;
}

// The first design: one thread a lane on Stream(key, lane). plan, where
// given, gets each lane's partitions m (divide-and-conquer) or 0 (double
// rejection).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ts_kernel(const T* __restrict__ tilt_in, const int64_t* __restrict__ keys,
              int k, int64_t n, T a, int mode, int max_rounds, int dc_rounds,
              int max_partition, T* __restrict__ out,
              unsigned long long* capped, int* attempts, int* plan) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads +
                    threadIdx.x;
  if (i >= k * n) return;
  const int64_t c = i / n, j = i - c * n;
  bbrng::Stream s(static_cast<uint64_t>(keys[c]), static_cast<uint64_t>(j));
  const T tilt = bbm::fmax(tilt_in[i], T(FLT_MIN));
  int m;
  const bool dc = lane_method(a, tilt, mode, max_partition, &m);
  int rounds = 0;
  bool cap = false;
  T value;
  if (dc) {
    value = divide_conquer(s, a, tilt, m, mode == 0 ? max_rounds : dc_rounds,
                           &rounds, &cap);
  } else {
    value = double_rejection(s, a, tilt, max_rounds, &rounds, &cap);
  }
  out[i] = value;
  if (cap) atomicAdd(capped, 1ULL);
  if (attempts != nullptr) attempts[i] = rounds;
  if (plan != nullptr) plan[i] = m;
}

// Philox blocks a round of the sweep kernel: the most words a round takes
// (double rejection: eight uniforms, one word each in float, two in
// double) over four.
template <typename T>
struct RoundBlocks {
  static constexpr uint32_t value = sizeof(T) == 4 ? 2u : 4u;
};

// A lane of the sweep, in shared memory: its inputs, method and
// constants, and where its rounds stand.
template <typename T>
struct LaneState {
  DrLane<T> q;
  T tilt, scale, total, value;
  uint64_t key;
  int64_t i, j;
  int m, limit, next, done, rounds;
  bool dc, finished, cap;
};

// The sweeps: each warp owns 32 / T lanes, lane q on threads q T .. q T +
// T - 1 at the start. Before every sweep the warp shares its 32 threads
// among its lanes still running (Ta threads a lane, the largest power of
// two with Ta x running lanes <= 32), so that its last lanes run up to 32
// rounds a sweep. A lane's rounds are taken in order, Ta at a time, and
// decided in round order: the same values, attempts and caps whatever T.
// Every thread of the warp runs each sweep until all the warp's lanes are
// done, so the ballots and shuffles see the whole warp.
template <typename T>
__global__ void __launch_bounds__(kSweepThreads)
    ts_regroup_kernel(const T* __restrict__ tilt_in,
                      const int64_t* __restrict__ keys, int k, int64_t n,
                      T a, int mode, int max_rounds, int dc_rounds,
                      int max_partition, int log2_t,
                      T* __restrict__ out, unsigned long long* capped,
                      int* attempts, int* plan) {
  const unsigned full = 0xffffffffu;
  __shared__ LaneState<T> lanes[kSweepThreads];
  const int wl = threadIdx.x & 31;
  const int nl = 32 >> log2_t;
  LaneState<T>* L = lanes + (threadIdx.x & ~31);
  const int64_t first = (static_cast<int64_t>(blockIdx.x) * kSweepThreads +
                         (threadIdx.x & ~31)) >> log2_t;
  if (wl < nl) {
    LaneState<T>& S = L[wl];
    S.i = first + wl;
    S.finished = S.i >= k * n;
    if (!S.finished) {
      const int64_t c = S.i / n;
      S.j = S.i - c * n;
      S.key = static_cast<uint64_t>(keys[c]);
      S.tilt = bbm::fmax(tilt_in[S.i], T(FLT_MIN));
      S.dc = lane_method(a, S.tilt, mode, max_partition, &S.m);
      S.limit = S.dc && mode != 0 ? dc_rounds : max_rounds;
      if (S.dc)
        S.scale = bbm::pow_pos(T(1) / T(S.m), T(1) / a);
      else
        S.q.init(a, S.tilt);
      S.total = S.value = T(0);
      S.next = S.done = S.rounds = 0;
      S.cap = false;
    }
  }
  __syncwarp();
  for (;;) {
    const unsigned act = __ballot_sync(full, wl < nl && !L[wl].finished);
    if (act == 0u) break;
    const int running = __popc(act);
    const int lg = 32 - __clz(running - 1);  // ceil(log2(running))
    const int ta = 32 >> lg;
    const int g = wl >> (5 - lg);
    const bool has = g < running;
    unsigned rest = act;
    for (int q = 0; q < g && q < running; ++q) rest &= rest - 1u;
    const int slot = has ? __ffs(rest) - 1 : 0;
    const int sub = wl & (ta - 1);
    LaneState<T>& S = L[slot];
    const int r = S.next + sub;
    bool acc = false;
    T x = T(0);
    if (has && r < S.limit) {
      bbrng::RoundStream s(S.key, static_cast<uint64_t>(S.j),
                           static_cast<uint32_t>(r) * RoundBlocks<T>::value);
      acc = S.dc ? dc_round(s, a, S.tilt, S.scale, &x)
                 : dr_round(s, a, S.q, &x);
    }
    const int seg = has ? g * ta : 0;
    const unsigned seg_mask = ta == 32 ? full : ((1u << ta) - 1u);
    const unsigned ball = __ballot_sync(full, acc);
    const unsigned mine = has ? (ball >> seg) & seg_mask : 0u;
    // The decisions in round order, every thread of the warp in every
    // shuffle: double rejection's first accepting round, then
    // divide-and-conquer's accepted draws up to the m-th.
    const int fa = mine ? __ffs(mine) - 1 : 0;
    const T xf = __shfl_sync(full, x, seg + fa);
    bool fin = false, cap = false;
    int rounds = 0, done = has ? S.done : 0;
    T total = has ? S.total : T(0), value = T(0);
    if (has && !S.dc && mine) {
      fin = true;
      rounds = S.next + fa + 1;
      value = xf;
    }
    for (int t = 0; t < ta; ++t) {
      const T xt = __shfl_sync(full, x, seg + t);
      if (has && S.dc && !fin && ((mine >> t) & 1u)) {
        total += xt;
        if (++done >= S.m) {
          fin = true;
          rounds = S.next + t + 1;
          value = total;
        }
      }
    }
    if (has && !fin && S.next + ta >= S.limit) {
      fin = cap = true;
      rounds = S.limit;
      value = S.dc ? total : T(0);
    }
    __syncwarp();
    if (has && sub == 0) {
      S.total = total;
      S.done = done;
      S.next += ta;
      if (fin) {
        S.finished = true;
        S.rounds = rounds;
        S.value = value;
        S.cap = cap;
      }
    }
    __syncwarp();
  }
  if (wl >= nl || L[wl].i >= k * n) return;
  const LaneState<T>& S = L[wl];
  out[S.i] = S.value;
  if (S.cap) atomicAdd(capped, 1ULL);
  if (attempts != nullptr) attempts[S.i] = S.rounds;
  if (plan != nullptr) plan[S.i] = S.dc ? S.m : 0;
}

template <typename T>
cudaError_t launch(bool first, const void* tilt, const int64_t* keys, int k,
                   int64_t n, double alpha, int mode, int max_rounds,
                   int dc_rounds, int max_partition, int log2_t, void* out,
                   unsigned long long* capped, int* attempts, int* plan,
                   cudaStream_t s) {
  const int64_t lanes = k * n;
  if (!first) {
    const int64_t threads = lanes << log2_t;
    const unsigned blocks = static_cast<unsigned>(
        (threads + kSweepThreads - 1) / kSweepThreads);
    ts_regroup_kernel<T><<<blocks, kSweepThreads, 0, s>>>(
        static_cast<const T*>(tilt), keys, k, n, static_cast<T>(alpha),
        mode, max_rounds, dc_rounds, max_partition, log2_t,
        static_cast<T*>(out), capped, attempts, plan);
  } else {
    const unsigned blocks = static_cast<unsigned>((lanes + kThreads - 1) /
                                                  kThreads);
    ts_kernel<T><<<blocks, kThreads, 0, s>>>(
        static_cast<const T*>(tilt), keys, k, n, static_cast<T>(alpha), mode,
        max_rounds, dc_rounds, max_partition, static_cast<T*>(out), capped,
        attempts, plan);
  }
  return cudaGetLastError();
}

int draw(bool first, int is_double, const void* tilt, const void* keys,
         int k, long long n, double alpha, int mode, int max_rounds,
         int dc_rounds, int max_partition, int log2_t, void* out,
         void* capped, void* attempts, void* plan, void* stream) {
  if (k <= 0 || n <= 0 || mode < 0 || mode > 2 || max_rounds <= 0 ||
      dc_rounds <= 0 || max_partition <= 0 || !(alpha > 0.0 && alpha < 1.0) ||
      log2_t < 0 || log2_t > 5 ||
      (k * n) << log2_t > static_cast<long long>(INT32_MAX) * kThreads)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto kk = static_cast<const int64_t*>(keys);
  auto cap = static_cast<unsigned long long*>(capped);
  auto att = static_cast<int*>(attempts);
  auto pl = static_cast<int*>(plan);
  return (int)(is_double
                   ? launch<double>(first, tilt, kk, k, n, alpha, mode,
                                    max_rounds, dc_rounds, max_partition,
                                    log2_t, out, cap, att, pl, s)
                   : launch<float>(first, tilt, kk, k, n, alpha, mode,
                                   max_rounds, dc_rounds, max_partition,
                                   log2_t, out, cap, att, pl, s));
}

}  // namespace

// tilt (k, n) float or double, keys (k,) int64, out like tilt, capped one
// uint64 counter, attempts and plan (k, n) int32 or null. The regrouping
// design from 2**log2_t threads a lane (0 <= log2_t <= 5), a warp's
// threads shared among its lanes still running before every sweep; the
// same values whatever log2_t.
extern "C" int bb_ts_draw(int is_double, const void* tilt, const void* keys,
                          int k, long long n, double alpha, int mode,
                          int max_rounds, int dc_rounds, int max_partition,
                          int log2_t, void* out, void* capped,
                          void* attempts, void* plan, void* stream) {
  return draw(false, is_double, tilt, keys, k, n, alpha, mode,
              max_rounds, dc_rounds, max_partition, log2_t, out, capped,
              attempts, plan, stream);
}

// The same arguments but log2_t, on the first design (one thread a lane).
extern "C" int bb_ts_draw_first(int is_double, const void* tilt,
                                const void* keys, int k, long long n,
                                double alpha, int mode, int max_rounds,
                                int dc_rounds, int max_partition, void* out,
                                void* capped, void* attempts, void* plan,
                                void* stream) {
  return draw(true, is_double, tilt, keys, k, n, alpha, mode, max_rounds,
              dc_rounds, max_partition, 0, out, capped, attempts, plan,
              stream);
}
