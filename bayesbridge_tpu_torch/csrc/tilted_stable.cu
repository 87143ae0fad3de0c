// Exponentially tilted positive stable draws, one thread a lane: out[c, j]
// has density proportional to exp(-tilt[c, j] x) p_alpha(x), p_alpha the
// positive stable density of characteristic exponent alpha < 1.
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
// What bounds it on the H100: the longest lane of each warp (a warp runs
// until its slowest lane is done, and each round is a dependent chain of
// transcendentals), not bytes (tilt in, the draw out). The design keeps
// each lane's chain in registers with no compaction, no host round trip
// and no sync; lanes of both methods share a warp as they come (no sort).
// Capped lanes are counted with an integer atomic.

#include <cfloat>
#include <cmath>
#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int kThreads = 64;
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
template <typename T>
__device__ T non_tilted(bbrng::Stream& s, T a) {
  const T u = bbrng::uniform(s, T(0));
  const T v = bbrng::uniform(s, T(0));
  const T ratio = -zolotarev(T(kPi) * u, a) / bbm::log(v);
  return bbm::pow_pos(ratio, (T(1) - a) / a);
}

// Divide-and-conquer: the sum of m accepted partition draws, or the
// partial sum after `cap` rounds (*capped set).
template <typename T>
__device__ T divide_conquer(bbrng::Stream& s, T a, T tilt, int m, int cap,
                            int* rounds, bool* capped) {
  const T c = bbm::pow_pos(T(1) / T(m), T(1) / a);
  T total = T(0);
  int done = 0;
  for (int r = 0; r < cap; ++r) {
    const T draw = c * non_tilted(s, a);
    const T accept = safe_exp(-tilt * draw);
    if (bbrng::uniform(s, T(0)) < accept) {
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
template <typename T>
__device__ T reference_rv(bbrng::Stream& s, T u, T a, T tp, T z,
                          T* log_prob) {
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

// Double rejection: the value of the first accepted round, or 0 after
// `cap` rounds (*capped set).
template <typename T>
__device__ T double_rejection(bbrng::Stream& s, T a, T tilt, int cap,
                              int* rounds, bool* capped) {
  const T pi = T(kPi);
  const T sqrt_half_pi = T(1.2533141373155002512);
  const T tp = bbm::pow_pos(tilt, a);
  const T gamma = tp * a * (T(1) - a);
  const T sqrt_gamma = bbm::sqrt(gamma);
  const T xi = (T(1) + bbm::sqrt(T(2) * gamma) * (T(2) + sqrt_half_pi)) / pi;
  const T psi = bbm::sqrt(gamma / pi) * (T(2) + sqrt_half_pi) *
                safe_exp(-gamma * pi * pi / T(8));
  const T w2 = T(2) * bbm::sqrt(pi) * psi;
  const T u_hi = pi * (T(1) - T(1e-7));
  for (int r = 0; r < cap; ++r) {
    // The auxiliary proposal (tilted_stable.pyx:210-236).
    const T v = bbrng::uniform(s, T(0));
    const T n = bbrng::normal(s, T(0));
    const T w = bbrng::uniform(s, T(0));
    T u_cand;
    if (gamma >= T(1)) {
      const T w1 = bbm::sqrt(T(0.5) * pi / gamma) * xi;
      u_cand = v < w1 / (w1 + w2) ? bbm::fabs(n) / sqrt_gamma
                                  : pi * (T(1) - w * w);
    } else {
      const T w3 = xi * pi;
      u_cand = v < w3 / (w2 + w3) ? pi * w : pi * (T(1) - w * w);
    }
    const bool u_ok = u_cand < pi;
    const T u = bbm::fmin(bbm::fmax(u_cand, T(1e-10)), u_hi);
    const T zeta = bbm::sqrt(zolotarev_pdf_exponentiated(u, a));
    const T z = T(1) / (T(1) - bbm::pow_pos(T(1) + a * zeta / sqrt_gamma,
                                            -T(1) / a));
    // Its acceptance probability (tilted_stable.pyx:238-256).
    const T inv_prob = pi * safe_exp(-tp * (T(1) - T(1) / (zeta * zeta))) /
                       ((T(1) + sqrt_half_pi) * sqrt_gamma / zeta + z);
    T d = T(0);
    if (u >= T(0) && gamma >= T(1)) d += xi * safe_exp(-gamma * u * u / T(2));
    if (u > T(0) && u < pi)
      d += psi / bbm::sqrt(bbm::fmax(pi - u, tiny<T>()));
    if (u >= T(0) && u <= pi && gamma < T(1)) d += xi;
    const T accept = T(1) / (inv_prob * d);
    const T v_cand = bbrng::uniform(s, T(0)) / accept;
    if (!(u_ok && accept > T(0) && v_cand <= T(1))) continue;
    // The final proposal given the auxiliary draw.
    T log_prob;
    const T x = reference_rv(s, u, a, tp, z, &log_prob);
    if (log_prob > bbm::log(v_cand)) {
      *rounds = r + 1;
      return bbm::pow_pos(x, -(T(1) - a) / a);
    }
  }
  *rounds = cap;
  *capped = true;
  return T(0);
}

// mode 0: each lane by tilt**alpha < 2; 1: divide-and-conquer; 2: double
// rejection. plan, where given, gets each lane's partitions m
// (divide-and-conquer) or 0 (double rejection).
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
  const T tp = bbm::pow_pos(tilt, a);
  const bool dc = mode == 0 ? tp < T(kTiltPowerThreshold) : mode == 1;
  int rounds = 0;
  bool cap = false;
  int m = 0;
  T value;
  if (dc) {
    // Clamped in float before the integer cast.
    m = max(1, static_cast<int>(
                   bbm::floor(bbm::fmin(tp, T(max_partition)))));
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

template <typename T>
cudaError_t launch(const void* tilt, const int64_t* keys, int k, int64_t n,
                   double alpha, int mode, int max_rounds, int dc_rounds,
                   int max_partition, void* out, unsigned long long* capped,
                   int* attempts, int* plan, cudaStream_t s) {
  const int64_t lanes = k * n;
  const unsigned blocks = static_cast<unsigned>((lanes + kThreads - 1) /
                                                kThreads);
  ts_kernel<T><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(tilt), keys, k, n, static_cast<T>(alpha), mode,
      max_rounds, dc_rounds, max_partition, static_cast<T*>(out), capped,
      attempts, plan);
  return cudaGetLastError();
}

}  // namespace

// tilt (k, n) float or double, keys (k,) int64, out like tilt, capped one
// uint64 counter, attempts and plan (k, n) int32 or null.
extern "C" int bb_ts_draw(int is_double, const void* tilt, const void* keys,
                          int k, long long n, double alpha, int mode,
                          int max_rounds, int dc_rounds, int max_partition,
                          void* out, void* capped, void* attempts,
                          void* plan, void* stream) {
  if (k <= 0 || n <= 0 || mode < 0 || mode > 2 || max_rounds <= 0 ||
      dc_rounds <= 0 || max_partition <= 0 || !(alpha > 0.0 && alpha < 1.0) ||
      k * n > static_cast<long long>(INT32_MAX) * kThreads)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto kk = static_cast<const int64_t*>(keys);
  auto cap = static_cast<unsigned long long*>(capped);
  auto att = static_cast<int*>(attempts);
  auto pl = static_cast<int*>(plan);
  return (int)(is_double
                   ? launch<double>(tilt, kk, k, n, alpha, mode, max_rounds,
                                    dc_rounds, max_partition, out, cap, att,
                                    pl, s)
                   : launch<float>(tilt, kk, k, n, alpha, mode, max_rounds,
                                   dc_rounds, max_partition, out, cap, att,
                                   pl, s));
}
