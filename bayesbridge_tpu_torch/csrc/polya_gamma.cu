// Polya-Gamma draws, one thread a lane: out[c, j] ~ PG(b[j], z[c, j]).
//
// Replaces the device loop that the JAX package runs on the TPU:
// bayesbridge_tpu/random/polya_gamma.py:225 sample_polya_gamma ->
// _rand_tilted_jacobi (:153), its inverse-Gaussian proposal (:115) and its
// alternating-series test (:77, a lax.while_loop at :106), driven by
// bayesbridge_tpu/random/rejection.py:76 run_rejection (masked
// lax.while_loops with lane compaction). The port's plain version
// (random/polya_gamma.py, rounds of torch ops on the chain's generator)
// draws the same law.
//
// A PG(1, z) draw is J*(|z|/2) / 4, J* the tilted Jacobi law, by Devroye's
// accept/reject: the proposal is a left-truncated exponential (right
// piece) or a right-truncated inverse Gaussian (left piece), split at
// 2/pi, accepted by the alternating series truncated at 100 terms (a lane
// undecided at the cap accepts). A round is one attempt of whatever stage
// the lane is in: a fresh proposal picks its piece, and a left-piece lane
// keeps retrying its inverse Gaussian across rounds; a failed series test
// starts afresh. After 512 rounds a lane stops and keeps 0 (the JAX
// semantics, tail_replicas=1: every lane runs its own chain, with no
// first-finisher pick). Integer b > 1 is the sum of b unit draws, taken in
// the thread in order and summed in double.
//
// What bounds it on the H100: neither bytes (z in, the draw out) nor the
// card's peak rate, but the longest lane of each warp: a warp runs until
// its slowest lane accepts, and each round is a dependent chain of
// transcendentals. The design keeps each lane's chain in registers with
// no compaction, no host round trip and no sync: the thread loops its own
// rounds, and a lane that is done idles beside its warp's stragglers.
// Capped lanes are counted with an integer atomic (the same count in any
// order).

#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int kThreads = 64;

constexpr double kPi = 3.14159265358979323846;
constexpr double kThreshold = 0.63661977236758134308;  // 2 / pi
constexpr int kMaxTerms = 100;

// log Phi(a), with the erfcx form below -1 so that it stays finite where
// normcdf underflows (large tilts).
template <typename T>
__device__ T log_ndtr(T a) {
  const T rsqrt2 = T(0.70710678118654752440);
  if (a < T(-1)) {
    const T t = -a * rsqrt2;
    return bbm::log(bbm::erfcx(t)) - t * t - T(0.69314718055994530942);
  }
  return bbm::log1p(T(-0.5) * bbm::erfc(a * rsqrt2));
}

// log of the n-th term of the Jacobi density's alternating series
// (polya_gamma.pyx:142-148).
template <typename T>
__device__ T log_series_term(int n, T x) {
  const T nh = T(n) + T(0.5);
  const T log_base = bbm::log(T(kPi) * nh);
  if (x <= T(kThreshold))
    return log_base - T(1.5) * bbm::log(T(0.5) * x * T(kPi)) -
           T(2) * nh * nh / x;
  return log_base - T(0.5) * x * T(kPi) * T(kPi) * nh * nh;
}

// Devroye's alternating-series test: odd partial sums bound the density
// from below (accept if u <= sum), even ones from above (reject if
// u > sum); undecided at the cap, accept.
template <typename T>
__device__ bool series_accept(T u, T x, T zeroth) {
  T partial = zeroth;
  for (int n = 1; n < kMaxTerms; ++n) {
    const T term = bbm::exp(log_series_term(n, x));
    if (n & 1) {
      partial -= term;
      if (u <= partial) return true;
    } else {
      partial += term;
      if (u > partial) return false;
    }
  }
  return true;
}

// One attempt at an inverse-Gaussian(1 / rate, 1) draw truncated to
// (0, 2/pi) (polya_gamma.pyx:192-216): the inverted truncated chi-squared
// with both of its tests at once when the mean exceeds 2/pi, else
// Michael-Schucany-Haas accepted below 2/pi.
template <typename T>
__device__ bool invgauss_attempt(bbrng::Stream& s, T rate, T* x) {
  const T mean = T(1) / rate;
  if (mean > T(kThreshold)) {
    const T u1 = bbrng::uniform(s, T(0));
    const T u2 = bbrng::uniform(s, T(0));
    const T u3 = bbrng::uniform(s, T(0));
    const T e = T(0.5) * T(kPi) - T(2) * bbm::log1p(-u1);
    *x = T(1) / e;
    return u2 <= bbm::sqrt(T(0.5) * T(kPi) / e) &&
           bbm::log(u3) < T(-0.5) * *x * rate * rate;
  }
  const T n = bbrng::normal(s, T(0));
  const T u2 = bbrng::uniform(s, T(0));
  const T mv = mean * (n * n);
  T xb = mean + T(0.5) * mean * (mv - bbm::sqrt(T(4) * mv + mv * mv));
  if (u2 > mean / (mean + xb)) xb = mean * mean / xb;
  *x = xb;
  return xb < T(kThreshold);
}

// One J*(tilt) draw, or 0 after max_rounds rounds (*capped set).
template <typename T>
__device__ T tilted_jacobi(bbrng::Stream& s, T tilt, int max_rounds,
                           int* rounds, bool* capped) {
  const T thr = T(kThreshold);
  const T exp_rate = T(0.5) * tilt * tilt + T(0.125) * T(kPi) * T(kPi);
  const T log_mass_expo = -bbm::log(exp_rate) - exp_rate * thr +
                          bbm::log(T(0.25) * T(kPi));
  const T sqrt_t = bbm::sqrt(thr);
  const T lm1 = -tilt + log_ndtr((thr * tilt - T(1)) / sqrt_t);
  const T lm2 = tilt + log_ndtr(-(thr * tilt + T(1)) / sqrt_t);
  const T p_right = T(1) / (T(1) + bbm::exp(lm1 - log_mass_expo) +
                            bbm::exp(lm2 - log_mass_expo));
  const T rate = bbm::fmax(tilt, T(1e-7));
  bool pending = false;
  for (int r = 0; r < max_rounds; ++r) {
    T x;
    bool have;
    if (!pending && bbrng::uniform(s, T(0)) < p_right) {
      x = thr - bbm::log1p(-bbrng::uniform(s, T(0))) / exp_rate;
      have = true;
    } else {
      have = invgauss_attempt(s, rate, &x);
      pending = !have;
    }
    if (have) {
      const T zeroth = bbm::exp(log_series_term(0, x));
      const T u = bbrng::uniform(s, T(0)) * zeroth;
      if (series_accept(u, x, zeroth)) {
        *rounds += r + 1;
        return x;
      }
    }
  }
  *rounds += max_rounds;
  *capped = true;
  return T(0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    pg_kernel(const T* __restrict__ z, const int* __restrict__ b,
              const int64_t* __restrict__ keys, int k, int64_t n,
              int max_rounds, T* __restrict__ out,
              unsigned long long* capped, int* attempts) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads +
                    threadIdx.x;
  if (i >= k * n) return;
  const int64_t c = i / n, j = i - c * n;
  bbrng::Stream s(static_cast<uint64_t>(keys[c]), static_cast<uint64_t>(j));
  const T tilt = T(0.5) * bbm::fabs(z[i]);
  const int units = b == nullptr ? 1 : b[j];
  int rounds = 0;
  int n_capped = 0;
  double sum = 0.0;
  for (int u = 0; u < units; ++u) {
    bool cap = false;
    const T draw =
        T(0.25) * tilted_jacobi(s, tilt, max_rounds, &rounds, &cap);
    sum += static_cast<double>(draw);
    n_capped += cap;
  }
  out[i] = static_cast<T>(sum);
  if (n_capped) atomicAdd(capped, static_cast<unsigned long long>(n_capped));
  if (attempts != nullptr) attempts[i] = rounds;
}

template <typename T>
cudaError_t launch(const void* z, const int* b, const int64_t* keys, int k,
                   int64_t n, int max_rounds, void* out,
                   unsigned long long* capped, int* attempts,
                   cudaStream_t s) {
  const int64_t lanes = k * n;
  const unsigned blocks = static_cast<unsigned>((lanes + kThreads - 1) /
                                                kThreads);
  pg_kernel<T><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(z), b, keys, k, n, max_rounds,
      static_cast<T*>(out), capped, attempts);
  return cudaGetLastError();
}

}  // namespace

// z (k, n) float or double, b (n,) int32 or null (all ones), keys (k,)
// int64, out like z, capped one uint64 counter, attempts (k, n) int32 or
// null (the rounds each lane took, summed over its units).
extern "C" int bb_pg_draw(int is_double, const void* z, const void* b,
                          const void* keys, int k, long long n,
                          int max_rounds, void* out, void* capped,
                          void* attempts, void* stream) {
  if (k <= 0 || n <= 0 || max_rounds <= 0 ||
      k * n > static_cast<long long>(INT32_MAX) * kThreads)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto bb = static_cast<const int*>(b);
  auto kk = static_cast<const int64_t*>(keys);
  auto cap = static_cast<unsigned long long*>(capped);
  auto att = static_cast<int*>(attempts);
  return (int)(is_double
                   ? launch<double>(z, bb, kk, k, n, max_rounds, out, cap,
                                    att, s)
                   : launch<float>(z, bb, kk, k, n, max_rounds, out, cap,
                                   att, s));
}
