// Counter-based random bits for the rejection kernels (csrc/polya_gamma.cu,
// csrc/tilted_stable.cu): Philox4x32-10 (Salmon et al., SC'11), the
// generator of curand_kernel.h's curand_Philox4x32_10 and of torch's CUDA
// generator, written into the source.
//
// The JAX package draws these bits with jax.random (threefry) inside its
// lax.while_loops; the port cannot give the TPU's bits, so the kernels
// are held to their plain versions in law (KS and moments). The key is one
// 64-bit word per chain and call, drawn by the wrapper from the chain's
// torch.Generator on the card; the counter is (lane low, lane high, block
// low, block high) and each block of four words is one Philox call. Two
// streams:
//
// - Stream(key, lane): the lane's blocks 0, 1, 2, ... taken word by word,
//   one sequence for all its rounds (pg_draw; ts_draw's first design). A
//   lane's bits depend only on the key, the lane and how many words it
//   has taken.
// - RoundStream(key, lane, round * B): round r of the lane takes the
//   blocks r B .. r B + B - 1 word by word, B blocks covering the most
//   words a round takes (ts_draw: 2 in float, 4 in double). A round's
//   bits depend only on the key, the lane and the round, so any thread
//   can run any round of a lane.
//
// Either way a lane gives the same bits whatever else the launch holds.
//
// Uniforms lie on the open interval (0, 1). Double takes 53 bits of two
// words, k 2^-53, clamped below at the smallest normal as the plain
// versions clamp torch.rand. Float takes the top 23 bits of a word at the
// midpoints, (k + 1/2) 2^-23, never below 2^-24: a clamped zero, which
// torch.rand's 24 bits give once in 2^24 draws, would pass every
// acceptance test u < p with p above the smallest normal, and
// divide-and-conquer's p = exp(-tilt x) never falls below that (its
// argument is clamped at -79.85), so such a lane accepts a partition draw
// however large. Normals by Box-Muller from two uniforms (the cosine
// branch).

#pragma once

#include <cfloat>
#include <cstdint>

namespace bbrng {

constexpr uint32_t kM0 = 0xD2511F53u;
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;
constexpr uint32_t kW1 = 0xBB67AE85u;

// Ten rounds, the key bumped between rounds.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += kW0;
      k.y += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

struct Stream {
  uint2 key;
  uint4 ctr;
  uint4 buf;
  int pos;

  __device__ Stream(uint64_t key64, uint64_t lane)
      : key(make_uint2(static_cast<uint32_t>(key64),
                       static_cast<uint32_t>(key64 >> 32))),
        ctr(make_uint4(static_cast<uint32_t>(lane),
                       static_cast<uint32_t>(lane >> 32), 0u, 0u)),
        buf(make_uint4(0u, 0u, 0u, 0u)),
        pos(4) {}

  __device__ __forceinline__ uint32_t next() {
    if (pos == 4) {
      buf = philox4x32_10(ctr, key);
      if (++ctr.z == 0) ++ctr.w;
      pos = 0;
    }
    const uint32_t w = pos == 0 ? buf.x : pos == 1 ? buf.y
                       : pos == 2 ? buf.z : buf.w;
    ++pos;
    return w;
  }
};

// Round r's words of a lane: the blocks (lane, first), (lane, first + 1),
// ... taken in order; the caller never takes more than its B blocks.
struct RoundStream {
  uint2 key;
  uint4 ctr;
  uint4 buf;
  int pos;

  __device__ RoundStream(uint64_t key64, uint64_t lane, uint32_t first)
      : key(make_uint2(static_cast<uint32_t>(key64),
                       static_cast<uint32_t>(key64 >> 32))),
        ctr(make_uint4(static_cast<uint32_t>(lane),
                       static_cast<uint32_t>(lane >> 32), first, 0u)),
        buf(make_uint4(0u, 0u, 0u, 0u)),
        pos(4) {}

  __device__ __forceinline__ uint32_t next() {
    if (pos == 4) {
      buf = philox4x32_10(ctr, key);
      ++ctr.z;
      pos = 0;
    }
    const uint32_t w = pos == 0 ? buf.x : pos == 1 ? buf.y
                       : pos == 2 ? buf.z : buf.w;
    ++pos;
    return w;
  }
};

template <class S>
__device__ __forceinline__ float uniform(S& s, float) {
  return (static_cast<float>(s.next() >> 9) + 0.5f) * 0x1p-23f;
}

template <class S>
__device__ __forceinline__ double uniform(S& s, double) {
  const uint64_t hi = s.next(), lo = s.next();
  const double u =
      static_cast<double>((hi << 21) | (lo >> 11)) * 0x1p-53;
  return fmax(u, DBL_MIN);
}

template <class S>
__device__ __forceinline__ float normal(S& s, float) {
  const float u1 = uniform(s, 0.f), u2 = uniform(s, 0.f);
  return sqrtf(-2.f * logf(u1)) * cospif(2.f * u2);
}

template <class S>
__device__ __forceinline__ double normal(S& s, double) {
  const double u1 = uniform(s, 0.0), u2 = uniform(s, 0.0);
  return sqrt(-2.0 * log(u1)) * cospi(2.0 * u2);
}

}  // namespace bbrng

// The draws' math in their dtype, by overload: the accurate library
// functions (expf, logf, log1pf, ... and their double counterparts),
// never the __expf-style intrinsics, since the draws' tails depend on
// them (the build passes no fast-math flag).
namespace bbm {

#define BBM_UNARY(name, fname)                                             \
  __device__ __forceinline__ float name(float x) { return ::fname(x); }    \
  __device__ __forceinline__ double name(double x) { return ::name(x); }
BBM_UNARY(exp, expf)
BBM_UNARY(log, logf)
BBM_UNARY(log1p, log1pf)
BBM_UNARY(sqrt, sqrtf)
BBM_UNARY(sin, sinf)
BBM_UNARY(erfc, erfcf)
BBM_UNARY(erfcx, erfcxf)
BBM_UNARY(floor, floorf)
BBM_UNARY(fabs, fabsf)
#undef BBM_UNARY

__device__ __forceinline__ float fmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double fmin(double a, double b) {
  return ::fmin(a, b);
}
__device__ __forceinline__ float fmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double fmax(double a, double b) {
  return ::fmax(a, b);
}

// x ** a for x >= 0, as exp(a log x) (the port's utils.chains.pow_pos).
template <typename T>
__device__ __forceinline__ T pow_pos(T x, T a) {
  return exp(a * log(x));
}

}  // namespace bbm
