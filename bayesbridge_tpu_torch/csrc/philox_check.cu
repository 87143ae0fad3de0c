// Test entries of csrc/philox.cuh (no kernel of the port's path): the
// card test holds our Philox4x32-10 against the toolkit's
// curand_Philox4x32_10 (curand_kernel.h) on the same counters and keys,
// and reads a lane's words, uniforms and normals as the draw kernels
// take them. Kept out of the draw kernels' sources so that they do not
// include curand_kernel.h.

#include <cstdint>

#include <curand_kernel.h>

#include "philox.cuh"

namespace {

__global__ void philox_check_kernel(const uint4* ctr, const uint2* key,
                                    uint4* ours, uint4* theirs, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  ours[i] = bbrng::philox4x32_10(ctr[i], key[i]);
  theirs[i] = curand_Philox4x32_10(ctr[i], key[i]);
}

// The first `n_words` words of stream (key, lane), then `n_draws`
// uniforms of stream (key, lane + 1) and normals of (key, lane + 2).
template <typename T>
__global__ void stream_check_kernel(uint64_t key, uint64_t lane,
                                    uint32_t* words, int n_words, T* unif,
                                    T* norm, int n_draws) {
  bbrng::Stream s(key, lane);
  for (int w = 0; w < n_words; ++w) words[w] = s.next();
  bbrng::Stream u(key, lane + 1);
  for (int d = 0; d < n_draws; ++d) unif[d] = bbrng::uniform(u, T(0));
  bbrng::Stream g(key, lane + 2);
  for (int d = 0; d < n_draws; ++d) norm[d] = bbrng::normal(g, T(0));
}

}  // namespace

// ctr (n, 4) and key (n, 2) uint32 words; ours, theirs (n, 4).
extern "C" int bb_philox_check(const void* ctr, const void* key, void* ours,
                               void* theirs, int n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  philox_check_kernel<<<(n + 127) / 128, 128, 0, s>>>(
      static_cast<const uint4*>(ctr), static_cast<const uint2*>(key),
      static_cast<uint4*>(ours), static_cast<uint4*>(theirs), n);
  return (int)cudaGetLastError();
}

extern "C" int bb_philox_stream(int is_double, long long key, long long lane,
                                void* words, int n_words, void* unif,
                                void* norm, int n_draws, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto w = static_cast<uint32_t*>(words);
  const auto k = static_cast<uint64_t>(key);
  const auto l = static_cast<uint64_t>(lane);
  if (is_double)
    stream_check_kernel<double><<<1, 1, 0, s>>>(
        k, l, w, n_words, static_cast<double*>(unif),
        static_cast<double*>(norm), n_draws);
  else
    stream_check_kernel<float><<<1, 1, 0, s>>>(
        k, l, w, n_words, static_cast<float*>(unif),
        static_cast<float*>(norm), n_draws);
  return (int)cudaGetLastError();
}
