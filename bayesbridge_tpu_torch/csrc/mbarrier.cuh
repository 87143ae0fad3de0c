// Shared-memory barriers (mbarrier) and bulk asynchronous copies (TMA's
// cp.async.bulk) for the warp-specialised kernels: ne_oneread.cu and
// bitlut.cu. A producer thread arms a barrier with the bytes it expects
// and starts the copies; consumers wait on the barrier's phase parity.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bbasync {
namespace {  // internal linkage: each .cu file gets its own copy

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   saddr(bar))
               : "memory");
}

// Arrive on `bar` and expect `bytes` of bulk copies in its current phase.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          saddr(bar)),
      "r"(bytes)
      : "memory");
}

// Wait for the phase of the given parity to complete; kCluster: acquire
// at cluster scope (for arrivals from peers). Bounded at about ten
// seconds: a miscounted phase traps, a launch error, instead of hanging
// the card.
template <bool kCluster>
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    if constexpr (kCluster)
      asm volatile(
          "{\n\t.reg .pred p;\n\t"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, "
          "[%1], %2;\n\tselp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(saddr(bar)), "r"(parity)
          : "memory");
    else
      asm volatile(
          "{\n\t.reg .pred p;\n\t"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(saddr(bar)), "r"(parity)
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
      "[%0], [%1], %2, [%3];\n" ::"r"(saddr(dst)),
      "l"(src), "r"(bytes), "r"(saddr(bar))
      : "memory");
}

}  // namespace
}  // namespace bbasync
