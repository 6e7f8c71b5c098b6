// Bulk copies from global into shared memory on Hopper's copy engine
// (cp.async.bulk, sm_90), completing on an mbarrier in shared memory: one
// thread starts a copy, every thread that reads the data waits on the
// barrier.  Used by mesh_binned_pair.cu (each bin's packed faces),
// mesh_binned_phase1.cu (the bin bounds) and conv5x5_act.cu (its rings of
// weights and halos, whose barriers also count threads' arrivals).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace aptd {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A barrier whose phase completes on one arrival (the copy's own) and the
// bytes that arrival announced.  One thread initialises; the block
// synchronises before any other thread waits on it.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// A barrier whose phase completes on `count` arrivals and the bytes they
// announced.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival, announcing no bytes.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Start copying `bytes` (a multiple of 16; both addresses 16-byte aligned)
// from global `src` to shared `dst`.  The caller makes sure, by a block
// barrier before this call, that no thread still reads `dst`; the proxy
// fence orders those reads before the copy engine's writes.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

}  // namespace aptd
