// Hopper's bulk copy from device memory into shared memory (the Tensor
// Memory Accelerator's cp.async.bulk, no tensor map), completing on an
// mbarrier in shared memory, in inline PTX: one thread sets the bytes a
// barrier's phase waits for and issues the copy; every thread waits for
// the phase. Addresses and sizes of a copy are multiples of 16 bytes.
#pragma once

#include <cstdint>

namespace gat {

__device__ __forceinline__ unsigned smem_address(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// A barrier that completes a phase at `count` arrivals (and the bytes
// they announce); by one thread, before the block's barrier.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_address(bar)), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival, announcing `bytes` that copies will complete on the barrier
// (0: a plain arrival).
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_address(bar)), "r"(bytes) : "memory");
}

// Copies `bytes` from src (device memory) to dst (shared memory),
// completing them on `bar`. The fence orders the block's earlier reads of
// dst, made before a __syncthreads, before the copy's writes.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_address(dst)), "l"(src), "r"(bytes),
         "r"(smem_address(bar))
      : "memory");
}

// Waits until the barrier's phase of this parity (0 for its first, 1 for
// its second, ...) has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_address(bar)), "r"(parity) : "memory");
  } while (!done);
}

}  // namespace gat
