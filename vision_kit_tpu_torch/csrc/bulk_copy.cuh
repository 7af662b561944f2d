// Hopper bulk copies (TMA, cp.async.bulk) from device memory into shared
// memory, with mbarrier completion, for the port's kernels.
//
// One thread arms a barrier with the bytes it expects and issues the copy;
// every thread that reads the data waits on the barrier's phase parity. A
// copy needs a 16-byte-aligned source and destination and a size that is a
// multiple of 16 bytes.

#pragma once

#include <stdint.h>

namespace bulk {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Called by one thread for `n` barriers; each completes a phase on one
// arrival plus the bytes announced with it. One fence after all of them
// makes the initialisation visible to the copies and the other threads.
__device__ __forceinline__ void barriers_init(uint64_t* bars, int n) {
  for (int i = 0; i < n; ++i)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&bars[i]))
                 : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Orders this thread's earlier shared-memory accesses (and, after a block
// or warp barrier, those of the threads it synchronised with) before the
// bulk copy that it issues next into the same memory.
__device__ __forceinline__ void fence_before_copy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Arms `bar` for `bytes` and, if there are any, copies them from `src` to
// `dst`. Issued by one thread.
__device__ __forceinline__ void load(void* dst, const void* src, uint32_t bytes,
                                     uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
  if (bytes > 0) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
  }
}

// Waits until the phase of `bar` with this parity has completed. A copy
// that never lands (a fault in the caller's byte count) traps after about
// ten seconds instead of hanging the card.
__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 34)) {
      __trap();
    }
  }
}

}  // namespace bulk
