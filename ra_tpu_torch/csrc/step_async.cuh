// The barriers and asynchronous copies of step.cu, each behind a small
// helper: the block's mbarrier (init, arrive, wait on a phase), the 1-D
// bulk copy from device memory into shared memory that completes on it,
// the block barrier, the grid barrier of a cooperative launch and the
// L1-bypassing load of the pre-pass maps.
// tests/test_torch_step_host.py compiles step.cu on the host with its
// own header of this name in place of this one: there a bulk copy is a
// memcpy, the barriers are no-ops (its runner orders the phases and
// sub-phases itself) and the load a plain read.

#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

// one thread initialises the block's barrier for `count` arrivals a phase
__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(bar));
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(a),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// a plain arrival (release: the thread's shared-memory stores before it
// are visible to the threads that wait on the phase)
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(bar));
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(a)
               : "memory");
}

// this thread's arrival, carrying `bytes` of transfer, and a bulk copy of
// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// memory into shared memory that completes them on the barrier. The
// proxy fence orders the block's earlier generic accesses to the
// destination (the previous tile) before the copy's writes.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(bar));
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(a),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(d),
      "l"(src), "r"(bytes), "r"(a)
      : "memory");
}

// wait until the barrier completes the phase of the given parity (0 for
// its first phase, then 1, 0, ...)
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(bar));
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void block_sync() { __syncthreads(); }

// every thread of a cooperative launch
__device__ __forceinline__ void grid_sync() {
  cooperative_groups::this_grid().sync();
}

template <class T>
__device__ __forceinline__ T load_cg(const T* p) {
  return __ldcg(p);
}
