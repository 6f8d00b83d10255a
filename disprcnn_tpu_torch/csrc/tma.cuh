// The Tensor Memory Accelerator's bulk copies of contiguous runs of bytes
// between global and shared memory, and the mbarriers that count their
// arrival (sm_90). Used by conv3d.cu, nms.cu and roipool3d.cu.
//
// A load: one thread arms the barrier with the bytes it expects
// (expect), the copies arrive against it (load), and a thread that needs
// the data waits on the barrier's phase (wait). A store: the threads that
// wrote the shared source fence it for the async proxy (fence_to_async),
// a barrier follows, one thread issues the stores (store) and commits them
// as a group (commit); before the source is written again that thread
// waits until the groups have read it (wait_read<N>, N groups may still be
// pending) and, before the block exits, until they are done (wait_all).
// Every address is 16-byte aligned and every size a multiple of 16 bytes.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace tma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)));
}

// make the barriers' initialisation visible to the async proxy
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
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

// order this thread's generic-proxy accesses to shared memory before
// later async-proxy ones (a bulk copy that overwrites or reads them)
__device__ __forceinline__ void fence_to_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace tma
