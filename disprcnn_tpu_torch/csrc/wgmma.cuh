// The mbarrier, named-barrier and warpgroup-product (wgmma, sm_90a)
// primitives of the kernels built on Hopper's warpgroup tensor-core
// products: mlp_wgmma.cuh (grouped_mlp.cu) and conv_bf16_wgmma.cu. The
// products themselves (wgmma.mma_async) stay with their users, whose
// operands differ: A from registers in mlp_wgmma.cuh, A and B both from
// shared memory in conv_bf16_wgmma.cu.
//
// A ring of stages in shared memory runs on two mbarriers a slot: `full`
// completes when the slot's data has landed, `empty` when every consumer
// warp is done with it (bar_init's count is the arrivals a phase takes).
// A product: wgmma reads shared memory through a matrix descriptor; the
// warpgroup fences its accumulators and issues (fence), groups its issued
// products (commit) and waits until at most N groups are pending (wait<N>).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace wg {

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(tma::smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(tma::smem_u32(bar))
               : "memory");
}

// Wait for the phase of `parity` of an mbarrier to complete, as tma::wait,
// but suspended in try_wait until the phase completes (the hint allows up
// to 1 ms) instead of polling, which leaves the issue slots to the warps
// that have work.
__device__ __forceinline__ void wait_suspended(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1, %2;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(tma::smem_u32(bar)),
      "r"(parity), "r"(1000000)
      : "memory");
}

// bar.sync on a named barrier of `threads` threads (id 0 is __syncthreads')
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma's matrix descriptor of a K-major operand without swizzle at shared
// address `addr`: core matrices of 8 rows x 16 bytes, leading byte offset
// `lbo` (to the core matrix of the next K values), stride byte offset `sbo`
// (to the next 8 rows)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of an accumulator across the
// asynchronous products' issue and wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

}  // namespace wg
