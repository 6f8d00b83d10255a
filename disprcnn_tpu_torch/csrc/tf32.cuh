// Error-compensated TF32 ("3xTF32") on Hopper's tensor cores (sm_90a), and
// the cp.async copies that stage their operands: shared by conv3d_tc.cu
// (the PSMNet convs) and mlp_tc.cuh (the set-abstraction chain of sa.cu).
//
// Each float32 operand v is split as v = hi + lo, hi = tf32(v), lo =
// tf32(v - hi), tf32 rounding to nearest with ties away from zero at 10
// mantissa bits ((bits + 0x1000) & ~0x1fff, what cvt.rna.tf32.f32 gives
// for finite v; its plain version is ops/cuda/conv3d.py::split_tf32). A
// product is lo*hi + hi*lo + hi*hi into float32 accumulators (the two small
// terms first); the dropped lo*lo and the rounding of lo are ~2^-22 of
// |a*b|, float32-level, where one TF32 product keeps ~2^-11. The mma's own
// accumulation is not IEEE (each add into its accumulator truncates toward
// zero), so the callers sum a few dozen terms in the mma and promote those
// sums into their running float32 sums with rounding to nearest.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// d += a * b, a 16x8 (row), b 8x8 (col), tf32 operands, float32 accumulators.
// Fragments (g = lane / 4, t = lane % 4): a0 (row g, col t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4); b0 (row t, col g), b1 (t + 4, g); d0,
// d1 (row g, cols 2t, 2t + 1), d2, d3 (row g + 8, the same columns).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes, zero-filled where !valid (src is then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
