// bf16 operands on Hopper's tensor cores (sm_90a) with float32 accumulation,
// the conversions around them, and (namespace tc) the operand fragments of
// the float32 (3xTF32) and bf16 forms side by side: the mma and fragments
// are conv3d_tc.cu's (the PSMNet convs) and cost_volume_tc.cu's (the
// cost-volume conv); the element helpers also serve conv3d.cuh, conv3d.cu
// and softargmin.cu in their bf16 forms.
//
// A bf16 value is kept as its 16 bits (uint16_t in memory); two of them
// share a 32-bit register as the mma's operands want them, the lower K index
// in the lower half. A product of two bf16 values is exact in float32 (8 + 8
// significant bits), so a bf16 conv differs from the float32 conv of the
// same bf16 values only in the order of its float32 sums and in the one
// rounding to bf16 at the store. Every rounding to bf16 is to nearest, ties
// to even (cvt.rn), as XLA's astype(bfloat16) and torch's .to(torch.bfloat16)
// round; nothing truncates.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tf32.cuh"

using bf16_t = uint16_t;

__device__ __forceinline__ float bf16_to_float(bf16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// v rounded to bf16, to nearest, ties to even (NaN stays NaN)
__device__ __forceinline__ bf16_t bf16_rn(float v) {
  uint16_t r;
  asm("cvt.rn.bf16.f32 %0, %1;" : "=h"(r) : "f"(v));
  return r;
}

// lo and hi rounded to bf16 (to nearest, ties to even) and packed: lo in
// the lower half
__device__ __forceinline__ uint32_t bf16x2_rn(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// two bf16 values packed, lo in the lower half
__device__ __forceinline__ uint32_t bf16_pack(bf16_t lo, bf16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// d += a * b, a 16x16 (row), b 16x8 (col), bf16 operands, float32
// accumulators. Fragments (g = lane / 4, t = lane % 4), each register two
// bf16 values of consecutive K: a0 (row g, K 2t, 2t + 1), a1 (g + 8, 2t,
// 2t + 1), a2 (g, 2t + 8, 2t + 9), a3 (g + 8, 2t + 8, 2t + 9); b0 (K 2t,
// 2t + 1, col g), b1 (K 2t + 8, 2t + 9, col g); d0, d1 (row g, cols 2t,
// 2t + 1), d2, d3 (row g + 8, the same columns). Seen as pairs of K, the
// A fragment is m16n8k8's TF32 one (pair t and t + 4 of rows g and g + 8),
// so the callers read the staged operands at the TF32 form's offsets. The
// products are exact; the mma's own adds into its accumulators are not
// IEEE (they truncate), so the callers promote a stage's sums into their
// running float32 sums with rounding to nearest, as with TF32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Element access for kernels templated on their storage type (float or
// bf16_t): the value as float, and a float stored to the type (bf16 to
// nearest even).
__device__ __forceinline__ float elem_to_float(float v) { return v; }
__device__ __forceinline__ float elem_to_float(bf16_t v) { return bf16_to_float(v); }

template <typename T>
__device__ __forceinline__ T elem_from_float(float v);
template <>
__device__ __forceinline__ float elem_from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16_t elem_from_float<bf16_t>(float v) {
  return bf16_rn(v);
}

// read-only loads through the non-coherent cache
__device__ __forceinline__ float ldg_float(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_float(const bf16_t* p) {
  return bf16_to_float(__ldg(reinterpret_cast<const unsigned short*>(p)));
}

// The tensor-core convs' two forms side by side (conv3d_tc.cu,
// cost_volume_tc.cu), so that one kernel body serves both: the staged
// operands are 32-bit words either way.
namespace tc {

// The two forms. float: a K step is 8 input channels, each a halo slot of
// floats, the weights' B fragments pre-split as [hi(k), hi(k + 4), lo(k),
// lo(k + 4)] (4 words a lane), 3 TF32 products a step. bf16: a K step is 16
// input channels, each halo slot a 32-bit word holding a pair of them
// (channels 2p, 2p + 1 of one position), the weights' B fragments as two
// packed pairs (2 words a lane), one bf16 product a step.
template <typename T>
struct Form {
  static constexpr bool kBf16 = std::is_same<T, bf16_t>::value;
  static constexpr int kChunk = kBf16 ? 16 : 8;  // input channels a stage
  static constexpr int kLaneWords = kBf16 ? 2 : 4;  // weight words a lane, tap and N-tile
};

// A lane's B fragment of one N-tile: load_b reads it from the staged
// weights, word index 4 idx (float, one 16-byte vector) or 2 idx (bf16, 8
// bytes).
template <typename T>
struct Frags;

template <>
struct Frags<float> {
  uint32_t bh[2], bl[2];
  __device__ __forceinline__ void load_b(const uint32_t* ws, int idx) {
    const float4 q = reinterpret_cast<const float4*>(ws)[idx];
    bh[0] = __float_as_uint(q.x);
    bh[1] = __float_as_uint(q.y);
    bl[0] = __float_as_uint(q.z);
    bl[1] = __float_as_uint(q.w);
  }
};

template <>
struct Frags<bf16_t> {
  uint32_t b[2];
  __device__ __forceinline__ void load_b(const uint32_t* ws, int idx) {
    const uint2 q = reinterpret_cast<const uint2*>(ws)[idx];
    b[0] = q.x;
    b[1] = q.y;
  }
};

// A lane's A fragment: load reads the staged words at offsets o0 (row g of
// the M-tile) and o1 (row g + 8), slot t and slot t + 4 (cp4 words on);
// float splits each into TF32 hi and lo.
template <typename T>
struct AFrag;

template <>
struct AFrag<float> {
  uint32_t ah[4], al[4];
  __device__ __forceinline__ void load(const uint32_t* h, int o0, int o1, int cp4) {
    split_tf32(__uint_as_float(h[o0]), ah[0], al[0]);
    split_tf32(__uint_as_float(h[o1]), ah[1], al[1]);
    split_tf32(__uint_as_float(h[o0 + cp4]), ah[2], al[2]);
    split_tf32(__uint_as_float(h[o1 + cp4]), ah[3], al[3]);
  }
};

template <>
struct AFrag<bf16_t> {
  uint32_t a[4];
  __device__ __forceinline__ void load(const uint32_t* h, int o0, int o1, int cp4) {
    a[0] = h[o0];
    a[1] = h[o1];
    a[2] = h[o0 + cp4];
    a[3] = h[o1 + cp4];
  }
};

// acc[i][j] += A[i] * B[j] for the first `mt` of the MT M-tiles: float as
// lo*hi + hi*lo + hi*hi (3xTF32, the small terms first; each pass over all
// tiles, so that consecutive mma write different accumulators), bf16 as
// one product
template <int MT, int NT>
__device__ __forceinline__ void mma_tiles(float (&acc)[MT][NT][4], const AFrag<float> (&a)[MT],
                                          const Frags<float> (&b)[NT], int mt) {
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (i >= mt) break;
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], a[i].al, b[j].bh[0], b[j].bh[1]);
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (i >= mt) break;
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], a[i].ah, b[j].bl[0], b[j].bl[1]);
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (i >= mt) break;
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], a[i].ah, b[j].bh[0], b[j].bh[1]);
  }
}

template <int MT, int NT>
__device__ __forceinline__ void mma_tiles(float (&acc)[MT][NT][4], const AFrag<bf16_t> (&a)[MT],
                                          const Frags<bf16_t> (&b)[NT], int mt) {
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (i >= mt) break;
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], a[i].a, b[j].b[0], b[j].b[1]);
  }
}

}  // namespace tc
