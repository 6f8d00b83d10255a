// The shared-MLP chain of the fused set-abstraction kernel (sa.cu) and of
// the feature-propagation kernel (fp.cu) on Hopper's tensor cores
// (sm_90a), float32 in and out at float32 accuracy.
//
// A block of W warps (8 in sa.cu, 16 in fp.cu) holds a tile of R = 16 MT
// activation rows (whole balls in sa.cu) in shared memory and runs each dense layer Y = relu(X W +
// b) as an (R x Ci) by (Ci x Co) product on mma.sync.m16n8k8 TF32 with both
// operands split hi + lo and the three products lo*hi + hi*lo + hi*hi
// summed (tf32.cuh: "3xTF32"); the last layer ends in the max over each
// ball (sa.cu) or stores its rows (fp.cu), from registers. The TPU kernels
// run these chains as MXU products with float32 accumulation
// (disprcnn_tpu/ops/pallas/sa_fused.py and fp_fused.py, bf16 weights);
// this one keeps float32 accuracy.
//
// GEMM view of a layer: M = the tile's R rows, N = Co, K = Ci, both padded
// to a multiple of 8 with zeros (a 196-wide layer is 200 wide here; the
// padded weights are zero, so the padded columns of Y are relu(0) = 0 and
// add nothing to the next layer). A pass of the W warps covers 16 W output
// columns: warp w owns N-tiles 2w, 2w + 1 of the pass against all R rows
// (MT M-tiles), so a ball's rows all sit in one warp and its max needs no
// shared memory: an in-lane max over the M-tiles and halves the ball spans,
// then butterfly shuffles over the 8 row groups of a fragment.
// A (the activations) is read from shared memory as fragments and split in
// registers; its leading dimension is 4 (mod 32), so the 32 lanes of one
// fragment read (8 rows x 4 columns) fall in 32 distinct banks. B (the
// weights) comes split and fragment-ordered from device memory, one float4
// per lane and N-tile per k8 step ([hi(k), hi(k + 4), lo(k), lo(k + 4)] of
// row k = lane % 4 and column lane / 4; sa.cu's pack_kernel, whose plain
// version is ops/cuda/sa.py::pack_tf32_chain), loaded one step ahead of
// its use: each block reads each weight once, from L2.
// Promotion: every kPromote k8 steps (64 terms) the mma sums join the
// running float32 sums with rounding to nearest, as conv3d_tc.cu's stages
// do (the mma's adds truncate).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32.cuh"

namespace mlp_tc {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxLayers = 4;
constexpr int kPromote = 8;   // k8 steps summed in the mma before promotion
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNT = 2;        // N-tiles of 8 columns a warp owns in a pass

// Dense layers of a chain, each followed by ReLU: wpk[l] is layer l's
// packed weights (pad8(c[l]) / 8 k8 steps, pad8(c[l + 1]) / 8 N-tiles, 32
// lanes, 4 floats), b[l] its bias (c[l + 1],).
struct Chain {
  const float* wpk[kMaxLayers];
  const float* b[kMaxLayers];
  int c[kMaxLayers + 1];
  int layers;
};

__host__ __device__ inline int pad8(int c) { return (c + 7) & ~7; }

// floats of one layer's packed weights
__host__ __device__ inline int packed_floats(int ci, int co) { return pad8(ci) * pad8(co) * 2; }

// leading dimension of an activation buffer of c columns: >= pad8(c), = 4
// (mod 32)
inline int lead(int c) {
  const int p = pad8(c);
  return p + (36 - p % 32) % 32;
}

// Leading dimensions of the two ping-pong buffers: activations 0, 2, 4
// live in buf0, 1, 3 in buf1 (0 if none); the last layer's output is not
// stored.
inline void buffer_widths(const Chain& chain, int* ld0, int* ld1) {
  int w0 = chain.c[0], w1 = 0;
  for (int l = 1; l < chain.layers; ++l) {
    if (l % 2 == 0) w0 = chain.c[l] > w0 ? chain.c[l] : w0;
    else w1 = chain.c[l] > w1 ? chain.c[l] : w1;
  }
  *ld0 = lead(w0);
  *ld1 = w1 > 0 ? lead(w1) : 0;
}

// acc[i][j] += rows 16 i .. 16 i + 15 of A (shared, lda) times N-tile nt0 +
// j of the packed weights wpk (k8 steps of 8 rows, n8 N-tiles, 32 lanes, 4),
// over the weights' k8 steps kb .. ke - 1; A's column 0 is row 8 kb of the
// weights. The mma sums are promoted every kPromote steps counted from kb
// (a multiple of kPromote, so that a product split over several calls
// rounds as one call over all its steps). N-tiles at or past n8 are
// neither read nor multiplied (warp-uniform).
template <int MT>
__device__ __forceinline__ void pass_accumulate(const float* A, int lda, int kb, int ke,
                                                const float* __restrict__ wpk, int n8, int nt0,
                                                float (&acc)[MT][kNT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nts = min(kNT, n8 - nt0);
  const float4* wb = reinterpret_cast<const float4*>(wpk) + (size_t)nt0 * 32 + lane;
  const size_t kstride = (size_t)n8 * 32;
  const float* ap = A + g * lda + t;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 b[kNT];
#pragma unroll
  for (int j = 0; j < kNT; ++j) b[j] = j < nts ? __ldg(wb + (size_t)kb * kstride + j * 32) : zero;
  for (int k0 = kb; k0 < ke; k0 += kPromote) {
    float part[MT][kNT][4];  // this stage's products
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
    const int k1 = min(ke, k0 + kPromote);
    for (int kk = k0; kk < k1; ++kk) {
      float4 nb[kNT];  // the next step's B, in flight while this one multiplies
      const bool more = kk + 1 < ke;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        nb[j] = more && j < nts ? __ldg(wb + (size_t)(kk + 1) * kstride + j * 32) : zero;
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float* p = ap + 16 * i * lda + 8 * (kk - kb);
        split_tf32(p[0], ah[i][0], al[i][0]);
        split_tf32(p[8 * lda], ah[i][1], al[i][1]);
        split_tf32(p[4], ah[i][2], al[i][2]);
        split_tf32(p[8 * lda + 4], ah[i][3], al[i][3]);
      }
      uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        bh[j][0] = __float_as_uint(b[j].x);
        bh[j][1] = __float_as_uint(b[j].y);
        bl[j][0] = __float_as_uint(b[j].z);
        bl[j][1] = __float_as_uint(b[j].w);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          if (j < nts) mma_tf32(part[i][j], al[i], bh[j][0], bh[j][1]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          if (j < nts) mma_tf32(part[i][j], ah[i], bl[j][0], bl[j][1]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          if (j < nts) mma_tf32(part[i][j], ah[i], bh[j][0], bh[j][1]);
#pragma unroll
      for (int j = 0; j < kNT; ++j) b[j] = nb[j];
    }
    // the stage's sums join the running ones in float32, rounded to nearest
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
}

template <int MT>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][kNT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// acc[i][j] = rows 16 i .. 16 i + 15 of A (shared, lda, k8 steps of 8
// columns) times N-tile nt0 + j of the packed weights wpk (k8, n8, 32, 4).
template <int MT>
__device__ __forceinline__ void pass_product(const float* A, int lda, int k8,
                                             const float* __restrict__ wpk, int n8, int nt0,
                                             float (&acc)[MT][kNT][4]) {
  zero_acc<MT>(acc);
  pass_accumulate<MT>(A, lda, 0, k8, wpk, n8, nt0, acc);
}

// Y (shared, ldy) = relu(acc + b) in the columns of N-tiles nt0 .. nt0 +
// kNT - 1 below n8 (zero past co): a pass's epilogue into the next layer's
// input.
template <int MT>
__device__ __forceinline__ void store_relu(const float (&acc)[MT][kNT][4],
                                           const float* __restrict__ bias, int co, int n8,
                                           int nt0, float* Y, int ldy) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    if (nt0 + j >= n8) break;
    const int col = (nt0 + j) * 8 + 2 * t;
    const float b0 = col < co ? __ldg(bias + col) : 0.f;
    const float b1 = col + 1 < co ? __ldg(bias + col + 1) : 0.f;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(Y + (16 * i + g + 8 * h) * ldy + col) =
            make_float2(fmaxf(acc[i][j][2 * h] + b0, 0.f), fmaxf(acc[i][j][2 * h + 1] + b1, 0.f));
  }
}

// out[r * co + col] = relu(acc + b) for rows r < rows and columns col < co
// of N-tiles nt0 .. nt0 + kNT - 1 below n8: a last layer's rows, from
// registers to device memory.
template <int MT>
__device__ __forceinline__ void store_relu_rows(const float (&acc)[MT][kNT][4],
                                                const float* __restrict__ bias, int co, int n8,
                                                int nt0, int rows, float* __restrict__ out) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    if (nt0 + j >= n8) break;
    const int col = (nt0 + j) * 8 + 2 * t;
    if (col >= co) continue;
    const bool two = col + 1 < co;
    const float b0 = __ldg(bias + col);
    const float b1 = two ? __ldg(bias + col + 1) : 0.f;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * i + g + 8 * h;
        if (r >= rows) continue;
        float* o = out + (size_t)r * co + col;
        const float v0 = fmaxf(acc[i][j][2 * h] + b0, 0.f);
        const float v1 = fmaxf(acc[i][j][2 * h + 1] + b1, 0.f);
        if (two && co % 2 == 0) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          o[0] = v0;
          if (two) o[1] = v1;
        }
      }
  }
}

// Y (shared, ldy) = relu(A W + b) over the padded width pad8(co), zero past
// co. A and Y are different buffers; the caller synchronises before
// reading Y.
// WARPS warps share the layer, kNT N-tiles each a pass.
template <int MT, int WARPS = kWarps>
__device__ void hidden_layer(const float* A, int lda, int ci, const float* __restrict__ wpk,
                             const float* __restrict__ bias, int co, float* Y, int ldy) {
  const int warp = threadIdx.x >> 5;
  const int k8 = pad8(ci) / 8, n8 = pad8(co) / 8;
  for (int nt0 = warp * kNT; nt0 < n8; nt0 += WARPS * kNT) {
    float acc[MT][kNT][4];
    pass_product<MT>(A, lda, k8, wpk, n8, nt0, acc);
    store_relu<MT>(acc, bias, co, n8, nt0, Y, ldy);
  }
}

// out[r * co + col] = relu(A W + b) for the tile's rows r < rows: a last
// layer whose rows go from registers to device memory.
template <int MT, int WARPS = kWarps>
__device__ void last_layer_rows(const float* A, int lda, int ci, const float* __restrict__ wpk,
                                const float* __restrict__ bias, int co, int rows,
                                float* __restrict__ out) {
  const int warp = threadIdx.x >> 5;
  const int k8 = pad8(ci) / 8, n8 = pad8(co) / 8;
  for (int nt0 = warp * kNT; nt0 < n8; nt0 += WARPS * kNT) {
    float acc[MT][kNT][4];
    pass_product<MT>(A, lda, k8, wpk, n8, nt0, acc);
    store_relu_rows<MT>(acc, bias, co, n8, nt0, rows, out);
  }
}

// out[q * co + col] = max over rows q s .. q s + s - 1 of relu(A W + b), for
// balls q < groups and col < co; s divides R = 16 MT.
template <int MT>
__device__ void last_layer_max(const float* A, int lda, int ci, const float* __restrict__ wpk,
                               const float* __restrict__ bias, int co, int groups, int s,
                               float* __restrict__ out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int k8 = pad8(ci) / 8, n8 = pad8(co) / 8;
  const int s8 = min(s, 8);  // rows of a ball within one fragment half
  for (int nt0 = warp * kNT; nt0 < n8; nt0 += kWarps * kNT) {
    float acc[MT][kNT][4];
    pass_product<MT>(A, lda, k8, wpk, n8, nt0, acc);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      if (nt0 + j >= n8) break;
      const int col = (nt0 + j) * 8 + 2 * t;
      const float bv[2] = {col < co ? __ldg(bias + col) : 0.f,
                           col + 1 < co ? __ldg(bias + col + 1) : 0.f};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v[MT][2];  // rows 16 i + g + 8 h
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) v[i][h] = fmaxf(acc[i][j][2 * h + e] + bv[e], 0.f);
        if (s >= 16) {
          // a ball spans s / 16 whole M-tiles: the max over them and both
          // halves in the lane, then over the 8 row groups
          const int span = s / 16;  // a power of two dividing MT
          float x[MT];
#pragma unroll
          for (int i = 0; i < MT; ++i) x[i] = fmaxf(v[i][0], v[i][1]);
#pragma unroll
          for (int d = 1; d < MT; d <<= 1)
            if (d < span)
#pragma unroll
              for (int i = 0; i < MT; ++i) x[i] = fmaxf(x[i], x[i ^ d]);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            if (i % span != 0) continue;
            float y = x[i];
#pragma unroll
            for (int o = 4; o < 32; o <<= 1) y = fmaxf(y, __shfl_xor_sync(kFull, y, o));
            const int q = i / span;
            if (g == 0 && q < groups && col + e < co) out[(size_t)q * co + col + e] = y;
          }
        } else {
          // a ball is s consecutive row groups of one half
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float x = v[i][h];
              for (int o = 1; o < s8; o <<= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, 4 * o));
              const int q = (16 * i + 8 * h + g) / s;
              if (g % s8 == 0 && q < groups && col + e < co) out[(size_t)q * co + col + e] = x;
            }
        }
      }
    }
  }
}

// The chain over a tile of R = 16 MT rows whose first activations sit in
// buf0 (ld0, pad8(c[0]) columns, zero past c[0]), reduced over balls of s
// consecutive rows: the hidden layers, ping-ponging between buf0 and buf1
// (ld1) with a barrier after each, then the last layer into out[q * co +
// col] for balls q < groups. chain.layers >= 1; the caller synchronises
// after filling buf0.
template <int MT>
__device__ void chain_max(const Chain& chain, float* buf0, int ld0, float* buf1, int ld1,
                          int groups, int s, float* __restrict__ out) {
  float* cur = buf0;
  float* nxt = buf1;
  int lc = ld0, ln = ld1;
  for (int l = 0; l + 1 < chain.layers; ++l) {
    hidden_layer<MT>(cur, lc, chain.c[l], chain.wpk[l], chain.b[l], chain.c[l + 1], nxt, ln);
    __syncthreads();
    float* tb = cur;
    cur = nxt;
    nxt = tb;
    const int tl = lc;
    lc = ln;
    ln = tl;
  }
  const int last = chain.layers - 1;
  last_layer_max<MT>(cur, lc, chain.c[last], chain.wpk[last], chain.b[last],
                     chain.c[chain.layers], groups, s, out);
}

}  // namespace mlp_tc
