// The shared-MLP chain of the fused set-abstraction kernel (sa.cu) and of
// the feature-propagation kernel (fp.cu) on Hopper's tensor cores
// (sm_90a), in two forms: float32 in and out at float32 accuracy, and the
// bf16 form of a bf16 model (TPU.COMPUTE_DTYPE bfloat16).
//
// A block of W warps (8 in sa.cu, 16 in fp.cu) holds a tile of R = 16 MT
// activation rows (whole balls in sa.cu) in shared memory and runs each
// dense layer Y = relu(X W + b) as an (R x Ci) by (Ci x Co) product; the
// last layer ends in the max over each ball (sa.cu) or stores its rows
// (fp.cu), from registers. The TPU kernels run these chains as MXU
// products of bf16 operands with float32 accumulation
// (disprcnn_tpu/ops/pallas/sa_fused.py:330 and fp_fused.py:71).
// - float (T = float): mma.sync.m16n8k8 TF32 with both operands split hi +
//   lo and the three products lo*hi + hi*lo + hi*hi summed (tf32.cuh:
//   "3xTF32"): float32 accuracy. Channels padded to a multiple of 8.
// - bf16 (T = bf16_t): the activations are bf16 in shared memory, the
//   weights the folded chain rounded to bf16, one mma.sync.m16n8k16 bf16
//   product a K step (bf16.cuh) into float32 sums; then the bias in
//   float32, the ReLU, and one rounding to nearest even to bf16
//   (cvt.rn.bf16x2.f32), as JAX's jnp.maximum(y + b, 0).astype(bfloat16).
//   The last layer's max over a ball is taken on the float32 values and
//   rounded once: rounding to nearest is monotone, so max(round(x)) ==
//   round(max(x)), which is JAX's max of the rounded rows. Channels padded
//   to a multiple of 16.
//
// Activations are 32-bit words in shared memory either way: a float, or a
// pair of bf16 channels (2p, 2p + 1; the lower one in the lower half). A K
// step reads 8 words of a row (8 channels, or 16), so both forms read A's
// fragment at the same word offsets (bf16.cuh: seen as pairs of K, the
// m16n8k16 A fragment is m16n8k8's TF32 one).
//
// GEMM view of a layer: M = the tile's R rows, N = Co, K = Ci, both padded
// with zeros (a 196-wide layer is 200 wide in float, 208 in bf16; the
// padded weights are zero, so the padded columns of Y are relu(0) = 0 and
// add nothing to the next layer). A pass of the W warps covers 16 W output
// columns: warp w owns N-tiles 2w, 2w + 1 of the pass against all R rows
// (MT M-tiles), so a ball's rows all sit in one warp and its max needs no
// shared memory: an in-lane max over the M-tiles and halves the ball spans,
// then butterfly shuffles over the 8 row groups of a fragment.
// A (the activations) is read from shared memory as fragments (and split
// in registers in float); its leading dimension is 4 (mod 32) words, so
// the 32 lanes of one fragment read (8 rows x 4 words) fall in 32 distinct
// banks. B (the weights) comes fragment-ordered from device memory, one
// vector per lane and N-tile per K step (float: a float4 [hi(k), hi(k +
// 4), lo(k), lo(k + 4)] of row k = lane % 4 and column lane / 4; bf16: a
// uint2 of the pairs of rows 2 (lane % 4) and 2 (lane % 4) + 8; sa.cu's
// pack kernels, whose plain versions are ops/cuda/sa.py::pack_tf32_chain
// and pack_bf16_chain), loaded one step ahead of its use: each block reads
// each weight once, from L2.
// Promotion: every 64 terms (kPromote K steps) the mma sums join the
// running float32 sums with rounding to nearest, as conv3d_tc.cu's stages
// do (the mma's adds truncate).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bf16.cuh"

namespace mlp_tc {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxLayers = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNT = 2;        // N-tiles of 8 columns a warp owns in a pass

// The two forms: channels padded to kPad (K and N), kKStep channels of K a
// mma step (8 words of an activation row), kPromote steps summed in the mma
// before promotion, kLaneWords weight words a lane, N-tile and step.
template <typename T>
struct Form;
template <>
struct Form<float> {
  static constexpr int kPad = 8, kKStep = 8, kPromote = 8, kLaneWords = 4;
};
template <>
struct Form<bf16_t> {
  static constexpr int kPad = 16, kKStep = 16, kPromote = 4, kLaneWords = 2;
};

// Dense layers of a chain, each followed by ReLU: wpk[l] is layer l's
// packed weights (K steps, N-tiles, 32 lanes, kLaneWords words), b[l] its
// float32 bias (c[l + 1],).
struct Chain {
  const uint32_t* wpk[kMaxLayers];
  const float* b[kMaxLayers];
  int c[kMaxLayers + 1];
  int layers;
};

__host__ __device__ inline int pad8(int c) { return (c + 7) & ~7; }

template <typename T>
__host__ __device__ inline int padc(int c) {
  return (c + Form<T>::kPad - 1) & ~(Form<T>::kPad - 1);
}

// words of a row of c activations, padded
template <typename T>
__host__ __device__ inline int row_words(int c) {
  return padc<T>(c) * static_cast<int>(sizeof(T)) / 4;
}

// words of one layer's packed weights
template <typename T>
__host__ __device__ inline int packed_words(int ci, int co) {
  return padc<T>(ci) / Form<T>::kKStep * (padc<T>(co) / 8) * 32 * Form<T>::kLaneWords;
}

// floats of one layer's packed float32 weights
__host__ __device__ inline int packed_floats(int ci, int co) { return packed_words<float>(ci, co); }

// a leading dimension of at least w words, 4 (mod 32)
inline int lead_words(int w) {
  const int p = pad8(w);
  return p + (36 - p % 32) % 32;
}

// leading dimension (words) of an activation buffer of c columns
template <typename T = float>
inline int lead(int c) {
  return lead_words(row_words<T>(c));
}

// Leading dimensions of the two ping-pong buffers: activations 0, 2, 4
// live in buf0, 1, 3 in buf1 (0 if none); the last layer's output is not
// stored.
template <typename T = float>
inline void buffer_widths(const Chain& chain, int* ld0, int* ld1) {
  int w0 = chain.c[0], w1 = 0;
  for (int l = 1; l < chain.layers; ++l) {
    if (l % 2 == 0) w0 = chain.c[l] > w0 ? chain.c[l] : w0;
    else w1 = chain.c[l] > w1 ? chain.c[l] : w1;
  }
  *ld0 = lead<T>(w0);
  *ld1 = w1 > 0 ? lead<T>(w1) : 0;
}

// A lane's weight fragment of one N-tile and K step, from device memory
template <typename T>
struct BFrag;
template <>
struct BFrag<float> {
  float4 q;
  __device__ __forceinline__ void ldg(const uint32_t* w, size_t idx) {
    q = __ldg(reinterpret_cast<const float4*>(w) + idx);
  }
  __device__ __forceinline__ void zero() { q = make_float4(0.f, 0.f, 0.f, 0.f); }
};
template <>
struct BFrag<bf16_t> {
  uint2 q;
  __device__ __forceinline__ void ldg(const uint32_t* w, size_t idx) {
    q = __ldg(reinterpret_cast<const uint2*>(w) + idx);
  }
  __device__ __forceinline__ void zero() { q = make_uint2(0u, 0u); }
};

// acc[i][j] += rows 16 i .. 16 i + 15 of A (shared words, lda) times N-tile
// nt0 + j of the packed weights wpk (K steps, n8 N-tiles, 32 lanes), over
// the weights' K steps kb .. ke - 1; A's word 0 is the weights' row kKStep
// kb. The mma sums are promoted every kPromote steps counted from kb (a
// multiple of kPromote, so that a product split over several calls rounds
// as one call over all its steps). N-tiles at or past n8 are neither read
// nor multiplied (warp-uniform).
template <int MT, typename T = float>
__device__ __forceinline__ void pass_accumulate(const uint32_t* A, int lda, int kb, int ke,
                                                const uint32_t* __restrict__ wpk, int n8, int nt0,
                                                float (&acc)[MT][kNT][4]) {
  constexpr int kPromote = Form<T>::kPromote;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nts = min(kNT, n8 - nt0);
  const size_t base = (size_t)nt0 * 32 + lane;
  const size_t kstride = (size_t)n8 * 32;
  const uint32_t* ap = A + g * lda + t;
  BFrag<T> b[kNT];
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    if (j < nts) b[j].ldg(wpk, base + (size_t)kb * kstride + j * 32);
    else b[j].zero();
  }
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
      BFrag<T> nb[kNT];  // the next step's B, in flight while this one multiplies
      const bool more = kk + 1 < ke;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        if (more && j < nts) nb[j].ldg(wpk, base + (size_t)(kk + 1) * kstride + j * 32);
        else nb[j].zero();
      }
      if constexpr (std::is_same<T, float>::value) {
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const uint32_t* p = ap + 16 * i * lda + 8 * (kk - kb);
          split_tf32(__uint_as_float(p[0]), ah[i][0], al[i][0]);
          split_tf32(__uint_as_float(p[8 * lda]), ah[i][1], al[i][1]);
          split_tf32(__uint_as_float(p[4]), ah[i][2], al[i][2]);
          split_tf32(__uint_as_float(p[8 * lda + 4]), ah[i][3], al[i][3]);
        }
        uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          bh[j][0] = __float_as_uint(b[j].q.x);
          bh[j][1] = __float_as_uint(b[j].q.y);
          bl[j][0] = __float_as_uint(b[j].q.z);
          bl[j][1] = __float_as_uint(b[j].q.w);
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
      } else {
        uint32_t a[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const uint32_t* p = ap + 16 * i * lda + 8 * (kk - kb);
          a[i][0] = p[0];
          a[i][1] = p[8 * lda];
          a[i][2] = p[4];
          a[i][3] = p[8 * lda + 4];
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j)
            if (j < nts) mma_bf16(part[i][j], a[i], b[j].q.x, b[j].q.y);
      }
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

// acc[i][j] = rows 16 i .. 16 i + 15 of A (shared words, lda, k steps)
// times N-tile nt0 + j of the packed weights wpk.
template <int MT, typename T = float>
__device__ __forceinline__ void pass_product(const uint32_t* A, int lda, int k8,
                                             const uint32_t* __restrict__ wpk, int n8, int nt0,
                                             float (&acc)[MT][kNT][4]) {
  zero_acc<MT>(acc);
  pass_accumulate<MT, T>(A, lda, 0, k8, wpk, n8, nt0, acc);
}

// Y (shared words, ldy) = relu(acc + b) in the columns of N-tiles nt0 ..
// nt0 + kNT - 1 below n8 (zero past co), as T: a pass's epilogue into the
// next layer's input.
template <int MT, typename T = float>
__device__ __forceinline__ void store_relu(const float (&acc)[MT][kNT][4],
                                           const float* __restrict__ bias, int co, int n8,
                                           int nt0, uint32_t* Y, int ldy) {
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
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * i + g + 8 * h;
        const float v0 = fmaxf(acc[i][j][2 * h] + b0, 0.f);
        const float v1 = fmaxf(acc[i][j][2 * h + 1] + b1, 0.f);
        if constexpr (std::is_same<T, float>::value)
          *reinterpret_cast<float2*>(Y + r * ldy + col) = make_float2(v0, v1);
        else
          Y[r * ldy + col / 2] = bf16x2_rn(v0, v1);
      }
  }
}

// out[r * co + col] = relu(acc + b) as T for rows r < rows and columns col <
// co of N-tiles nt0 .. nt0 + kNT - 1 below n8: a last layer's rows, from
// registers to device memory.
template <int MT, typename T = float>
__device__ __forceinline__ void store_relu_rows(const float (&acc)[MT][kNT][4],
                                                const float* __restrict__ bias, int co, int n8,
                                                int nt0, int rows, T* __restrict__ out) {
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
        T* o = out + (size_t)r * co + col;
        const float v0 = fmaxf(acc[i][j][2 * h] + b0, 0.f);
        const float v1 = fmaxf(acc[i][j][2 * h + 1] + b1, 0.f);
        if (two && co % 2 == 0) {
          if constexpr (std::is_same<T, float>::value)
            *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
          else
            *reinterpret_cast<uint32_t*>(o) = bf16x2_rn(v0, v1);
        } else {
          o[0] = elem_from_float<T>(v0);
          if (two) o[1] = elem_from_float<T>(v1);
        }
      }
  }
}

// Y (shared words, ldy) = relu(A W + b) over the padded width padc(co),
// zero past co. A and Y are different buffers; the caller synchronises
// before reading Y. WARPS warps share the layer, kNT N-tiles each a pass.
template <int MT, int WARPS = kWarps, typename T = float>
__device__ void hidden_layer(const uint32_t* A, int lda, int ci,
                             const uint32_t* __restrict__ wpk, const float* __restrict__ bias,
                             int co, uint32_t* Y, int ldy) {
  const int warp = threadIdx.x >> 5;
  const int k8 = padc<T>(ci) / Form<T>::kKStep, n8 = padc<T>(co) / 8;
  for (int nt0 = warp * kNT; nt0 < n8; nt0 += WARPS * kNT) {
    float acc[MT][kNT][4];
    pass_product<MT, T>(A, lda, k8, wpk, n8, nt0, acc);
    store_relu<MT, T>(acc, bias, co, n8, nt0, Y, ldy);
  }
}

// out[r * co + col] = relu(A W + b) for the tile's rows r < rows: a last
// layer whose rows go from registers to device memory.
template <int MT, int WARPS = kWarps, typename T = float>
__device__ void last_layer_rows(const uint32_t* A, int lda, int ci,
                                const uint32_t* __restrict__ wpk,
                                const float* __restrict__ bias, int co, int rows,
                                T* __restrict__ out) {
  const int warp = threadIdx.x >> 5;
  const int k8 = padc<T>(ci) / Form<T>::kKStep, n8 = padc<T>(co) / 8;
  for (int nt0 = warp * kNT; nt0 < n8; nt0 += WARPS * kNT) {
    float acc[MT][kNT][4];
    pass_product<MT, T>(A, lda, k8, wpk, n8, nt0, acc);
    store_relu_rows<MT, T>(acc, bias, co, n8, nt0, rows, out);
  }
}

// out[q * co + col] = max over rows q s .. q s + s - 1 of relu(A W + b), for
// balls q < groups and col < co, as T (the max of the float32 values,
// rounded once); s divides R = 16 MT.
template <int MT, typename T = float>
__device__ void last_layer_max(const uint32_t* A, int lda, int ci,
                               const uint32_t* __restrict__ wpk, const float* __restrict__ bias,
                               int co, int groups, int s, T* __restrict__ out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int k8 = padc<T>(ci) / Form<T>::kKStep, n8 = padc<T>(co) / 8;
  const int s8 = min(s, 8);  // rows of a ball within one fragment half
  for (int nt0 = warp * kNT; nt0 < n8; nt0 += kWarps * kNT) {
    float acc[MT][kNT][4];
    pass_product<MT, T>(A, lda, k8, wpk, n8, nt0, acc);
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
            if (g == 0 && q < groups && col + e < co)
              out[(size_t)q * co + col + e] = elem_from_float<T>(y);
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
              if (g % s8 == 0 && q < groups && col + e < co)
                out[(size_t)q * co + col + e] = elem_from_float<T>(x);
            }
        }
      }
    }
  }
}

// The chain over a tile of R = 16 MT rows whose first activations sit in
// buf0 (ld0 words, padc(c[0]) columns, zero past c[0]), reduced over balls of s
// consecutive rows: the hidden layers, ping-ponging between buf0 and buf1
// (ld1) with a barrier after each, then the last layer into out[q * co +
// col] for balls q < groups. chain.layers >= 1; the caller synchronises
// after filling buf0.
template <int MT, typename T = float>
__device__ void chain_max(const Chain& chain, uint32_t* buf0, int ld0, uint32_t* buf1, int ld1,
                          int groups, int s, T* __restrict__ out) {
  uint32_t* cur = buf0;
  uint32_t* nxt = buf1;
  int lc = ld0, ln = ld1;
  for (int l = 0; l + 1 < chain.layers; ++l) {
    hidden_layer<MT, kWarps, T>(cur, lc, chain.c[l], chain.wpk[l], chain.b[l], chain.c[l + 1],
                                nxt, ln);
    __syncthreads();
    uint32_t* tb = cur;
    cur = nxt;
    nxt = tb;
    const int tl = lc;
    lc = ln;
    ln = tl;
  }
  const int last = chain.layers - 1;
  last_layer_max<MT, T>(cur, lc, chain.c[last], chain.wpk[last], chain.b[last],
                     chain.c[chain.layers], groups, s, out);
}

}  // namespace mlp_tc
