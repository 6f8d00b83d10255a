// The shared-MLP chain of the grouped MLP + max kernel (grouped_mlp.cu,
// its only user) on the CUDA cores; sa.cu's and fp.cu's chains run on the
// tensor cores (mlp_tc.cuh). A block of 256 threads multiplies a tile of R
// activation rows, held in shared memory, by a dense weight (Ci, Co) read
// from device memory, adds the bias and applies ReLU. The products are the
// TPU kernel's own work, so they run here and not in a library.
//
// Thread (ty, tx) = (threadIdx.x / 32, threadIdx.x % 32) computes rows
// ty + 8 i (i < RT, R = 8 RT) and the 4 neighbouring columns col0 + 4 tx ..
// col0 + 4 tx + 3 of a 128-column chunk. When every width is a multiple of
// 4 and the weights are 16-byte aligned (Chain::vec), a step of the inner
// product takes 4 rows of the weight as one 16-byte load each (a warp reads
// 512 contiguous bytes, which the 8 warps share through L1) and 4 values of
// each activation row as one 16-byte shared-memory broadcast, for 16 RT
// multiply-adds; otherwise it goes one scalar at a time.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mlp {

constexpr int kThreads = 256;
constexpr int kColChunk = 128;
constexpr int kMaxLayers = 4;

// Dense layers of a chain, each followed by ReLU: w[l] is (c[l], c[l+1])
// row-major, b[l] is (c[l+1],).
struct Chain {
  const float* w[kMaxLayers];
  const float* b[kMaxLayers];
  int c[kMaxLayers + 1];
  int layers;
  int vec;  // 16-byte loads: every width % 4 == 0, every weight 16-byte aligned
};

// acc[i][j] = sum_k A[(ty + 8 i) * lda + k] * W[k * co + col0 + 4 tx + j]
template <int RT>
__device__ __forceinline__ void tile_product(const float* A, int lda, int ci,
                                             const float* __restrict__ W, int co, int col0,
                                             bool vec, float (&acc)[RT][4]) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int c4 = col0 + 4 * tx;
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  if (vec) {
    if (c4 >= co) return;  // co % 4 == 0: the thread's 4 columns exist or none does
    const float4* wp = reinterpret_cast<const float4*>(W + c4);
    const int co4 = co >> 2;
    for (int k = 0; k < ci; k += 4) {
      const float4 w0 = __ldg(wp), w1 = __ldg(wp + co4), w2 = __ldg(wp + 2 * co4),
                   w3 = __ldg(wp + 3 * co4);
      wp += 4 * co4;
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(A + (ty + 8 * i) * lda + k);
        acc[i][0] = fmaf(a.w, w3.x, fmaf(a.z, w2.x, fmaf(a.y, w1.x, fmaf(a.x, w0.x, acc[i][0]))));
        acc[i][1] = fmaf(a.w, w3.y, fmaf(a.z, w2.y, fmaf(a.y, w1.y, fmaf(a.x, w0.y, acc[i][1]))));
        acc[i][2] = fmaf(a.w, w3.z, fmaf(a.z, w2.z, fmaf(a.y, w1.z, fmaf(a.x, w0.z, acc[i][2]))));
        acc[i][3] = fmaf(a.w, w3.w, fmaf(a.z, w2.w, fmaf(a.y, w1.w, fmaf(a.x, w0.w, acc[i][3]))));
      }
    }
    return;
  }
  bool ok[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) ok[j] = c4 + j < co;
  const float* wk = W + c4;
#pragma unroll 4
  for (int k = 0; k < ci; ++k) {
    float wv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wv[j] = ok[j] ? __ldg(wk + j) : 0.f;
    wk += co;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float a = A[(ty + 8 * i) * lda + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, wv[j], acc[i][j]);
    }
  }
}

// Y (shared, ldy) = relu(A W + b) over all co columns. A and Y are
// different buffers; the caller synchronises before reading Y.
template <int RT>
__device__ void layer_to_shared(const float* A, int lda, int ci, const float* __restrict__ W,
                                const float* __restrict__ bias, int co, bool vec, float* Y,
                                int ldy) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int col0 = 0; col0 < co; col0 += kColChunk) {
    float acc[RT][4];
    tile_product<RT>(A, lda, ci, W, co, col0, vec, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + 4 * tx + j;
      if (col < co) {
        const float bv = __ldg(bias + col);
#pragma unroll
        for (int i = 0; i < RT; ++i) Y[(ty + 8 * i) * ldy + col] = fmaxf(acc[i][j] + bv, 0.f);
      }
    }
  }
}

// Runs layers 0 .. chain.layers - 2 over the tile, ping-ponging between buf0
// (which holds the input, ld0) and buf1 (ld1), with a barrier after each.
// Returns the buffer that holds the input of the last layer in *in, *ld.
template <int RT>
__device__ void hidden_layers(const Chain& chain, float* buf0, int ld0, float* buf1, int ld1,
                              float** in, int* ld) {
  float* cur = buf0;
  float* nxt = buf1;
  int lc = ld0, ln = ld1;
  for (int l = 0; l + 1 < chain.layers; ++l) {
    layer_to_shared<RT>(cur, lc, chain.c[l], chain.w[l], chain.b[l], chain.c[l + 1],
                        chain.vec != 0, nxt, ln);
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
    const int tl = lc;
    lc = ln;
    ln = tl;
  }
  *in = cur;
  *ld = lc;
}

// The chain over a tile of R = 8 RT rows whose first activations sit in
// buf0 (ld0), reduced over groups of s consecutive rows: the hidden layers
// (hidden_layers), then the last layer 128 columns at a time through
// `chunk` (R x 128, shared), each column's max over rows t s .. t s + s - 1
// written to out[t * co + col] for t < groups. The last layer's
// activations are never stored whole. chain.layers >= 1; the caller
// synchronises after filling buf0.
template <int RT>
__device__ void chain_max(const Chain& chain, float* buf0, int ld0, float* buf1, int ld1,
                          float* chunk, int groups, int s, float* __restrict__ out) {
  float* in;
  int ld;
  hidden_layers<RT>(chain, buf0, ld0, buf1, ld1, &in, &ld);
  const int last = chain.layers - 1;
  const int ci = chain.c[last], co = chain.c[chain.layers];
  const float* W = chain.w[last];
  const float* bias = chain.b[last];
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  for (int col0 = 0; col0 < co; col0 += kColChunk) {
    float acc[RT][4];
    tile_product<RT>(in, ld, ci, W, co, col0, chain.vec != 0, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + 4 * tx + j;
      const float bv = col < co ? __ldg(bias + col) : 0.f;
#pragma unroll
      for (int i = 0; i < RT; ++i)
        chunk[(ty + 8 * i) * kColChunk + 4 * tx + j] = fmaxf(acc[i][j] + bv, 0.f);
    }
    __syncthreads();
    for (int e = tid; e < groups * kColChunk; e += kThreads) {
      const int t = e / kColChunk, cl = e - t * kColChunk;
      const int col = col0 + cl;
      if (col >= co) continue;
      float mx = chunk[(t * s) * kColChunk + cl];
      for (int r = 1; r < s; ++r) mx = fmaxf(mx, chunk[(t * s + r) * kColChunk + cl]);
      out[(size_t)t * co + col] = mx;
    }
    __syncthreads();
  }
}

// Widths of the two ping-pong buffers: activations 0, 2, 4, ... live in
// buf0, 1, 3, ... in buf1; the last layer's output is not stored.
inline void buffer_widths(const Chain& chain, int* ld0, int* ld1) {
  *ld0 = chain.c[0];
  *ld1 = 0;
  for (int l = 1; l < chain.layers; ++l) {
    if (l % 2 == 0) *ld0 = chain.c[l] > *ld0 ? chain.c[l] : *ld0;
    else *ld1 = chain.c[l] > *ld1 ? chain.c[l] : *ld1;
  }
}

// Chain::vec for the widths and pointers of a chain whose input buffer has
// leading dimension ld0 (and ld1 for the second buffer).
inline int vector_ok(const Chain& chain, int ld0, int ld1) {
  int ok = ld0 % 4 == 0 && ld1 % 4 == 0;
  for (int l = 0; l <= chain.layers; ++l) ok = ok && chain.c[l] % 4 == 0;
  for (int l = 0; l < chain.layers; ++l)
    ok = ok && reinterpret_cast<uintptr_t>(chain.w[l]) % 16 == 0;
  return ok;
}

}  // namespace mlp
