// A PointNet++ SharedMLP over grouped activations and the max over each
// group, for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel disprcnn_tpu/ops/pallas/grouped_mlp.py
// (grouped_mlp_max). For group g of S rows of x (G, S, C0), the grouped
// pre-activation of a ball-grouped scale (mlp0 applied, its bias added):
//   x0  = relu(x[g, s] * mul0 + add0)      (mlp0's folded BN)
//   x_l = relu(x_{l-1} W_l + b_l)           (the folded-BN chain, 1-4 layers)
//   out[g] = max over the S rows of the last x.
// The TPU kernel rounded x, the weights and every layer to bf16; this one
// is float32 throughout (the plain version's arithmetic, to a float32
// tolerance).
//
// Bound on an H100 SXM: operations. At the headline budget with the SA
// kernel off, the chain's products over every row of x are ~2.1 TFLOP a
// request (RCNN SA0 1.1, SA1 0.4, the six RPN scales 0.55), ~31 ms at 67
// TFLOP/s, against ~13 GB of x read once (~4 ms at 3.35 TB/s). Rows that
// repeat a ball's first neighbour cannot be told apart here, so every row
// is computed and counted.
//
// Design: one block of 256 threads per tile of T = R / S whole groups (R =
// 16, 32 or 64 rows, the largest that holds a group and fits in shared
// memory); it loads the T S rows of x with the affine and ReLU into shared
// memory (rows past the last group are zero and never reduced), runs the
// chain as register-tiled products between two shared buffers and reduces
// the last layer 128 columns at a time into the max over each group
// (mlp.cuh: chain_max).
// Only the (G, C_last) result is written.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp.cuh"

namespace {

constexpr int kMaxShared = 232448;  // bytes of shared memory a block may use

template <int RT>
__global__ void __launch_bounds__(mlp::kThreads)
grouped_mlp_kernel(const float* __restrict__ x, const float* __restrict__ mul0,
                   const float* __restrict__ add0, mlp::Chain chain, int g, int s, int ld0,
                   int ld1, float* __restrict__ out) {
  constexpr int R = 8 * RT;
  extern __shared__ float smem[];
  float* buf0 = smem;              // R x ld0
  float* buf1 = buf0 + R * ld0;    // R x ld1
  float* chunk = buf1 + R * ld1;   // R x 128
  const int tiles = R / s;
  const int g0 = blockIdx.x * tiles;
  const int groups = min(tiles, g - g0);
  const int rows = groups * s;
  const int c0 = chain.c[0];
  const float* xt = x + (size_t)g0 * s * c0;

  // 1. x0 = relu(x * mul0 + add0) for the tile's rows, zero below them
  for (int e = threadIdx.x; e < R * c0; e += mlp::kThreads) {
    const int r = e / c0, c = e - r * c0;
    float val = 0.f;
    if (r < rows) val = fmaxf(__ldg(xt + (size_t)r * c0 + c) * __ldg(mul0 + c) + __ldg(add0 + c),
                              0.f);
    buf0[r * ld0 + c] = val;
  }
  __syncthreads();

  // 2. the chain, the last layer reduced over each group
  mlp::chain_max<RT>(chain, buf0, ld0, buf1, ld1, chunk, groups, s,
                     out + (size_t)g0 * chain.c[chain.layers]);
}

size_t shared_bytes(int rows, int ld0, int ld1) {
  return sizeof(float) * (size_t)rows * (ld0 + ld1 + mlp::kColChunk);
}

template <int RT>
cudaError_t launch(const float* x, const float* mul0, const float* add0, const mlp::Chain& chain,
                   int g, int s, int ld0, int ld1, float* out, cudaStream_t stream) {
  constexpr int R = 8 * RT;
  const size_t bytes = shared_bytes(R, ld0, ld1);
  cudaError_t err = cudaFuncSetAttribute(grouped_mlp_kernel<RT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int tiles = R / s;
  dim3 grid((g + tiles - 1) / tiles);
  grouped_mlp_kernel<RT><<<grid, mlp::kThreads, bytes, stream>>>(x, mul0, add0, chain, g, s, ld0,
                                                                  ld1, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (G, S, C0), mul0 and add0 (C0,), weights[l] (C_l, C_{l+1}) and
// biases[l] (C_{l+1},) for l < layers (1..4), chans = (C0, ..., C_layers);
// all float32, contiguous. out (G, C_layers). 1 <= S <= 64. Launches on
// `stream`, does not synchronise, returns the cudaError_t of the launch (0
// on success).
int grouped_mlp_cuda(const void* x, const void* mul0, const void* add0,
                     const void* const* weights, const void* const* biases, const int* chans,
                     int layers, int g, int s, void* out, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (g < 1 || s < 1 || s > 64 || layers < 1 || layers > mlp::kMaxLayers)
    return static_cast<int>(cudaErrorInvalidValue);
  mlp::Chain chain;
  chain.layers = layers;
  for (int l = 0; l <= layers; ++l) {
    if (chans[l] < 1) return static_cast<int>(cudaErrorInvalidValue);
    chain.c[l] = chans[l];
  }
  for (int l = 0; l < layers; ++l) {
    chain.w[l] = static_cast<const float*>(weights[l]);
    chain.b[l] = static_cast<const float*>(biases[l]);
  }
  int ld0, ld1;
  mlp::buffer_widths(chain, &ld0, &ld1);
  chain.vec = mlp::vector_ok(chain, ld0, ld1);
  // the largest row tile that holds a whole group and fits in shared memory
  int rt = 0;
  for (int cand = 8; cand >= 2; cand /= 2) {
    const int rows = 8 * cand;
    if (rows >= s && shared_bytes(rows, ld0, ld1) <= (size_t)kMaxShared) {
      rt = cand;
      break;
    }
  }
  const float* xp = static_cast<const float*>(x);
  const float* m0 = static_cast<const float*>(mul0);
  const float* a0 = static_cast<const float*>(add0);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rt == 8)
    err = launch<8>(xp, m0, a0, chain, g, s, ld0, ld1, o, st);
  else if (rt == 4)
    err = launch<4>(xp, m0, a0, chain, g, s, ld0, ld1, o, st);
  else if (rt == 2)
    err = launch<2>(xp, m0, a0, chain, g, s, ld0, ld1, o, st);
  else
    return static_cast<int>(cudaErrorInvalidConfiguration);
  return static_cast<int>(err);
}

const char* grouped_mlp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
