// The PSMNet classifier's 32 -> 1 stride-1 3x3x3 conv on the CUDA cores,
// for Hopper (sm_90a), float32, canonical NCDHW layout.
//
// Replaces disprcnn_tpu/ops/pallas/packed_conv.py's _conv_call at dg = 1
// ("cl1"): the conv to one output channel, no BN (conv3d_bn_cuda):
//   out[n, 0, z, y, x] = epilogue(sum_{c, kd, kh, kw}
//       in(n, c, z + kd - 1, y + kh - 1, x + kw - 1) * wt[c, kd, kh, kw, 0])
// (padding 1, zero outside the volume), the epilogue of conv3d.cuh: v *
// mul + add, then + residual, then ReLU. The other PSMNet convs are on the
// tensor cores: the stride-1 and stride-2 3D convs, the transposed conv and
// the feature tower's 2D conv in conv3d_tc.cu, the cost-volume conv in
// cost_volume_tc.cu.
//
// Bound on an H100 SXM: its input's bytes (one output channel: 27 products
// per input value read).
//
// Design: one block per (n, z, 8 x 32 output tile). Per step of CI_STEP
// input channels the block stages the 3-deep halo of the input (10 rows,
// 34 columns) and the weights of those channels in shared memory; 4 warps
// split the tile's rows, 2 rows per thread, a lane per column.
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv3d.cuh"

namespace {

using conv::Out;

constexpr int kTH = 8;   // output rows per block
constexpr int kTW = 32;  // output columns per block, one per lane
constexpr int kKD = 3;   // depth taps

struct PlainSrc {
  const float* x;  // (N, Ci, D, H, W)
  int ci, d, h, w;
  __device__ __forceinline__ float load(int n, int c, int z, int y, int xx) const {
    if (c >= ci || z < 0 || z >= d || y < 0 || y >= h || xx < 0 || xx >= w) return 0.f;
    return __ldg(x + ((((size_t)n * ci + c) * d + z) * h + y) * (size_t)w + xx);
  }
};

// Blocks per SM the conv's register allocation must leave room for: 512
// threads resident at least, so that one block's barrier does not idle the
// SM.
constexpr int min_blocks(int threads) { return threads >= 512 ? 1 : 512 / threads; }

template <int CO_T>
__device__ __forceinline__ void load_weights(const float* wp, float (&wv)[CO_T]) {
#pragma unroll
  for (int j = 0; j < CO_T; ++j) wv[j] = wp[j];
}

// The conv: CO output channels, CO_T of them per thread, RG warps
// splitting the tile rows (kTH / RG rows per thread), CO / CO_T * RG warps
// per block; CI_STEP input channels staged per step. The input tile's
// origin is the output origin - 1 in every dim.
template <int CO, int CO_T, int RG, int CI_STEP>
__global__ void __launch_bounds__(CO / CO_T * RG * 32, min_blocks(CO / CO_T * RG * 32))
conv_kernel(const PlainSrc src, int ci, int tiles_w, const float* __restrict__ wt, const Out out) {
  constexpr int kPX = kTH / RG;
  constexpr int kThreads = CO / CO_T * RG * 32;
  constexpr int kHaloH = kTH + 2;
  constexpr int kHaloW = kTW + 2;
  constexpr int kHaloSize = CI_STEP * kKD * kHaloH * kHaloW;
  constexpr int kTaps = kKD * 9;
  constexpr int kWSize = CI_STEP * kTaps * CO;
  __shared__ float in_s[kHaloSize];
  __shared__ __align__(16) float w_s[kWSize];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cog = warp / RG;
  const int rg = warp % RG;
  const int y0 = (blockIdx.x / tiles_w) * kTH;
  const int x0 = (blockIdx.x % tiles_w) * kTW;
  const int z = blockIdx.y;
  const int n = blockIdx.z;

  float acc[kPX][CO_T];
#pragma unroll
  for (int p = 0; p < kPX; ++p)
#pragma unroll
    for (int j = 0; j < CO_T; ++j) acc[p][j] = 0.f;

  for (int c0 = 0; c0 < ci; c0 += CI_STEP) {
    __syncthreads();  // the previous step's reads are done
    for (int i = threadIdx.x; i < kHaloSize; i += kThreads) {
      const int xx = i % kHaloW;
      int t = i / kHaloW;
      const int yy = t % kHaloH;
      t /= kHaloH;
      const int kd = t % kKD;
      const int c = t / kKD;
      in_s[i] = src.load(n, c0 + c, z + kd - 1, y0 + yy - 1, x0 + xx - 1);
    }
    for (int i = threadIdx.x; i < kWSize; i += kThreads) {
      const int c = i / (kTaps * CO);
      w_s[i] = c0 + c < ci ? __ldg(wt + (size_t)c0 * kTaps * CO + i) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int c = 0; c < CI_STEP; ++c) {
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
        const int kd = k / 9, kh = (k / 3) % 3, kw = k % 3;
        float wv[CO_T];
        load_weights<CO_T>(w_s + (c * kTaps + k) * CO + cog * CO_T, wv);
        const float* ip =
            in_s + ((c * kKD + kd) * kHaloH + rg * kPX + kh) * kHaloW + lane + kw;
#pragma unroll
        for (int p = 0; p < kPX; ++p) {
          const float xv = ip[p * kHaloW];
#pragma unroll
          for (int j = 0; j < CO_T; ++j) acc[p][j] += xv * wv[j];
        }
      }
    }
  }

  const int xo = x0 + lane;
  if (xo >= out.w) return;
#pragma unroll
  for (int p = 0; p < kPX; ++p) {
    const int yo = y0 + rg * kPX + p;
    if (yo >= out.h) continue;
#pragma unroll
    for (int j = 0; j < CO_T; ++j) out.store(n, cog * CO_T + j, z, yo, xo, acc[p][j]);
  }
}

template <int CO, int CO_T, int RG, int CI_STEP>
cudaError_t launch(const PlainSrc& src, int n, int ci, const float* wt, const Out& out,
                   cudaStream_t s) {
  const int tiles_w = (out.w + kTW - 1) / kTW;
  const int tiles = ((out.h + kTH - 1) / kTH) * tiles_w;
  const dim3 grid(tiles, out.d, n);
  conv_kernel<CO, CO_T, RG, CI_STEP>
      <<<grid, CO / CO_T * RG * 32, 0, s>>>(src, ci, tiles_w, wt, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (N, Ci, D, H, W); wt (Ci, 3, 3, 3, 1), the torch weight (1, Ci, 3, 3,
// 3) permuted; the stride-1 pad-1 conv to one output channel (the
// classifier's), out (N, 1, D, H, W); mul, add (1,); res of the output's
// shape or null. All float32, contiguous, on `device`. Launches on
// `stream`, does not synchronise, returns the cudaError_t of the launch (0
// on success). Co 32 and 64 are conv3d_tc.cu's.
int conv3d_bn_cuda(const void* x, int n, int ci, int d, int h, int w, const void* wt,
                   const void* mul, const void* add, const void* res, int relu, void* out,
                   void* stream, int device) {
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: set it to the tensors' device
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ci < 1 || !conv::grid_fits(n, d, h, w, kTH, kTW))
    return static_cast<int>(cudaErrorInvalidValue);
  const PlainSrc src{static_cast<const float*>(x), ci, d, h, w};
  return static_cast<int>(launch<1, 1, 4, 4>(
      src, n, ci, static_cast<const float*>(wt),
      conv::make_out(out, mul, add, res, 1, d, h, w, relu), static_cast<cudaStream_t>(stream)));
}

const char* conv3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
