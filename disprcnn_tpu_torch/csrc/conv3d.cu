// The PSMNet convolutions with a fused epilogue on the CUDA cores, for
// Hopper (sm_90a), float32, canonical NCDHW layout.
//
// Replaces three TPU kernels of disprcnn_tpu/ops/pallas/packed_conv.py:
//   - _conv_call at dg = 1 ("cl1"): the classifier's 32 -> 1 stride-1
//     conv, no BN (conv3d_bn_cuda, CO 1);
//   - _kernel_cv (cost_volume_conv_bn): the PSMNet concat cost volume built
//     inside the first trunk conv (cost_volume_conv_bn_cuda);
//   - _kernel_dc (packed_deconv_bn): the hourglass's stride-2 transposed
//     3x3x3 conv + BN + optional residual + optional ReLU
//     (deconv3d_bn_cuda).
// The stride-1 trunk conv and the stride-2 conv at Co 32/64 (_kernel and
// _kernel_s2) and the feature tower's 2D conv (_kernel_w) are
// conv3d_tc.cu's, on the tensor cores.
// They compute what the TPU kernels compute, not their packed layouts:
//   out[n, o, z, y, x] = epilogue(sum_{c, kd, kh, kw}
//       in(n, c, z + kd - 1, y + kh - 1, x + kw - 1) * wt[c, kd, kh, kw, o])
// (padding 1, zero outside the volume), and for the transposed conv (torch ConvTranspose3d(k 3,
// stride 2, padding 1, output_padding 1), whose effective padding (1, 2) is
// the flax padding of the JAX package)
//   out[n, o, z, y, x] = epilogue(sum over in(n, c, i_z, i_y, i_x) *
//       wt[c, k_z, k_y, k_x, o] with 2 * i + k - 1 = output index per dim)
// The epilogue is conv3d.cuh's: v * mul[o] + add[o], then + residual, then
// ReLU.
//
// Two input loaders feed the forward conv body:
//   PlainSrc       reads a stored volume (N, Ci, D, H, W);
//   CostVolumeSrc  reads input channel c of depth slice z straight from the
//                  (N, C, H, W) left/right feature maps: disparity
//                  i = mind + z; channel c < C is left[c, y, x], channel
//                  c >= C is right[c - C, y, x - i], both only where
//                  0 <= x - i < W, zero elsewhere. The (N, 2C, D, H, W)
//                  volume is never stored. The conv's depth padding slices
//                  z = -1 and z = D are zero, not the volume at disparities
//                  mind - 1 and mind + D (as the TPU kernel zeroes them,
//                  packed_conv.py:37-47).
//
// Bound on an H100 SXM (67 TFLOP/s float32, 3.35 TB/s): operations for
// every form but CO = 1, which is bound by its input's bytes.
//
// Design (simple and right first; the tensor cores come later).
// Forward conv: one block per (n, z, 8 x 32 output tile). Per step of
// CI_STEP input channels the block stages the 3-deep halo of the input
// (10 rows, 34 columns) and the weights of those channels for all CO
// outputs in shared memory, then each thread accumulates 8 output rows x 8
// output channels (CO 32/64; lane = column, warp = group of 8 channels) in
// registers: per tap, 8 input reads and 2 broadcast float4 weight reads
// feed 64 FMAs. CO = 1 gets its own shape: 4 warps split the tile's rows,
// 2 rows per thread.
// Transposed conv: per dimension an even output 2i takes one tap (input i,
// k 1) and an odd output 2i + 1 two (input i + 1, k 0; input i, k 2), so
// an output does 1.5^3 taps on average. One block per (n, z, 4 x 64
// output tile): the depth parity is the block's, the row parity is the
// unrolled row's, and the column parity is the warp's (lane l of a warp of
// parity px writes column 2l + px), so no thread branches on its own
// parity and no tap is evaluated that does not exist.
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

struct CostVolumeSrc {
  const float* left;   // (N, C, H, W)
  const float* right;  // (N, C, H, W)
  int c_half, d, h, w, mind;
  __device__ __forceinline__ float load(int n, int c, int z, int y, int xx) const {
    if (c >= 2 * c_half || z < 0 || z >= d || y < 0 || y >= h || xx < 0 || xx >= w)
      return 0.f;
    const int xs = xx - (mind + z);
    if (xs < 0 || xs >= w) return 0.f;
    if (c < c_half)
      return __ldg(left + (((size_t)n * c_half + c) * h + y) * (size_t)w + xx);
    return __ldg(right + (((size_t)n * c_half + (c - c_half)) * h + y) * (size_t)w + xs);
  }
};

// Blocks per SM the forward conv's register allocation must leave room
// for: 512 threads resident at least, so that one block's barrier does not
// idle the SM (uncapped, the Co 64 form of this body took ~170 registers
// and fit one 256-thread block per SM). The transposed conv was slower under the same
// cap and has none.
constexpr int min_blocks(int threads) { return threads >= 512 ? 1 : 512 / threads; }

template <int CO_T>
__device__ __forceinline__ void load_weights(const float* wp, float (&wv)[CO_T]) {
  if constexpr (CO_T % 4 == 0) {
#pragma unroll
    for (int j = 0; j < CO_T; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(wp + j);
      wv[j] = q.x;
      wv[j + 1] = q.y;
      wv[j + 2] = q.z;
      wv[j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < CO_T; ++j) wv[j] = wp[j];
  }
}

// Forward conv: CO output channels, CO_T of them per thread, RG warps
// splitting the tile rows (kTH / RG rows per thread), CO / CO_T * RG warps
// per block; CI_STEP input channels staged per step. The input tile's
// origin is the output origin - 1 in every dim.
template <int CO, int CO_T, int RG, int CI_STEP, class Src>
__global__ void __launch_bounds__(CO / CO_T * RG * 32, min_blocks(CO / CO_T * RG * 32))
conv_kernel(const Src src, int ci, int tiles_w, const float* __restrict__ wt, const Out out) {
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

// Transposed conv tiles: 4 output rows x 64 output columns per block; its
// input is rows y0 / 2 .. y0 / 2 + 2, columns x0 / 2 .. x0 / 2 + 32 and
// depth slices z / 2, z / 2 + 1 (floors).
constexpr int kDTH = 4;
constexpr int kDTW = 64;
constexpr int kDHaloH = kDTH / 2 + 1;
constexpr int kDHaloW = kDTW / 2 + 1;
constexpr int kDCiStep = 4;

// CO output channels, 8 per thread; warp = (channel group, column parity).
template <int CO>
__global__ void __launch_bounds__(CO / 8 * 2 * 32)
deconv_kernel(const PlainSrc src, int tiles_w, const float* __restrict__ wt, const Out out) {
  constexpr int kCoT = 8;
  constexpr int kThreads = CO / kCoT * 2 * 32;
  constexpr int kHaloSize = kDCiStep * 2 * kDHaloH * kDHaloW;
  constexpr int kWSize = kDCiStep * 27 * CO;
  __shared__ float in_s[kHaloSize];
  __shared__ __align__(16) float w_s[kWSize];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int px = warp & 1;
  const int cog = warp >> 1;
  const int y0 = (blockIdx.x / tiles_w) * kDTH;
  const int x0 = (blockIdx.x % tiles_w) * kDTW;
  const int z = blockIdx.y;
  const int n = blockIdx.z;
  // depth taps: an even z one (slice z / 2, kd 1), an odd z two (slice
  // z / 2 + 1, kd 0; slice z / 2, kd 2); columns alike by the warp's parity
  const int pz = z & 1;
  const int nz = pz + 1;
  const int nx = px + 1;

  float acc[kDTH][kCoT];
#pragma unroll
  for (int p = 0; p < kDTH; ++p)
#pragma unroll
    for (int j = 0; j < kCoT; ++j) acc[p][j] = 0.f;

  for (int c0 = 0; c0 < src.ci; c0 += kDCiStep) {
    __syncthreads();
    for (int i = threadIdx.x; i < kHaloSize; i += kThreads) {
      const int xx = i % kDHaloW;
      int t = i / kDHaloW;
      const int yy = t % kDHaloH;
      t /= kDHaloH;
      const int slot = t % 2;
      const int c = t / 2;
      in_s[i] = src.load(n, c0 + c, z / 2 + slot, y0 / 2 + yy, x0 / 2 + xx);
    }
    for (int i = threadIdx.x; i < kWSize; i += kThreads) {
      const int c = i / (27 * CO);
      w_s[i] = c0 + c < src.ci ? __ldg(wt + (size_t)c0 * 27 * CO + i) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int c = 0; c < kDCiStep; ++c) {
      for (int tz = 0; tz < nz; ++tz) {
        const int zslot = pz & (tz == 0), kd = pz ? 2 * tz : 1;
        for (int tx = 0; tx < nx; ++tx) {
          const int col = lane + (px & (tx == 0)), kw = px ? 2 * tx : 1;
          const float* ip = in_s + (c * 2 + zslot) * kDHaloH * kDHaloW + col;
          const float* wp = w_s + (c * 27 + kd * 9 + kw) * CO + cog * kCoT;
          // kh 1 feeds the even rows p from halo row p / 2; kh 0 and 2 feed
          // the odd rows from halo rows (p + 1) / 2 and (p - 1) / 2
#pragma unroll
          for (int kh = 0; kh < 3; ++kh) {
            float wv[kCoT];
            load_weights<kCoT>(wp + kh * 3 * CO, wv);
#pragma unroll
            for (int p = 0; p < kDTH; ++p) {
              if ((p & 1) != (kh != 1)) continue;
              const int r = kh == 1 ? p / 2 : kh == 0 ? (p + 1) / 2 : (p - 1) / 2;
              const float xv = ip[r * kDHaloW];
#pragma unroll
              for (int j = 0; j < kCoT; ++j) acc[p][j] += xv * wv[j];
            }
          }
        }
      }
    }
  }

  const int xo = x0 + 2 * lane + px;
  if (xo >= out.w) return;
#pragma unroll
  for (int p = 0; p < kDTH; ++p) {
    const int yo = y0 + p;
    if (yo >= out.h) continue;
#pragma unroll
    for (int j = 0; j < kCoT; ++j) out.store(n, cog * kCoT + j, z, yo, xo, acc[p][j]);
  }
}

template <int CO, int CO_T, int RG, int CI_STEP, class Src>
cudaError_t launch(const Src& src, int n, int ci, const float* wt, const Out& out,
                   cudaStream_t s) {
  const int tiles_w = (out.w + kTW - 1) / kTW;
  const int tiles = ((out.h + kTH - 1) / kTH) * tiles_w;
  const dim3 grid(tiles, out.d, n);
  conv_kernel<CO, CO_T, RG, CI_STEP, Src>
      <<<grid, CO / CO_T * RG * 32, 0, s>>>(src, ci, tiles_w, wt, out);
  return cudaGetLastError();
}

// Co 32 and 64: the cost-volume conv. Shared memory stays under 48 KiB: 4
// channels a step.
cudaError_t dispatch(const CostVolumeSrc& src, int n, int ci, const float* wt, const Out& out,
                     cudaStream_t s) {
  switch (out.co) {
    case 32: return launch<32, 8, 1, 4>(src, n, ci, wt, out, s);
    case 64: return launch<64, 8, 1, 4>(src, n, ci, wt, out, s);
    default: return cudaErrorInvalidValue;
  }
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

// left, right (N, C, H, W); the cost volume has D slices, slice z at
// disparity mind + z, and 2C channels; wt (2C, 3, 3, 3, Co); mul, add
// (Co,); out (N, Co, D, H, W). Co is 32 or 64. Otherwise as conv3d_bn_cuda.
int cost_volume_conv_bn_cuda(const void* left, const void* right, int n, int c, int h,
                             int w, int mind, int d, const void* wt, int co,
                             const void* mul, const void* add, int relu, void* out,
                             void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (c < 1 || !conv::grid_fits(n, d, h, w, kTH, kTW))
    return static_cast<int>(cudaErrorInvalidValue);
  const CostVolumeSrc src{static_cast<const float*>(left), static_cast<const float*>(right),
                          c, d, h, w, mind};
  return static_cast<int>(dispatch(
      src, n, 2 * c, static_cast<const float*>(wt),
      conv::make_out(out, mul, add, nullptr, co, d, h, w, relu),
      static_cast<cudaStream_t>(stream)));
}

// x (N, Ci, D, H, W) -> out (N, Co, 2D, 2H, 2W), the transposed conv;
// wt (Ci, 3, 3, 3, Co), the torch ConvTranspose3d weight (Ci, Co, 3, 3, 3)
// permuted; res of the output's shape or null. Co is 32 or 64. Otherwise
// as conv3d_bn_cuda.
int deconv3d_bn_cuda(const void* x, int n, int ci, int d, int h, int w, const void* wt,
                     int co, const void* mul, const void* add, const void* res, int relu,
                     void* out, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ci < 1 || !conv::grid_fits(n, 2 * d, 2 * h, 2 * w, kDTH, kDTW))
    return static_cast<int>(cudaErrorInvalidValue);
  const PlainSrc src{static_cast<const float*>(x), ci, d, h, w};
  const Out o = conv::make_out(out, mul, add, res, co, 2 * d, 2 * h, 2 * w, relu);
  const int tiles_w = (o.w + kDTW - 1) / kDTW;
  const dim3 grid(((o.h + kDTH - 1) / kDTH) * tiles_w, o.d, n);
  const float* wf = static_cast<const float*>(wt);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (co) {
    case 32: deconv_kernel<32><<<grid, 32 / 8 * 2 * 32, 0, s>>>(src, tiles_w, wf, o); break;
    case 64: deconv_kernel<64><<<grid, 64 / 8 * 2 * 32, 0, s>>>(src, tiles_w, wf, o); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* conv3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
