// Fused trilinear upsample + softmax over disparity + expected disparity,
// for Hopper (sm_90a), float32. The PSMNet eval regression head.
//
// Replaces the TPU kernel disprcnn_tpu/ops/pallas/softargmin.py:_kernel
// (entry fused_softargmin). It computes the same function: the logits
// (B, D4, h4, w4) are upsampled with align_corners=True to (B, D, H, W),
// D = maxdisp - mindisp, softmaxed over D, and reduced to the expected
// disparity sum_k p_k * (mindisp + k), (B, H, W). The TPU kernel ran the D
// and H upsamples outside it and only the W upsample inside; linear maps
// compose, so here all three run inside and only the order of rounding
// differs.
//
// Bound on an H100 SXM at the slice's shape (B 128, D4 24, 56 x 56 ->
// D 96, 224 x 224): the inputs (38.5 MB) and the output (25.7 MB) move in
// ~0.02 ms; the ~8 operations per tap of the bilinear pass and per
// disparity of the softmax take ~0.09 ms at 67 TFLOP/s: operations. The
// plain version stores the (B, 96, 224, 224) volume (2.5 GB) several times.
//
// Design: one thread per output pixel (b, y, x). It interpolates the D4
// logits of its pixel bilinearly in H and W (4 taps per slice, neighbours
// in x read neighbouring addresses), then walks k = 0..D-1: the D
// interpolation of two of those values, then an online max, sum of exp and
// sum of exp * disparity in one pass. Only the (B, H, W) map is written.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxD4 = 64;
constexpr int kThreads = 256;

// align_corners=True taps of output o along an axis of n_in -> n_out
// (psmnet.py:_interp_matrix_align_corners): position o * (n_in - 1) /
// max(n_out - 1, 1) in float32, i0 clamped to [0, n_in - 2].
__device__ __forceinline__ void taps(int o, int n_in, int n_out, int& i0, int& i1,
                                     float& f) {
  if (n_in == 1) {
    i0 = i1 = 0;
    f = 0.f;
    return;
  }
  const float pos = (float)o * (float)(n_in - 1) / (float)max(n_out - 1, 1);
  const int i = min(max((int)floorf(pos), 0), n_in - 2);
  i0 = i;
  i1 = i + 1;
  f = pos - (float)i;
}

__global__ void __launch_bounds__(kThreads)
softargmin_kernel(const float* __restrict__ logits, int b, int d4, int h4, int w4, int h,
                  int w, int mindisp, int d, float* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (long long)b * h * w) return;
  const int x = (int)(idx % w);
  const int y = (int)((idx / w) % h);
  const int bi = (int)(idx / ((long long)w * h));

  int y0, y1, x0, x1;
  float fy, fx;
  taps(y, h4, h, y0, y1, fy);
  taps(x, w4, w, x0, x1, fx);
  const float* base = logits + (size_t)bi * d4 * h4 * w4;
  float v[kMaxD4];
  for (int s = 0; s < d4; ++s) {
    const float* p = base + (size_t)s * h4 * w4;
    const float top = (1.f - fx) * __ldg(p + y0 * w4 + x0) + fx * __ldg(p + y0 * w4 + x1);
    const float bot = (1.f - fx) * __ldg(p + y1 * w4 + x0) + fx * __ldg(p + y1 * w4 + x1);
    v[s] = (1.f - fy) * top + fy * bot;
  }

  float m = -CUDART_INF_F, sum = 0.f, dsum = 0.f;
  for (int k = 0; k < d; ++k) {
    int k0, k1;
    float fk;
    taps(k, d4, d, k0, k1, fk);
    const float z = (1.f - fk) * v[k0] + fk * v[k1];
    const float disp = (float)(mindisp + k);
    if (z > m) {
      const float scale = expf(m - z);  // 0 on the first step
      sum = sum * scale + 1.f;
      dsum = dsum * scale + disp;
      m = z;
    } else {
      const float e = expf(z - m);
      sum += e;
      dsum += e * disp;
    }
  }
  out[idx] = dsum / sum;
}

}  // namespace

extern "C" {

// logits (B, D4, h4, w4) float32, contiguous, D4 <= 64; out (B, H, W)
// float32. Launches on `stream`, does not synchronise, returns the
// cudaError_t of the launch (0 on success).
int softargmin_cuda(const void* logits, int b, int d4, int h4, int w4, int h, int w,
                    int mindisp, int maxdisp, void* out, void* stream, int device) {
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: set it to the tensors' device
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int d = maxdisp - mindisp;
  if (b < 1 || d4 < 1 || d4 > kMaxD4 || h4 < 1 || w4 < 1 || h < 1 || w < 1 || d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = (long long)b * h * w;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  softargmin_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), b, d4, h4, w4, h, w, mindisp, d,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* softargmin_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
