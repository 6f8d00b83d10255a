// Furthest-point sampling for Hopper (sm_90a), float32 clouds.
//
// Replaces the TPU kernel disprcnn_tpu/ops/pallas/fps.py:_fps_kernel (entry
// furthest_point_sample_pallas). Same function: for each cloud (N, 3), slot
// 0 is point 0; step i takes the point with the largest running minimum
// squared distance to the points taken so far (the minimum starts at 1e10),
// ties to the lowest index. Squared distances are ((dx*dx + dy*dy) + dz*dz)
// with every product and sum rounded on its own (__fmul_rn, __fadd_rn), as
// the plain PyTorch version computes them, so the selection is exact.
//
// Bound on an H100 SXM: the loop is sequential over npoint, and each step
// does ~10 operations per point: 128 clouds of 768 points and 511 steps
// are ~0.5 GFLOP (~7 us at 67 TFLOP/s); the inputs (1.2 MB) move in under
// 1 us. What limits it in practice is the latency of each step's argmax.
//
// Design: one warp per cloud, four clouds per block. A lane holds the
// coordinates and running minima of points lane, lane + 32, ... in
// registers (K of them, N <= 32 K); a step is K distance updates per lane
// and a five-round butterfly argmax over (distance, index) with shuffles:
// no shared memory and no block barrier, so the 2048-6400 clouds of the
// RCNN stage keep many warps in flight on each SM.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr unsigned kFull = 0xffffffffu;

template <int K>
__global__ void __launch_bounds__(kWarps * 32)
fps_kernel(const float* __restrict__ xyz, int b, int n, int npoint,
           int64_t* __restrict__ out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long cloud = (long long)blockIdx.x * kWarps + warp;
  if (cloud >= b) return;  // whole warps leave together
  const float* p = xyz + cloud * n * 3;
  int64_t* o = out + cloud * npoint;

  float px[K], py[K], pz[K], md[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + 32 * k;
    if (j < n) {
      px[k] = p[3 * j];
      py[k] = p[3 * j + 1];
      pz[k] = p[3 * j + 2];
      md[k] = 1e10f;
    } else {
      px[k] = py[k] = pz[k] = 0.f;
      md[k] = -1.f;  // below every distance: never the maximum
    }
  }
  if (lane == 0) o[0] = 0;
  int last = 0;
  for (int i = 1; i < npoint; ++i) {
    // the last point's coordinates, from the lane and register that hold it
    const int owner = last & 31, slot = last >> 5;
    float sx = 0.f, sy = 0.f, sz = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k == slot) {
        sx = px[k];
        sy = py[k];
        sz = pz[k];
      }
    }
    const float lx = __shfl_sync(kFull, sx, owner);
    const float ly = __shfl_sync(kFull, sy, owner);
    const float lz = __shfl_sync(kFull, sz, owner);
    float best = -2.f;
    int bi = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = lane + 32 * k;
      if (j < n) {
        const float dx = __fsub_rn(px[k], lx), dy = __fsub_rn(py[k], ly),
                    dz = __fsub_rn(pz[k], lz);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        md[k] = fminf(md[k], d);
        if (md[k] > best) {  // strict: the lower index keeps a tie
          best = md[k];
          bi = j;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(kFull, best, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      if (ob > best || (ob == best && oi < bi)) {
        best = ob;
        bi = oi;
      }
    }
    last = bi;
    if (lane == 0) o[i] = bi;
  }
}

template <int K>
cudaError_t launch(const float* xyz, int b, int n, int npoint, int64_t* out,
                   cudaStream_t stream) {
  const int blocks = (b + kWarps - 1) / kWarps;
  fps_kernel<K><<<blocks, kWarps * 32, 0, stream>>>(xyz, b, n, npoint, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// xyz (B, N, 3) float32 contiguous, 1 <= npoint <= N <= 1024; out (B,
// npoint) int64. Launches on `stream`, does not synchronise, returns the
// cudaError_t of the launch (0 on success).
int fps_cuda(const void* xyz, int b, int n, int npoint, void* out, void* stream,
             int device) {
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: set it to the tensors' device
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b < 1 || n < 1 || n > 1024 || npoint < 1 || npoint > n)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* x = static_cast<const float*>(xyz);
  int64_t* o = static_cast<int64_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 256) err = launch<8>(x, b, n, npoint, o, s);
  else if (n <= 512) err = launch<16>(x, b, n, npoint, o, s);
  else if (n <= 768) err = launch<24>(x, b, n, npoint, o, s);
  else err = launch<32>(x, b, n, npoint, o, s);
  return static_cast<int>(err);
}

const char* fps_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
