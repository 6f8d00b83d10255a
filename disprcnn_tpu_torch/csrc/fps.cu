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
// Bound on an H100 SXM: ~10 operations per point and step (0.5 GFLOP for
// 128 clouds of 768 points and 511 steps, ~7 us at 67 TFLOP/s); the inputs
// move in under 1 us. What limits it is the chain of npoint - 1 dependent
// steps: each step's argmax must finish before the next step's distances
// can start, so a step's latency, not the card's rate, sets the time.
//
// The argmax runs on integer keys. A running minimum is >= 0 (a sum of
// squares, never -0), so its float bits order as a signed int; padded slots
// hold -1.0f, whose bits are negative and never the maximum. In a warp,
// redux.sync max over the bits gives the largest distance and redux.sync
// min over the indices of the lanes that hold it the lowest index: two
// instructions instead of a butterfly of shuffles.
//
// Two routes, chosen by the wrapper (ops/cuda/fps.py::fps_route):
// - block route, for a few long clouds (the RPN's 128): one block of
//   kBlockThreads threads a cloud, K points a thread in registers. A step
//   is the thread's K distance updates, a warp argmax, each warp's winner
//   as the key (bits << 32) | (0xffffffff - index) in a shared slot, one
//   __syncthreads(), and every thread's max over the kW keys (a tree of
//   64-bit maxima over broadcast loads). The slots alternate by step
//   parity, so one barrier a step suffices: a warp can rewrite step i's
//   slots only at step i + 2, after every warp has passed step i + 1's
//   barrier and so has read them. 4 warps a cloud beat 8 and 16, and the
//   tree beat two redux.sync over the keys' halves (an unkept study on an
//   H100).
// - warp route, for thousands of short clouds (the RCNN's 2048-6400): one
//   warp a cloud, kWarps clouds a block, K points a lane; no barrier.
// Both keep the cloud's coordinates in shared memory too, so the last point
// taken is one broadcast load rather than a select over K registers.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxN = 1024;
constexpr int kBlockThreads = 128;
constexpr int kWarps = 4;  // clouds per block on the warp route

__device__ __forceinline__ float sqdist(float x, float y, float z, float lx, float ly,
                                        float lz) {
  const float dx = __fsub_rn(x, lx), dy = __fsub_rn(y, ly), dz = __fsub_rn(z, lz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// Stage a cloud's (N, 3) coordinates as three planes in shared memory,
// reading the array in order; threads `t` of `count`.
__device__ __forceinline__ void stage(const float* __restrict__ p, int n, float* sx, float* sy,
                                     float* sz, int t, int count) {
  for (int i = t; i < 3 * n; i += count) {
    const int j = i / 3, c = i - 3 * j;
    const float v = __ldg(p + i);
    (c == 0 ? sx : c == 1 ? sy : sz)[j] = v;
  }
}

// The K points j = first + stride * k of a thread: coordinates and running
// minima in registers, -1.0f for the slots past N.
template <int K>
struct Points {
  float x[K], y[K], z[K], md[K];

  __device__ __forceinline__ void load(const float* sx, const float* sy, const float* sz,
                                       int first, int stride, int n) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = first + stride * k;
      const bool in = j < n;
      x[k] = in ? sx[j] : 0.f;
      y[k] = in ? sy[j] : 0.f;
      z[k] = in ? sz[j] : 0.f;
      md[k] = in ? 1e10f : -1.f;
    }
  }

  // Update the minima with the distances to (lx, ly, lz); returns the
  // largest minimum's bits, and in `bi` its lowest index. A padded slot
  // keeps -1.0f: min(-1, d) = -1.
  __device__ __forceinline__ int update(float lx, float ly, float lz, int first, int stride,
                                        int& bi) {
    int best = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      md[k] = fminf(md[k], sqdist(x[k], y[k], z[k], lx, ly, lz));
      const int bits = __float_as_int(md[k]);
      if (k == 0 || bits > best) {  // strict: the lower index keeps a tie
        best = bits;
        bi = first + stride * k;
      }
    }
    return best;
  }
};

// A warp's largest bits and the lowest index that holds them.
__device__ __forceinline__ int warp_argmax(int bits, int bi, int& wbits) {
  wbits = __reduce_max_sync(kFull, bits);
  return (int)__reduce_min_sync(kFull, bits == wbits ? (unsigned)bi : kFull);
}

template <int K>
__global__ void __launch_bounds__(kBlockThreads)
fps_block_kernel(const float* __restrict__ xyz, int n, int npoint, int64_t* __restrict__ out) {
  constexpr int kW = kBlockThreads / 32;  // a power of 2
  __shared__ float sx[kMaxN], sy[kMaxN], sz[kMaxN];
  __shared__ unsigned long long slot[2][kW];
  const int t = threadIdx.x, warp = t >> 5;
  const long long cloud = blockIdx.x;
  int64_t* o = out + cloud * npoint;
  stage(xyz + cloud * n * 3, n, sx, sy, sz, t, kBlockThreads);
  __syncthreads();
  Points<K> pts;
  pts.load(sx, sy, sz, t, kBlockThreads, n);
  if (t == 0) o[0] = 0;
  int last = 0;
  for (int i = 1; i < npoint; ++i) {
    int bi;
    const int bits = pts.update(sx[last], sy[last], sz[last], t, kBlockThreads, bi);
    int wbits;
    const int wi = warp_argmax(bits, bi, wbits);
    unsigned long long* s = slot[i & 1];
    // every lane stores the same key (one store, no branch); a warp with no
    // point (wbits < 0) offers key 0, below every real key
    s[warp] = wbits < 0 ? 0ull
                        : ((unsigned long long)(unsigned)wbits << 32) | (kFull - (unsigned)wi);
    __syncthreads();
    unsigned long long key[kW];
#pragma unroll
    for (int w = 0; w < kW; ++w) key[w] = s[w];
#pragma unroll
    for (int half = kW / 2; half > 0; half /= 2)
#pragma unroll
      for (int w = 0; w < half; ++w) key[w] = max(key[w], key[w + half]);
    last = (int)(kFull - (unsigned)key[0]);
    if (t == 0) o[i] = last;
  }
}

template <int K>
__global__ void __launch_bounds__(kWarps * 32)
fps_warp_kernel(const float* __restrict__ xyz, int b, int n, int npoint,
                int64_t* __restrict__ out) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long cloud = (long long)blockIdx.x * kWarps + warp;
  if (cloud >= b) return;  // whole warps leave together; no block barrier follows
  float* sx = smem + warp * 3 * n;
  float* sy = sx + n;
  float* sz = sy + n;
  int64_t* o = out + cloud * npoint;
  stage(xyz + cloud * n * 3, n, sx, sy, sz, lane, 32);
  __syncwarp();
  Points<K> pts;
  pts.load(sx, sy, sz, lane, 32, n);
  if (lane == 0) o[0] = 0;
  int last = 0;
  for (int i = 1; i < npoint; ++i) {
    int bi;
    const int bits = pts.update(sx[last], sy[last], sz[last], lane, 32, bi);
    int wbits;
    last = warp_argmax(bits, bi, wbits);
    if (lane == 0) o[i] = last;
  }
}

// The block route with the least K (points a thread) that holds N.
template <int K>
cudaError_t launch_block(const float* xyz, int b, int n, int npoint, int64_t* out,
                         cudaStream_t stream) {
  if constexpr (K * kBlockThreads < kMaxN) {
    if (n > K * kBlockThreads) return launch_block<K + 1>(xyz, b, n, npoint, out, stream);
  }
  fps_block_kernel<K><<<b, kBlockThreads, 0, stream>>>(xyz, n, npoint, out);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_warp(const float* xyz, int b, int n, int npoint, int64_t* out,
                        cudaStream_t stream) {
  const int blocks = (b + kWarps - 1) / kWarps;
  const size_t smem = sizeof(float) * 3 * n * kWarps;  // <= 48 KB at N = 1024
  fps_warp_kernel<K><<<blocks, kWarps * 32, smem, stream>>>(xyz, b, n, npoint, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// xyz (B, N, 3) float32 contiguous, 1 <= npoint <= N <= 1024; out (B,
// npoint) int64; route 0 = warp route, 1 = block route. Launches on
// `stream`, does not synchronise, returns the cudaError_t of the launch (0
// on success).
int fps_cuda(const void* xyz, int b, int n, int npoint, void* out, int route, void* stream,
             int device) {
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: set it to the tensors' device
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b < 1 || n < 1 || n > kMaxN || npoint < 1 || npoint > n || (route != 0 && route != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* x = static_cast<const float*>(xyz);
  int64_t* o = static_cast<int64_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    err = launch_block<1>(x, b, n, npoint, o, s);
  } else {
    if (n <= 128) err = launch_warp<4>(x, b, n, npoint, o, s);
    else if (n <= 256) err = launch_warp<8>(x, b, n, npoint, o, s);
    else if (n <= 512) err = launch_warp<16>(x, b, n, npoint, o, s);
    else if (n <= 768) err = launch_warp<24>(x, b, n, npoint, o, s);
    else err = launch_warp<32>(x, b, n, npoint, o, s);
  }
  return static_cast<int>(err);
}

const char* fps_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
