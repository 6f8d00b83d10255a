// 3D RoI pooling for Hopper (sm_90a), float32: the points inside each
// box, the first S of them in scan order with the tail cycling through
// them, gathered with their features.
//
// Replaces the TPU kernel disprcnn_tpu/ops/pallas/roipool3d_fused.py:_kernel
// (entry roipool3d_fused; the production "f32dot" form, and the bf16
// split forms compute the same function). For box (cx, by, cz, h, w, l, ry)
// of cloud b, with cos and sin of ry given:
//   cy = by - h/2; dx, dy, dz = p - (cx, cy, cz);
//   in = |dx| <= max_dis & |dy| <= h/2 & |dz| <= max_dis
//        & -l/2 <= dx c - dz s <= l/2 & -w/2 <= dx s + dz c <= w/2,
//   every product and sum rounded on its own (the plain version's mask);
//   slot k < cnt takes the k-th point inside in index order, slot k >= cnt
//   the (k mod cnt)-th (an exact integer remainder); each slot is
//   [xyz, features] of that point; an empty box gives zero rows and its
//   flag.
//
// Bound on an H100 SXM: bytes. At the headline budget the output is 2048
// boxes x 512 slots x 133 channels (558 MB, ~0.17 ms at 3.35 TB/s), and
// the in-box tests are ~25 operations per (box, point), 1.6 MFLOP per
// cloud's 16 boxes.
//
// Design: one block of 256 threads per (cloud, box). The block tests 256
// points at a time; a warp ballot, popc and a scan of the 8 warp counts
// give each inside point its rank in scan order, and the first S ranks
// store their point index in shared memory; the scan stops once S are
// found. The block then writes the box's (S, 3 + C) rows flat and
// coalesced, each element reading its source row through L1/L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
roipool3d_kernel(const float* __restrict__ pts, const float* __restrict__ feats,
                 const float* __restrict__ boxes, const float* __restrict__ cossin, int n,
                 int m, int c, int s, float max_dis, float* __restrict__ out,
                 uint8_t* __restrict__ empty) {
  extern __shared__ int sel[];  // s
  __shared__ int warp_cnt[kWarps];
  __shared__ int warp_off[kWarps + 1];
  const int box = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t bm = (size_t)b * m + box;
  const float* bx = boxes + bm * 7;
  const float cx = bx[0], by = bx[1], cz = bx[2];
  const float hh = bx[3] * 0.5f, hw = bx[4] * 0.5f, hl = bx[5] * 0.5f;
  const float cy = __fsub_rn(by, hh);
  const float ca = cossin[bm * 2], sa = cossin[bm * 2 + 1];
  const float* P = pts + (size_t)b * n * 3;

  int count = 0;  // the same in every thread
  for (int base = 0; base < n && count < s; base += kThreads) {
    const int j = base + tid;
    bool in = false;
    if (j < n) {
      const float dx = __fsub_rn(P[j * 3], cx), dy = __fsub_rn(P[j * 3 + 1], cy),
                  dz = __fsub_rn(P[j * 3 + 2], cz);
      if (fabsf(dx) <= max_dis && fabsf(dy) <= hh && fabsf(dz) <= max_dis) {
        const float xr = __fsub_rn(__fmul_rn(dx, ca), __fmul_rn(dz, sa));
        const float zr = __fadd_rn(__fmul_rn(dx, sa), __fmul_rn(dz, ca));
        in = xr >= -hl && xr <= hl && zr >= -hw && zr <= hw;
      }
    }
    const unsigned hit = __ballot_sync(kFull, in);
    if (lane == 0) warp_cnt[warp] = __popc(hit);
    __syncthreads();
    if (tid == 0) {
      warp_off[0] = 0;
      for (int w = 0; w < kWarps; ++w) warp_off[w + 1] = warp_off[w] + warp_cnt[w];
    }
    __syncthreads();
    const int pos = count + warp_off[warp] + __popc(hit & ((1u << lane) - 1u));
    if (in && pos < s) sel[pos] = j;
    count += warp_off[kWarps];
    __syncthreads();  // warp_off is rewritten by the next step
  }
  const int cnt = min(count, s);
  if (tid == 0) empty[bm] = cnt == 0;

  const int width = 3 + c;
  float* o = out + bm * (size_t)s * width;
  const float* Fb = feats + (size_t)b * n * c;
  for (int e = tid; e < s * width; e += kThreads) {
    const int slot = e / width, ch = e - slot * width;
    float val = 0.f;
    if (cnt > 0) {
      const int j = sel[slot < cnt ? slot : slot % cnt];
      val = ch < 3 ? __ldg(P + j * 3 + ch) : __ldg(Fb + (size_t)j * c + (ch - 3));
    }
    o[e] = val;
  }
}

}  // namespace

extern "C" {

// pts (B, N, 3), feats (B, N, C), boxes (B, M, 7), cossin (B, M, 2) = (cos
// ry, sin ry); all float32, contiguous. out (B, M, S, 3 + C) float32, empty
// (B, M) uint8. Launches on `stream`, does not synchronise, returns the
// cudaError_t of the launch (0 on success).
int roipool3d_cuda(const void* pts, const void* feats, const void* boxes, const void* cossin,
                   int b, int n, int m, int c, int s, float max_dis, void* out, void* empty,
                   void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b < 1 || b > 65535 || n < 1 || m < 1 || c < 0 || s < 1 || s > 8192)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(m, b);
  roipool3d_kernel<<<grid, kThreads, sizeof(int) * s, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const float*>(feats),
      static_cast<const float*>(boxes), static_cast<const float*>(cossin), n, m, c, s, max_dis,
      static_cast<float*>(out), static_cast<uint8_t*>(empty));
  return static_cast<int>(cudaGetLastError());
}

const char* roipool3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
