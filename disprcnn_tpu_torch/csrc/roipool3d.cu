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
// found. The box's output is one contiguous run of S rows of 3 + C
// floats. On the bulk route the block gathers chunks of up to 16 rows
// into a ring of 3 shared-memory buffers, a warp a row (its lanes read the
// source row's xyz and features, coalesced, and no element needs a
// division), and one thread writes each chunk out with a TMA bulk store,
// so the output leaves as whole lines while the next chunk is gathered.
// Where a chunk's part of the run does not start or end on 16 bytes, its
// first and last floats (at most 3 each) are plain stores. The main path's
// width, 133, is a compile-time constant. The direct route, taken where
// the ring does not fit in shared memory, stores each row from its warp's
// registers.
//
// A bf16 model's form (roipool3d_bf16_cuda): the features come in two
// arrays, E float32 channels (the RCNN's seg mask and depth) and C bf16
// channels (the RPN's features); each row is [xyz, the float32 channels,
// the bf16 channels widened to float32], float32 out, bit-equal to the
// float32 form on the widened features (the TPU kernel's bf16 channels
// ride its gather exactly, roipool3d_fused.py:184-194). The caller then
// keeps no float32 copy of the RPN's features.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"
#include "tma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBufs = 3;            // the bulk route's ring of chunks
constexpr int kChunkRows = 16;      // rows a chunk, at most: 8 blocks an SM at C = 130
constexpr int kChunkBytes = 24576;  // a chunk's rows, at most
constexpr int kMaxShared = 232448;
constexpr int kMainWidth = 3 + 130;  // the RCNN's pooled row: xyz, seg, depth, 128 features

enum Route { kAuto = 0, kBulk = 1, kDirect = 2 };

__host__ __device__ inline int align_up(int x, int a) { return (x + a - 1) / a * a; }

// Floats of a chunk's buffer: its rows and up to 3 floats ahead of them,
// so that the buffer starts on the 16 bytes of the output that hold the
// chunk's first float.
__host__ __device__ inline int chunk_floats(int rows, int width) {
  return align_up(rows * width + 3, 4);
}

// Channel ch of point j's row: xyz, then the float32 features (e of them;
// all c in the float32 form), then (kBf16) the bf16 ones widened
template <bool kBf16>
__device__ __forceinline__ float row_value(int ch, const float* xyz, const float* f,
                                          const bf16_t* bf, int e) {
  if constexpr (kBf16) {
    if (ch >= 3 + e) return ldg_float(bf + (ch - 3 - e));
  }
  return __ldg(ch < 3 ? xyz + ch : f + (ch - 3));
}

// Rows [s0, s1) of a box with cnt > 0 points inside (sel their indices),
// row `slot` into dst + (slot - s0) * width: a warp a row, its lanes over
// the channels; each warp's rows are unrolled so that their loads are in
// flight together. Fb holds e float32 channels a point, Bb (kBf16) c - e
// bf16 channels.
template <int kWidth, bool kBf16>
__device__ __forceinline__ void gather_rows(float* dst, const int* sel, int s0, int s1, int cnt,
                                            const float* __restrict__ P,
                                            const float* __restrict__ Fb,
                                            const bf16_t* __restrict__ Bb, int c, int e,
                                            int warp, int lane) {
  const int width = kWidth > 0 ? kWidth : 3 + c;
#pragma unroll 4
  for (int slot = s0 + warp; slot < s1; slot += kWarps) {
    const int j = sel[slot < cnt ? slot : slot % cnt];
    const float* xyz = P + static_cast<size_t>(j) * 3;
    const float* f = Fb + static_cast<size_t>(j) * e;
    const bf16_t* bf = kBf16 ? Bb + static_cast<size_t>(j) * (c - e) : nullptr;
    float* row = dst + static_cast<size_t>(slot - s0) * width;
    if constexpr (kWidth > 0) {
      constexpr int kSteps = (kWidth + 31) / 32;
      float v[kSteps];
#pragma unroll
      for (int q = 0; q < kSteps; ++q) {
        const int ch = lane + 32 * q;
        v[q] = ch < kWidth ? row_value<kBf16>(ch, xyz, f, bf, e) : 0.f;
      }
#pragma unroll
      for (int q = 0; q < kSteps; ++q) {
        const int ch = lane + 32 * q;
        if (ch < kWidth) row[ch] = v[q];
      }
    } else {
      for (int ch = lane; ch < width; ch += 32) row[ch] = row_value<kBf16>(ch, xyz, f, bf, e);
    }
  }
}

// dst[0, count) = 0, by the whole block
__device__ __forceinline__ void zero_fill(float* dst, size_t count, int tid) {
  for (size_t e = tid; e < count; e += kThreads) dst[e] = 0.f;
}

template <int kWidth, bool kBulkRoute, bool kBf16>
__global__ void __launch_bounds__(kThreads)
roipool3d_kernel(const float* __restrict__ pts, const float* __restrict__ feats,
                 const bf16_t* __restrict__ bfeats, const float* __restrict__ boxes,
                 const float* __restrict__ cossin, int n, int m, int c, int e, int s, int rows,
                 float max_dis, float* __restrict__ out, uint8_t* __restrict__ empty) {
  extern __shared__ __align__(128) unsigned char smem[];
  int* sel = reinterpret_cast<int*>(smem);  // s
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
    __syncthreads();  // warp_off is rewritten by the next step; sel is complete
  }
  const int cnt = min(count, s);
  if (tid == 0) empty[bm] = cnt == 0;

  const int width = kWidth > 0 ? kWidth : 3 + c;
  const float* Fb = feats + (size_t)b * n * e;
  const bf16_t* Bb = kBf16 ? bfeats + (size_t)b * n * (c - e) : nullptr;
  const size_t run = bm * (size_t)s * width;  // the box's first float in out
  if (!kBulkRoute) {
    if (cnt == 0)
      zero_fill(out + run, (size_t)s * width, tid);
    else
      gather_rows<kWidth, kBf16>(out + run, sel, 0, s, cnt, P, Fb, Bb, c, e, warp, lane);
    return;
  }

  float* bufs = reinterpret_cast<float*>(smem + align_up(s * 4, 128));
  const int cf = chunk_floats(rows, width);
  const int chunks = (s + rows - 1) / rows;
  for (int q = 0; q < chunks; ++q) {
    float* buf = bufs + (q % kBufs) * cf;
    const int s0 = q * rows, s1 = min(s, s0 + rows);
    const size_t g0 = run + (size_t)s0 * width, g1 = run + (size_t)s1 * width;
    const size_t a0 = g0 & ~size_t(3);  // the 16 bytes that hold g0 start the buffer
    if (cnt == 0)
      zero_fill(buf + (g0 - a0), g1 - g0, tid);
    else
      gather_rows<kWidth, kBf16>(buf + (g0 - a0), sel, s0, s1, cnt, P, Fb, Bb, c, e, warp,
                                 lane);
    tma::fence_to_async();
    // the buffer that the next chunk fills was last read by the store of
    // chunk q + 1 - kBufs: at most kBufs - 2 later groups may be pending
    if (tid == 0) tma::wait_read<kBufs - 2>();
    __syncthreads();
    const size_t b0 = (g0 + 3) & ~size_t(3), b1 = g1 & ~size_t(3);
    if (tid == 0) {
      if (b1 > b0) tma::store(out + b0, buf + (b0 - a0), static_cast<uint32_t>((b1 - b0) * 4));
      tma::commit();
    } else if (warp == 1) {
      // the floats before and after the 16-byte-aligned body
      for (size_t f = g0 + lane; f < g1 && f < b0; f += 32) out[f] = buf[f - a0];
      for (size_t f = (b1 > b0 ? b1 : b0) + lane; f < g1; f += 32) out[f] = buf[f - a0];
    }
  }
  if (tid == 0) tma::wait_all();  // the stores are done before the block leaves
}

template <int kWidth, bool kBulkRoute, bool kBf16>
cudaError_t launch(const float* pts, const float* feats, const bf16_t* bfeats, const float* boxes,
                   const float* cossin, int b, int n, int m, int c, int e, int s, int rows,
                   float max_dis, float* out, uint8_t* empty, int smem, cudaStream_t stream) {
  static bool attr_set[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!attr_set[device]) {
    err = cudaFuncSetAttribute(roipool3d_kernel<kWidth, kBulkRoute, kBf16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShared - 1024);
    if (err != cudaSuccess) return err;
    attr_set[device] = true;
  }
  roipool3d_kernel<kWidth, kBulkRoute, kBf16><<<dim3(m, b), kThreads, smem, stream>>>(
      pts, feats, bfeats, boxes, cossin, n, m, c, e, s, rows, max_dis, out, empty);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The route a launch takes (kBulk or kDirect) for `route` (kAuto: bulk
// where its ring fits in shared memory), its rows a chunk and its shared
// memory; -1 where the route asked for does not fit.
int roipool3d_plan(int c, int s, int route, int* rows_out, int* smem_out) {
  const int width = 3 + c;
  int rows = kChunkBytes / (4 * width);
  rows = rows > kChunkRows ? kChunkRows : rows;
  rows = rows > s ? s : rows;
  const int sel_bytes = align_up(s * 4, 128);
  const int bulk_smem = sel_bytes + kBufs * chunk_floats(rows > 0 ? rows : 1, width) * 4;
  const bool bulk_fits = rows >= 1 && bulk_smem <= kMaxShared - 1024;
  if (route == kAuto) route = bulk_fits ? kBulk : kDirect;
  if (route == kBulk && !bulk_fits) return -1;
  *rows_out = route == kBulk ? rows : 0;
  *smem_out = route == kBulk ? bulk_smem : sel_bytes;
  return route;
}

}  // extern "C"

namespace {

// The launch of either form on its route: the float32 form takes c float32
// channels a point (e == c, bfeats null), the bf16 form e float32 ones and
// c - e bf16 ones.
template <bool kBf16>
int run(const void* pts, const void* feats, const void* bfeats, const void* boxes,
        const void* cossin, int b, int n, int m, int c, int e, int s, float max_dis, int route,
        void* out, void* empty, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b < 1 || b > 65535 || n < 1 || m < 1 || c < 0 || e < 0 || e > c || s < 1 || s > 8192 ||
      route < 0 || route > kDirect || reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  int rows = 0, smem = 0;
  route = roipool3d_plan(c, s, route, &rows, &smem);
  if (route < 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* p = static_cast<const float*>(pts);
  const float* f = static_cast<const float*>(feats);
  const bf16_t* bf = static_cast<const bf16_t*>(bfeats);
  const float* bx = static_cast<const float*>(boxes);
  const float* cs = static_cast<const float*>(cossin);
  float* o = static_cast<float*>(out);
  uint8_t* em = static_cast<uint8_t*>(empty);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool main_width = 3 + c == kMainWidth;
  if (route == kBulk)
    err = main_width ? launch<kMainWidth, true, kBf16>(p, f, bf, bx, cs, b, n, m, c, e, s, rows,
                                                       max_dis, o, em, smem, st)
                     : launch<0, true, kBf16>(p, f, bf, bx, cs, b, n, m, c, e, s, rows, max_dis,
                                              o, em, smem, st);
  else
    err = main_width ? launch<kMainWidth, false, kBf16>(p, f, bf, bx, cs, b, n, m, c, e, s, rows,
                                                        max_dis, o, em, smem, st)
                     : launch<0, false, kBf16>(p, f, bf, bx, cs, b, n, m, c, e, s, rows, max_dis,
                                               o, em, smem, st);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// pts (B, N, 3), feats (B, N, C), boxes (B, M, 7), cossin (B, M, 2) = (cos
// ry, sin ry); all float32, contiguous, out 16-byte aligned. out (B, M, S,
// 3 + C) float32, empty (B, M) uint8. route: 0 the plan's choice, 1 bulk,
// 2 direct. Launches on `stream`, does not synchronise, returns the
// cudaError_t of the launch (0 on success).
int roipool3d_cuda(const void* pts, const void* feats, const void* boxes, const void* cossin,
                   int b, int n, int m, int c, int s, float max_dis, int route, void* out,
                   void* empty, void* stream, int device) {
  return run<false>(pts, feats, nullptr, boxes, cossin, b, n, m, c, c, s, max_dis, route, out,
                    empty, stream, device);
}

// The bf16 form: extra (B, N, E) float32 and feats (B, N, C) bf16, both
// contiguous; out (B, M, S, 3 + E + C) float32, rows [xyz, extra, feats
// widened]; the rest as roipool3d_cuda's.
int roipool3d_bf16_cuda(const void* pts, const void* extra, const void* feats, const void* boxes,
                        const void* cossin, int b, int n, int m, int e, int c, int s,
                        float max_dis, int route, void* out, void* empty, void* stream,
                        int device) {
  return run<true>(pts, extra, feats, boxes, cossin, b, n, m, e + c, e, s, max_dis, route, out,
                   empty, stream, device);
}

const char* roipool3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
