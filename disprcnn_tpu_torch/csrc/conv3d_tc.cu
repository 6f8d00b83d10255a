// The PSMNet 3x3x3 and 3x3 convolutions with a fused epilogue on Hopper's
// tensor cores (sm_90a), float32 in and out at float32 accuracy, NCDHW
// (NCHW in 2D).
//
// Replaces three TPU kernels of disprcnn_tpu/ops/pallas/packed_conv.py, and
// through the first the train form's forward and input gradient:
//   - _kernel via _conv_call (packed_conv_bn): the stride-1 trunk conv +
//     folded BN + optional residual + optional ReLU, Co 32 and 64 (and
//     packed_conv_train's _pct_fwd/_pct_bwd, which run the same conv);
//   - _kernel_s2 (packed_conv_bn_s2): the hourglass's stride-2 pad-1 conv
//     + BN + ReLU;
//   - _kernel_w (wpacked_conv_bn): the feature tower's 3x3 stride-1 2D conv
//     + BN + optional residual + optional ReLU, Co 32 and 64: the 3D conv at
//     D = 1, where only the middle depth tap is inside the volume, with
//     weights packed for that one tap (conv2d_tc_cuda).
// The TPU kernels do the conv as matrix products on the MXU with float32
// accumulation (jnp.dot(..., preferred_element_type=jnp.float32)); this is
// their Hopper counterpart. It computes
//   out[n, o, z, y, x] = epilogue(sum_{c, kd, kh, kw}
//       in(n, c, S*z + kd - 1, S*y + kh - 1, S*x + kw - 1) * wt[o, c, kd, kh, kw])
// (stride S = 1 or 2, padding 1, zero outside the volume), the epilogue of
// conv3d.cuh.
//
// Bound on an H100 SXM: operations. One 56^2 trunk launch (N 128, 32 -> 32,
// D 24) needs ~0.5 TFLOP against ~2.5 GB of input and output: 7.5 ms on
// the float32 cores (67 TFLOP/s), ~3 ms at the 3xTF32 tensor-core rate
// (495 / 3 TFLOP/s), 0.75 ms of memory traffic.
//
// Accuracy: error-compensated TF32 ("3xTF32", tf32.cuh). The weights come
// split and fragment-ordered by conv3d_tc_pack_cuda, one launch before the
// conv's (its plain version is ops/cuda/conv3d.py::pack_tf32_weight); the
// input is split in registers as each fragment is read. Over K = 1728
// terms (648 mma adds into one register) the mma's truncating adds drift
// past cuDNN's float32 error, so each stage (72 terms) sums into fresh
// accumulators, added to the running sums in float32 with rounding to
// nearest. chip_smoke.py (phase 3) logs the kernel's and cuDNN's distance
// from a float64 conv at the main path's sites.
//
// Design.
// GEMM view: per block, M = a tile of output positions of one (n, z) plane,
// N = all Co (32 or 64), K = Ci x 27, walked as one k8 step per (8-channel
// chunk, tap). Instruction: mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32
// .f32, A (positions x channels) gathered from the staged halo into
// registers, B (channels x Co) read as one float4 per lane from the staged,
// pre-split, fragment-ordered weights. mma.sync rather than wgmma: wgmma
// wants A as a dense 64-row tile in shared memory (or registers in its own
// layout), and the implicit GEMM's A is a shifted window of the halo per
// tap; building that tile per tap would cost a copy per tap, and the
// m16n8k8 fragments read the window in place. What it leaves on the table:
// wgmma's asynchrony and its higher issue rate (mma.sync on Hopper reaches
// only part of the 495 TFLOP/s TF32 peak).
// Block: 8 warps, one (n, z, tile of TH whole output rows x TW columns);
// TW = the output width where it fits (112, 56, 28 and 14 on the main
// path), TH chosen so that TH x TW <= 512 positions (Co 32) or 256 (Co 64)
// and the row tiles of a plane are equal; M-tiles of 16 positions run
// over the tile's flattened positions, so no lane idles at widths that are
// not a multiple of 16 (masked positions only in a tile's last M-tile). Warp w
// owns M-tiles w, w + 8, ... (4 of them at Co 32, 2 at Co 64) against all
// Co: 64 float32 accumulators a thread either way. M-tiles past the tile's
// positions are skipped (warp-uniform).
// Staging: one stage = (8-channel chunk, one depth tap kd): the input
// slice S*z + kd - 1 of those channels over the tile's halo, and the 9
// taps' weights of that (chunk, kd). Depth taps outside the volume are
// never staged, so at D = 1 (the 2D conv) a stage is one chunk at kd = 1,
// and its weights are packed with that one depth tap. A ring of 3 stages
// in dynamic shared memory, filled by cp.async (4-byte copies with zero
// fill for the padding and the ragged edges, 16-byte copies for the
// weights) two stages ahead of the one that multiplies: one __syncthreads
// per stage.
// Halo layout: per channel a slot of CP floats, CP = 8 (mod 32), so that
// the A-fragment reads of one instruction (8 positions x 4 channels) fall
// in distinct banks wherever their 8 positions are consecutive in a halo
// row (two banks may collide where they cross a row break). Stride 1: the
// slot holds rows y0 - 1 .. y0 + TH, columns x0 - 1 .. x0 + TW, row
// stride TW + 2; tap (kh, kw) of output (r, c) is at (r + kh, c + kw).
// Stride 2: the slot holds four parity planes (row parity, column
// parity) of (TH + 1) x (TW + 1): plane q = 2 * rp + cp holds input row
// 2 * y0 - 1 + 2 * i + rp, column 2 * x0 - 1 + 2 * j + cp, so tap (kh, kw)
// of output (r, c) is plane 2 * (kh & 1) + (kw & 1) at (r + kh / 2,
// c + kw / 2): unit stride in the output column, as _kernel_s2 splits its
// block by column parity (packed_conv.py:241-276). The copy walks each
// input row's consecutive columns (coalesced) and deals them to the two
// column planes.
// Epilogue: the accumulator fragment of a lane holds positions g, g + 8 of
// an M-tile and channels 2t, 2t + 1 of an N-tile (g = lane / 4, t = lane %
// 4), so the 8 lanes of one t store 8 consecutive positions of one output
// channel: contiguous in x within a row.
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv3d.cuh"
#include "tf32.cuh"

namespace {

using conv::Out;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;
constexpr int kChunk = 8;            // input channels per k8 step
constexpr int kMaxSmem = 232448;     // bytes of shared memory a block may take on sm_90

// A launch's tile geometry, the same for every block.
struct Tile {
  int th, tw, tiles_w;  // output rows and columns per block; column tiles per plane
  int hs;               // halo row stride: tw + 2 (stride 1), tw + 1 (stride 2)
  int ps;               // one halo plane: (th + 2) * hs (stride 1), (th + 1) * hs (stride 2)
  int cp;               // floats per staged channel, >= the channel's halo, = 8 (mod 32)
};

// x (N, Ci, D, H, W); wpk the weights as pack_tf32_weight lays them out:
// (ceil(Ci / 8), wkd, 9 taps, CO / 8 N-tiles, 32 lanes, 4), lane l's 4
// floats [hi(k), hi(k + 4), lo(k), lo(k + 4)] of input channel k = l % 4 of
// the chunk and output channel l / 4 of the N-tile (the B fragment); wkd =
// 3 depth taps, or 1 (the middle one) for the 2D conv, whose D is 1.
template <int CO, int S>
__global__ void __launch_bounds__(kThreads, 1)
conv_tc_kernel(const float* __restrict__ x, int ci, int d, int h, int w,
               const float* __restrict__ wpk, int wkd, const Out out, const Tile tl) {
  constexpr int kNT = CO / 8;        // N-tiles
  constexpr int kMT = 16 / kNT;      // M-tiles per warp
  constexpr int kWS = 9 * kNT * 128;  // floats of one stage's weights
  extern __shared__ __align__(16) float smem[];
  const int stage_floats = kWS + kChunk * tl.cp;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int y0 = (blockIdx.x / tl.tiles_w) * tl.th;
  const int x0 = (blockIdx.x % tl.tiles_w) * tl.tw;
  const int z = blockIdx.y;
  const int n = blockIdx.z;
  const int npos = tl.th * tl.tw;

  // depth taps inside the volume: input slice S * z + kd - 1 in [0, d)
  const int kd_lo = max(0, 1 - S * z);
  const int nkd = min(2, d - S * z) - kd_lo + 1;
  const int nstages = (ci + kChunk - 1) / kChunk * nkd;
  const size_t plane = (size_t)d * h * w;
  const float* xn = x + (size_t)n * ci * plane;

  auto load_stage = [&](int s, int buf) {
    const int cc = s / nkd, kd = kd_lo + s % nkd;
    float* ws = smem + buf * stage_floats;
    const float* wsrc = wpk + (size_t)(cc * wkd + (wkd == 3 ? kd : 0)) * kWS;
    for (int i = threadIdx.x; i < kWS / 4; i += kThreads) cp_async16(ws + 4 * i, wsrc + 4 * i);
    float* hs = ws + kWS;
    const int c0 = cc * kChunk;
    const int nc = min(kChunk, ci - c0);
    const float* xs = xn + (size_t)c0 * plane + (size_t)(S * z + kd - 1) * h * w;
    // halo rows: stride 1, input row y0 - 1 + r; stride 2, input row
    // 2 * y0 - 1 + 2 * i + rp, its consecutive columns dealt to the two
    // column-parity planes of row parity rp
    const int rows = S == 1 ? tl.th + 2 : 2 * (tl.th + 1);
    for (int r = warp; r < rows; r += kWarps) {
      int yin, off;
      if (S == 1) {
        yin = y0 - 1 + r;
        off = r * tl.hs;
      } else {
        const int rp = r / (tl.th + 1), i = r % (tl.th + 1);
        yin = 2 * y0 - 1 + 2 * i + rp;
        off = 2 * rp * tl.ps + i * tl.hs;
      }
      const bool row_ok = yin >= 0 && yin < h;
      for (int e = lane; e < S * tl.hs; e += 32) {
        const int xin = S * x0 - 1 + e;
        const bool ok = row_ok && xin >= 0 && xin < w;
        const float* src = ok ? xs + (size_t)yin * w + xin : x;
        float* dst = hs + off + (S == 1 ? e : (e & 1) * tl.ps + (e >> 1));
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          const bool v = ok && c < nc;
          cp_async4(dst + c * tl.cp, v ? src + c * plane : x, v);
        }
      }
    }
  };

  // this lane's A rows: positions g and g + 8 of each of its M-tiles, as
  // halo offsets (channel t's slot); positions past the tile read offset 0
  int aoff[kMT][2];
  int mtiles = 0;  // active M-tiles of this warp (warp-uniform)
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
    const int mt = i * kWarps + warp;
    if (mt * 16 < npos) mtiles = i + 1;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int p = mt * 16 + g + 8 * hh;
      aoff[i][hh] = (p < npos ? (p / tl.tw) * tl.hs + p % tl.tw : 0) + t * tl.cp;
    }
  }
  const int cp4 = 4 * tl.cp;  // channel k + 4

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  load_stage(0, 0);
  cp_async_commit();
  if (nstages > 1) load_stage(1, 1);
  cp_async_commit();
  for (int s = 0; s < nstages; ++s) {
    cp_async_wait<1>();  // stage s has landed (only s + 1 may be in flight)
    __syncthreads();     // ... for every thread; and stage s - 1's buffer is free
    if (s + 2 < nstages) load_stage(s + 2, (s + 2) % kStages);
    cp_async_commit();
    const float* ws = smem + (s % kStages) * stage_floats;
    const float4* wv = reinterpret_cast<const float4*>(ws);
    const float* hs = ws + kWS;
    float part[kMT][kNT][4];  // this stage's products
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int kh = tap / 3, kw = tap % 3;
      const float* ht = hs + (S == 1 ? kh * tl.hs + kw
                                     : (2 * (kh & 1) + (kw & 1)) * tl.ps + (kh >> 1) * tl.hs +
                                           (kw >> 1));
      uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float4 q = wv[(tap * kNT + j) * 32 + lane];
        bh[j][0] = __float_as_uint(q.x);
        bh[j][1] = __float_as_uint(q.y);
        bl[j][0] = __float_as_uint(q.z);
        bl[j][1] = __float_as_uint(q.w);
      }
      uint32_t ah[kMT][4], al[kMT][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        if (i >= mtiles) break;
        split_tf32(ht[aoff[i][0]], ah[i][0], al[i][0]);
        split_tf32(ht[aoff[i][1]], ah[i][1], al[i][1]);
        split_tf32(ht[aoff[i][0] + cp4], ah[i][2], al[i][2]);
        split_tf32(ht[aoff[i][1] + cp4], ah[i][3], al[i][3]);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        if (i >= mtiles) break;
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_tf32(part[i][j], al[i], bh[j][0], bh[j][1]);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        if (i >= mtiles) break;
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_tf32(part[i][j], ah[i], bl[j][0], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        if (i >= mtiles) break;
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_tf32(part[i][j], ah[i], bh[j][0], bh[j][1]);
      }
    }
    // the stage's sums join the running ones in float32, rounded to nearest
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kMT; ++i) {
    if (i >= mtiles) break;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int p = (i * kWarps + warp) * 16 + g + 8 * hh;
      if (p >= npos) continue;
      const int y = y0 + p / tl.tw, xo = x0 + p % tl.tw;
      if (y >= out.h || xo >= out.w) continue;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        out.store(n, j * 8 + 2 * t, z, y, xo, acc[i][j][2 * hh]);
        out.store(n, j * 8 + 2 * t + 1, z, y, xo, acc[i][j][2 * hh + 1]);
      }
    }
  }
}

// The tile of a launch: whole output rows where the width fits the block's
// positions (else column tiles of one row), the row tiles of a plane equal,
// and the 3-stage ring within kMaxSmem. Returns the dynamic shared memory
// in bytes, 0 if no tile fits.
template <int CO, int S>
size_t plan_tile(int oh, int ow, Tile& tl) {
  constexpr int kNT = CO / 8;
  constexpr int kPositions = kWarps * (16 / kNT) * 16;
  constexpr int kWS = 9 * kNT * 128;
  int tw = ow < kPositions ? ow : kPositions;
  int th_max = kPositions / tw < oh ? kPositions / tw : oh;
  for (;;) {
    const int tiles_h = (oh + th_max - 1) / th_max;
    tl.th = (oh + tiles_h - 1) / tiles_h;
    tl.tw = tw;
    tl.tiles_w = (ow + tw - 1) / tw;
    tl.hs = tw + (S == 1 ? 2 : 1);
    tl.ps = (tl.th + (S == 1 ? 2 : 1)) * tl.hs;
    const int halo = S == 1 ? tl.ps : 4 * tl.ps;
    tl.cp = halo <= 8 ? 8 : (halo - 8 + 31) / 32 * 32 + 8;
    const size_t bytes = sizeof(float) * kStages * ((size_t)kWS + (size_t)kChunk * tl.cp);
    if (bytes <= (size_t)kMaxSmem) return bytes;
    if (th_max > 1) {
      --th_max;
    } else if (tw > 16) {
      tw = (tw + 1) / 2;
    } else {
      return 0;
    }
  }
}

template <int CO, int S>
cudaError_t launch(const float* x, int n, int ci, int d, int h, int w, const float* wpk,
                   int wkd, const Out& o, cudaStream_t s) {
  Tile tl;
  const size_t bytes = plan_tile<CO, S>(o.h, o.w, tl);
  if (bytes == 0 || !conv::grid_fits(n, o.d, o.h, o.w, tl.th, tl.tw))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      conv_tc_kernel<CO, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(((o.h + tl.th - 1) / tl.th) * tl.tiles_w, o.d, n);
  conv_tc_kernel<CO, S><<<grid, kThreads, bytes, s>>>(x, ci, d, h, w, wpk, wkd, o, tl);
  return cudaGetLastError();
}

// One float of the staged weights (pack_tf32_weight's layout, (ceil(Ci /
// 8), wkd, 9, Co / 8, 32, 4)) per thread, from the torch weight w (Co, Ci,
// wkd, 3, 3) (wkd = 3, or 1: the 2D weight (Co, Ci, 3, 3)), or with `flip`
// (wkd 3) from w (Ci, Co, 3, 3, 3) flipped in every spatial dim: the input
// gradient's weights (flip_transpose).
__global__ void pack_kernel(const float* __restrict__ w, int co, int ci, int wkd, int flip,
                            float* __restrict__ out, int total) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= total) return;
  const int e = o & 3, l = (o >> 2) & 31, nt = co / 8;
  int r = o >> 7;
  const int j = r % nt;
  r /= nt;
  const int tap = r % 9;
  r /= 9;
  const int kd = r % wkd, cc = r / wkd;
  const int c = 8 * cc + (l & 3) + 4 * (e & 1), oc = 8 * j + (l >> 2);
  float v = 0.f;
  if (c < ci) {
    const int kh = tap / 3, kw = tap % 3;
    v = flip ? w[(((size_t)c * co + oc) * 3 + 2 - kd) * 9 + (2 - kh) * 3 + 2 - kw]
             : w[(((size_t)oc * ci + c) * wkd + kd) * 9 + tap];
  }
  uint32_t hi, lo;
  split_tf32(v, hi, lo);
  out[o] = __uint_as_float(e < 2 ? hi : lo);
}

// The launch of one conv: Co 32 or 64, stride 1 or 2, weights of wkd depth
// taps (pack_kernel's layout).
cudaError_t run(const float* x, int n, int ci, int d, int h, int w, int stride,
                const float* wpk, int wkd, const Out& o, cudaStream_t s) {
  if (o.co == 32)
    return stride == 1 ? launch<32, 1>(x, n, ci, d, h, w, wpk, wkd, o, s)
                       : launch<32, 2>(x, n, ci, d, h, w, wpk, wkd, o, s);
  if (o.co == 64)
    return stride == 1 ? launch<64, 1>(x, n, ci, d, h, w, wpk, wkd, o, s)
                       : launch<64, 2>(x, n, ci, d, h, w, wpk, wkd, o, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The staged weights of conv3d_tc_cuda (wkd 3) or conv2d_tc_cuda (wkd 1)
// into wpk (pack_tf32_weight's layout for Co, Ci): from w (Co, Ci, 3, 3, 3)
// or (Co, Ci, 3, 3), or with flip (wkd 3 only) from w (Ci, Co, 3, 3, 3) as
// flip_transpose gives them (the input gradient of a conv with weights w).
// Float32, contiguous, on `device`; Co is 32 or 64. Launches on `stream`,
// returns the cudaError_t of the launch.
int conv3d_tc_pack_cuda(const void* w, int co, int ci, int wkd, int flip, void* wpk,
                        void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((co != 32 && co != 64) || ci < 1 || (wkd != 1 && wkd != 3) || (flip && wkd != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const int total = (ci + 7) / 8 * wkd * 9 * co * 16;
  pack_kernel<<<(total + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), co, ci, wkd, flip, static_cast<float*>(wpk), total);
  return static_cast<int>(cudaGetLastError());
}

// x (N, Ci, D, H, W); wpk the split, fragment-ordered weights of
// conv3d_tc_pack_cuda (ops/cuda/conv3d.py::pack_tf32_weight's layout) for
// the torch weight (Co, Ci, 3, 3, 3); mul, add (Co,); stride 1 or 2
// (padding 1 either way, so the output is (D - 1) / stride + 1 per dim);
// res (N, Co, D', H', W') of the output's shape or null; out (N, Co, D',
// H', W'). All float32, contiguous, on `device`. Co is 32 or 64. Launches
// on `stream`, does not synchronise, returns the cudaError_t of the launch
// (0 on success).
int conv3d_tc_cuda(const void* x, int n, int ci, int d, int h, int w, int stride,
                   const void* wpk, int co, const void* mul, const void* add, const void* res,
                   int relu, void* out, void* stream, int device) {
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: set it to the tensors' device
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ci < 1 || d < 1 || h < 1 || w < 1 || (stride != 1 && stride != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int od = (d - 1) / stride + 1, oh = (h - 1) / stride + 1, ow = (w - 1) / stride + 1;
  return static_cast<int>(run(static_cast<const float*>(x), n, ci, d, h, w, stride,
                              static_cast<const float*>(wpk), 3,
                              conv::make_out(out, mul, add, res, co, od, oh, ow, relu),
                              static_cast<cudaStream_t>(stream)));
}

// x (N, Ci, H, W) -> out (N, Co, H, W), the 3x3 stride-1 pad-1 2D conv;
// wpk the packing of the torch weight (Co, Ci, 3, 3) (conv3d_tc_pack_cuda
// with wkd 1). Otherwise as conv3d_tc_cuda.
int conv2d_tc_cuda(const void* x, int n, int ci, int h, int w, const void* wpk, int co,
                   const void* mul, const void* add, const void* res, int relu, void* out,
                   void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ci < 1 || h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(run(static_cast<const float*>(x), n, ci, 1, h, w, 1,
                              static_cast<const float*>(wpk), 1,
                              conv::make_out(out, mul, add, res, co, 1, h, w, relu),
                              static_cast<cudaStream_t>(stream)));
}

const char* conv3d_tc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
