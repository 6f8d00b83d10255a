// The PSMNet 3x3x3 and 3x3 convolutions with a fused epilogue on Hopper's
// tensor cores (sm_90a), float32 in and out at float32 accuracy, NCDHW
// (NCHW in 2D). Their bf16 forms are csrc/conv_bf16_wgmma.cu's.
//
// Replaces four TPU kernels of disprcnn_tpu/ops/pallas/packed_conv.py, and
// through the first the train form's forward and input gradient:
//   - _kernel via _conv_call (packed_conv_bn): the stride-1 trunk conv +
//     folded BN + optional residual + optional ReLU, Co 32 and 64 (and
//     packed_conv_train's _pct_fwd/_pct_bwd, which run the same conv);
//   - _kernel_s2 (packed_conv_bn_s2): the hourglass's stride-2 pad-1 conv
//     + BN + ReLU;
//   - _kernel_w (wpacked_conv_bn): the feature tower's 3x3 stride-1 2D conv
//     + BN + optional residual + optional ReLU, Co 32 and 64: the 3D conv at
//     D = 1, where only the middle depth tap is inside the volume, with
//     weights packed for that one tap (conv2d_tc_cuda);
//   - _kernel_dc (packed_deconv_bn): the hourglass's stride-2 transposed
//     3x3x3 conv + BN + optional residual + optional ReLU, Co 32 and 64
//     (deconv3d_tc_cuda): split by output parity into 8 stride-1 convs
//     over the input grid, as _kernel_dc does the op as four spatial-parity
//     products on the MXU (packed_conv.py:376-383); deconv_tc_kernel below.
// The TPU kernels do the conv as matrix products on the MXU with float32
// accumulation (jnp.dot(..., preferred_element_type=jnp.float32)); this is
// their Hopper counterpart. It computes
//   out[n, o, z, y, x] = epilogue(sum_{c, kd, kh, kw}
//       in(n, c, S*z + kd - 1, S*y + kh - 1, S*x + kw - 1) * wt[o, c, kd, kh, kw])
// (stride S = 1 or 2, padding 1, zero outside the volume), the epilogue of
// conv3d.cuh, and the transposed conv
//   out[n, o, z, y, x] = epilogue(sum over in(n, c, i_z, i_y, i_x) *
//       wt[c, o, k_z, k_y, k_x] with 2 * i + k - 1 = output index per dim)
// (torch ConvTranspose3d(k 3, stride 2, padding 1, output_padding 1), whose
// effective padding (1, 2) is the flax padding of the JAX package).
//
// Bound on an H100 SXM: operations. One 56^2 trunk launch (N 128, 32 -> 32,
// D 24) needs ~0.5 TFLOP against ~2.5 GB of input and output: 7.5 ms on
// the float32 cores (67 TFLOP/s), ~3 ms at the 3xTF32 tensor-core rate
// (495 / 3 TFLOP/s), 0.75 ms of memory traffic. The transposed conv at
// 28^2 -> 56^2 (N 128, 64 -> 32, D 12 -> 24) needs ~0.17 TFLOP: 2.5 ms on
// the float32 cores, 1.0 ms at the 3xTF32 rate.
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
// The bf16 forms of these four kernels (and of row 8's train form), as the
// JAX package's bf16 model runs them, are csrc/conv_bf16_wgmma.cu's
// warpgroup body; this source builds the float32 forms only.
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
// Halo layout: per channel a slot of CP words, CP = 8
// (mod 32), so that the A-fragment reads of one instruction (8 positions x
// 4 slots) fall
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
// Transposed conv: the same ring, stages, fragments and promotion over the
// input grid, one block per (input tile, output slice, n);
// deconv_tc_kernel's comment says how its four parity classes share one
// halo. Its epilogue stores each class at stride 2 in x; the block's two
// column classes fill the same output rows, which meet in L2.
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv3d.cuh"

namespace {

using conv::Out;
using tc::AFrag;
using tc::Form;
using tc::Frags;
using tc::mma_tiles;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;
constexpr int kSlots = 8;            // halo slots a stage: 8 channels
constexpr int kMaxSmem = 232448;     // bytes of shared memory a block may take on sm_90

// A launch's tile geometry, the same for every block.
// Its positions are output positions, or input positions for the
// transposed conv.
struct Tile {
  int th, tw, tiles_w;  // rows and columns of positions per block; column tiles per plane
  int hs;               // halo row stride: tw + 2 (stride 1), tw + 1 (stride 2, transposed)
  int ps;               // one halo plane: (th + 2) * hs (stride 1), (th + 1) * hs (the others)
  int cp;               // words per halo slot, >= the slot's halo, = 8 (mod 32)
};

// One halo position of a stage, all kSlots slots: the kSlots channels c0
// .. of src (x at channel c0, this position; channels `plane` apart), zero
// where !ok or past the nc channels left, by one 4-byte cp.async a channel
// (zero-filled).
__device__ __forceinline__ void stage_position(uint32_t* dst, const float* src, const float* any,
                                               bool ok, int nc, size_t plane, int cp) {
#pragma unroll
  for (int c = 0; c < kSlots; ++c) {
    const bool v = ok && c < nc;
    cp_async4(reinterpret_cast<float*>(dst) + c * cp, v ? src + c * plane : any, v);
  }
}

// x (N, Ci, D, H, W); wpk the weights as pack_tf32_weight lays them out:
// (ceil(Ci / 8), wkd, 9 taps, CO / 8 N-tiles, 32 lanes, 4 words), the B
// fragment of each lane ([hi(k), hi(k + 4), lo(k), lo(k + 4)] of input
// channel k = l % 4 of the chunk and output channel l / 4 of the N-tile);
// wkd = 3 depth taps, or 1 (the middle one) for the 2D conv, whose D is 1.
template <int CO, int S>
__global__ void __launch_bounds__(kThreads, 1)
conv_tc_kernel(const float* __restrict__ x, int ci, int d, int h, int w,
               const uint32_t* __restrict__ wpk, int wkd, const Out out, const Tile tl) {
  using F = Form<float>;
  constexpr int kNT = CO / 8;        // N-tiles
  constexpr int kMT = 16 / kNT;      // M-tiles per warp
  constexpr int kWS = 9 * kNT * 32 * F::kLaneWords;  // words of one stage's weights
  extern __shared__ __align__(16) uint32_t smem[];
  const int stage_words = kWS + kSlots * tl.cp;

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
  const int nstages = (ci + F::kChunk - 1) / F::kChunk * nkd;
  const size_t plane = (size_t)d * h * w;
  const float* xn = x + (size_t)n * ci * plane;

  auto load_stage = [&](int s, int buf) {
    const int cc = s / nkd, kd = kd_lo + s % nkd;
    uint32_t* ws = smem + buf * stage_words;
    const uint32_t* wsrc = wpk + (size_t)(cc * wkd + (wkd == 3 ? kd : 0)) * kWS;
    for (int i = threadIdx.x; i < kWS / 4; i += kThreads)
      cp_async16(reinterpret_cast<float*>(ws) + 4 * i,
                 reinterpret_cast<const float*>(wsrc) + 4 * i);
    uint32_t* hs = ws + kWS;
    const int c0 = cc * F::kChunk;
    const int nc = min(F::kChunk, ci - c0);
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
        stage_position(hs + off + (S == 1 ? e : (e & 1) * tl.ps + (e >> 1)),
                          ok ? xs + (size_t)yin * w + xin : x, x, ok, nc, plane, tl.cp);
      }
    }
  };

  // this lane's A rows: positions g and g + 8 of each of its M-tiles, as
  // halo offsets (slot t); positions past the tile read offset 0
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
  const int cp4 = 4 * tl.cp;  // slot t + 4

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
    const uint32_t* ws = smem + (s % kStages) * stage_words;
    const uint32_t* hs = ws + kWS;
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
      const uint32_t* ht = hs + (S == 1 ? kh * tl.hs + kw
                                        : (2 * (kh & 1) + (kw & 1)) * tl.ps + (kh >> 1) * tl.hs +
                                              (kw >> 1));
      Frags<float> b[kNT];
#pragma unroll
      for (int j = 0; j < kNT; ++j) b[j].load_b(ws, (tap * kNT + j) * 32 + lane);
      AFrag<float> a[kMT];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        if (i >= mtiles) break;
        a[i].load(ht, aoff[i][0], aoff[i][1], cp4);
      }
      mma_tiles(part, a, b, mtiles);
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

// The transposed conv, torch ConvTranspose3d(k 3, stride 2, padding 1,
// output_padding 1): x (N, Ci, D, H, W) -> (N, CO, 2D, 2H, 2W). Per axis an
// even output 2m takes tap k 1 at input m, an odd output 2m + 1 taps k 2 at
// input m and k 0 at input m + 1 (zero past the edge): each of the 8
// output-parity classes is a stride-1 conv over the input grid with input
// offsets {0} or {0, +1} per axis, 27 taps over the classes per input
// position and none of them zero. A block takes one output slice (its
// depth parity fixes the depth taps: 1 for an even slice, 2 for an odd one,
// staged as the forward conv stages its depth taps) and a tile of th x tw
// input positions for all four (row, column) parity classes; its halo is
// the tile plus one row and one column on the high side. Tap (kh, kw)
// reads the halo at input offset (kh == 0, kw == 0) and feeds class (kh !=
// 1, kw != 1), so the 9 taps of a stage need 4 A fragments. Warp w holds
// M-tile w / (CO / 32) and 32 of the output channels (N-tiles 4 (w % (CO /
// 32)) .. + 3) for all 4 classes: 64 float32 accumulators a thread, so a
// block takes 128 input positions at CO 32 and 64 at CO 64. wpk is
// pack_tf32_deconv_weight's layout: the conv's packing of the (CO, Ci)
// weight w[c, o, kd, kh, kw].
template <int CO>
__global__ void __launch_bounds__(kThreads, 1)
deconv_tc_kernel(const float* __restrict__ x, int ci, int d, int h, int w,
                 const uint32_t* __restrict__ wpk, const Out out, const Tile tl) {
  using F = Form<float>;
  constexpr int kNT = CO / 8;        // N-tiles
  constexpr int kWN = CO / 32;       // warps along N, 4 N-tiles each
  constexpr int kWS = 9 * kNT * 32 * F::kLaneWords;  // words of one stage's weights
  extern __shared__ __align__(16) uint32_t smem[];
  const int stage_words = kWS + kSlots * tl.cp;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp / kWN, nw = warp % kWN;
  const int r0 = (blockIdx.x / tl.tiles_w) * tl.th;  // the input tile's origin
  const int c0 = (blockIdx.x % tl.tiles_w) * tl.tw;
  const int zo = blockIdx.y;  // the output slice, 2 m + pz
  const int n = blockIdx.z;
  const int npos = tl.th * tl.tw;
  const int m = zo >> 1, pz = zo & 1;

  // depth taps: an even slice kd 1 at input slice m; an odd one kd 2 at m
  // and kd 0 at m + 1, if inside the volume
  const int nkd = pz == 0 ? 1 : (m + 1 < d ? 2 : 1);
  const int nstages = (ci + F::kChunk - 1) / F::kChunk * nkd;
  const size_t plane = (size_t)d * h * w;
  const float* xn = x + (size_t)n * ci * plane;

  auto load_stage = [&](int s, int buf) {
    const int cc = s / nkd, tz = s % nkd;
    const int kd = pz == 0 ? 1 : (tz == 0 ? 2 : 0);
    uint32_t* ws = smem + buf * stage_words;
    const uint32_t* wsrc = wpk + (size_t)(cc * 3 + kd) * kWS;
    for (int i = threadIdx.x; i < kWS / 4; i += kThreads)
      cp_async16(reinterpret_cast<float*>(ws) + 4 * i,
                 reinterpret_cast<const float*>(wsrc) + 4 * i);
    uint32_t* hs = ws + kWS;
    const int c0c = cc * F::kChunk;
    const int nc = min(F::kChunk, ci - c0c);
    const float* xs = xn + (size_t)c0c * plane + (size_t)(m + tz) * h * w;
    // halo rows r0 .. r0 + th, columns c0 .. c0 + tw
    for (int r = warp; r <= tl.th; r += kWarps) {
      const int yin = r0 + r;
      for (int e = lane; e < tl.hs; e += 32) {
        const int xin = c0 + e;
        const bool ok = yin < h && xin < w;
        stage_position(hs + r * tl.hs + e, ok ? xs + (size_t)yin * w + xin : x, x, ok, nc,
                          plane, tl.cp);
      }
    }
  };

  // this lane's A rows: positions g and g + 8 of its M-tile, as halo
  // offsets (slot t); positions past the tile read offset 0
  int aoff[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int p = mt * 16 + g + 8 * hh;
    aoff[hh] = (p < npos ? (p / tl.tw) * tl.hs + p % tl.tw : 0) + t * tl.cp;
  }
  const bool active = mt * 16 < npos;  // warp-uniform
  const int cp4 = 4 * tl.cp;           // slot t + 4

  float acc[4][4][4];  // (class 2 py + px, N-tile, fragment)
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][j][e] = 0.f;

  load_stage(0, 0);
  cp_async_commit();
  if (nstages > 1) load_stage(1, 1);
  cp_async_commit();
  for (int s = 0; s < nstages; ++s) {
    cp_async_wait<1>();  // stage s has landed (only s + 1 may be in flight)
    __syncthreads();     // ... for every thread; and stage s - 1's buffer is free
    if (s + 2 < nstages) load_stage(s + 2, (s + 2) % kStages);
    cp_async_commit();
    if (!active) continue;
    const uint32_t* ws = smem + (s % kStages) * stage_words;
    const uint32_t* hs = ws + kWS;
    float part[4][1][4][4];  // this stage's products (class, M-tile, N-tile, fragment)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[q][0][j][e] = 0.f;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        AFrag<float> a[1];
        a[0].load(hs + dy * tl.hs + dx, aoff[0], aoff[1], cp4);
        // the taps at this offset: kh 0 (dy 1) or 1, 2 (dy 0); kw alike
#pragma unroll
        for (int kh = dy ? 0 : 1; kh < (dy ? 1 : 3); ++kh) {
#pragma unroll
          for (int kw = dx ? 0 : 1; kw < (dx ? 1 : 3); ++kw) {
            const int tap = kh * 3 + kw, q = 2 * (kh != 1) + (kw != 1);
            Frags<float> b[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j].load_b(ws, (tap * kNT + nw * 4 + j) * 32 + lane);
            mma_tiles(part[q], a, b, 1);
          }
        }
      }
    }
    // the stage's sums join the running ones in float32, rounded to nearest
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][j][e] += part[q][0][j][e];
  }
  cp_async_wait<0>();
  if (!active) return;

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int p = mt * 16 + g + 8 * hh;
    if (p >= npos) continue;
    const int yi = r0 + p / tl.tw, xi = c0 + p % tl.tw;
    if (yi >= h || xi >= w) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int yo = 2 * yi + (q >> 1), xo = 2 * xi + (q & 1);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = (nw * 4 + j) * 8 + 2 * t;
        out.store(n, o, zo, yo, xo, acc[q][j][2 * hh]);
        out.store(n, o + 1, zo, yo, xo, acc[q][j][2 * hh + 1]);
      }
    }
  }
}

// The tile of a launch over a grid of oh x ow positions: whole rows where
// the width fits the block's `positions` (else column tiles of one row),
// the row tiles of a plane equal, and the 3-stage ring within kMaxSmem. A
// tile's halo is `planes` planes of (th + ext) x (tw + ext); a stage holds
// `ws` words of weights. Returns the dynamic shared memory in bytes, 0 if
// no tile fits.
size_t plan_tile(int positions, int ws, int ext, int planes, int oh, int ow, Tile& tl) {
  int tw = ow < positions ? ow : positions;
  int th_max = positions / tw < oh ? positions / tw : oh;
  for (;;) {
    const int tiles_h = (oh + th_max - 1) / th_max;
    tl.th = (oh + tiles_h - 1) / tiles_h;
    tl.tw = tw;
    tl.tiles_w = (ow + tw - 1) / tw;
    tl.hs = tw + ext;
    tl.ps = (tl.th + ext) * tl.hs;
    const int halo = planes * tl.ps;
    tl.cp = halo <= 8 ? 8 : (halo - 8 + 31) / 32 * 32 + 8;
    const size_t bytes = sizeof(uint32_t) * kStages * ((size_t)ws + (size_t)kSlots * tl.cp);
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
cudaError_t launch(const float* x, int n, int ci, int d, int h, int w, const uint32_t* wpk,
                   int wkd, const Out& o, cudaStream_t s) {
  constexpr int kNT = CO / 8;
  Tile tl;
  const size_t bytes = plan_tile(kWarps * (16 / kNT) * 16, 9 * kNT * 32 * Form<float>::kLaneWords,
                                 S == 1 ? 2 : 1, S == 1 ? 1 : 4, o.h, o.w, tl);
  if (bytes == 0 || !conv::grid_fits(n, o.d, o.h, o.w, tl.th, tl.tw))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      conv_tc_kernel<CO, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(((o.h + tl.th - 1) / tl.th) * tl.tiles_w, o.d, n);
  conv_tc_kernel<CO, S><<<grid, kThreads, bytes, s>>>(x, ci, d, h, w, wpk, wkd, o, tl);
  return cudaGetLastError();
}

// The forms of a weight the packings read: the torch conv weight (Co, Ci,
// wkd, 3, 3) (wkd = 3, or 1: the 2D weight (Co, Ci, 3, 3)); or (wkd 3) w
// (Ci, Co, 3, 3, 3) flipped in every spatial dim, the input gradient's
// weights (flip_transpose); or (wkd 3) the torch ConvTranspose3d weight
// (Ci, Co, 3, 3, 3) as it is, the transposed conv's.
enum PackForm { kConv = 0, kFlip = 1, kDeconv = 2 };

// The weight from input channel c to output channel oc at depth tap kd and
// tap (kh, kw) of w in the given form.
__device__ __forceinline__ float weight_at(const float* __restrict__ w, int co, int ci, int wkd,
                                           int form, int c, int oc, int kd, int tap) {
  const int kh = tap / 3, kw = tap % 3;
  return form == kFlip     ? w[(((size_t)c * co + oc) * 3 + 2 - kd) * 9 + (2 - kh) * 3 + 2 - kw]
         : form == kDeconv ? w[(((size_t)c * co + oc) * 3 + kd) * 9 + tap]
                           : w[(((size_t)oc * ci + c) * wkd + kd) * 9 + tap];
}

// One float of the staged weights (pack_tf32_weight's layout, (ceil(Ci /
// 8), wkd, 9, Co / 8, 32, 4)) per thread, from w in the given form.
__global__ void pack_kernel(const float* __restrict__ w, int co, int ci, int wkd, int form,
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
  const float v = c < ci ? weight_at(w, co, ci, wkd, form, c, oc, kd, tap) : 0.f;
  uint32_t hi, lo;
  split_tf32(v, hi, lo);
  out[o] = __uint_as_float(e < 2 ? hi : lo);
}

// The launch of one conv: Co 32 or 64, stride 1 or 2, weights of wkd depth
// taps (the packing's layout).
cudaError_t run(const float* x, int n, int ci, int d, int h, int w, int stride,
                const uint32_t* wpk, int wkd, const Out& o, cudaStream_t s) {
  if (o.co == 32)
    return stride == 1 ? launch<32, 1>(x, n, ci, d, h, w, wpk, wkd, o, s)
                       : launch<32, 2>(x, n, ci, d, h, w, wpk, wkd, o, s);
  if (o.co == 64)
    return stride == 1 ? launch<64, 1>(x, n, ci, d, h, w, wpk, wkd, o, s)
                       : launch<64, 2>(x, n, ci, d, h, w, wpk, wkd, o, s);
  return cudaErrorInvalidValue;
}

// The transposed conv's launch: a tile of the input grid, its halo one
// plane of (th + 1) x (tw + 1), a block per (tile, output slice, n).
template <int CO>
cudaError_t launch_deconv(const float* x, int n, int ci, int d, int h, int w, const uint32_t* wpk,
                          const Out& o, cudaStream_t s) {
  constexpr int kNT = CO / 8;
  Tile tl;
  const size_t bytes =
      plan_tile(16 * kWarps / (CO / 32), 9 * kNT * 32 * Form<float>::kLaneWords, 1, 1, h, w, tl);
  if (bytes == 0 || !conv::grid_fits(n, o.d, h, w, tl.th, tl.tw)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      deconv_tc_kernel<CO>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(((h + tl.th - 1) / tl.th) * tl.tiles_w, o.d, n);
  deconv_tc_kernel<CO><<<grid, kThreads, bytes, s>>>(x, ci, d, h, w, wpk, o, tl);
  return cudaGetLastError();
}

bool pack_args_ok(int co, int ci, int wkd, int form) {
  return (co == 32 || co == 64) && ci >= 1 && (wkd == 1 || wkd == 3) && form >= kConv &&
         form <= kDeconv && (form == kConv || wkd == 3);
}

int conv3d_entry(const void* x, int n, int ci, int d, int h, int w, int stride, const void* wpk,
                 int co, const void* mul, const void* add, const void* res, int relu, void* out,
                 void* stream, int device) {
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: set it to the tensors' device
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ci < 1 || d < 1 || h < 1 || w < 1 || (stride != 1 && stride != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int od = (d - 1) / stride + 1, oh = (h - 1) / stride + 1, ow = (w - 1) / stride + 1;
  return static_cast<int>(run(static_cast<const float*>(x), n, ci, d, h, w, stride,
                              static_cast<const uint32_t*>(wpk), 3,
                              conv::make_out(out, mul, add, res, co, od, oh, ow, relu),
                              static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" {

// The staged weights of conv3d_tc_cuda (wkd 3), conv2d_tc_cuda (wkd 1) or
// deconv3d_tc_cuda into wpk (pack_tf32_weight's layout for Co, Ci): with
// form 0 from w (Co, Ci, 3, 3, 3) or (Co, Ci, 3, 3); with form 1 (wkd 3)
// from w (Ci, Co, 3, 3, 3) as flip_transpose gives them (the input
// gradient of a conv with weights w); with form 2 (wkd 3) from the torch
// ConvTranspose3d weight w (Ci, Co, 3, 3, 3) (pack_tf32_deconv_weight).
// Float32, contiguous, on `device`; Co is 32 or 64. Launches on `stream`,
// returns the cudaError_t of the launch.
int conv3d_tc_pack_cuda(const void* w, int co, int ci, int wkd, int form, void* wpk,
                        void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!pack_args_ok(co, ci, wkd, form)) return static_cast<int>(cudaErrorInvalidValue);
  const int total = (ci + 7) / 8 * wkd * 9 * co * 16;
  pack_kernel<<<(total + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), co, ci, wkd, form, static_cast<float*>(wpk), total);
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
  return conv3d_entry(x, n, ci, d, h, w, stride, wpk, co, mul, add, res, relu, out, stream,
                      device);
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
                              static_cast<const uint32_t*>(wpk), 1,
                              conv::make_out(out, mul, add, res, co, 1, h, w, relu),
                              static_cast<cudaStream_t>(stream)));
}

// x (N, Ci, D, H, W) -> out (N, Co, 2D, 2H, 2W), the transposed conv of
// torch ConvTranspose3d(k 3, stride 2, padding 1, output_padding 1); wpk the
// packing of its weight (Ci, Co, 3, 3, 3) by conv3d_tc_pack_cuda with form
// 2; res of the output's shape or null. Otherwise as conv3d_tc_cuda.
int deconv3d_tc_cuda(const void* x, int n, int ci, int d, int h, int w, const void* wpk,
                     int co, const void* mul, const void* add, const void* res, int relu,
                     void* out, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ci < 1 || d < 1 || h < 1 || w < 1 || (co != 32 && co != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const conv::Out o = conv::make_out(out, mul, add, res, co, 2 * d, 2 * h, 2 * w, relu);
  const float* xt = static_cast<const float*>(x);
  const uint32_t* wt = static_cast<const uint32_t*>(wpk);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(co == 32 ? launch_deconv<32>(xt, n, ci, d, h, w, wt, o, s)
                                   : launch_deconv<64>(xt, n, ci, d, h, w, wt, o, s));
}

const char* conv3d_tc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
