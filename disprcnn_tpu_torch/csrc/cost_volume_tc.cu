// The PSMNet cost volume and its first 3x3x3 conv + folded BN + ReLU, for
// Hopper (sm_90a), float32 in and out at float32 accuracy, and its bf16
// form, NCHW features and an NCDHW output.
//
// Replaces disprcnn_tpu/ops/pallas/packed_conv.py's cost_volume_conv_bn
// (_kernel_cv): the concat cost volume of the (N, C, H, W) left and right
// features (slice z at disparity i = mind + z holds left[c, y, x] and
// right[c, y, x - i], both only where 0 <= x - i < W) fed to the conv to
// Co outputs, the volume never stored.
//
// What it computes: the volume's mask depends only on the input column, so
// the conv's channel and row sums are done once per column and view, as
// tap planes
//   PL[n, kd, kw, o, y, x] = sum_{c, kh} wt[o, c, kd, kh, kw] * left[n, c, y + kh - 1, x]
//   PR[n, kd, kw, o, y, x] = sum_{c, kh} wt[o, C + c, kd, kh, kw] * right[n, c, y + kh - 1, x]
// (rows outside [0, H) zero), and
//   out[n, o, z, y, x] = epilogue(sum_{kd, kw} PL[.., x'] + PR[.., x' - i'])
// over the taps with slice z + kd - 1 in [0, D), x' = x + kw - 1 in [0, W)
// and x' - i' in [0, W), i' = mind + z + kd - 1: exact, with no per-column
// corrections (the depth padding slices are zero, as _kernel_cv zeroes
// them). The dense conv does D times the products (~1 TFLOP at the main
// path's shapes, N 128, C 32, Co 32, 56^2, D 24); the planes take ~44 GFLOP
// and each output at most 18 adds. Its plain version is
// ops/cuda/conv3d.py::cost_volume_conv_bn_planes_plain.
//
// Bound on an H100 SXM: the output's bytes (1.23 GB at the main path's
// shapes, 0.37 ms at 3.35 TB/s) against the planes' operations (0.66 ms on
// the float32 cores, ~0.27 ms at the 3xTF32 tensor-core rate).
//
// Design: two launches, after the weight packing (cv_pack_kernel, one
// launch; its plain version is pack_tf32_cost_volume_weight).
// 1. planes_kernel: per view, a GEMM of M = the N H W positions, K = (C
//    channels, 3 kh) against N = (3 kd, 3 kw, Co), on the tensor cores as
//    conv3d_tc.cu does it: 3xTF32 mma.sync.m16n8k8 (tf32.cuh), the input
//    split in registers, the weights split and fragment-ordered. A block
//    takes one view, one kd (N = 3 Co: 12 or 24 N-tiles) and 128 (Co 32)
//    or 64 (Co 64) positions flattened over (n, y, x); each of its 8 warps
//    2 M-tiles x 6 N-tiles. A stage is one chunk of 8 channels: its 3 kh
//    rows of the block's positions (row kh of position (y, x) is input row
//    y + kh - 1, so the A tile of one kh is the positions shifted by a
//    whole row, zero outside the image) and the weights of (chunk, 3 kh);
//    a ring of 3 stages filled by cp.async two ahead, each stage's mma
//    sums promoted into the running float32 sums (the mma's own adds
//    truncate). The planes go to device memory, (2, N, H, 9, Co, W), 32
//    bytes of consecutive positions per store.
// 2. sum_kernel: one block per (y, group of 8 output channels, n) stages
//    the 18 planes' rows of its channels in shared memory (contiguous in
//    the planes' layout), then each thread takes one (channel, column x)
//    and walks the slices with its 9 PL values in registers: per output at
//    most 9 PR reads from shared memory (lanes on consecutive columns) and
//    18 adds, then conv3d.cuh's epilogue, stored as whole rows. Bound by
//    the output's writes, it runs at under half of that rate: latency
//    holds it (a thread summing 2, 4 or 8 channels at once, sharing each
//    tap's masks, was slower at every count: fewer threads an SM).
// The planes' round trip (0.92 GB written and read at the main path's
// shapes, ~0.55 ms at 3.35 TB/s) is the cost of the two launches; the
// fused form would keep one row's planes in shared memory.
//
// The bf16 form (cost_volume_tc_bf16_cuda), the kernel of the JAX
// package's bf16 model (_kernel_cv on bf16 features, packed_conv.py:37-91):
// bf16 features in, the weights rounded to bf16 by their packing
// (cost_volume_tc_pack_bf16_cuda; plain version ops/cuda/conv3d.py::
// pack_bf16_cost_volume_weight), the planes' products on the tensor cores
// as one bf16 mma.m16n8k16 (bf16.cuh) into float32 sums, the planes and
// their masked sums float32, BN and ReLU in float32, one rounding to bf16
// (nearest even) at the store. A stage is 16 channels, staged as channel
// pairs in 32-bit words (loaded and packed through registers: no cp.async
// copies 2 bytes), so the A fragments are read at the float32 form's
// offsets. Bound at the main path's shapes: the bf16 output's 0.62 GB,
// 0.18 ms at 3.35 TB/s.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"
#include "conv3d.cuh"

namespace {

using conv::OutT;
using tc::AFrag;
using tc::Form;
using tc::Frags;
using tc::mma_tiles;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;
constexpr int kSlots = 8;         // staged rows of a kh: 8 channels (float), 8 channel pairs (bf16)
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may take on sm_90

// The planes GEMM's block shape at Co output channels: each warp 2 M-tiles
// x 6 N-tiles, the warps split as kWM (M) x kWN (N); T the form (Form:
// input channels a stage, weight words a lane).
template <typename T, int CO>
struct Planes {
  static constexpr int kNT = 3 * CO / 8;          // N-tiles of one kd: (kw, o)
  static constexpr int kWN = kNT / 6;             // warps along N
  static constexpr int kWM = kWarps / kWN;        // warps along M
  static constexpr int kM = kWM * 32;             // positions per block
  static constexpr int kCP = kM + 8;              // words per staged row, 8 (mod 32)
  static constexpr int kWS = 3 * kNT * 32 * Form<T>::kLaneWords;  // words of one stage's weights
  static constexpr int kStage = kWS + 3 * kSlots * kCP;  // words of one stage
  static constexpr size_t kSmem = sizeof(uint32_t) * kStages * kStage;
};

// The weight wt[o, v C + ch, kd, kh, kw] of the torch weight w (Co, 2C, 3,
// 3, 3) for plane column col = kw * Co + o.
__device__ __forceinline__ float cv_weight(const float* __restrict__ w, int co, int c, int v,
                                           int ch, int kd, int kh, int col) {
  const int kw = col / co, oc = col % co;
  return w[(((size_t)oc * 2 * c + v * c + ch) * 3 + kd) * 9 + kh * 3 + kw];
}

// One float of the staged weights per thread, from the torch weight w (Co,
// 2C, 3, 3, 3) into pack_tf32_cost_volume_weight's layout: (2 views, 3 kd,
// ceil(C / 8), 3 kh, 3 Co / 8, 32 lanes, 4).
__global__ void cv_pack_kernel(const float* __restrict__ w, int co, int c,
                               float* __restrict__ out, int total) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= total) return;
  const int e = o & 3, l = (o >> 2) & 31, nt = 3 * co / 8, ci8 = (c + 7) / 8;
  int r = o >> 7;
  const int j = r % nt;
  r /= nt;
  const int kh = r % 3;
  r /= 3;
  const int cc = r % ci8;
  r /= ci8;
  const int kd = r % 3, v = r / 3;
  const int ch = 8 * cc + (l & 3) + 4 * (e & 1), col = 8 * j + (l >> 2);
  const float val = ch < c ? cv_weight(w, co, c, v, ch, kd, kh, col) : 0.f;
  uint32_t hi, lo;
  split_tf32(val, hi, lo);
  out[o] = __uint_as_float(e < 2 ? hi : lo);
}

// One word of the bf16 staged weights per thread, into
// pack_bf16_cost_volume_weight's layout: (2 views, 3 kd, ceil(C / 16), 3
// kh, 3 Co / 8, 32 lanes, 2): lane l's word e holds channels 16 cc + 2 (l %
// 4) + 8 e and the next one of column 8 j + l / 4, rounded to bf16 (nearest
// even), the lower channel in the lower half.
__global__ void cv_pack_bf16_kernel(const float* __restrict__ w, int co, int c,
                                    uint32_t* __restrict__ out, int total) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= total) return;
  const int e = o & 1, l = (o >> 1) & 31, nt = 3 * co / 8, ci16 = (c + 15) / 16;
  int r = o >> 6;
  const int j = r % nt;
  r /= nt;
  const int kh = r % 3;
  r /= 3;
  const int cc = r % ci16;
  r /= ci16;
  const int kd = r % 3, v = r / 3;
  const int ch = 16 * cc + 2 * (l & 3) + 8 * e, col = 8 * j + (l >> 2);
  const float lo = ch < c ? cv_weight(w, co, c, v, ch, kd, kh, col) : 0.f;
  const float hi = ch + 1 < c ? cv_weight(w, co, c, v, ch + 1, kd, kh, col) : 0.f;
  out[o] = bf16x2_rn(lo, hi);
}

// planes (2, N, H, 9, CO, W), float32, of view blockIdx.z (0 left, 1 right)
// and depth tap blockIdx.y, positions blockIdx.x * kM .. + kM - 1 of the N
// H W; left and right in T.
template <typename T, int CO>
__global__ void __launch_bounds__(kThreads, 1)
planes_kernel(const T* __restrict__ left, const T* __restrict__ right, int nimg, int c, int h,
              int w, const uint32_t* __restrict__ wpk, float* __restrict__ planes) {
  using P = Planes<T, CO>;
  constexpr int kChunk = Form<T>::kChunk;
  extern __shared__ __align__(16) uint32_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int mw = warp % P::kWM, nw = warp / P::kWM;
  const int kd = blockIdx.y, view = blockIdx.z;
  const int hw = h * w;
  const int total = nimg * hw;
  const int p0 = blockIdx.x * P::kM;
  const int nchunks = (c + kChunk - 1) / kChunk;
  const T* x = view == 0 ? left : right;
  const uint32_t* wsrc0 = wpk + (size_t)(view * 3 + kd) * nchunks * P::kWS;

  // the A rows this thread stages: position m (kThreads is a multiple of
  // kM), and from it the image and pixel; staged row r = (kh, slot)
  const int m = threadIdx.x % P::kM;
  const int p = p0 + m;
  const bool p_ok = p < total;
  const int pn = p_ok ? p / hw : 0, pq = p_ok ? p % hw : 0;
  const int py = pq / w;
  const T* xp = x + (size_t)pn * c * hw + pq;

  auto load_stage = [&](int cc, int buf) {
    uint32_t* ws = smem + buf * P::kStage;
    const uint32_t* wsrc = wsrc0 + (size_t)cc * P::kWS;
    for (int i = threadIdx.x; i < P::kWS / 4; i += kThreads)
      cp_async16(reinterpret_cast<float*>(ws) + 4 * i,
                 reinterpret_cast<const float*>(wsrc) + 4 * i);
    uint32_t* as = ws + P::kWS;
    const int c0 = cc * kChunk;
    for (int r = threadIdx.x / P::kM; r < 3 * kSlots; r += kThreads / P::kM) {
      const int kh = r / kSlots, q = r % kSlots;
      const int yy = py + kh - 1;
      const bool row_ok = p_ok && yy >= 0 && yy < h;
      if constexpr (Form<T>::kBf16) {
        // channels 2q, 2q + 1 of the chunk, loaded and stored as one pair
        const unsigned short* src = reinterpret_cast<const unsigned short*>(xp) +
                                    (size_t)(c0 + 2 * q) * hw + (kh - 1) * w;
        const bf16_t lo = row_ok && c0 + 2 * q < c ? __ldg(src) : 0;
        const bf16_t hi = row_ok && c0 + 2 * q + 1 < c ? __ldg(src + hw) : 0;
        as[r * P::kCP + m] = bf16_pack(lo, hi);
      } else {
        const int ch = c0 + q;
        const bool ok = row_ok && ch < c;
        cp_async4(reinterpret_cast<float*>(as) + r * P::kCP + m,
                  ok ? xp + (size_t)ch * hw + (kh - 1) * w : x, ok);
      }
    }
  };

  float acc[2][6][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // this lane's A rows: positions g and g + 8 of each of its M-tiles
  const int a0 = mw * 32 + g + t * P::kCP;
  constexpr int cp4 = 4 * P::kCP;  // slot t + 4

  load_stage(0, 0);
  cp_async_commit();
  if (nchunks > 1) load_stage(1, 1);
  cp_async_commit();
  for (int s = 0; s < nchunks; ++s) {
    cp_async_wait<1>();  // stage s has landed (only s + 1 may be in flight)
    __syncthreads();     // ... for every thread; and stage s - 1's buffer is free
    if (s + 2 < nchunks) load_stage(s + 2, (s + 2) % kStages);
    cp_async_commit();
    const uint32_t* ws = smem + (s % kStages) * P::kStage;
    const uint32_t* as = ws + P::kWS;
    float part[2][6][4];  // this stage's products
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 6; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      Frags<T> b[6];
#pragma unroll
      for (int j = 0; j < 6; ++j) b[j].load_b(ws, (kh * P::kNT + nw * 6 + j) * 32 + lane);
      const uint32_t* ak = as + kh * kSlots * P::kCP + a0;
      AFrag<T> a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) a[i].load(ak + 16 * i, 0, 8, cp4);
      mma_tiles(part, a, b, 2);
    }
    // the stage's sums join the running ones in float32, rounded to nearest
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 6; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
  cp_async_wait<0>();

  // column 8 j' + 2t (+1) of the kd group is (kw, o) = divmod(., CO): plane
  // kd * 3 + kw, channel o; one plane row's columns are contiguous
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int pp = p0 + mw * 32 + 16 * i + g + 8 * hh;
      if (pp >= total) continue;
      const int n = pp / hw, q = pp % hw;
      float* dst = planes + (((size_t)(view * nimg + n) * h + q / w) * 9 + kd * 3) * CO * w +
                   q % w;
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const int col = (nw * 6 + j) * 8 + 2 * t;
        dst[(size_t)col * w] = acc[i][j][2 * hh];
        dst[(size_t)(col + 1) * w] = acc[i][j][2 * hh + 1];
      }
    }
  }
}

// Output channels of a sum_kernel block.
constexpr int kOG = 8;

// out[n, o, z, y, x] for row y = blockIdx.x, channels kOG * blockIdx.y ..
// + kOG - 1, image n = blockIdx.z; its 2 x 9 x kOG plane rows staged first.
// A thread takes one (channel, column x) and a run of zlen slices, with
// its 9 PL values in registers. The sums are float32 either way; T is the
// output's type.
template <typename T>
__global__ void __launch_bounds__(kThreads)
sum_kernel(const float* __restrict__ planes, int nimg, int h, int w, int mind, int zlen,
           const OutT<T> out) {
  extern __shared__ float rows[];  // (2 views, 9 taps, kOG, w)
  const int y = blockIdx.x, o0 = blockIdx.y * kOG, n = blockIdx.z;
  const int co = out.co, d = out.d;
  const int tap_stride = kOG * w;
  // the block's rows: kOG consecutive channels of each (view, tap), contiguous
  for (int i = threadIdx.x; i < 18 * tap_stride; i += blockDim.x) {
    const int r = i / tap_stride, e = i % tap_stride;
    rows[i] = __ldg(planes + (((size_t)((r / 9) * nimg + n) * h + y) * 9 + r % 9) * co * w +
                    (size_t)o0 * w + e);
  }
  __syncthreads();
  const int zgroups = (d + zlen - 1) / zlen;
  for (int item = threadIdx.x; item < zgroups * tap_stride; item += blockDim.x) {
    const int x = item % w, o = item / w % kOG, z0 = item / tap_stride * zlen;
    const int z1 = min(d, z0 + zlen);
    const float* pl = rows + o * w;              // PL of tap k at pl[k * tap_stride + x']
    const float* pr = rows + (9 * kOG + o) * w;  // PR alike
    float lv[9];  // PL at column x + kw - 1
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const int xq = x + k % 3 - 1;
      lv[k] = (unsigned)xq < (unsigned)w ? pl[k * tap_stride + xq] : 0.f;
    }
    for (int z = z0; z < z1; ++z) {
      float s = 0.f;
#pragma unroll
      for (int kd = 0; kd < 3; ++kd) {
        const int zz = z + kd - 1;
        if ((unsigned)zz >= (unsigned)d) continue;
        const int u0 = x - (mind + zz);  // the right view's column at kw 1
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const int u = u0 + kw - 1;
          if ((unsigned)(x + kw - 1) < (unsigned)w && (unsigned)u < (unsigned)w)
            s += lv[kd * 3 + kw] + pr[(kd * 3 + kw) * tap_stride + u];
        }
      }
      out.store(n, o0 + o, z, y, x, s);
    }
  }
}

// the sum's staged rows, 2 x 9 x kOG of w floats
size_t sum_bytes(int w) { return sizeof(float) * 18 * kOG * (size_t)w; }

template <typename T>
cudaError_t launch_sum(const float* planes, int n, int h, int w, int mind, const OutT<T>& o,
                       cudaStream_t s) {
  const size_t bytes = sum_bytes(w);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sum_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  // runs of slices per (channel, column), so that a block has ~kThreads items
  const int zgroups = max(1, min(o.d, kThreads / (kOG * w)));
  const int zlen = (o.d + zgroups - 1) / zgroups;
  const int items = (o.d + zlen - 1) / zlen * kOG * w;
  const dim3 grid(h, o.co / kOG, n);
  sum_kernel<T><<<grid, min(kThreads, (items + 31) / 32 * 32), bytes, s>>>(planes, n, h, w, mind,
                                                                           zlen, o);
  return cudaGetLastError();
}

template <typename T, int CO>
cudaError_t launch_planes(const T* left, const T* right, int n, int c, int h, int w,
                          const uint32_t* wpk, float* planes, cudaStream_t s) {
  using P = Planes<T, CO>;
  cudaError_t err = cudaFuncSetAttribute(
      planes_kernel<T, CO>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::kSmem);
  if (err != cudaSuccess) return err;
  const long long total = (long long)n * h * w;
  const dim3 grid((unsigned)((total + P::kM - 1) / P::kM), 3, 2);
  planes_kernel<T, CO><<<grid, kThreads, P::kSmem, s>>>(left, right, n, c, h, w, wpk, planes);
  return cudaGetLastError();
}

template <typename T>
int cost_volume_entry(const void* left, const void* right, int n, int c, int h, int w, int mind,
                      int d, const void* wpk, int co, const void* mul, const void* add, int relu,
                      void* planes, void* out, void* stream, int device) {
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: set it to the tensors' device
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (c < 1 || (co != 32 && co != 64) || !conv::grid_fits(n, d, h, w, 1, w) ||
      (long long)n * h * w > 2147483647LL || sum_bytes(w) > (size_t)kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* l = static_cast<const T*>(left);
  const T* r = static_cast<const T*>(right);
  const uint32_t* wp = static_cast<const uint32_t*>(wpk);
  float* pl = static_cast<float*>(planes);
  err = co == 32 ? launch_planes<T, 32>(l, r, n, c, h, w, wp, pl, s)
                 : launch_planes<T, 64>(l, r, n, c, h, w, wp, pl, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_sum<T>(
      pl, n, h, w, mind, conv::make_out<T>(out, mul, add, nullptr, co, d, h, w, relu), s));
}

}  // namespace

extern "C" {

// The staged plane weights of cost_volume_tc_cuda into wpk
// (pack_tf32_cost_volume_weight's layout for Co, C) from the torch weight w
// (Co, 2C, 3, 3, 3). Float32, contiguous, on `device`; Co is 32 or 64.
// Launches on `stream`, returns the cudaError_t of the launch.
int cost_volume_tc_pack_cuda(const void* w, int co, int c, void* wpk, void* stream,
                             int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((co != 32 && co != 64) || c < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int total = 2 * 3 * ((c + 7) / 8) * 3 * (3 * co / 8) * 128;
  cv_pack_kernel<<<(total + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), co, c, static_cast<float*>(wpk), total);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 form's staged plane weights (pack_bf16_cost_volume_weight's
// layout) from the float32 torch weight w (Co, 2C, 3, 3, 3), rounded to
// bf16 to nearest even. Otherwise as cost_volume_tc_pack_cuda.
int cost_volume_tc_pack_bf16_cuda(const void* w, int co, int c, void* wpk, void* stream,
                                  int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((co != 32 && co != 64) || c < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int total = 2 * 3 * ((c + 15) / 16) * 3 * (3 * co / 8) * 64;
  cv_pack_bf16_kernel<<<(total + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), co, c, static_cast<uint32_t*>(wpk), total);
  return static_cast<int>(cudaGetLastError());
}

// left, right (N, C, H, W); the cost volume has D slices, slice z at
// disparity mind + z, and 2C channels; wpk the packing of the torch weight
// (Co, 2C, 3, 3, 3) by cost_volume_tc_pack_cuda; mul, add (Co,); planes
// (2, N, H, 9, Co, W), scratch the first launch fills and the second reads;
// out (N, Co, D, H, W). All float32, contiguous, on `device`. Co is 32 or
// 64; W is at most 403 (the sum's staged rows fill a block's shared
// memory). Launches both kernels on `stream`, does not synchronise,
// returns the first failing launch's cudaError_t (0 on success).
int cost_volume_tc_cuda(const void* left, const void* right, int n, int c, int h, int w,
                        int mind, int d, const void* wpk, int co, const void* mul,
                        const void* add, int relu, void* planes, void* out, void* stream,
                        int device) {
  return cost_volume_entry<float>(left, right, n, c, h, w, mind, d, wpk, co, mul, add, relu,
                                  planes, out, stream, device);
}

// cost_volume_tc_cuda's bf16 form: left, right and out bf16, wpk from
// cost_volume_tc_pack_bf16_cuda; the planes' products on the tensor cores
// in bf16 into float32 sums, the planes and their masked sums float32, the
// epilogue in float32, one rounding to bf16 at the store.
int cost_volume_tc_bf16_cuda(const void* left, const void* right, int n, int c, int h, int w,
                             int mind, int d, const void* wpk, int co, const void* mul,
                             const void* add, int relu, void* planes, void* out, void* stream,
                             int device) {
  return cost_volume_entry<bf16_t>(left, right, n, c, h, w, mind, d, wpk, co, mul, add, relu,
                                   planes, out, stream, device);
}

const char* cost_volume_tc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
