// Fused trilinear upsample + softmax over disparity + expected disparity,
// for Hopper (sm_90a), float32 logits or bf16 ones, float32 out. The PSMNet
// eval regression head.
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
// ~0.02 ms; the FP32 work ~0.09 ms at 67 TFLOP/s, which binds. Within a
// segment exp(z - m) is a geometric sequence, so the function needs two
// exponentials a segment, ~0.07 ms at the SFU's 16 a clock per SM; this
// design takes one per (pixel, disparity), 617 M, 0.147 ms of SFU time.
//
// Design: one thread per output pixel (b, y, x). It interpolates the D4
// logits of its pixel bilinearly in H and W into registers v[0..D4), then
// walks the D interpolation segment by segment: the disparities k of
// segment s lie between v[s] and v[s + 1], z_k = v[s] + f_k (v[s + 1] -
// v[s]), so with the segments unrolled at compile time every v[s] stays a
// register (no stack frame). The taps (each segment's first k and count,
// and f_k) are built once on the host with exact division, as the plain
// version's interpolation matrix. z is linear in f_k within a segment, so
// the softmax's max over D is the max over each segment's two ends; then
// one pass, with no branch on the data, takes exp(z - m) as ex2 of
// (z - m) log2(e), the scale folded into each segment's two constants, and
// sums exp and exp * j (j the place in the segment) per segment before
// adding the segment to the pixel's totals (shorter chains of rounding than
// one sum over D, and places >= 0: no cancellation); mindisp is added to
// the expected place last. Two kernels:
// - softargmin_fixed_kernel, for the main path's (D4, D) = (24, 96): the
//   whole walk is one unrolled sequence of compile-time taps (immediates;
//   the host checks them against the wrapper's table), a block is one
//   output row, so no division finds the pixel. Issue-bound: four
//   instructions a disparity beside its exponential.
// - softargmin_kernel<NV>, for any D4 <= NV (NV = 4, 8, 16, 24, 32, 48, 64)
//   and D <= 512: the table comes as a kernel argument, each segment's
//   disparities are a loop.
// The bf16 form (softargmin_bf16_cuda), the head of the JAX package's bf16
// model: bf16 logits in, each converted to float32 as it is read (exact),
// then the same float32 walk, float32 out. JAX's bf16 model casts the
// classifier's bf16 cost to float32 before fused_softargmin
// (psmnet.py:1008-1011), so the two forms compute the same function of the
// same values: the bf16 form equals the float32 form on the logits cast up.
// (JAX's XLA route, psmnet.py:1012-1020, interpolates and takes the softmax
// in bf16; the port follows the kernel route, as the TPU runs it.)
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "bf16.cuh"

#include <utility>

namespace {

constexpr int kMaxD4 = 64;
constexpr int kMaxD = 512;
constexpr int kThreads = 256;
constexpr int kMaxW = 1024;  // columns of a row, one block (fixed kernel)
constexpr float kLog2e = 1.4426950408889634f;

// The D interpolation's taps (ops/cuda/softargmin.py::disparity_segments):
// segment s (0 <= s < max(D4 - 1, 1)) holds the disparities first[s] ..
// first[s] + count[s] - 1, whose positions are s + fk[k].
struct Segments {
  float fk[kMaxD];
  int16_t first[kMaxD4];
  int16_t count[kMaxD4];
};

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

// 2^x, one SFU instruction; a result below 2^-126 flushes to 0 (a term
// below 1e-38 of the largest, which is 1).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The output pixel (bi, y, x)'s D4 logits (T: float or bf16, read as
// float32), interpolated bilinearly in H and W with
// the align-corners taps, into v[0..d4) (v[s] = 0 for d4 <= s < NV). The
// four taps' weights are formed once; a slice reads two rows through two
// pointers. kUnitTaps: the caller guarantees h4, w4 >= 2, so x1 = x0 + 1 is
// an immediate offset.
template <typename T, int NV, bool kUnitTaps>
__device__ __forceinline__ void bilinear(const T* __restrict__ logits, int d4, int h4,
                                         int w4, int h, int w, int bi, int y, int x,
                                         float (&v)[NV]) {
  int y0, y1, x0, x1;
  float fy, fx;
  taps(y, h4, h, y0, y1, fy);
  taps(x, w4, w, x0, x1, fx);
  const int hw = h4 * w4, dx = kUnitTaps ? 1 : x1 - x0;
  const T* r0 = logits + (size_t)bi * d4 * hw + y0 * w4 + x0;
  const T* r1 = r0 + (y1 - y0) * w4;
  const float w00 = (1.f - fy) * (1.f - fx), w01 = (1.f - fy) * fx;
  const float w10 = fy * (1.f - fx), w11 = fy * fx;
#pragma unroll
  for (int s = 0; s < NV; ++s) {
    v[s] = 0.f;
    if (s < d4) {
      const T* p0 = r0 + s * hw;
      const T* p1 = r1 + s * hw;
      v[s] = fmaf(w11, ldg_float(p1 + dx),
                  fmaf(w10, ldg_float(p1), fmaf(w01, ldg_float(p0 + dx), w00 * ldg_float(p0))));
    }
  }
}

// Any D4 <= NV and D <= kMaxD: the segments come as a __grid_constant__
// argument, read in place from the parameter bank (uniform loads), never
// copied to the stack; each segment's disparities are a loop.
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
softargmin_kernel(const T* __restrict__ logits, int b, int d4, int h4, int w4, int h,
                  int w, int mindisp, const __grid_constant__ Segments seg,
                  float* __restrict__ out) {
  static_assert(NV >= 2, "the walk reads v[s + 1] for s < NV - 1");
  constexpr int kSeg = NV - 1;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= b * h * w) return;
  float v[NV];
  bilinear<T, NV, false>(logits, d4, h4, w4, h, w, idx / (w * h), (idx / w) % h, idx % w, v);
  const int nseg = d4 > 1 ? d4 - 1 : 1;

  // the max over D: z is linear in f within a segment, so at one of its ends
  float m = -CUDART_INF_F;
#pragma unroll
  for (int s = 0; s < kSeg; ++s) {
    const int cnt = seg.count[s];
    if (s < nseg && cnt > 0) {
      const float a = v[s], g = (s + 1 < d4 ? v[s + 1] : a) - a;  // D4 = 1: z = v[0]
      const int k0 = seg.first[s];
      m = fmaxf(m, fmaxf(fmaf(seg.fk[k0], g, a), fmaf(seg.fk[k0 + cnt - 1], g, a)));
    }
  }

  float sum = 0.f, dsum = 0.f;
#pragma unroll
  for (int s = 0; s < kSeg; ++s) {
    const int cnt = seg.count[s];
    if (s < nseg && cnt > 0) {
      const float a = v[s], g = (s + 1 < d4 ? v[s + 1] : a) - a;
      const float gl = g * kLog2e, al = (a - m) * kLog2e;
      const int k0 = seg.first[s];
      float ss = 0.f, sj = 0.f, j = 0.f;
      for (int k = k0; k < k0 + cnt; ++k) {
        const float e = ex2(fmaf(seg.fk[k], gl, al));
        ss += e;
        sj = fmaf(e, j, sj);
        j += 1.f;
      }
      sum += ss;
      dsum += fmaf((float)k0, ss, sj);
    }
  }
  out[idx] = (float)mindisp + dsum / sum;
}

// The D interpolation's taps at compile time, as disparity_segments builds
// them on the host: position k (d4 - 1) / (d - 1) correctly rounded in
// float32, segment min(floor(position), d4 - 2), fraction position -
// segment. The host checks that they equal the wrapper's table before it
// takes softargmin_fixed_kernel.
__host__ __device__ constexpr float tap_pos(int k, int d4, int d) {
  return (float)(k * (d4 - 1)) / (float)(d - 1);
}
__host__ __device__ constexpr int tap_seg(int k, int d4, int d) {
  return (int)tap_pos(k, d4, d) < d4 - 2 ? (int)tap_pos(k, d4, d) : d4 - 2;
}
__host__ __device__ constexpr float tap_frac(int k, int d4, int d) {
  return tap_pos(k, d4, d) - (float)tap_seg(k, d4, d);
}
__host__ __device__ constexpr int tap_first(int s, int d4, int d) {
  int k = 0;
  while (tap_seg(k, d4, d) < s) ++k;
  return k;
}

// Disparity K of the (D4, D) walk, every quantity a compile-time constant:
// its segment S, its place J in S, its tap F, whether it ends S.
template <int D4, int D, int K>
struct Tap {
  static constexpr int S = tap_seg(K, D4, D);
  static constexpr int First = tap_first(S, D4, D);
  static constexpr int J = K - First;
  static constexpr float F = tap_frac(K, D4, D);
  static constexpr bool Last = K == D - 1 || tap_seg(K + 1, D4, D) != S;
};

// The walk's running values: the max, the totals, and the open segment's
// sums and constants.
struct Walk {
  float m, sum, dsum, ss, sj, gl, al;
};

// The max over D takes the two ends of each segment.
template <int D4, int D, int K>
__device__ __forceinline__ void max_at(const float (&v)[D4], Walk& w) {
  using T = Tap<D4, D, K>;
  if constexpr (T::J == 0 || T::Last)
    w.m = fmaxf(w.m, fmaf(T::F, v[T::S + 1] - v[T::S], v[T::S]));
}

template <int D4, int D, int K>
__device__ __forceinline__ void exp_at(const float (&v)[D4], Walk& w) {
  using T = Tap<D4, D, K>;
  if constexpr (T::J == 0) {
    w.gl = (v[T::S + 1] - v[T::S]) * kLog2e;
    w.al = (v[T::S] - w.m) * kLog2e;
  }
  const float e = ex2(fmaf(T::F, w.gl, w.al));
  if constexpr (T::J == 0) {
    w.ss = e;
    w.sj = 0.f;
  } else {
    w.ss += e;
    w.sj = fmaf(e, (float)T::J, w.sj);
  }
  if constexpr (T::Last) {
    w.sum += w.ss;
    w.dsum += fmaf((float)T::First, w.ss, w.sj);
  }
}

// The expected place k in [0, D), sum_k k exp(z_k - m) / sum_k exp(z_k - m).
template <int D4, int D, int... K>
__device__ __forceinline__ float walk(const float (&v)[D4], std::integer_sequence<int, K...>) {
  Walk w = {-CUDART_INF_F, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  (max_at<D4, D, K>(v, w), ...);
  (exp_at<D4, D, K>(v, w), ...);
  return w.dsum / w.sum;
}

// (D4, D) fixed, as on the main path (24, 96): the walk is one unrolled
// sequence in which every segment, tap and place is a constant, so the taps
// are immediates and no loop or table read is left. A block is one output
// row (blockIdx.y, of ROI blockIdx.z), a thread one column: no division to
// find the pixel. Needs h4, w4 >= 2 and W <= kMaxW.
template <typename T, int D4, int D>
__global__ void __launch_bounds__(kMaxW)
softargmin_fixed_kernel(const T* __restrict__ logits, int h4, int w4, int h, int w,
                        int mindisp, float* __restrict__ out) {
  static_assert(D4 >= 2 && D >= D4, "every segment holds a disparity");
  const int x = threadIdx.x, y = blockIdx.y, bi = blockIdx.z;
  if (x >= w) return;
  float v[D4];
  bilinear<T, D4, true>(logits, D4, h4, w4, h, w, bi, y, x, v);
  out[((size_t)bi * h + y) * w + x] =
      (float)mindisp + walk<D4, D>(v, std::make_integer_sequence<int, D>{});
}

// Whether the wrapper's table equals the compile-time taps of (D4, D).
template <int D4, int D>
bool fixed_taps_match(int d4, int d, const float* fk, const int16_t* first,
                      const int16_t* count) {
  if (d4 != D4 || d != D) return false;
  for (int k = 0; k < D; ++k)
    if (fk[k] != tap_frac(k, D4, D)) return false;
  for (int s = 0; s < D4 - 1; ++s) {
    const int next = s + 1 < D4 - 1 ? tap_first(s + 1, D4, D) : D;
    if (first[s] != tap_first(s, D4, D) || count[s] != next - tap_first(s, D4, D))
      return false;
  }
  return true;
}

template <typename T, int NV>
cudaError_t launch(const T* logits, int b, int d4, int h4, int w4, int h, int w, int mindisp,
                   const Segments& seg, float* out, unsigned blocks, cudaStream_t stream) {
  softargmin_kernel<T, NV><<<blocks, kThreads, 0, stream>>>(logits, b, d4, h4, w4, h, w,
                                                            mindisp, seg, out);
  return cudaGetLastError();
}

template <typename T>
int softargmin_entry(const void* logits, int b, int d4, int h4, int w4, int h, int w,
                     int mindisp, int maxdisp, const void* fk, const void* first,
                     const void* count, void* out, void* stream, int device) {
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: set it to the tensors' device
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int d = maxdisp - mindisp;
  if (b < 1 || d4 < 1 || d4 > kMaxD4 || h4 < 1 || w4 < 1 || h < 1 || w < 1 || d < 1 ||
      d > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = (long long)b * h * w;  // pixels index as int
  if (total > 2147483647LL - kThreads) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (total + kThreads - 1) / kThreads;
  const T* x = static_cast<const T*>(logits);
  const float* tf = static_cast<const float*>(fk);
  const int16_t* t0 = static_cast<const int16_t*>(first);
  const int16_t* tc = static_cast<const int16_t*>(count);
  float* o = static_cast<float*>(out);
  const unsigned nb = static_cast<unsigned>(blocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (h4 >= 2 && w4 >= 2 && w <= kMaxW && h <= 65535 && b <= 65535 &&
      fixed_taps_match<24, 96>(d4, d, tf, t0, tc)) {
    const dim3 grid(1, h, b);
    softargmin_fixed_kernel<T, 24, 96><<<grid, (w + 31) / 32 * 32, 0, st>>>(x, h4, w4, h, w,
                                                                           mindisp, o);
    return static_cast<int>(cudaGetLastError());
  }
  Segments seg = {};
  for (int k = 0; k < d; ++k) seg.fk[k] = tf[k];
  for (int s = 0; s < (d4 > 1 ? d4 - 1 : 1); ++s) {
    seg.first[s] = t0[s];
    seg.count[s] = tc[s];
  }
  if (d4 <= 4) err = launch<T, 4>(x, b, d4, h4, w4, h, w, mindisp, seg, o, nb, st);
  else if (d4 <= 8) err = launch<T, 8>(x, b, d4, h4, w4, h, w, mindisp, seg, o, nb, st);
  else if (d4 <= 16) err = launch<T, 16>(x, b, d4, h4, w4, h, w, mindisp, seg, o, nb, st);
  else if (d4 <= 24) err = launch<T, 24>(x, b, d4, h4, w4, h, w, mindisp, seg, o, nb, st);
  else if (d4 <= 32) err = launch<T, 32>(x, b, d4, h4, w4, h, w, mindisp, seg, o, nb, st);
  else if (d4 <= 48) err = launch<T, 48>(x, b, d4, h4, w4, h, w, mindisp, seg, o, nb, st);
  else err = launch<T, 64>(x, b, d4, h4, w4, h, w, mindisp, seg, o, nb, st);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// logits (B, D4, h4, w4) float32, contiguous, D4 <= 64; out (B, H, W)
// float32; D = maxdisp - mindisp <= 512. fk (D floats), first and count
// (max(D4 - 1, 1) int16 each): the D taps by segment, as
// ops/cuda/softargmin.py::disparity_segments builds them. Launches on
// `stream`, does not synchronise, returns the cudaError_t of the launch (0
// on success).
int softargmin_cuda(const void* logits, int b, int d4, int h4, int w4, int h, int w,
                    int mindisp, int maxdisp, const void* fk, const void* first,
                    const void* count, void* out, void* stream, int device) {
  return softargmin_entry<float>(logits, b, d4, h4, w4, h, w, mindisp, maxdisp, fk, first,
                                 count, out, stream, device);
}

// softargmin_cuda's bf16 form: logits bf16, read as float32; out float32.
int softargmin_bf16_cuda(const void* logits, int b, int d4, int h4, int w4, int h, int w,
                         int mindisp, int maxdisp, const void* fk, const void* first,
                         const void* count, void* out, void* stream, int device) {
  return softargmin_entry<bf16_t>(logits, b, d4, h4, w4, h, w, mindisp, maxdisp, fk, first,
                                  count, out, stream, device);
}

const char* softargmin_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
