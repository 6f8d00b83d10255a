// One whole PointNet++ set-abstraction scale for Hopper (sm_90a), float32:
// ball query, gather, the factored first layer, BN0 + ReLU, the MLP chain
// on the tensor cores and the max over each ball.
//
// Replaces the TPU kernel disprcnn_tpu/ops/pallas/sa_fused.py
// (sa_ball_mlp_max: _kernel_t, the default, and _kernel; the retired _b,
// _l and _g forms compute the same function). For centre m of cloud b:
//   idx  = the first S points j in index order with
//          ((dx*dx + dy*dy) + dz*dz) < r^2 (each operation rounded on its
//          own, so the selection is the plain version's exactly); a partial
//          ball repeats its first neighbour, an empty ball takes point 0;
//   x0   = relu((v[j] + ((gx*w0x[0] + gy*w0x[1]) + gz*w0x[2])) * mul0 + add0)
//          with (gx, gy, gz) = xyz[j] - centre in float32: v holds mlp0's
//          feature columns applied at the N source points plus its bias;
//   x_l  = relu(x_{l-1} W_l + b_l), the folded-BN chain;
//   out  = max over the S rows of the ball of the last x.
// The float32 form (sa_cuda) is float32 in and out at float32 accuracy: the
// ball query and x0 in float32 on the CUDA cores, the chain's products in
// 3xTF32 on the tensor cores (mlp_tc.cuh).
// The bf16 form (sa_bf16_cuda, a bf16 model's) follows the TPU kernel's
// _kernel_t (sa_fused.py:316-337) step by step: v is bf16 and gathered
// exactly; each centred offset is formed in float32 and rounded to bf16
// (ctd); the xyz term is three bf16 products bf16(w0x[k]) * ctd[k] and two
// bf16 adds, (t0 + t1) + t2, each rounded; x = v[j] + pos is a bf16 add;
// then BN0's affine x * mul0 + add0 and the ReLU in float32 (the product
// and the sum each rounded, not fused), rounded to bf16; then the chain in
// its bf16 form (mlp_tc.cuh: bf16 weights, float32 sums, each layer's
// output rounded) and the max over the ball, bf16 out.
//
// Bound on an H100 SXM: operations. The chain's products dominate: RCNN
// SA0 at the headline budget (2048 clouds, 128 balls of 64, 128 -> 128 ->
// 128) is 1.1 TFLOP of the ~2.1 TFLOP a request's eight sites need (~31 ms
// at 67 TFLOP/s on the float32 cores, ~13 ms at the 3xTF32 tensor-core
// rate of 495 / 3 TFLOP/s); every site's inputs and outputs move in well
// under 1 ms.
//
// Design: one block of 256 threads per (cloud, tile of T = R / S centres),
// R = 64 rows where two blocks' shared memory fits on an SM (else 32 or
// 16; else the largest tile that fits), two blocks an SM (at most 128
// registers a thread), so that one block's ball query and gather overlap
// the other's products. The block stages the cloud in shared memory, 512
// points at a time; one warp per centre scans them by ballot and popc, 32
// a step in index order, until S are found. The block then gathers the R
// rows of x0 into shared memory (its width padded to a multiple of 8 with
// zeros; the rows' offsets and the columns' w0x, mul0, add0 staged first,
// v read 16 bytes at a time, 8 loads in flight a thread) and runs the
// chain (mlp_tc.cuh: each layer an R x Co x Ci product on mma.sync,
// between two shared buffers, the last one reduced in registers into the
// max over each ball). Only the (B, M, C_last) result is written. The
// weights are split and fragment-ordered once per launch by pack_kernel
// (sa_pack_cuda, or sa_pack_bf16_cuda for the bf16 form, one launch
// before). The bf16 form stages its activations as bf16 pairs (half the
// shared memory a row) and gathers v 8 bytes at a time.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mlp_tc.cuh"

namespace {

using mlp_tc::kFull;
using mlp_tc::kThreads;
constexpr size_t kMaxShared = 232448;  // bytes of shared memory a block may use
// ... and at most, for two blocks on one SM (228 KB, 1 KB reserved a block)
constexpr size_t kTwoBlocksShared = 113 * 1024;

constexpr int kPts = 512;    // points of the cloud staged per round of the ball query
constexpr int kGather = 8;   // x0 elements a thread loads before it stores any

// MT M-tiles of 16 rows: a tile of R = 16 MT rows, T = R / s centres. Two
// blocks an SM (at most 128 registers a thread), so that one block's ball
// query and gather overlap the other's products. V is the type of v, of
// the activations and of the output: float, or bf16_t for the bf16 form.
template <int MT, typename V>
__global__ void __launch_bounds__(kThreads, 2)
sa_kernel(const float* __restrict__ xyz, const float* __restrict__ centers,
          const V* __restrict__ v, const float* __restrict__ w0x,
          const float* __restrict__ mul0, const float* __restrict__ add0, mlp_tc::Chain chain,
          int n, int m, int s, float r2, int ld0, int ld1, V* __restrict__ out) {
  constexpr int R = 16 * MT;
  constexpr bool kBf16 = std::is_same<V, bf16_t>::value;
  const int c0 = chain.c[0], c0p = mlp_tc::padc<V>(c0);
  extern __shared__ __align__(16) float smem[];
  int* idx = reinterpret_cast<int*>(smem);  // R
  int* found = idx + R;                     // R (one per centre of the tile)
  float* gofs = smem + 2 * R;               // R x 4: a row's neighbour - centre
  float* cst = gofs + 4 * R;                // 5 x c0p: w0x's rows, mul0, add0
  float* pts = cst + 5 * c0p;               // 3 x kPts
  uint32_t* buf0 = reinterpret_cast<uint32_t*>(pts + 3 * kPts);  // R x ld0 words
  uint32_t* buf1 = buf0 + R * ld0;                               // R x ld1 words
  const int tiles = R / s;
  const int b = blockIdx.y, m0 = blockIdx.x * tiles;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* X = xyz + (size_t)b * n * 3;
  const float* C = centers + (size_t)b * m * 3;

  // 1. ball query: the cloud staged kPts points at a time in shared memory
  // (every thread copies); one warp per centre scans them 32 a step in
  // index order until it has S
  for (int t = tid; t < tiles; t += kThreads) found[t] = 0;
  for (int p0 = 0; p0 < n; p0 += kPts) {
    const int np = min(kPts, n - p0);
    __syncthreads();  // the last round's reads (and the counts) are done
    for (int e = tid; e < 3 * np; e += kThreads) pts[e] = X[3 * p0 + e];
    __syncthreads();
    bool more = false;
    for (int t = warp; t < tiles; t += kThreads / 32) {
      const int mc = m0 + t;
      int cnt = found[t];
      if (mc >= m || cnt >= s) continue;
      int* bi = idx + t * s;
      const float cx = C[mc * 3], cy = C[mc * 3 + 1], cz = C[mc * 3 + 2];
      for (int base = 0; base < np && cnt < s; base += 32) {
        const int j = base + lane;
        bool in = false;
        if (j < np) {
          const float dx = __fsub_rn(cx, pts[j * 3]), dy = __fsub_rn(cy, pts[j * 3 + 1]),
                      dz = __fsub_rn(cz, pts[j * 3 + 2]);
          const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                     __fmul_rn(dz, dz));
          in = d2 < r2;
        }
        const unsigned hit = __ballot_sync(kFull, in);
        const int pos = cnt + __popc(hit & ((1u << lane) - 1u));
        if (in && pos < s) bi[pos] = p0 + j;
        cnt += __popc(hit);
      }
      __syncwarp();
      if (lane == 0) found[t] = cnt;
      more = more || cnt < s;
    }
    if (!__syncthreads_or(more)) break;  // (a barrier: the counts are visible)
  }
  // a partial ball repeats its first neighbour, an empty one takes point 0
  for (int t = warp; t < tiles; t += kThreads / 32) {
    int* bi = idx + t * s;
    const int cnt = min(found[t], s);
    const int first = cnt > 0 ? bi[0] : 0;
    for (int k = lane; k < s; k += 32)
      if (k >= cnt) bi[k] = first;
  }
  __syncthreads();

  // 2. x0: gathered feature columns + the centred xyz term, BN0, ReLU; the
  // columns that pad C0 are zero. Each row's offset (neighbour - centre;
  // rounded to bf16 in the bf16 form) and each column's w0x (rounded to
  // bf16 in the bf16 form), mul0 and add0 are staged first; then a thread
  // takes 4 columns of a row at a time (one 16-byte load of v, 8 bytes in
  // bf16, where C0 % 4 == 0) and issues the loads of kGather of them before
  // it computes any (the gathered rows of v come from device memory).
  for (int e = tid; e < 5 * c0p; e += kThreads) {
    const int k = e / c0p, c = e - k * c0p;
    const float* src = k < 3 ? w0x + k * c0 : k == 3 ? mul0 : add0;
    const float val = c < c0 ? __ldg(src + c) : 0.f;
    cst[e] = kBf16 && k < 3 ? bf16_to_float(bf16_rn(val)) : val;
  }
  for (int r = tid; r < R; r += kThreads) {
    const int mc = m0 + r / s, j = idx[r];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float go = mc < m ? X[j * 3 + d] - C[mc * 3 + d] : 0.f;
      gofs[4 * r + d] = kBf16 ? bf16_to_float(bf16_rn(go)) : go;
    }
  }
  __syncthreads();
  const int nq = c0p / 4, total = R * nq;
  const bool vec = (c0 & 3) == 0;  // every row of v 16-byte (bf16: 8-byte) aligned
  for (int e0 = tid; e0 < total; e0 += kThreads * kGather) {
    float4 val[kGather];
#pragma unroll
    for (int u = 0; u < kGather; ++u) {
      const int e = e0 + u * kThreads;
      const int r = e / nq, c = 4 * (e - r * nq);
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e < total && m0 + r / s < m && c < c0) {
        const V* vr = v + ((size_t)b * n + idx[r]) * c0 + c;
        if constexpr (kBf16) {
          if (vec) {
            const uint2 q = __ldg(reinterpret_cast<const uint2*>(vr));
            x = make_float4(__uint_as_float(q.x << 16), __uint_as_float(q.x & 0xffff0000u),
                            __uint_as_float(q.y << 16), __uint_as_float(q.y & 0xffff0000u));
          } else {
            x.x = ldg_float(vr);
            x.y = c + 1 < c0 ? ldg_float(vr + 1) : 0.f;
            x.z = c + 2 < c0 ? ldg_float(vr + 2) : 0.f;
            x.w = c + 3 < c0 ? ldg_float(vr + 3) : 0.f;
          }
        } else if (vec) {
          x = __ldg(reinterpret_cast<const float4*>(vr));
        } else {
          x.x = __ldg(vr);
          x.y = c + 1 < c0 ? __ldg(vr + 1) : 0.f;
          x.z = c + 2 < c0 ? __ldg(vr + 2) : 0.f;
          x.w = c + 3 < c0 ? __ldg(vr + 3) : 0.f;
        }
      }
      val[u] = x;
    }
#pragma unroll
    for (int u = 0; u < kGather; ++u) {
      const int e = e0 + u * kThreads;
      if (e >= total) break;
      const int r = e / nq, c = 4 * (e - r * nq);
      const float4 go = *reinterpret_cast<const float4*>(gofs + 4 * r);
      const float* vx = &val[u].x;
      float y[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int ck = c + k;
        if constexpr (kBf16) {
          // sa_fused.py:326-333, every bf16 operation rounded on its own
          const float t0 = bf16_to_float(bf16_rn(__fmul_rn(cst[ck], go.x)));
          const float t1 = bf16_to_float(bf16_rn(__fmul_rn(cst[c0p + ck], go.y)));
          const float t2 = bf16_to_float(bf16_rn(__fmul_rn(cst[2 * c0p + ck], go.z)));
          const float pos = bf16_to_float(bf16_rn(__fadd_rn(bf16_to_float(bf16_rn(
              __fadd_rn(t0, t1))), t2)));
          const float x = bf16_to_float(bf16_rn(__fadd_rn(vx[k], pos)));
          y[k] = fmaxf(__fadd_rn(__fmul_rn(x, cst[3 * c0p + ck]), cst[4 * c0p + ck]), 0.f);
        } else {
          const float term = (go.x * cst[ck] + go.y * cst[c0p + ck]) + go.z * cst[2 * c0p + ck];
          y[k] = fmaxf((vx[k] + term) * cst[3 * c0p + ck] + cst[4 * c0p + ck], 0.f);
        }
      }
      if (m0 + r / s >= m) y[0] = y[1] = y[2] = y[3] = 0.f;
      if constexpr (kBf16)
        *reinterpret_cast<uint2*>(buf0 + r * ld0 + c / 2) =
            make_uint2(bf16x2_rn(y[0], y[1]), bf16x2_rn(y[2], y[3]));
      else
        *reinterpret_cast<float4*>(buf0 + r * ld0 + c) = make_float4(y[0], y[1], y[2], y[3]);
    }
  }
  __syncthreads();

  V* out_b = out + (size_t)b * m * chain.c[chain.layers];
  if (chain.layers == 0) {  // no layer after mlp0: the max of x0
    const V* x0 = reinterpret_cast<const V*>(buf0);
    const int ldv = ld0 * 4 / static_cast<int>(sizeof(V));
    for (int e = tid; e < tiles * c0; e += kThreads) {
      const int t = e / c0, c = e - t * c0, mc = m0 + t;
      if (mc >= m) continue;
      float mx = elem_to_float(x0[(t * s) * ldv + c]);
      for (int r = 1; r < s; ++r) mx = fmaxf(mx, elem_to_float(x0[(t * s + r) * ldv + c]));
      out_b[(size_t)mc * c0 + c] = elem_from_float<V>(mx);
    }
    return;
  }

  // 3. the chain on the tensor cores, the last layer reduced over each ball
  mlp_tc::chain_max<MT, V>(chain, buf0, ld0, buf1, ld1, min(tiles, m - m0), s,
                           out_b + (size_t)m0 * chain.c[chain.layers]);
}

// bytes of shared memory for rows R, padded C0 c0p and buffers of ld0, ld1
// words
size_t shared_bytes(int rows, int c0p, int ld0, int ld1) {
  return sizeof(float) * ((size_t)rows * (6 + ld0 + ld1) + 5 * c0p + 3 * kPts);
}

template <int MT, typename V>
cudaError_t launch(const float* const (&a)[5], const V* v, const mlp_tc::Chain& chain, int b,
                   int n, int m, int s, float r2, int ld0, int ld1, V* out, cudaStream_t stream) {
  const size_t bytes = shared_bytes(16 * MT, mlp_tc::padc<V>(chain.c[0]), ld0, ld1);
  cudaError_t err = cudaFuncSetAttribute(sa_kernel<MT, V>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int tiles = 16 * MT / s;
  dim3 grid((m + tiles - 1) / tiles, b);
  sa_kernel<MT, V><<<grid, kThreads, bytes, stream>>>(a[0], a[1], v, a[2], a[3], a[4], chain, n,
                                                      m, s, r2, ld0, ld1, out);
  return cudaGetLastError();
}

// Layer l's raw weights (c[l], c[l + 1]), row-major
struct Raw {
  const float* w[mlp_tc::kMaxLayers];
  int c[mlp_tc::kMaxLayers + 1];
  int layers;
};

// The layer that packed word o falls in, and o's offset within it
template <typename T>
__device__ __forceinline__ int packed_layer(const Raw& raw, int o, int* r) {
  int l = 0, base = 0;
  while (o >= base + mlp_tc::packed_words<T>(raw.c[l], raw.c[l + 1])) {
    base += mlp_tc::packed_words<T>(raw.c[l], raw.c[l + 1]);
    ++l;
  }
  *r = o - base;
  return l;
}

// One float of the packed chain per thread: the layers' packings one after
// the other, layer l (pad8(c[l]) / 8 k8 steps, pad8(c[l + 1]) / 8
// N-tiles, 32 lanes, 4): lane l's [hi(k), hi(k + 4), lo(k), lo(k + 4)] of
// row k = 8 kk + l % 4 and column 8 nt + l / 4 (the B fragment), zero
// past the weight's rows and columns.
__global__ void pack_kernel(const Raw raw, float* __restrict__ out, int total) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= total) return;
  int r;
  const int l = packed_layer<float>(raw, o, &r);
  const int e = r & 3, lane = (r >> 2) & 31;
  const int ci = raw.c[l], co = raw.c[l + 1], n8 = mlp_tc::pad8(co) / 8;
  const int nt = (r >> 7) % n8, kk = (r >> 7) / n8;
  const int k = 8 * kk + (lane & 3) + 4 * (e & 1), col = 8 * nt + (lane >> 2);
  const float v = k < ci && col < co ? raw.w[l][(size_t)k * co + col] : 0.f;
  uint32_t hi, lo;
  split_tf32(v, hi, lo);
  out[o] = __uint_as_float(e < 2 ? hi : lo);
}

// The bf16 form's packing, one word per thread: layer l (pad16(c[l]) / 16
// k16 steps, pad16(c[l + 1]) / 8 N-tiles, 32 lanes, 2 words): word e of
// lane l holds the weights of rows k = 16 kk + 8 e + 2 (l % 4) (lower half)
// and k + 1 to column 8 nt + l / 4 (the m16n8k16 B fragment), each rounded
// to bf16 (nearest even), zero past the weight's rows and columns.
__global__ void pack_bf16_kernel(const Raw raw, uint32_t* __restrict__ out, int total) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= total) return;
  int r;
  const int l = packed_layer<bf16_t>(raw, o, &r);
  const int e = r & 1, lane = (r >> 1) & 31;
  const int ci = raw.c[l], co = raw.c[l + 1], n8 = mlp_tc::padc<bf16_t>(co) / 8;
  const int nt = (r >> 6) % n8, kk = (r >> 6) / n8;
  const int k = 16 * kk + 8 * e + 2 * (lane & 3), col = 8 * nt + (lane >> 2);
  const float* w = raw.w[l];
  const float lo = k < ci && col < co ? w[(size_t)k * co + col] : 0.f;
  const float hi = k + 1 < ci && col < co ? w[(size_t)(k + 1) * co + col] : 0.f;
  out[o] = bf16x2_rn(lo, hi);
}

// Raw from the C interface's arguments; false if the chain is not one
int raw_chain(const void* const* weights, const int* chans, int layers, Raw* raw) {
  if (layers < 0 || layers > mlp_tc::kMaxLayers) return 0;
  raw->layers = layers;
  for (int l = 0; l <= layers; ++l) {
    if (chans[l] < 1) return 0;
    raw->c[l] = chans[l];
  }
  for (int l = 0; l < layers; ++l) raw->w[l] = static_cast<const float*>(weights[l]);
  return 1;
}

template <typename T>
int packed_total(const int* chans, int layers) {
  int total = 0;
  for (int l = 0; l < layers; ++l) total += mlp_tc::packed_words<T>(chans[l], chans[l + 1]);
  return total;
}

template <typename T>
int pack(const void* const* weights, const int* chans, int layers, void* wpk, void* stream,
         int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Raw raw;
  if (layers < 1 || !raw_chain(weights, chans, layers, &raw))
    return static_cast<int>(cudaErrorInvalidValue);
  const int total = packed_total<T>(chans, layers);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same<T, float>::value)
    pack_kernel<<<(total + 255) / 256, 256, 0, st>>>(raw, static_cast<float*>(wpk), total);
  else
    pack_bf16_kernel<<<(total + 255) / 256, 256, 0, st>>>(raw, static_cast<uint32_t*>(wpk),
                                                          total);
  return static_cast<int>(cudaGetLastError());
}

template <typename V>
int run(const void* xyz, const void* centers, const void* v, const void* w0x, const void* mul0,
        const void* add0, const void* wpk, const void* const* biases, const int* chans,
        int layers, int b, int n, int m, int s, float r2, void* out, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b < 1 || b > 65535 || n < 1 || m < 1 || s < 1 || s > 64 || layers < 0 ||
      layers > mlp_tc::kMaxLayers)
    return static_cast<int>(cudaErrorInvalidValue);
  mlp_tc::Chain chain;
  chain.layers = layers;
  for (int l = 0; l <= layers; ++l) {
    if (chans[l] < 1) return static_cast<int>(cudaErrorInvalidValue);
    chain.c[l] = chans[l];
  }
  const uint32_t* wp = static_cast<const uint32_t*>(wpk);
  for (int l = 0; l < layers; ++l) {
    chain.wpk[l] = wp;
    wp += mlp_tc::packed_words<V>(chans[l], chans[l + 1]);
    chain.b[l] = static_cast<const float*>(biases[l]);
  }
  int ld0, ld1;
  mlp_tc::buffer_widths<V>(chain, &ld0, &ld1);
  const int c0p = mlp_tc::padc<V>(chans[0]);
  // the largest row tile that holds whole balls and leaves room for two
  // blocks an SM, else the largest that fits
  int mt = 0;
  for (int cand = 4; cand >= 1 && mt == 0; cand /= 2)
    if (16 * cand % s == 0 && shared_bytes(16 * cand, c0p, ld0, ld1) <= kTwoBlocksShared)
      mt = cand;
  for (int cand = 4; cand >= 1 && mt == 0; cand /= 2)
    if (16 * cand % s == 0 && shared_bytes(16 * cand, c0p, ld0, ld1) <= kMaxShared) mt = cand;
  const float* const args[5] = {
      static_cast<const float*>(xyz), static_cast<const float*>(centers),
      static_cast<const float*>(w0x), static_cast<const float*>(mul0),
      static_cast<const float*>(add0)};
  const V* vv = static_cast<const V*>(v);
  V* o = static_cast<V*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidConfiguration;
  if (mt == 4) e = launch<4>(args, vv, chain, b, n, m, s, r2, ld0, ld1, o, st);
  if (mt == 2) e = launch<2>(args, vv, chain, b, n, m, s, r2, ld0, ld1, o, st);
  if (mt == 1) e = launch<1>(args, vv, chain, b, n, m, s, r2, ld0, ld1, o, st);
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

// Floats of the packed chain of sa_pack_cuda for chans = (C0, ...,
// C_layers).
int sa_packed_floats(const int* chans, int layers) { return packed_total<float>(chans, layers); }

// 32-bit words of the packed chain of sa_pack_bf16_cuda.
int sa_packed_words_bf16(const int* chans, int layers) {
  return packed_total<bf16_t>(chans, layers);
}

// The chain's weights[l] (C_l, C_{l+1}) for l < layers (1..4), chans =
// (C0, ..., C_layers), split and fragment-ordered into wpk
// (sa_packed_floats(chans, layers) floats; the plain version is
// ops/cuda/sa.py::pack_tf32_chain). Float32, contiguous, on `device`.
// Launches on `stream`, returns the cudaError_t of the launch.
int sa_pack_cuda(const void* const* weights, const int* chans, int layers, void* wpk,
                 void* stream, int device) {
  return pack<float>(weights, chans, layers, wpk, stream, device);
}

// The same weights (float32) rounded to bf16 and fragment-ordered for the
// bf16 form into wpk (sa_packed_words_bf16(chans, layers) words; the plain
// version is ops/cuda/sa.py::pack_bf16_chain).
int sa_pack_bf16_cuda(const void* const* weights, const int* chans, int layers, void* wpk,
                      void* stream, int device) {
  return pack<bf16_t>(weights, chans, layers, wpk, stream, device);
}

// xyz (B, N, 3), centers (B, M, 3), v (B, N, C0), w0x (3, C0), mul0 and
// add0 (C0,); wpk the packed chain of sa_pack_cuda (null if layers is 0)
// and biases[l] (C_{l+1},) for l < layers (0..4), chans = (C0, ...,
// C_layers); all float32, contiguous. out (B, M, C_layers). S must divide
// 16, 32 or 64. Launches on `stream`, does not synchronise, returns the
// cudaError_t of the launch (0 on success).
int sa_cuda(const void* xyz, const void* centers, const void* v, const void* w0x,
            const void* mul0, const void* add0, const void* wpk, const void* const* biases,
            const int* chans, int layers, int b, int n, int m, int s, float r2, void* out,
            void* stream, int device) {
  return run<float>(xyz, centers, v, w0x, mul0, add0, wpk, biases, chans, layers, b, n, m, s,
                    r2, out, stream, device);
}

// The bf16 form: v (B, N, C0) and out (B, M, C_layers) bf16, wpk the
// packed chain of sa_pack_bf16_cuda; the rest as sa_cuda's (float32).
int sa_bf16_cuda(const void* xyz, const void* centers, const void* v, const void* w0x,
                 const void* mul0, const void* add0, const void* wpk, const void* const* biases,
                 const int* chans, int layers, int b, int n, int m, int s, float r2, void* out,
                 void* stream, int device) {
  return run<bf16_t>(xyz, centers, v, w0x, mul0, add0, wpk, biases, chans, layers, b, n, m, s,
                     r2, out, stream, device);
}

const char* sa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
