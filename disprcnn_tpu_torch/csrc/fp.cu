// PointNet++ feature propagation for Hopper (sm_90a), float32: 3-NN,
// inverse-distance interpolation, the skip features concatenated, and the
// folded-BN MLP chain on the tensor cores.
//
// Replaces the TPU kernel disprcnn_tpu/ops/pallas/fp_fused.py:_kernel
// (entry fp_fused). For target point n of cloud b:
//   the 3 source points with the smallest ((dx*dx + dy*dy) + dz*dz), each
//   operation rounded on its own, ties to the lowest index (so the
//   selection is the plain version's exactly);
//   d_k = sqrt(max(d2_k, 0)), r_k = 1 / (d_k + eps), w_k = r_k / ((r_0 +
//   r_1) + r_2);
//   x = [(f[i0] w0 + f[i1] w1) + f[i2] w2, skip[n]], then x = relu(x W_l +
//   b_l) for each layer.
// The float32 form (fp_cuda) is float32 in and out at float32 accuracy:
// the chain's products in 3xTF32 on the tensor cores (mlp_tc.cuh, the
// set-abstraction kernel's chain). The bf16 form (fp_bf16_cuda, a bf16
// model's) follows the TPU kernel: the known and skip features are bf16;
// the three neighbours and their weights in float32 as above; the known
// features gathered exactly and interpolated in float32 in JAX's order,
// ((w0 / wsum) * f0 + (w1 / wsum) * f1) + (w2 / wsum) * f2, each product
// and sum rounded on its own (fp_fused.py:56-63), then rounded to bf16;
// the concatenation with the skip features and the chain in its bf16 form
// (mlp_tc.cuh), bf16 out.
//
// Bound on an H100 SXM: operations, the chain's products (fp3: 128 clouds x
// 256 targets x (1536 x 512 + 512 x 512) multiply-adds, 68.7 GFLOP; the
// three sites 198 GFLOP a request, 2.98 ms at 67 TFLOP/s on the float32
// cores, 1.2 ms at the 3xTF32 rate of 495 / 3 TFLOP/s).
//
// Design: one block of 512 threads per (cloud, tile of R = 64 targets),
// one block an SM (R = 32 or 16 where 64 rows do not fit). The cloud's
// source points sit in shared memory; one warp per target scans them, each
// lane keeping its own 3 best, and three butterfly rounds over (distance,
// index) merge the lanes' lists. The first layer's input (1536 wide at fp3,
// 394 KB for 64 rows) does not fit in shared memory, so it is made in
// chunks of kKC columns, double buffered: a chunk's interpolated columns
// from each row's 3 indices and weights, its skip columns copied, 16 bytes
// a load where the widths allow. A pass of the 16 warps covers 256 of the
// layer's output columns against all R rows (each B fragment feeds the MT
// M-tiles; each block reads each weight once, from L2), so the chunks are
// made again for each pass: the input is read twice at fp3, against the
// weights' 4.2 MB. The later layers run from shared memory as sa.cu's do;
// the last one stores its rows from registers. The weights are split and
// fragment-ordered once per launch by sa.cu's packing (sa_pack_cuda; the
// bf16 form's by sa_pack_bf16_cuda). In the bf16 form a chunk's 128
// columns are 64 words a row (bf16 pairs), made 4 columns a load.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "mlp_tc.cuh"

namespace {

using mlp_tc::kFull;
using mlp_tc::kNT;
using mlp_tc::lead_words;

// 16 warps, one block an SM: a pass covers 256 output columns, so fp3 and
// fp2 make their chunks twice, fp1 once (8 warps, mlp_tc's, were slower on
// the card: half the warps to hide the weights' loads, twice the chunks)
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;

constexpr int kMaxShared = 232448;
constexpr int kNoIndex = 0x7fffffff;
constexpr int kKC = 128;          // columns of the first layer's input a chunk holds

// a chunk row's words (4 mod 32: no bank conflicts): 128 floats, or 64
// words of bf16 pairs
template <typename T>
__host__ __device__ constexpr int ld_chunk() {
  return kKC * static_cast<int>(sizeof(T)) / 4 + 4;
}

struct Shape {
  int nt, ns, c, cs;
  float eps;
  int lda;  // floats of a row of the region that holds the chunks, then odd layers' outputs
  int ld1;  // floats of a row of even layers' outputs
  int vec;  // 16-byte loads: C % 4 == 0, Cs % 4 == 0, both feature arrays 16-byte aligned
};

// The interpolated and skip columns k0 .. k0 + kKC - 1 of the tile's R rows
// into dst (R x ld_chunk<T>() words), zero past C + Cs and in rows past the
// cloud's Nt.
template <int MT, typename T>
__device__ __forceinline__ void stage_chunk(int k0, const Shape& sh, int rows,
                                            const int* nni, const float* nnw,
                                            const T* __restrict__ F,
                                            const T* __restrict__ S, uint32_t* dst) {
  constexpr int R = 16 * MT;
  constexpr int kLdC = ld_chunk<T>();
  const int tid = threadIdx.x, c0 = sh.c + sh.cs;
  if constexpr (std::is_same<T, bf16_t>::value) {
    // 4 columns a thread: the interpolation in float32 as JAX orders it,
    // each operation rounded on its own, then rounded to bf16
    for (int e = tid; e < R * (kKC / 4); e += kThreads) {
      const int r = e / (kKC / 4), col = k0 + 4 * (e % (kKC / 4));
      float y[4] = {0.f, 0.f, 0.f, 0.f};
      if (r < rows) {
        if (sh.vec && col + 4 <= sh.c) {
          const int* ii = nni + r * 3;
          const float* ww = nnw + r * 3;
          uint2 q[3];
#pragma unroll
          for (int k = 0; k < 3; ++k)
            q[k] = __ldg(reinterpret_cast<const uint2*>(F + (size_t)ii[k] * sh.c + col));
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            float f[3];
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              const uint32_t w = u < 2 ? q[k].x : q[k].y;
              f[k] = __uint_as_float(u % 2 ? w & 0xffff0000u : w << 16);
            }
            y[u] = __fadd_rn(__fadd_rn(__fmul_rn(ww[0], f[0]), __fmul_rn(ww[1], f[1])),
                             __fmul_rn(ww[2], f[2]));
          }
        } else if (sh.vec && col >= sh.c && col + 4 <= c0) {
          const uint2 q =
              __ldg(reinterpret_cast<const uint2*>(S + (size_t)r * sh.cs + col - sh.c));
          y[0] = __uint_as_float(q.x << 16);
          y[1] = __uint_as_float(q.x & 0xffff0000u);
          y[2] = __uint_as_float(q.y << 16);
          y[3] = __uint_as_float(q.y & 0xffff0000u);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int cu = col + u;
            if (cu < sh.c) {
              const int* ii = nni + r * 3;
              const float* ww = nnw + r * 3;
              float f[3];
#pragma unroll
              for (int k = 0; k < 3; ++k) f[k] = ldg_float(F + (size_t)ii[k] * sh.c + cu);
              y[u] = __fadd_rn(__fadd_rn(__fmul_rn(ww[0], f[0]), __fmul_rn(ww[1], f[1])),
                               __fmul_rn(ww[2], f[2]));
            } else if (cu < c0) {
              y[u] = ldg_float(S + (size_t)r * sh.cs + cu - sh.c);
            }
          }
        }
      }
      *reinterpret_cast<uint2*>(dst + r * kLdC + (col - k0) / 2) =
          make_uint2(bf16x2_rn(y[0], y[1]), bf16x2_rn(y[2], y[3]));
    }
  } else if (sh.vec) {
#pragma unroll 1
    for (int e = tid; e < R * (kKC / 4); e += kThreads) {
      const int r = e / (kKC / 4), col = k0 + 4 * (e % (kKC / 4));
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows && col < c0) {
        if (col < sh.c) {
          const int* ii = nni + r * 3;
          const float* ww = nnw + r * 3;
          const float4 f0 = __ldg(reinterpret_cast<const float4*>(F + (size_t)ii[0] * sh.c + col));
          const float4 f1 = __ldg(reinterpret_cast<const float4*>(F + (size_t)ii[1] * sh.c + col));
          const float4 f2 = __ldg(reinterpret_cast<const float4*>(F + (size_t)ii[2] * sh.c + col));
          v.x = (f0.x * ww[0] + f1.x * ww[1]) + f2.x * ww[2];
          v.y = (f0.y * ww[0] + f1.y * ww[1]) + f2.y * ww[2];
          v.z = (f0.z * ww[0] + f1.z * ww[1]) + f2.z * ww[2];
          v.w = (f0.w * ww[0] + f1.w * ww[1]) + f2.w * ww[2];
        } else {
          v = __ldg(reinterpret_cast<const float4*>(S + (size_t)r * sh.cs + col - sh.c));
        }
      }
      *reinterpret_cast<float4*>(dst + r * kLdC + col - k0) = v;
    }
  } else {
    for (int e = tid; e < R * kKC; e += kThreads) {
      const int r = e / kKC, col = k0 + e % kKC;
      float v = 0.f;
      if (r < rows && col < c0) {
        if (col < sh.c) {
          const int* ii = nni + r * 3;
          const float* ww = nnw + r * 3;
          v = (__ldg(F + (size_t)ii[0] * sh.c + col) * ww[0] +
               __ldg(F + (size_t)ii[1] * sh.c + col) * ww[1]) +
              __ldg(F + (size_t)ii[2] * sh.c + col) * ww[2];
        } else {
          v = __ldg(S + (size_t)r * sh.cs + col - sh.c);
        }
      }
      dst[r * kLdC + col - k0] = __float_as_uint(v);
    }
  }
}

// T: the type of the features, the activations and the output (float, or
// bf16_t for the bf16 form)
template <int MT, typename T>
__global__ void __launch_bounds__(kThreads, 1)
fp_kernel(const float* __restrict__ unknown, const float* __restrict__ known,
          const T* __restrict__ known_feats, const T* __restrict__ unknown_feats,
          const mlp_tc::Chain chain, const Shape sh, T* __restrict__ out) {
  constexpr int R = 16 * MT;
  constexpr int kLdC = ld_chunk<T>();
  extern __shared__ __align__(16) float smem[];
  float* nnw = smem;                                 // R x 3
  int* nni = reinterpret_cast<int*>(nnw + R * 3);    // R x 3
  // the chunks, then odd layers' outputs (R x lda words); even layers'
  // outputs (R x ld1 words)
  uint32_t* region = reinterpret_cast<uint32_t*>(smem + R * 6);
  uint32_t* buf1 = region + R * sh.lda;
  const int b = blockIdx.y, n0 = blockIdx.x * R;
  const int rows = min(R, sh.nt - n0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* K = known + (size_t)b * sh.ns * 3;
  // the cloud's points, over both buffers until the 3-NN is done
  float* kxyz = reinterpret_cast<float*>(region);
  for (int e = tid; e < sh.ns * 3; e += kThreads) kxyz[e] = K[e];
  __syncthreads();

  // 1. three nearest sources of each target, one warp per target
  for (int r = warp; r < R; r += kWarps) {
    if (r >= rows) {
      if (lane < 3) {
        nni[r * 3 + lane] = 0;
        nnw[r * 3 + lane] = 0.f;
      }
      continue;
    }
    const float* u = unknown + ((size_t)b * sh.nt + n0 + r) * 3;
    const float ux = u[0], uy = u[1], uz = u[2];
    float d0 = CUDART_INF_F, d1 = CUDART_INF_F, d2 = CUDART_INF_F;
    int i0 = kNoIndex, i1 = kNoIndex, i2 = kNoIndex;
    for (int j = lane; j < sh.ns; j += 32) {
      const float dx = __fsub_rn(ux, kxyz[j * 3]), dy = __fsub_rn(uy, kxyz[j * 3 + 1]),
                  dz = __fsub_rn(uz, kxyz[j * 3 + 2]);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      // strict: an earlier (lower) index keeps its place on a tie
      if (d < d2) {
        if (d < d1) {
          d2 = d1;
          i2 = i1;
          if (d < d0) {
            d1 = d0;
            i1 = i0;
            d0 = d;
            i0 = j;
          } else {
            d1 = d;
            i1 = j;
          }
        } else {
          d2 = d;
          i2 = j;
        }
      }
    }
    float dk[3];
    int ik[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float bd = d0;
      int bj = i0;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float od = __shfl_xor_sync(kFull, bd, off);
        const int oj = __shfl_xor_sync(kFull, bj, off);
        if (od < bd || (od == bd && oj < bj)) {
          bd = od;
          bj = oj;
        }
      }
      dk[k] = bd;
      ik[k] = bj;
      if (bj == i0) {  // this lane's head was taken: pop it
        d0 = d1;
        i0 = i1;
        d1 = d2;
        i1 = i2;
        d2 = CUDART_INF_F;
        i2 = kNoIndex;
      }
    }
    if (lane == 0) {
      float rk[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) rk[k] = 1.f / (sqrtf(fmaxf(dk[k], 0.f)) + sh.eps);
      const float sum = (rk[0] + rk[1]) + rk[2];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        nni[r * 3 + k] = ik[k];
        nnw[r * 3 + k] = rk[k] / sum;
      }
    }
  }
  __syncthreads();  // the indices and weights are set; the points are read

  // 2. the first layer, its input made a chunk at a time: step s is pass s /
  // nk (128 output columns) over chunk s % nk; chunk s + 1 is made while
  // chunk s multiplies
  constexpr int kChunkSteps = kKC / mlp_tc::Form<T>::kKStep;  // K steps a chunk
  const T* F = known_feats + (size_t)b * sh.ns * sh.c;
  const T* S = unknown_feats + ((size_t)b * sh.nt + n0) * sh.cs;
  const int c1 = chain.c[1];
  const int k8 = mlp_tc::padc<T>(chain.c[0]) / mlp_tc::Form<T>::kKStep;
  const int n8 = mlp_tc::padc<T>(c1) / 8;
  const int nk = (k8 + kChunkSteps - 1) / kChunkSteps;
  const int steps = (n8 + kWarps * kNT - 1) / (kWarps * kNT) * nk;
  T* ob = out + ((size_t)b * sh.nt + n0) * chain.c[chain.layers];
  stage_chunk<MT, T>(0, sh, rows, nni, nnw, F, S, region);
  __syncthreads();
  float acc[MT][kNT][4];
  for (int s = 0; s < steps; ++s) {
    const int pass = s / nk, k = s - pass * nk;
    if (nk > 1 && s + 1 < steps)
      stage_chunk<MT, T>((k + 1 < nk ? k + 1 : 0) * kKC, sh, rows, nni, nnw, F, S,
                         region + ((s + 1) & 1) * R * kLdC);
    if (k == 0) mlp_tc::zero_acc<MT>(acc);
    const int nt0 = pass * kWarps * kNT + warp * kNT;
    if (nt0 < n8) {
      const int kb = k * kChunkSteps;
      mlp_tc::pass_accumulate<MT, T>(region + (nk > 1 ? s & 1 : 0) * R * kLdC, kLdC, kb,
                                     min(k8, kb + kChunkSteps), chain.wpk[0], n8, nt0, acc);
      if (k == nk - 1) {
        if (chain.layers == 1)
          mlp_tc::store_relu_rows<MT, T>(acc, chain.b[0], c1, n8, nt0, rows, ob);
        else
          mlp_tc::store_relu<MT, T>(acc, chain.b[0], c1, n8, nt0, buf1, sh.ld1);
      }
    }
    __syncthreads();  // the chunk is read before it is made again
  }

  // 3. the later layers: outputs of layers 1 and 3 in the region, of layer
  // 2 in buf1; the last layer's rows from registers to the output
  uint32_t* cur = buf1;
  uint32_t* nxt = region;
  int lc = sh.ld1, ln = sh.lda;
  for (int l = 1; l < chain.layers; ++l) {
    if (l + 1 < chain.layers) {
      mlp_tc::hidden_layer<MT, kWarps, T>(cur, lc, chain.c[l], chain.wpk[l], chain.b[l],
                                          chain.c[l + 1], nxt, ln);
      __syncthreads();
      uint32_t* tb = cur;
      cur = nxt;
      nxt = tb;
      const int tl = lc;
      lc = ln;
      ln = tl;
    } else {
      mlp_tc::last_layer_rows<MT, kWarps, T>(cur, lc, chain.c[l], chain.wpk[l], chain.b[l],
                                             chain.c[l + 1], rows, ob);
    }
  }
}

// Words of a row of the region that holds the two chunks, then the
// outputs of layers 1 and 3 (a hidden layer's output feeds the next
// layer), and of a row of the even layers' outputs; both 4 (mod 32).
template <typename T>
void row_widths(const mlp_tc::Chain& chain, int* lda, int* ld1) {
  int wa = 2 * ld_chunk<T>(), w1 = 0;
  for (int l = 0; l + 1 < chain.layers; ++l) {
    const int w = mlp_tc::row_words<T>(chain.c[l + 1]);
    if (l % 2 == 0) w1 = w > w1 ? w : w1;
    else wa = w > wa ? w : wa;
  }
  *lda = lead_words(wa);
  *ld1 = w1 > 0 ? lead_words(w1) : 0;
}

// The region also holds the cloud's points during the 3-NN, before either
// buffer is written.
size_t shared_bytes(int rows, int ns, int lda, int ld1) {
  const size_t bufs = (size_t)rows * (lda + ld1);
  return sizeof(float) * ((size_t)rows * 6 + (bufs > (size_t)ns * 3 ? bufs : (size_t)ns * 3));
}

template <int MT, typename T>
cudaError_t launch(const float* unknown, const float* known, const T* kf, const T* uf,
                   const mlp_tc::Chain& chain, int b, const Shape& sh, T* out,
                   cudaStream_t stream) {
  constexpr int R = 16 * MT;
  const size_t bytes = shared_bytes(R, sh.ns, sh.lda, sh.ld1);
  cudaError_t err = cudaFuncSetAttribute(fp_kernel<MT, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid((sh.nt + R - 1) / R, b);
  fp_kernel<MT, T><<<grid, kThreads, bytes, stream>>>(unknown, known, kf, uf, chain, sh, out);
  return cudaGetLastError();
}

template <typename T>
int run(const void* unknown, const void* known, const void* known_feats,
        const void* unknown_feats, const void* wpk, const void* const* biases, const int* chans,
        int layers, int b, int nt, int ns, int c, int cs, float eps, void* out, void* stream,
        int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b < 1 || b > 65535 || nt < 1 || ns < 3 || ns > 4096 || c < 1 || cs < 1 || layers < 1 ||
      layers > mlp_tc::kMaxLayers || chans[0] != c + cs)
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
    wp += mlp_tc::packed_words<T>(chans[l], chans[l + 1]);
    chain.b[l] = static_cast<const float*>(biases[l]);
  }
  // 16-byte loads (bf16: 8-byte) where the widths and pointers allow
  constexpr int kVec = std::is_same<T, float>::value ? 16 : 8;
  Shape sh{nt, ns, c, cs, eps, 0, 0, 0};
  row_widths<T>(chain, &sh.lda, &sh.ld1);
  sh.vec = c % 4 == 0 && cs % 4 == 0 && (reinterpret_cast<uintptr_t>(known_feats) % kVec) == 0 &&
           (reinterpret_cast<uintptr_t>(unknown_feats) % kVec) == 0;
  const float* u = static_cast<const float*>(unknown);
  const float* k = static_cast<const float*>(known);
  const T* kf = static_cast<const T*>(known_feats);
  const T* uf = static_cast<const T*>(unknown_feats);
  T* o = static_cast<T*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (shared_bytes(64, ns, sh.lda, sh.ld1) <= (size_t)kMaxShared)
    err = launch<4, T>(u, k, kf, uf, chain, b, sh, o, st);
  else if (shared_bytes(32, ns, sh.lda, sh.ld1) <= (size_t)kMaxShared)
    err = launch<2, T>(u, k, kf, uf, chain, b, sh, o, st);
  else if (shared_bytes(16, ns, sh.lda, sh.ld1) <= (size_t)kMaxShared)
    err = launch<1, T>(u, k, kf, uf, chain, b, sh, o, st);
  else
    return static_cast<int>(cudaErrorInvalidConfiguration);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// unknown (B, Nt, 3), known (B, Ns, 3), known_feats (B, Ns, C),
// unknown_feats (B, Nt, Cs); wpk the chain's weights packed by sa.cu's
// sa_pack_cuda (chans[0] = C + Cs), biases[l] (C_{l+1},) for l < layers
// (1..4); all float32, contiguous; 3 <= Ns <= 4096. out (B, Nt,
// C_layers). Launches on `stream`, does not synchronise, returns the
// cudaError_t of the launch (0 on success).
int fp_cuda(const void* unknown, const void* known, const void* known_feats,
            const void* unknown_feats, const void* wpk, const void* const* biases,
            const int* chans, int layers, int b, int nt, int ns, int c, int cs, float eps,
            void* out, void* stream, int device) {
  return run<float>(unknown, known, known_feats, unknown_feats, wpk, biases, chans, layers, b,
                    nt, ns, c, cs, eps, out, stream, device);
}

// The bf16 form: known_feats, unknown_feats and out bf16, wpk packed by
// sa.cu's sa_pack_bf16_cuda; the rest as fp_cuda's.
int fp_bf16_cuda(const void* unknown, const void* known, const void* known_feats,
                 const void* unknown_feats, const void* wpk, const void* const* biases,
                 const int* chans, int layers, int b, int nt, int ns, int c, int cs, float eps,
                 void* out, void* stream, int device) {
  return run<bf16_t>(unknown, known, known_feats, unknown_feats, wpk, biases, chans, layers, b,
                     nt, ns, c, cs, eps, out, stream, device);
}

const char* fp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
