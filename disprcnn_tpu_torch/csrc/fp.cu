// PointNet++ feature propagation for Hopper (sm_90a), float32: 3-NN,
// inverse-distance interpolation, the skip features concatenated, and the
// folded-BN MLP chain.
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
// The TPU kernel kept the features and weights in bf16; this one is
// float32 throughout.
//
// Bound on an H100 SXM: operations, the chain's products (fp3: 128 clouds x
// 256 targets x (1536 x 512 + 512 x 512) multiply-adds, 68.7 GFLOP; the
// three sites ~190 GFLOP a request, ~3 ms at 67 TFLOP/s).
//
// Design: one block of 256 threads per (cloud, tile of R = 16, 32 or 64
// target points). The cloud's source points sit in shared memory; one
// warp per target scans them, each lane keeping its own 3 best, and three
// butterfly rounds over (distance, index) merge the lanes' lists. The
// block writes the interpolated and skip columns of its R rows into shared
// memory and runs the chain as register-tiled products (mlp.cuh: 4 rows of
// a weight and 4 values of an activation row per 16-byte load); the last
// layer goes from registers to the output.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mlp.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxShared = 232448;
constexpr int kNoIndex = 0x7fffffff;

template <int RT>
__global__ void __launch_bounds__(mlp::kThreads)
fp_kernel(const float* __restrict__ unknown, const float* __restrict__ known,
          const float* __restrict__ known_feats, const float* __restrict__ unknown_feats,
          mlp::Chain chain, int nt, int ns, int c, int cs, float eps, int ld0, int ld1,
          float* __restrict__ out) {
  constexpr int R = 8 * RT;
  extern __shared__ float smem[];
  float* kxyz = smem;                                // ns x 3, padded to 4
  float* nnw = kxyz + ((ns * 3 + 3) & ~3);           // R x 3
  int* nni = reinterpret_cast<int*>(nnw + R * 3);    // R x 3
  float* buf0 = reinterpret_cast<float*>(nni + R * 3);  // R x ld0
  float* buf1 = buf0 + R * ld0;                      // R x ld1
  const int b = blockIdx.y, n0 = blockIdx.x * R;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* K = known + (size_t)b * ns * 3;
  for (int e = tid; e < ns * 3; e += mlp::kThreads) kxyz[e] = K[e];
  __syncthreads();

  // 1. three nearest sources of each target, one warp per target
  for (int r = warp; r < R; r += mlp::kThreads / 32) {
    const int nn = n0 + r;
    if (nn >= nt) {
      if (lane < 3) {
        nni[r * 3 + lane] = 0;
        nnw[r * 3 + lane] = 0.f;
      }
      continue;
    }
    const float* u = unknown + ((size_t)b * nt + nn) * 3;
    const float ux = u[0], uy = u[1], uz = u[2];
    float d0 = CUDART_INF_F, d1 = CUDART_INF_F, d2 = CUDART_INF_F;
    int i0 = kNoIndex, i1 = kNoIndex, i2 = kNoIndex;
    for (int j = lane; j < ns; j += 32) {
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
      for (int k = 0; k < 3; ++k) rk[k] = 1.f / (sqrtf(fmaxf(dk[k], 0.f)) + eps);
      const float sum = (rk[0] + rk[1]) + rk[2];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        nni[r * 3 + k] = ik[k];
        nnw[r * 3 + k] = rk[k] / sum;
      }
    }
  }
  __syncthreads();

  // 2. the input rows: interpolated features, then the skip features
  const float* F = known_feats + (size_t)b * ns * c;
  for (int e = tid; e < R * c; e += mlp::kThreads) {
    const int r = e / c, ch = e - r * c;
    float val = 0.f;
    if (n0 + r < nt) {
      const int* ii = nni + r * 3;
      const float* ww = nnw + r * 3;
      val = (__ldg(F + (size_t)ii[0] * c + ch) * ww[0] + __ldg(F + (size_t)ii[1] * c + ch) * ww[1]) +
            __ldg(F + (size_t)ii[2] * c + ch) * ww[2];
    }
    buf0[r * ld0 + ch] = val;
  }
  const float* S = unknown_feats + ((size_t)b * nt + n0) * cs;
  for (int e = tid; e < R * cs; e += mlp::kThreads) {
    const int r = e / cs, ch = e - r * cs;
    buf0[r * ld0 + c + ch] = n0 + r < nt ? __ldg(S + (size_t)r * cs + ch) : 0.f;
  }
  __syncthreads();

  // 3. the chain; the last layer goes from registers to the output
  float* in;
  int ld;
  mlp::hidden_layers<RT>(chain, buf0, ld0, buf1, ld1, &in, &ld);
  const int last = chain.layers - 1;
  const int ci = chain.c[last], co = chain.c[chain.layers];
  const float* W = chain.w[last];
  const float* bias = chain.b[last];
  const int tx = tid & 31, ty = tid >> 5;
  float* ob = out + ((size_t)b * nt + n0) * co;
  for (int col0 = 0; col0 < co; col0 += mlp::kColChunk) {
    float acc[RT][4];
    mlp::tile_product<RT>(in, ld, ci, W, co, col0, chain.vec != 0, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + 4 * tx + j;
      if (col >= co) continue;
      const float bv = __ldg(bias + col);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int r = ty + 8 * i;
        if (n0 + r < nt) ob[(size_t)r * co + col] = fmaxf(acc[i][j] + bv, 0.f);
      }
    }
  }
}

size_t shared_bytes(int rows, int ns, int ld0, int ld1) {
  return sizeof(float) * ((size_t)((ns * 3 + 3) & ~3) + (size_t)rows * (6 + ld0 + ld1));
}

template <int RT>
cudaError_t launch(const float* unknown, const float* known, const float* kf, const float* uf,
                   const mlp::Chain& chain, int b, int nt, int ns, int c, int cs, float eps,
                   int ld0, int ld1, float* out, cudaStream_t stream) {
  constexpr int R = 8 * RT;
  const size_t bytes = shared_bytes(R, ns, ld0, ld1);
  cudaError_t err = cudaFuncSetAttribute(fp_kernel<RT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid((nt + R - 1) / R, b);
  fp_kernel<RT><<<grid, mlp::kThreads, bytes, stream>>>(unknown, known, kf, uf, chain, nt, ns, c,
                                                         cs, eps, ld0, ld1, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// unknown (B, Nt, 3), known (B, Ns, 3), known_feats (B, Ns, C),
// unknown_feats (B, Nt, Cs), weights[l] (C_l, C_{l+1}) and biases[l]
// (C_{l+1},) for l < layers (1..4) with chans[0] = C + Cs; all float32,
// contiguous; 3 <= Ns <= 4096. out (B, Nt, C_layers). Launches on
// `stream`, does not synchronise, returns the cudaError_t of the launch
// (0 on success).
int fp_cuda(const void* unknown, const void* known, const void* known_feats,
            const void* unknown_feats, const void* const* weights, const void* const* biases,
            const int* chans, int layers, int b, int nt, int ns, int c, int cs, float eps,
            void* out, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b < 1 || b > 65535 || nt < 1 || ns < 3 || ns > 4096 || c < 1 || cs < 1 || layers < 1 ||
      layers > mlp::kMaxLayers || chans[0] != c + cs)
    return static_cast<int>(cudaErrorInvalidValue);
  mlp::Chain chain;
  chain.layers = layers;
  for (int l = 0; l <= layers; ++l) {
    if (chans[l] < 1) return static_cast<int>(cudaErrorInvalidValue);
    chain.c[l] = chans[l];
  }
  for (int l = 0; l < layers; ++l) {
    chain.w[l] = static_cast<const float*>(weights[l]);
    chain.b[l] = static_cast<const float*>(biases[l]);
  }
  int ld0, ld1;
  mlp::buffer_widths(chain, &ld0, &ld1);
  chain.vec = mlp::vector_ok(chain, ld0, ld1);
  int rt = 0;
  for (int cand = 8; cand >= 2; cand /= 2) {
    if (shared_bytes(8 * cand, ns, ld0, ld1) <= (size_t)kMaxShared) {
      rt = cand;
      break;
    }
  }
  const float* u = static_cast<const float*>(unknown);
  const float* k = static_cast<const float*>(known);
  const float* kf = static_cast<const float*>(known_feats);
  const float* uf = static_cast<const float*>(unknown_feats);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rt == 8) err = launch<8>(u, k, kf, uf, chain, b, nt, ns, c, cs, eps, ld0, ld1, o, st);
  else if (rt == 4) err = launch<4>(u, k, kf, uf, chain, b, nt, ns, c, cs, eps, ld0, ld1, o, st);
  else if (rt == 2) err = launch<2>(u, k, kf, uf, chain, b, nt, ns, c, cs, eps, ld0, ld1, o, st);
  else return static_cast<int>(cudaErrorInvalidConfiguration);
  return static_cast<int>(err);
}

const char* fp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
