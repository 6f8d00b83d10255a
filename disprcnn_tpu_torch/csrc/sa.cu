// One whole PointNet++ set-abstraction scale for Hopper (sm_90a), float32:
// ball query, gather, the factored first layer, BN0 + ReLU, the MLP chain
// and the max over each ball.
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
// The TPU kernel kept v and the weights in bf16; this one is float32
// throughout (the plain version's arithmetic, to a float32 tolerance).
//
// Bound on an H100 SXM: operations. The chain's products dominate: RCNN
// SA0 at the headline budget (2048 clouds, 128 balls of 64, 128 -> 128 ->
// 128) is 1.1 TFLOP of the ~2.1 TFLOP a request's eight sites need (~31 ms
// at 67 TFLOP/s); every site's inputs and outputs move in well under 1 ms.
//
// Design: one block of 256 threads per (cloud, tile of T = R / S centres),
// R = 16, 32 or 64 rows. One warp per centre runs the ball query by ballot
// and popc over 32 points at a time, in index order, until S are found;
// the block then gathers the R rows of x0 into shared memory, runs the
// chain as register-tiled products (mlp.cuh: 4 rows of a weight and 4
// values of an activation row per 16-byte load) between two shared buffers,
// and reduces the last layer 128 columns at a time through a third buffer
// into the max over each ball. Only the (B, M, C_last) result is written.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxShared = 232448;  // bytes of shared memory a block may use

template <int RT>
__global__ void __launch_bounds__(mlp::kThreads)
sa_kernel(const float* __restrict__ xyz, const float* __restrict__ centers,
          const float* __restrict__ v, const float* __restrict__ w0x,
          const float* __restrict__ mul0, const float* __restrict__ add0, mlp::Chain chain,
          int n, int m, int s, float r2, int ld0, int ld1, float* __restrict__ out) {
  constexpr int R = 8 * RT;
  extern __shared__ float smem[];
  int* idx = reinterpret_cast<int*>(smem);  // R
  float* buf0 = smem + R;                   // R x ld0
  float* buf1 = buf0 + R * ld0;             // R x ld1
  float* chunk = buf1 + R * ld1;            // R x 128
  const int tiles = R / s;
  const int b = blockIdx.y, m0 = blockIdx.x * tiles;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* X = xyz + (size_t)b * n * 3;
  const float* C = centers + (size_t)b * m * 3;

  // 1. ball query: one warp per centre, 32 points a step in index order
  for (int t = warp; t < tiles; t += mlp::kThreads / 32) {
    int* bi = idx + t * s;
    const int mc = m0 + t;
    int cnt = 0;
    if (mc < m) {
      const float cx = C[mc * 3], cy = C[mc * 3 + 1], cz = C[mc * 3 + 2];
      for (int base = 0; base < n && cnt < s; base += 32) {
        const int j = base + lane;
        bool in = false;
        if (j < n) {
          const float dx = __fsub_rn(cx, X[j * 3]), dy = __fsub_rn(cy, X[j * 3 + 1]),
                      dz = __fsub_rn(cz, X[j * 3 + 2]);
          const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                     __fmul_rn(dz, dz));
          in = d2 < r2;
        }
        const unsigned hit = __ballot_sync(kFull, in);
        const int pos = cnt + __popc(hit & ((1u << lane) - 1u));
        if (in && pos < s) bi[pos] = j;
        cnt += __popc(hit);
      }
    }
    __syncwarp();
    cnt = min(cnt, s);
    const int first = cnt > 0 ? bi[0] : 0;
    __syncwarp();
    for (int k = lane; k < s; k += 32)
      if (k >= cnt) bi[k] = first;
  }
  __syncthreads();

  // 2. x0: gathered feature columns + the centred xyz term, BN0, ReLU
  const int c0 = chain.c[0];
  for (int e = tid; e < R * c0; e += mlp::kThreads) {
    const int r = e / c0, c = e - r * c0;
    const int mc = m0 + r / s;
    float val = 0.f;
    if (mc < m) {
      const int j = idx[r];
      const float gx = X[j * 3] - C[mc * 3], gy = X[j * 3 + 1] - C[mc * 3 + 1],
                  gz = X[j * 3 + 2] - C[mc * 3 + 2];
      const float term = (gx * __ldg(w0x + c) + gy * __ldg(w0x + c0 + c)) +
                         gz * __ldg(w0x + 2 * c0 + c);
      const float x = __ldg(v + ((size_t)b * n + j) * c0 + c) + term;
      val = fmaxf(x * __ldg(mul0 + c) + __ldg(add0 + c), 0.f);
    }
    buf0[r * ld0 + c] = val;
  }
  __syncthreads();

  float* out_b = out + (size_t)b * m * chain.c[chain.layers];
  if (chain.layers == 0) {  // no layer after mlp0: the max of x0
    for (int e = tid; e < tiles * c0; e += mlp::kThreads) {
      const int t = e / c0, c = e - t * c0, mc = m0 + t;
      if (mc >= m) continue;
      float mx = buf0[(t * s) * ld0 + c];
      for (int r = 1; r < s; ++r) mx = fmaxf(mx, buf0[(t * s + r) * ld0 + c]);
      out_b[(size_t)mc * c0 + c] = mx;
    }
    return;
  }

  // 3. the chain, the last layer reduced over each ball (mlp.cuh)
  mlp::chain_max<RT>(chain, buf0, ld0, buf1, ld1, chunk, min(tiles, m - m0), s,
                     out_b + (size_t)m0 * chain.c[chain.layers]);
}

size_t shared_bytes(int rows, int ld0, int ld1) {
  return sizeof(float) * (size_t)rows * (1 + ld0 + ld1 + mlp::kColChunk);
}

template <int RT>
cudaError_t launch(const float* xyz, const float* centers, const float* v, const float* w0x,
                   const float* mul0, const float* add0, const mlp::Chain& chain, int b, int n,
                   int m, int s, float r2, int ld0, int ld1, float* out, cudaStream_t stream) {
  constexpr int R = 8 * RT;
  const size_t bytes = shared_bytes(R, ld0, ld1);
  cudaError_t err = cudaFuncSetAttribute(sa_kernel<RT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int tiles = R / s;
  dim3 grid((m + tiles - 1) / tiles, b);
  sa_kernel<RT><<<grid, mlp::kThreads, bytes, stream>>>(xyz, centers, v, w0x, mul0, add0, chain,
                                                         n, m, s, r2, ld0, ld1, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// xyz (B, N, 3), centers (B, M, 3), v (B, N, C0), w0x (3, C0), mul0 and
// add0 (C0,), weights[l] (C_l, C_{l+1}) and biases[l] (C_{l+1},) for l <
// layers (0..4), chans = (C0, ..., C_layers); all float32, contiguous.
// out (B, M, C_layers). S must divide 16, 32 or 64. Launches on `stream`,
// does not synchronise, returns the cudaError_t of the launch (0 on success).
int sa_cuda(const void* xyz, const void* centers, const void* v, const void* w0x,
            const void* mul0, const void* add0, const void* const* weights,
            const void* const* biases, const int* chans, int layers, int b, int n, int m,
            int s, float r2, void* out, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b < 1 || b > 65535 || n < 1 || m < 1 || s < 1 || s > 64 || layers < 0 ||
      layers > mlp::kMaxLayers)
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
  // the largest row tile that holds whole balls and fits in shared memory
  int rt = 0;
  for (int cand = 8; cand >= 2; cand /= 2) {
    const int rows = 8 * cand;
    if (rows % s == 0 && shared_bytes(rows, ld0, ld1) <= (size_t)kMaxShared) {
      rt = cand;
      break;
    }
  }
  const float* args[6] = {static_cast<const float*>(xyz), static_cast<const float*>(centers),
                          static_cast<const float*>(v), static_cast<const float*>(w0x),
                          static_cast<const float*>(mul0), static_cast<const float*>(add0)};
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rt == 8)
    err = launch<8>(args[0], args[1], args[2], args[3], args[4], args[5], chain, b, n, m, s, r2,
                    ld0, ld1, o, st);
  else if (rt == 4)
    err = launch<4>(args[0], args[1], args[2], args[3], args[4], args[5], chain, b, n, m, s, r2,
                    ld0, ld1, o, st);
  else if (rt == 2)
    err = launch<2>(args[0], args[1], args[2], args[3], args[4], args[5], chain, b, n, m, s, r2,
                    ld0, ld1, o, st);
  else
    return static_cast<int>(cudaErrorInvalidConfiguration);
  return static_cast<int>(err);
}

const char* sa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
