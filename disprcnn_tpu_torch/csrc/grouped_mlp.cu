// A PointNet++ SharedMLP over grouped activations and the max over each
// group, for Hopper (sm_90a), float32 at float32 accuracy, and its bf16
// form (below).
//
// Replaces the TPU kernel disprcnn_tpu/ops/pallas/grouped_mlp.py
// (grouped_mlp_max). For group g of S rows of x (G, S, C0), the grouped
// pre-activation of a ball-grouped scale (mlp0 applied, its bias added):
//   x0  = relu(x[g, s] * mul0 + add0)      (mlp0's folded BN)
//   x_l = relu(x_{l-1} W_l + b_l)           (the folded-BN chain, 1-4 layers)
//   out[g] = max over the S rows of the last x.
// The TPU kernel rounded x, the weights and every layer to bf16; this one
// is float32 in and out, its products in 3xTF32 on the tensor cores.
//
// Bound on an H100 SXM: operations. At the headline budget with the SA
// kernel off, the chain's products over every row of x are ~2.1 TFLOP a
// request (RCNN SA0 1.1, SA1 0.4, the six RPN scales 0.55): ~12.5 ms at the
// 3xTF32 tensor-core rate (495 / 3 TFLOP/s), against ~13 GB of x read once
// (~4 ms at 3.35 TB/s). Rows that repeat a ball's first neighbour cannot be
// told apart here, so every row is computed and counted.
//
// Design: persistent blocks, one an SM, each walking tiles of T = 64 W / S
// whole groups (W = 2 consumer warpgroups, 128 rows, where the shared
// memory allows, else 1: the RPN SA3 scales). A block is W consumer
// warpgroups and a producer warpgroup, which hands most of its registers
// to the consumers (setmaxnreg; W = 2). One producer warp brings each
// tile's x in by bulk copies (one a row, into rows padded to a leading
// dimension of 4 mod 32) as soon as the consumers have finished the
// previous tile's first layer; another streams the packed weight slabs
// through a ring (mlp_wgmma.cuh), so one slab read from L2 serves the
// tile's 64 W rows. Each consumer warpgroup runs the chain over its 64
// rows on wgmma: x0's affine and ReLU applied while forming the first
// layer's A fragments, hidden activations in shared memory, and the last
// layer reduced from the accumulators into the max over each group
// (shuffles within a warp; groups of 32 or more rows meet in shared
// memory). Only the (G, C_last) result is written. The weights are split
// and laid out once per launch by pack_kernel (grouped_mlp_pack_cuda, one
// launch before).
//
// The bf16 form (grouped_mlp_bf16_cuda; a bf16 model's SA-off route) is
// the TPU kernel's own arithmetic (grouped_mlp.py:26-40): x bf16, x0 =
// bf16(relu(x * mul0 + add0)) in float32, bf16 weights (rounded by
// pack_bf16_kernel), float32 sums of exact products, + b, ReLU and one
// rounding to bf16 a layer, the max over the group, bf16 out. The same
// kernel body on bf16 tiles (mlp_wgmma.cuh's bf16 chain: one
// wgmma.m64nNk16 bf16 product a k16 step, no split): x and the hidden
// activations take half the shared memory and a weight slab a quarter, so
// the plan keeps two consumer warpgroups at every SA-off site and up to 8
// ring slots. Bound on an H100 SXM (data-sheet peaks, 700 W) at the
// headline budget: the same ~2.1 TFLOP of products at the bf16 tensor-core
// rate (989 TFLOP/s), ~2.1 ms, against ~6.5 GB of bf16 x read once (~1.9
// ms at 3.35 TB/s): operations, narrowly.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_wgmma.cuh"

namespace {

namespace mw = mlp_wgmma;

constexpr size_t kMaxShared = 232448;  // bytes of shared memory a block may use
// the producer warpgroup: the weight warp, the x warp and two idle warps
// (a whole warpgroup, so that its registers can go to the consumers)
constexpr int kProducerThreads = 128;
// with two consumer warpgroups a block starts at 168 registers a thread
// (384 threads); the producers give 128 each to the consumers
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// Byte offsets of a block's shared memory regions (each 128-byte aligned)
// and its shapes; ldx, ld0 and ld1 count elements of the chain's type.
struct Layout {
  size_t bars, mul, otile, ring, x, h0, h1, total;
  int ldx, ld0, ld1, slot_floats, tile_groups, stages;
};

size_t align128(size_t v) { return (v + 127) & ~size_t(127); }

// The layout for chans (C0, ..., C_layers), groups of s rows, wgs consumer
// warpgroups, chunks of nc columns and a ring of `stages` slots, for
// activations of T (float, or bf16_t: half the bytes, a quarter of a
// slab's); false if it exceeds a block's shared memory.
template <typename T>
bool make_layout(const int* c, int layers, int s, int wgs, int nc, int stages, Layout* L) {
  auto lead = [](int ch) {
    return std::is_same<T, bf16_t>::value ? mw::lead_bf16(ch) : mw::lead(ch);
  };
  const int rows = 64 * wgs;
  int widest = 0, w[2] = {0, 0};  // hidden layer l's output lives in h[l % 2]
  for (int l = 0; l < layers; ++l) {
    widest = max(widest, mw::pad32(c[l + 1]));
    if (l + 1 < layers) w[l % 2] = max(w[l % 2], c[l + 1]);
  }
  const int w0 = w[0], w1 = w[1];
  L->stages = stages;
  L->tile_groups = rows / s;
  L->slot_floats = mw::slab_words<T>(min(nc, widest));
  L->ldx = lead(c[0]);
  L->ld0 = w0 ? lead(w0) : 0;
  L->ld1 = w1 ? lead(w1) : 0;
  size_t off = 0;
  L->bars = off;
  off = align128(off + 8 * (2 + 2 * (size_t)stages));
  L->mul = off;
  off = align128(off + 4 * 2 * (size_t)mw::pad32(c[0]));
  L->otile = off;
  if (16 % s != 0) off = align128(off + 4 * (size_t)L->tile_groups * c[layers]);
  L->ring = off;
  off = align128(off + 4 * (size_t)stages * L->slot_floats);
  L->x = off;
  off = align128(off + sizeof(T) * rows * L->ldx);
  L->h0 = off;
  off = align128(off + sizeof(T) * rows * L->ld0);
  L->h1 = off;
  off = align128(off + sizeof(T) * rows * L->ld1);
  L->total = off;
  return off <= kMaxShared;
}

// x and out of T (float, or bf16_t for the bf16 form); mul0, add0, the
// biases float32
template <typename T>
struct Params {
  const T* x;
  const float* mul0;
  const float* add0;
  mw::Chain chain;
  Layout L;
  int g, s, bulk;  // bulk: x's rows come by bulk copies (rows of 16-byte multiples, x aligned)
  T* out;
};

template <int WGS, typename T>
__global__ void __launch_bounds__(WGS * 128 + kProducerThreads, 1)
grouped_mlp_kernel(const Params<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout& L = p.L;
  const mw::Chain& ch = p.chain;
  constexpr int kConsumers = WGS * 128;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = ch.c[0], co = ch.c[ch.layers], rows = 64 * WGS;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* x_full = bars;
  uint64_t* x_empty = bars + 1;
  float* mul0 = reinterpret_cast<float*>(smem + L.mul);
  float* add0 = mul0 + mw::pad32(c0);
  int* otile = reinterpret_cast<int*>(smem + L.otile);
  T* xs = reinterpret_cast<T*>(smem + L.x);
  T* h[2] = {reinterpret_cast<T*>(smem + L.h0), reinterpret_cast<T*>(smem + L.h1)};
  const int ldh[2] = {L.ld0, L.ld1};
  const mw::Ring ring{reinterpret_cast<float*>(smem + L.ring), bars + 2, bars + 2 + L.stages,
                      L.stages, L.slot_floats};
  const bool direct = 16 % p.s == 0;
  const int tile_groups = L.tile_groups;
  const int tiles = (p.g + tile_groups - 1) / tile_groups;

  if (tid == 0) {
    mw::bar_init(x_full, 1);
    mw::bar_init(x_empty, 4 * WGS);
    for (int i = 0; i < L.stages; ++i) {
      mw::bar_init(ring.full + i, 1);
      mw::bar_init(ring.empty + i, 4 * WGS);
    }
    tma::bar_init_fence();
  }
  // x's padding columns stay zero (the bulk copies write C0 columns a row);
  // the affine's are zero too, so x0 is zero there
  for (int i = tid; i < rows * L.ldx * (int)sizeof(T) / 4; i += blockDim.x)
    reinterpret_cast<uint32_t*>(xs)[i] = 0u;
  for (int i = tid; i < mw::pad32(c0); i += blockDim.x) {
    mul0[i] = i < c0 ? p.mul0[i] : 0.f;
    add0[i] = i < c0 ? p.add0[i] : 0.f;
  }
  if (!direct)
    for (int i = tid; i < tile_groups * co; i += blockDim.x) otile[i] = 0;
  tma::fence_to_async();
  __syncthreads();

  if (warp >= 4 * WGS) {
    if (WGS == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == 4 * WGS) {
      // the weights: the packed chain once a tile
      if (lane == 0) {
        mw::Cursor cur;
        for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
          mw::produce_chain<T>(ch, ring, cur);
      }
    } else if (warp == 4 * WGS + 1) {
      // x: a tile's rows once its previous tile's first layer is done
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
        if (it > 0) tma::wait(x_empty, (it - 1) & 1);
        const int nrows = min(tile_groups, p.g - tile * tile_groups) * p.s;
        const T* src = p.x + (size_t)tile * tile_groups * p.s * c0;
        constexpr uint32_t kBytes = sizeof(T);
        if (p.bulk) {
          if (lane == 0) tma::expect(x_full, kBytes * nrows * c0);
          __syncwarp();
          for (int r = lane; r < nrows; r += 32)
            tma::load(xs + r * L.ldx, src + (size_t)r * c0, kBytes * c0, x_full);
        } else {
          for (int e = lane; e < nrows * c0; e += 32) {
            const int r = e / c0;
            xs[r * L.ldx + e - r * c0] = src[e];
          }
          __syncwarp();
          if (lane == 0) mw::arrive(x_full);
        }
      }
    }
    return;
  }
  if (WGS == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  // the consumers: warpgroup wg owns the tile's rows 64 wg .. 64 wg + 63
  const int wg = warp >> 2;
  mw::Cursor cur;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
    const int g0 = tile * tile_groups;
    const mw::MaxOut<T> mo{p.out + (size_t)g0 * co, otile, p.s, min(tile_groups, p.g - g0),
                           64 * wg};
    tma::wait(x_full, it & 1);
    mw::layer<true>(ch, 0, xs + 64 * wg * L.ldx, L.ldx, mul0, add0, ring, cur,
                    h[0] + 64 * wg * ldh[0], ldh[0], mo);
    __syncwarp();
    if (lane == 0) mw::arrive(x_empty);
    for (int l = 1; l < ch.layers; ++l) {
      const T* a = h[(l - 1) & 1] + 64 * wg * ldh[(l - 1) & 1];
      mw::layer<false>(ch, l, a, ldh[(l - 1) & 1], nullptr, nullptr, ring, cur,
                       h[l & 1] + 64 * wg * ldh[l & 1], ldh[l & 1], mo);
      __syncwarp();
    }
    if (!direct) {
      // every warp's maxes are in otile: write the tile's groups, clear it
      mw::named_sync(1, kConsumers);
      for (int i = tid; i < mo.groups * co; i += kConsumers) {
        mo.out[i] = elem_from_float<T>(__int_as_float(otile[i]));
        otile[i] = 0;
      }
      mw::named_sync(1, kConsumers);
    }
  }
}

// The chain's weights as the consumers' descriptors read them: per layer,
// chunks of nc columns (the last one narrower where the padded width
// calls for it), each chunk's slabs of 32 K values, a slab's hi image
// then its lo image, an image's k8 steps, each step's groups of 8 columns
// as two core matrices (K 0-3, K 4-7) of 8
// columns x 4 K values; zero past W's rows and columns.
struct Raw {
  const float* w[mw::kMaxLayers];
  int c[mw::kMaxLayers + 1];
  int layers;
};

__global__ void pack_kernel(const Raw raw, int nc, float* __restrict__ out, int total) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= total) return;
  int l = 0, base = 0;
  while (o >= base + mw::packed_floats(raw.c[l], raw.c[l + 1])) {
    base += mw::packed_floats(raw.c[l], raw.c[l + 1]);
    ++l;
  }
  const int ci = raw.c[l], co = raw.c[l + 1], kp = mw::pad32(ci), np = mw::pad32(co);
  int r = o - base;
  const int chunk = r / (2 * kp * nc);
  r -= chunk * 2 * kp * nc;
  const int ncw = min(nc, np - chunk * nc);
  const int slab = r / mw::slab_floats(ncw);
  r -= slab * mw::slab_floats(ncw);
  const int lo = r / (mw::kSlabK * ncw);
  r -= lo * mw::kSlabK * ncw;
  const int kk = r / (8 * ncw);
  r -= kk * 8 * ncw;
  const int n8 = r / 64, half = (r / 32) & 1, row = (r / 4) & 7, k4 = r & 3;
  const int k = mw::kSlabK * slab + 8 * kk + 4 * half + k4;
  const int col = chunk * nc + 8 * n8 + row;
  const float v = k < ci && col < co ? raw.w[l][(size_t)k * co + col] : 0.f;
  uint32_t hi, lov;
  split_tf32(v, hi, lov);
  out[o] = __uint_as_float(lo ? lov : hi);
}

// The bf16 form's packing: one 32-bit word (two bf16 values of consecutive
// K, the lower in the lower half) per thread, of the layout pack_kernel's
// images have with 8 K values a core-matrix row: per layer, chunks of nc
// columns, each chunk's slabs of 32 K values, a slab's two k16 steps, each
// step's groups of 8 columns as two core matrices (K 0-7, K 8-15) of 8
// columns x 8 K values; the weights rounded to bf16 (nearest even), zero
// past W's rows and columns. Plain version:
// ops/cuda/grouped_mlp.py::pack_wgmma_chain_bf16.
__global__ void pack_bf16_kernel(const Raw raw, int nc, uint32_t* __restrict__ out, int total) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= total) return;
  int l = 0, base = 0;
  while (o >= base + mw::packed_words_bf16(raw.c[l], raw.c[l + 1])) {
    base += mw::packed_words_bf16(raw.c[l], raw.c[l + 1]);
    ++l;
  }
  const int ci = raw.c[l], co = raw.c[l + 1], kp = mw::pad32(ci), np = mw::pad32(co);
  int r = 2 * (o - base);  // the word's first bf16 value
  const int chunk = r / (kp * nc);
  r -= chunk * kp * nc;
  const int ncw = min(nc, np - chunk * nc);
  const int slab = r / (mw::kSlabK * ncw);
  r -= slab * mw::kSlabK * ncw;
  const int kk = r / (16 * ncw);
  r -= kk * 16 * ncw;
  const int n8 = r / 128, half = (r / 64) & 1, row = (r / 8) & 7, k8 = r & 7;
  const int k = mw::kSlabK * slab + 16 * kk + 8 * half + k8;
  const int col = chunk * nc + 8 * n8 + row;
  const float* w = raw.w[l];
  const float v0 = k < ci && col < co ? w[(size_t)k * co + col] : 0.f;
  const float v1 = k + 1 < ci && col < co ? w[(size_t)(k + 1) * co + col] : 0.f;
  out[o] = bf16x2_rn(v0, v1);
}

int check_chain(const int* chans, int layers) {
  if (layers < 1 || layers > mw::kMaxLayers) return 0;
  for (int l = 0; l <= layers; ++l)
    if (chans[l] < 1) return 0;
  return 1;
}

template <int WGS, typename T>
cudaError_t launch(const Params<T>& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(grouped_mlp_kernel<WGS, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(p.L.total));
  if (err != cudaSuccess) return err;
  int dev, sms;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int tiles = (p.g + p.L.tile_groups - 1) / p.L.tile_groups;
  grouped_mlp_kernel<WGS, T>
      <<<min(tiles, sms), WGS * 128 + kProducerThreads, p.L.total, stream>>>(p);
  return cudaGetLastError();
}

// The first plan that fits, in the order of grouped_mlp_plan: warpgroups
// 2 then 1, chunks of 128 then 64 columns, ring slots from max_stages down
// to 2.
template <typename T>
int plan_for(const int* chans, int layers, int s, int max_stages, int* plan) {
  if (!check_chain(chans, layers) || s < 1 || s > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int wgs = 2; wgs >= 1; --wgs)
    for (int nc = mw::kMaxChunk; nc >= 64; nc /= 2)
      for (int stages = max_stages; stages >= 2; --stages) {
        Layout L;
        if (make_layout<T>(chans, layers, s, wgs, nc, stages, &L)) {
          plan[0] = wgs;
          plan[1] = nc;
          plan[2] = stages;
          plan[3] = static_cast<int>(L.total);
          return 0;
        }
      }
  return static_cast<int>(cudaErrorInvalidConfiguration);
}

// The launch of either form on x and out of T (the C entry points' shared
// body; see grouped_mlp_cuda).
template <typename T>
int run(const void* x, const void* mul0, const void* add0, const void* wpk,
        const void* const* biases, const int* chans, int layers, int g, int s, const int* plan,
        void* out, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (g < 1 || s < 1 || s > 64 || !check_chain(chans, layers))
    return static_cast<int>(cudaErrorInvalidValue);
  Params<T> p;
  if ((plan[0] != 1 && plan[0] != 2) || (plan[1] != 64 && plan[1] != mw::kMaxChunk) ||
      plan[2] < 2 || !make_layout<T>(chans, layers, s, plan[0], plan[1], plan[2], &p.L))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  p.x = static_cast<const T*>(x);
  p.mul0 = static_cast<const float*>(mul0);
  p.add0 = static_cast<const float*>(add0);
  p.chain.wpk = static_cast<const float*>(wpk);
  p.chain.layers = layers;
  p.chain.nc = plan[1];
  for (int l = 0; l <= layers; ++l) p.chain.c[l] = chans[l];
  for (int l = 0; l < layers; ++l) p.chain.b[l] = static_cast<const float*>(biases[l]);
  p.g = g;
  p.s = s;
  p.bulk = (chans[0] * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  p.out = static_cast<T*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = plan[0] == 2 ? launch<2, T>(p, st) : launch<1, T>(p, st);
  return static_cast<int>(err);
}

// One launch of a packing kernel (pack_kernel, or with kBf16
// pack_bf16_kernel) over `total` outputs of the chain's weights (float32,
// W_l (C_l, C_{l+1})) into out.
template <bool kBf16>
int pack(const void* const* weights, const int* chans, int layers, int nc, void* out, int total,
         void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!check_chain(chans, layers) || (nc != 64 && nc != mw::kMaxChunk))
    return static_cast<int>(cudaErrorInvalidValue);
  Raw raw;
  raw.layers = layers;
  for (int l = 0; l <= layers; ++l) raw.c[l] = chans[l];
  for (int l = 0; l < layers; ++l) raw.w[l] = static_cast<const float*>(weights[l]);
  const dim3 grid((total + 255) / 256);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (kBf16)
    pack_bf16_kernel<<<grid, 256, 0, st>>>(raw, nc, static_cast<uint32_t*>(out), total);
  else
    pack_kernel<<<grid, 256, 0, st>>>(raw, nc, static_cast<float*>(out), total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The launch plan for chans = (C0, ..., C_layers) and groups of s rows:
// plan[0] consumer warpgroups (2, else 1), plan[1] the chunk width nc
// (128, else 64), plan[2] the ring's slots (4 down to 2), plan[3] the
// block's shared memory bytes: the first that fits, in that order.
// Returns 0, or cudaErrorInvalidConfiguration if none fits.
int grouped_mlp_plan(const int* chans, int layers, int s, int* plan) {
  return plan_for<float>(chans, layers, s, 4, plan);
}

// The bf16 form's launch plan, as grouped_mlp_plan with the ring's slots
// from 8 down to 2 (a bf16 slab is a quarter of a TF32 one's bytes).
int grouped_mlp_bf16_plan(const int* chans, int layers, int s, int* plan) {
  return plan_for<bf16_t>(chans, layers, s, 8, plan);
}

// Floats of the packed chain for chans = (C0, ..., C_layers).
int grouped_mlp_packed_floats(const int* chans, int layers) {
  int total = 0;
  for (int l = 0; l < layers; ++l) total += mw::packed_floats(chans[l], chans[l + 1]);
  return total;
}

// 32-bit words of the bf16 form's packed chain (two bf16 values a word).
int grouped_mlp_bf16_packed_words(const int* chans, int layers) {
  int total = 0;
  for (int l = 0; l < layers; ++l) total += mw::packed_words_bf16(chans[l], chans[l + 1]);
  return total;
}

// The chain's weights[l] (C_l, C_{l+1}) for l < layers (1..4), chans =
// (C0, ..., C_layers), split and laid out in chunks of nc (64 or 128)
// columns into wpk (grouped_mlp_packed_floats(chans, layers) floats; the
// plain version is ops/cuda/grouped_mlp.py::pack_wgmma_chain). Float32,
// contiguous, on `device`. Launches on `stream`, returns the cudaError_t
// of the launch.
int grouped_mlp_pack_cuda(const void* const* weights, const int* chans, int layers, int nc,
                          void* wpk, void* stream, int device) {
  if (!check_chain(chans, layers)) return static_cast<int>(cudaErrorInvalidValue);
  return pack<false>(weights, chans, layers, nc, wpk, grouped_mlp_packed_floats(chans, layers),
                     stream, device);
}

// The bf16 form's packing of the same weights into wpk
// (grouped_mlp_bf16_packed_words(chans, layers) words; plain version
// ops/cuda/grouped_mlp.py::pack_wgmma_chain_bf16).
int grouped_mlp_bf16_pack_cuda(const void* const* weights, const int* chans, int layers, int nc,
                               void* wpk, void* stream, int device) {
  if (!check_chain(chans, layers)) return static_cast<int>(cudaErrorInvalidValue);
  return pack<true>(weights, chans, layers, nc, wpk,
                    grouped_mlp_bf16_packed_words(chans, layers), stream, device);
}

// x (G, S, C0), mul0 and add0 (C0,), wpk the chain packed by
// grouped_mlp_pack_cuda with plan[1] as nc, biases[l] (C_{l+1},) for l <
// layers (1..4), chans = (C0, ..., C_layers), plan from grouped_mlp_plan;
// all float32, contiguous. out (G, C_layers). 1 <= S <= 64. Launches on
// `stream`, does not synchronise, returns the cudaError_t of the launch (0
// on success).
int grouped_mlp_cuda(const void* x, const void* mul0, const void* add0, const void* wpk,
                     const void* const* biases, const int* chans, int layers, int g, int s,
                     const int* plan, void* out, void* stream, int device) {
  return run<float>(x, mul0, add0, wpk, biases, chans, layers, g, s, plan, out, stream, device);
}

// The bf16 form: x (G, S, C0) and out (G, C_layers) bf16, wpk packed by
// grouped_mlp_bf16_pack_cuda with plan[1] as nc, plan from
// grouped_mlp_bf16_plan; mul0, add0 and the biases float32. Otherwise as
// grouped_mlp_cuda.
int grouped_mlp_bf16_cuda(const void* x, const void* mul0, const void* add0, const void* wpk,
                          const void* const* biases, const int* chans, int layers, int g, int s,
                          const int* plan, void* out, void* stream, int device) {
  return run<bf16_t>(x, mul0, add0, wpk, biases, chans, layers, g, s, plan, out, stream,
                     device);
}

const char* grouped_mlp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
