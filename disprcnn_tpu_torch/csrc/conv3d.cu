// The PSMNet classifier's 32 -> 1 stride-1 3x3x3 conv on the CUDA cores,
// for Hopper (sm_90a), float32 and its bf16 form, canonical NCDHW layout.
//
// Replaces disprcnn_tpu/ops/pallas/packed_conv.py's _conv_call at dg = 1
// ("cl1"): the conv to one output channel, no BN (conv3d_bn_cuda):
//   out[n, 0, z, y, x] = epilogue(sum_{kd, c, kh, kw}
//       in(n, c, z + kd - 1, y + kh - 1, x + kw - 1) * wt[c, kd, kh, kw])
// (padding 1, zero outside the volume), the epilogue of conv3d.cuh: v *
// mul + add, then + residual, then ReLU. Each output sums its 27 Ci terms
// in that order, (kd, c, kh, kw), each product fused into the running sum
// (fmaf); ops/cuda/conv3d.py::conv3d_cl1_march_plain models that
// arithmetic. The other PSMNet convs are on the
// tensor cores: the stride-1 and stride-2 3D convs, the transposed conv and
// the feature tower's 2D conv in conv3d_tc.cu, the cost-volume conv in
// cost_volume_tc.cu.
//
// Bound on an H100 SXM: its input's bytes. One output channel does 27
// multiply-adds per input value read: at the main path's shape (128 ROI
// slots x 32 channels x 24 x 56 x 56) 1.23 GB, 0.37 ms at 3.35 TB/s,
// against 0.25 ms for its 8.3e9 multiply-adds at 67 TFLOP/s.
//
// Design: a depth-marching stencil that reads its input about once. The
// rows of every image, each padded by a zero row above and below, are laid
// end to end; a block owns a tile of TH = 2 G consecutive padded rows over
// the whole width (or a column tile of up to 256 columns), G row groups of
// Q quads (4 columns) laid out linearly on its threads, so that a 56-wide
// row (14 quads) leaves no lane idle at G = 16 (224 threads). The block
// marches through the depth slices one input plane at a time; per stage
// of kCG channels it copies the plane's TH + 2 rows and the channels'
// weights into shared memory, kStages stages in flight. Where W % 4 == 0
// and the tile is the whole width, the rows of one image are one
// contiguous run in x and in the stage, and warp 0 asks the Tensor Memory
// Accelerator for each (channel, run) as one bulk copy whose arrival an
// mbarrier counts; the padding rows are zeroed once. Elsewhere every
// thread copies with cp.async (16 bytes a copy where W % 4 == 0, else 4),
// the columns either side of a column tile too. Issuing the copies is
// what limits a stencil this light: per-thread copies with per-row index
// arithmetic read x well under the card's rate, one bulk copy per run of
// rows near it. A thread keeps the sums of its 2 x 4 outputs at depths z - 1,
// z and z + 1, so one staged plane serves all 27 taps: per channel and
// input row one 16-byte shared load, two shuffles for the neighbouring
// columns (a shared load where the neighbour is another row's or warp's),
// and 36 multiply-adds per output row it feeds. An output slice is written
// once its last plane (z + 1) has been added. The host picks G from the
// card's SM count (fewest warps of work on the busiest SM).
//
// conv3d_cl1_study_cuda launches the same kernel with its copies or its
// arithmetic left out, so that tools/profile_convs.py can time each alone.
//
// The bf16 form (conv3d_bn_bf16_cuda), the classifier of the JAX package's
// bf16 model: bf16 rows in (staged as bf16, converted as each quad is
// read), the weights bf16 values held in float32, float32 FMAs in the same
// order, a bf16 output rounded to nearest even. JAX's classifier rounds its
// conv to bf16 in the kernel and adds the previous classifier's cost as a
// separate bf16 add (psmnet.py:976-989); here that add stays the conv's
// residual, and the epilogue rounds the conv to bf16 before the residual
// joins and the sum again after it (conv3d.cuh round_first), JAX's two
// roundings. Its rows come by bulk copies where W % 8 == 0 (a row of 4 qw
// bf16 is then a multiple of 16 bytes: 112 at W = 56), else by 8-byte
// cp.async a quad where W % 4 == 0, else by plain loads. Bound at the main
// path's shape: the bf16 input's 0.62 GB, 0.18 ms at 3.35 TB/s, against
// the same 0.25 ms of FMAs: operations.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bf16.cuh"
#include "conv3d.cuh"
#include "tma.cuh"

namespace {

using conv::OutT;

constexpr int kTR = 2;           // output rows a thread computes
constexpr int kCG = 4;           // input channels a stage copies
constexpr int kStages = 3;       // stages in flight
constexpr int kMaxThreads = 256;
constexpr int kMaxQuads = 64;    // quads of a column tile (256 columns)
constexpr int kWPad = 28;        // a channel's 27 weights padded to 7 float4
constexpr int kMaxShared = 232448;
constexpr unsigned kFull = 0xffffffffu;

// The launch geometry, set by the host.
struct Geom {
  int n, ci, d, h, w;
  int qw;      // quads of a column tile
  int ctiles;  // column tiles
  int g;       // row groups: a tile holds kTR * g padded rows
  int vec;     // one cp.async a quad: W % 4 == 0 and x aligned to a quad
  int bulk;    // bulk copies of whole runs of rows: one column tile, rows of 16-byte multiples
};

using tma::smem_u32;

// cp.async of 16, 8 or 4 bytes, zero-filled where !valid (src is then not read)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

// one element, zero where !valid: float by cp.async; bf16 by a load and a
// store (no cp.async copies 2 bytes)
__device__ __forceinline__ void copy1(float* dst, const float* src, bool valid) {
  cp4(dst, src, valid);
}
__device__ __forceinline__ void copy1(bf16_t* dst, const bf16_t* src, bool valid) {
  *dst = valid ? __ldg(reinterpret_cast<const unsigned short*>(src)) : 0;
}

// one quad (4 columns), zero where !valid: 16 bytes (float) or 8 (bf16)
__device__ __forceinline__ void copy4(float* dst, const float* src, bool valid) {
  cp16(dst, src, valid);
}
__device__ __forceinline__ void copy4(bf16_t* dst, const bf16_t* src, bool valid) {
  cp8(dst, src, valid);
}

// a staged quad as 4 floats (one 16-byte or 8-byte shared load)
__device__ __forceinline__ float4 quad(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 quad(const bf16_t* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Bytes of one channel of a stage: TH + 2 staged rows of 4 qw columns,
// then the two columns either side of each row (in T, padded to 16 bytes),
// then the 28 float weights.
template <typename T>
__host__ __device__ inline int rows_bytes(int g, int qw) {
  return ((kTR * g + 2) * (4 * qw + 2) * (int)sizeof(T) + 15) / 16 * 16;
}
template <typename T>
__host__ __device__ inline int chan_bytes(int g, int qw) {
  return rows_bytes<T>(g, qw) + kWPad * (int)sizeof(float);
}

// The stages, then per staged row its offset in x (8 bytes), the runs of
// rows (8 bytes each, at most one a row), their count and rows (8), then a
// barrier per stage.
template <typename T>
inline size_t shared_bytes(int g, int qw) {
  return (size_t)kStages * kCG * chan_bytes<T>(g, qw) + 16 * (size_t)(kTR * g + 2) +
         8 * (size_t)(kStages + 1);
}

// kMode 0: the conv. The study's builds (float only): 1, the copies and
// their waits without the arithmetic (the outputs are zeros); 2, the
// arithmetic on stages zeroed once, with no copy.
template <int kMode, typename T>
__global__ void __launch_bounds__(kMaxThreads, 2)
cl1_kernel(const T* __restrict__ x, const float* __restrict__ wt, const Geom gm,
           const OutT<T> out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int sr = kTR * gm.g + 2;  // staged rows
  const int p = 4 * gm.qw;        // staged columns
  const int cb = chan_bytes<T>(gm.g, gm.qw);
  const int rb = rows_bytes<T>(gm.g, gm.qw);
  const int sb = kCG * cb;        // bytes of a stage
  // channel c of stage buffer b: its rows (then side columns), its weights
  auto rows = [&](int b, int c) { return reinterpret_cast<T*>(smem + b * sb + c * cb); };
  auto wts = [&](int b, int c) { return reinterpret_cast<float*>(smem + b * sb + c * cb + rb); };
  long long* rowoff = reinterpret_cast<long long*>(smem + kStages * sb);
  int2* runs = reinterpret_cast<int2*>(rowoff + sr);  // (first staged row, rows)
  int2* nruns = runs + sr;                            // (runs, rows in them)
  uint64_t* bars = reinterpret_cast<uint64_t*>(nruns + 1);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const bool active = tid < gm.g * gm.qw;
  const int grp = active ? tid / gm.qw : 0;
  const int q = active ? tid - grp * gm.qw : 0;
  const int rt = blockIdx.x / gm.ctiles, ct = blockIdx.x - rt * gm.ctiles;
  const long long hp = gm.h + 2;
  const long long prows = (long long)gm.n * hp;
  const long long p0 = (long long)rt * (kTR * gm.g);  // the tile's first padded row
  const int x0 = ct * p;                             // its first column
  const long long plane = (long long)gm.h * gm.w;

  // staged row r is padded row p0 - 1 + r: the offset of (n, 0, 0, y, 0) in
  // x, or -1 for a padding row
  for (int r = tid; r < sr; r += blockDim.x) {
    const long long pr = p0 - 1 + r;
    long long off = -1;
    if (pr >= 0 && pr < prows) {
      const long long nn = pr / hp;
      const int y = (int)(pr - nn * hp) - 1;
      if (y >= 0 && y < gm.h) off = nn * gm.ci * gm.d * plane + (long long)y * gm.w;
    }
    rowoff[r] = off;
  }
  if (gm.ctiles == 1) {
    // the columns either side of a whole-width tile are padding: zero them
    // once in every stage; no copy writes them
    for (int e = tid; e < kStages * kCG * sr * 2; e += blockDim.x) {
      const int sc = e / (sr * 2);
      rows(sc / kCG, sc % kCG)[sr * p + e % (sr * 2)] = T(0);
    }
  }
  __syncthreads();
  if (gm.bulk) {
    // the padding rows are the same in every stage: zero them once; no bulk
    // copy writes them (they are the rows outside every run)
    for (int e = warp; e < kStages * kCG * sr; e += nwarps) {
      const int r = e % sr;
      if (rowoff[r] >= 0) continue;
      const int sc = e / sr;
      T* row = rows(sc / kCG, sc % kCG) + r * p;
      for (int k = lane; k < p; k += 32) row[k] = T(0);
    }
    if (tid == 0) {
      // runs of rows of one image, contiguous in x and in the stage
      int nr = 0, nrows = 0;
      for (int r = 0; r < sr;) {
        if (rowoff[r] < 0) {
          ++r;
          continue;
        }
        int k = 1;
        while (r + k < sr && rowoff[r + k] >= 0 && rowoff[r + k] == rowoff[r] + (long long)k * gm.w)
          ++k;
        runs[nr++] = make_int2(r, k);
        nrows += k;
        r += k;
      }
      *nruns = make_int2(nr, nrows);
      for (int b = 0; b < kStages; ++b) tma::bar_init(bars + b);
      tma::bar_init_fence();
    }
    __syncthreads();
  }

  const int ngroups = (gm.ci + kCG - 1) / kCG;
  const int nstage = gm.d * ngroups;
  // the copies of a staged row: lpr lanes a row, rpw rows a warp step
  const int lpr = gm.qw < 32 ? gm.qw : 32;
  const int rpw = 32 / lpr;
  const int sub = lane / lpr, lq = lane - sub * lpr;

  auto issue = [&](int s) {
    if constexpr (kMode == 2) return;
    const int b = s % kStages;
    if (gm.bulk) {
      // warp 0: one lane per (channel, run) or channel's weights
      if (warp == 0 && s < nstage) {
        uint64_t* bar = bars + b;
        const int zi = s / ngroups, c0 = (s - zi * ngroups) * kCG;
        const int nc = min(kCG, gm.ci - c0);
        const int2 nr = *nruns;
        // the stage's buffer was last read before this iteration's barrier
        tma::fence_to_async();
        if (lane == 0)  // rows and weights
          tma::expect(bar, nc * (nr.y * p * (int)sizeof(T) + kWPad * (int)sizeof(float)));
        __syncwarp();
        for (int t = lane; t < nc * (nr.x + 1); t += 32) {
          const int c = t / (nr.x + 1), k = t - c * (nr.x + 1);
          if (k < nr.x) {
            const int2 run = runs[k];
            tma::load(rows(b, c) + run.x * p,
                      x + rowoff[run.x] + ((long long)(c0 + c) * gm.d + zi) * plane,
                      run.y * p * (int)sizeof(T), bar);
          } else {
            tma::load(wts(b, c), wt + (size_t)(c0 + c) * kWPad, kWPad * (int)sizeof(float), bar);
          }
        }
      }
      return;
    }
    if (s < nstage) {
      const int zi = s / ngroups, c0 = (s - zi * ngroups) * kCG;
#pragma unroll
      for (int c = 0; c < kCG; ++c) {
        const bool cok = c0 + c < gm.ci;
        const T* xc = x + (cok ? ((long long)(c0 + c) * gm.d + zi) * plane + x0 : 0);
        T* sc = rows(b, c);
        for (int r = warp * rpw + sub; sub < rpw && r < sr; r += nwarps * rpw) {
          const long long ro = rowoff[r];
          const bool ok = cok && ro >= 0;
          const T* src = ok ? xc + ro : x;
          T* dst = sc + r * p;
          if (gm.vec) {
            for (int qq = lq; qq < gm.qw; qq += lpr)
              copy4(dst + 4 * qq, src + (ok ? 4 * qq : 0), ok && x0 + 4 * qq < gm.w);
          } else {
            for (int e = lq; e < p; e += lpr)
              copy1(dst + e, src + (ok ? e : 0), ok && x0 + e < gm.w);
          }
        }
      }
      if (gm.ctiles > 1) {
        // column x0 - 1 and column x0 + p of each staged row
        for (int e = tid; e < kCG * sr * 2; e += blockDim.x) {
          const int c = e / (sr * 2), r = (e >> 1) - c * sr, side = e & 1;
          const int col = side ? x0 + p : x0 - 1;
          const long long ro = rowoff[r];
          const bool ok = ro >= 0 && c0 + c < gm.ci && col >= 0 && col < gm.w;
          copy1(rows(b, c) + sr * p + 2 * r + side,
                ok ? x + ro + ((long long)(c0 + c) * gm.d + zi) * plane + col : x, ok);
        }
      }
      for (int e = tid; e < kCG * (kWPad / 4); e += blockDim.x) {
        const int c = e / (kWPad / 4), k = e - c * (kWPad / 4);
        const bool ok = c0 + c < gm.ci;
        cp16(wts(b, c) + 4 * k, ok ? wt + (size_t)(c0 + c) * kWPad + 4 * k : wt, ok);
      }
    }
    cp_commit();
  };

  // where this thread finds the columns left and right of its quad in a
  // staged row: in the neighbouring lane (a shuffle), else in shared memory
  // (the halo columns at the tile's edges, the row itself at a warp's)
  const bool need_l = q == 0 || lane == 0;
  const bool need_r = q == gm.qw - 1 || lane == 31;
  const int row0 = grp * kTR;
  const int lofs = q == 0 ? sr * p + 2 * row0 : row0 * p + 4 * q - 1;
  const int lstr = q == 0 ? 2 : p;
  const int rofs = q == gm.qw - 1 ? sr * p + 2 * row0 + 1 : row0 * p + 4 * q + 4;
  const int rstr = q == gm.qw - 1 ? 2 : p;

  // the image and row of each output row, y = -1 for a padding row
  long long on[kTR];
  int oy[kTR];
#pragma unroll
  for (int rr = 0; rr < kTR; ++rr) {
    const long long pr = p0 + row0 + rr;
    on[rr] = pr / hp;
    oy[rr] = active && pr < prows ? (int)(pr - on[rr] * hp) - 1 : -1;
    if (oy[rr] >= gm.h) oy[rr] = -1;
  }
  auto store = [&](const float (&a)[kTR][4], int z) {
#pragma unroll
    for (int rr = 0; rr < kTR; ++rr) {
      if (oy[rr] < 0) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int xx = x0 + 4 * q + j;
        if (xx < gm.w) out.store((int)on[rr], 0, z, oy[rr], xx, a[rr][j]);
      }
    }
  };

  // acc[0]: output slice zi - 1 (gets the plane's kd = 2 taps), acc[1]: zi
  // (kd = 1), acc[2]: zi + 1 (kd = 0)
  float acc[3][kTR][4];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int rr = 0; rr < kTR; ++rr)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[k][rr][j] = 0.f;

  if constexpr (kMode == 2) {
    for (int e = tid; e < kStages * sb; e += blockDim.x) smem[e] = 0;
    __syncthreads();
  }
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int s = 0; s < nstage; ++s) {
    if constexpr (kMode != 2) {
      if (gm.bulk)
        tma::wait(bars + s % kStages, (s / kStages) & 1);  // stage s has landed
      else
        cp_wait<kStages - 2>();  // this thread's copies of stage s have landed
    }
    __syncthreads();  // everyone's; and stage s - 1 is read
    issue(s + kStages - 1);
    const int zi = s / ngroups, c0 = (s - zi * ngroups) * kCG;
#pragma unroll 1
    for (int c = 0; c < kCG; ++c) {
      if (kMode == 1 || c0 + c >= gm.ci) break;
      const T* cbase = rows(s % kStages, c);
      const float* cw = wts(s % kStages, c);
      float wv[kWPad];
#pragma unroll
      for (int k = 0; k < kWPad / 4; ++k) {
        const float4 t = reinterpret_cast<const float4*>(cw)[k];
        wv[4 * k] = t.x;
        wv[4 * k + 1] = t.y;
        wv[4 * k + 2] = t.z;
        wv[4 * k + 3] = t.w;
      }
#pragma unroll
      for (int i = 0; i < kTR + 2; ++i) {
        const float4 v = quad(cbase + (row0 + i) * p + 4 * q);
        float l = __shfl_up_sync(kFull, v.w, 1);
        float r = __shfl_down_sync(kFull, v.x, 1);
        if (need_l) l = elem_to_float(cbase[lofs + i * lstr]);
        if (need_r) r = elem_to_float(cbase[rofs + i * rstr]);
        const float u[6] = {l, v.x, v.y, v.z, v.w, r};
#pragma unroll
        for (int rr = 0; rr < kTR; ++rr) {
          const int kh = i - rr;
          if (kh < 0 || kh > 2) continue;
#pragma unroll
          for (int kw = 0; kw < 3; ++kw)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float a = u[j + kw];
              acc[0][rr][j] = fmaf(a, wv[18 + 3 * kh + kw], acc[0][rr][j]);
              acc[1][rr][j] = fmaf(a, wv[9 + 3 * kh + kw], acc[1][rr][j]);
              acc[2][rr][j] = fmaf(a, wv[3 * kh + kw], acc[2][rr][j]);
            }
        }
      }
    }
    if (c0 + kCG >= gm.ci) {  // plane zi is done: slice zi - 1 is complete
      if (zi >= 1) store(acc[0], zi - 1);
#pragma unroll
      for (int rr = 0; rr < kTR; ++rr)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[0][rr][j] = acc[1][rr][j];
          acc[1][rr][j] = acc[2][rr][j];
          acc[2][rr][j] = 0.f;
        }
    }
  }
  cp_wait<0>();
  store(acc[0], gm.d - 1);  // the last slice (plane d is padding)
}

// Row groups G for quads of qw: among those whose block fits (threads,
// shared memory), the fewest warps of work on the busiest SM when the
// tiles spread evenly, ties to the larger tile (fewer halo rows).
template <typename T>
int pick_groups(long long padded_rows, int ctiles, int qw, int sms) {
  int best = 0;
  long long best_cost = 0;
  for (int g = 1; g * qw <= kMaxThreads; ++g) {
    if (shared_bytes<T>(g, qw) > (size_t)kMaxShared) break;
    const long long tiles = (padded_rows + kTR * g - 1) / (kTR * g) * ctiles;
    const long long warps = (g * qw + 31) / 32;
    const long long cost = (tiles + sms - 1) / sms * warps;
    if (best == 0 || cost <= best_cost) {
      best = g;
      best_cost = cost;
    }
  }
  return best;
}

template <int kMode, typename T>
int launch(const void* x, int n, int ci, int d, int h, int w, const void* wt, const void* mul,
           const void* add, const void* res, int relu, void* out, void* stream, int device) {
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: set it to the tensors' device
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ci < 1 || (reinterpret_cast<uintptr_t>(wt) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int quads = (w + 3) / 4;
  const int ctiles = (quads + kMaxQuads - 1) / kMaxQuads;
  const int qw = (quads + ctiles - 1) / ctiles;
  if (!conv::grid_fits(n, d, h, w, kTR, 4 * qw)) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long padded_rows = (long long)n * (h + 2);
  const int g = pick_groups<T>(padded_rows, ctiles, qw, sms);
  if (g == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long blocks = (padded_rows + kTR * g - 1) / (kTR * g) * ctiles;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kQuadBytes = 4 * sizeof(T);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const int vec = w % 4 == 0 && xa % kQuadBytes == 0;
  // a bulk copy moves whole rows: 4 qw T a row, a multiple of 16 bytes
  const int bulk = vec && ctiles == 1 && (w * (int)sizeof(T)) % 16 == 0 && xa % 16 == 0;
  const Geom gm{n, ci, d, h, w, qw, ctiles, g, vec, bulk};
  const size_t bytes = shared_bytes<T>(g, qw);
  err = cudaFuncSetAttribute(cl1_kernel<kMode, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 32 * ((g * qw + 31) / 32);
  cl1_kernel<kMode, T><<<static_cast<unsigned>(blocks), threads, bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(wt), gm,
      conv::make_out<T>(out, mul, add, res, 1, d, h, w, relu, std::is_same<T, bf16_t>::value));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (N, Ci, D, H, W); wt (Ci, 28): the torch weight (1, Ci, 3, 3, 3) as
// (Ci, 27) in (kd, kh, kw) order, padded with a zero to 28; the stride-1
// pad-1 conv to one output channel (the classifier's), out (N, 1, D, H, W);
// mul, add (1,); res of the output's shape or null. All float32,
// contiguous, on `device`, wt 16-byte aligned. Launches on `stream`, does
// not synchronise, returns the cudaError_t of the launch (0 on success).
// Co 32 and 64 are conv3d_tc.cu's.
int conv3d_bn_cuda(const void* x, int n, int ci, int d, int h, int w, const void* wt,
                   const void* mul, const void* add, const void* res, int relu, void* out,
                   void* stream, int device) {
  return launch<0, float>(x, n, ci, d, h, w, wt, mul, add, res, relu, out, stream, device);
}

// conv3d_bn_cuda's bf16 form: x, res and out bf16; wt float32 holding
// bf16 values (the weight rounded to bf16); mul and add float32. The conv
// is rounded to bf16 before the residual joins, the sum again after it.
int conv3d_bn_bf16_cuda(const void* x, int n, int ci, int d, int h, int w, const void* wt,
                        const void* mul, const void* add, const void* res, int relu, void* out,
                        void* stream, int device) {
  return launch<0, bf16_t>(x, n, ci, d, h, w, wt, mul, add, res, relu, out, stream, device);
}

// conv3d_bn_cuda's arguments, then the study's mode: 1 copies only, 2
// arithmetic only (the kernel's kMode); 0 is the conv itself.
int conv3d_cl1_study_cuda(const void* x, int n, int ci, int d, int h, int w, const void* wt,
                          const void* mul, const void* add, const void* res, int relu, void* out,
                          void* stream, int device, int mode) {
  switch (mode) {
    case 0:
      return launch<0, float>(x, n, ci, d, h, w, wt, mul, add, res, relu, out, stream, device);
    case 1:
      return launch<1, float>(x, n, ci, d, h, w, wt, mul, add, res, relu, out, stream, device);
    case 2:
      return launch<2, float>(x, n, ci, d, h, w, wt, mul, add, res, relu, out, stream, device);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* conv3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
