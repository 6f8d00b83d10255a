// The shared-MLP chain of the grouped MLP + max kernel (grouped_mlp.cu, its
// only user) on Hopper's warpgroup tensor-core products (wgmma, sm_90a),
// float32 in and out at float32 accuracy; and its bf16 form (below: bf16
// operands, one product a k16 step).
//
// A warpgroup (4 warps) owns 64 activation rows of a tile, held as float32
// in shared memory; each dense layer Y = relu(X W + b) runs as chunks of
// nc = 128 or 64 output columns (the launch's choice; the last chunk 32,
// 64 or 96 wide where the padded width calls for it), each chunk an (64 x
// K) by (K x NCW) product of wgmma.mma_async.m64nNCWk8 with TF32 operands
// and float32 accumulators.
// Float32 accuracy comes from the 3xTF32 split of tf32.cuh (v = hi + lo,
// both rounded to TF32 by split_tf32; a product is lo*hi + hi*lo + hi*hi),
// as in mlp_tc.cuh.
//
// A (the activations) comes from registers: warp w of the warpgroup holds
// rows 16 w .. 16 w + 15 as mma.m16n8k8's A fragment (a0 (row g, col t), a1
// (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4), g = lane / 4, t = lane %
// 4), read from shared memory (leading dimension 4 mod 32: the 32 lanes of
// a read fall in 32 distinct banks) and split in registers, the next
// slab's while this slab's products run. The accumulators are laid out
// the same way, so a warp's output rows are the rows its next layer reads:
// between layers a warp needs no other warp.
//
// B (the weights) comes from shared memory through a matrix descriptor, in
// the K-major layout without swizzle that wgmma reads for TF32: core
// matrices of 8 output columns x 4 K values (8 rows of 16 bytes, 128
// contiguous bytes, so a core matrix is read without bank conflicts), the
// two K halves of a k8 step 128 bytes apart (the descriptor's leading
// byte offset) and successive groups of 8 columns 256 bytes apart (its
// stride byte offset). Each layer's weights are packed ahead of the launch
// into exactly that image, padded with zeros to multiples of 32 in K and
// N, cut into chunks of nc columns and each chunk into slabs of 32 K
// values, a slab's TF32 hi image followed by its lo image
// (grouped_mlp.cu's pack_kernel; plain version
// ops/cuda/grouped_mlp.py::pack_wgmma_chain). The packed chain is one
// sequence of slabs in the order the consumers use them, so a producer
// thread streams it with one 1-D bulk copy (tma.cuh) a slab through a ring
// of `stages` slots, each with a full and an empty mbarrier.
//
// Promotion: the tensor cores' own adds truncate, so each slab's 32 terms
// are summed in a separate set of accumulators (written with scale-d = 0
// at its first product) and then added to the running float32 sums with
// rounding to nearest; within a slab the small products (lo*hi, hi*lo)
// go first, so that only the four hi*hi steps add into a sum of full
// size.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"
#include "tf32.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace mlp_wgmma {

constexpr int kMaxLayers = 4;
constexpr int kSlabK = 32;            // K values of a slab; widths are padded to this
constexpr int kSlabK8 = kSlabK / 8;   // k8 steps of a slab
constexpr int kMaxChunk = 128;        // output columns of a chunk: 128, or 64
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int pad32(int c) { return (c + kSlabK - 1) & ~(kSlabK - 1); }

// leading dimension of an activation buffer of c columns: >= pad32(c), = 4
// (mod 32)
__host__ __device__ inline int lead(int c) { return pad32(c) + 4; }

// floats of one layer's packed image (hi and lo)
__host__ __device__ inline int packed_floats(int ci, int co) { return 2 * pad32(ci) * pad32(co); }

// floats of one slab of ncw columns (hi and lo)
__host__ __device__ inline int slab_floats(int ncw) { return 2 * kSlabK * ncw; }

// The bf16 form's sizes: a row of c bf16 activations has a leading
// dimension of pad32(c) + 8 values (= 4 mod 32 words, as the float32
// form's); a layer's packed image and a slab are bf16 values counted in
// 32-bit words (two a word): one image, no split.
__host__ __device__ inline int lead_bf16(int c) { return pad32(c) + 8; }
__host__ __device__ inline int packed_words_bf16(int ci, int co) {
  return pad32(ci) * pad32(co) / 2;
}
__host__ __device__ inline int slab_words_bf16(int ncw) { return kSlabK * ncw / 2; }

// a slab's size in 32-bit words for a chain of T (float or bf16_t)
template <typename T>
__host__ __device__ inline int slab_words(int ncw) {
  return std::is_same<T, float>::value ? slab_floats(ncw) : slab_words_bf16(ncw);
}

// Dense layers of a chain, each followed by ReLU: wpk the packed images,
// layer after layer, b[l] layer l's bias (c[l + 1],), nc the chunk width
// (128 or 64) the images were packed for.
struct Chain {
  const float* wpk;
  const float* b[kMaxLayers];
  int c[kMaxLayers + 1];
  int layers;
  int nc;
};

// The ring of weight slabs in shared memory: `stages` slots of slot_floats
// floats; full[i] completes with slot i's bulk copy, empty[i] with one
// arrival of each consumer warp.
struct Ring {
  float* slot;
  uint64_t* full;
  uint64_t* empty;
  int stages, slot_floats;
};

// A thread's place in the ring: the slot and the parity of its round
struct Cursor {
  int stage = 0;
  uint32_t phase = 0;
  __device__ void next(int stages) {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

using wg::arrive;
using wg::bar_init;
using wg::fence_regs;
using wg::named_sync;

// wgmma's matrix descriptor of the packed weights at `p` (K-major, no
// swizzle): leading byte offset 128 (the second K half of a k8 step),
// stride byte offset 256 (the next 8 columns)
__device__ __forceinline__ uint64_t desc(const float* p) {
  return wg::desc(tma::smem_u32(p), 128, 256);
}

// d (+)= a * b: a 64 x 8 TF32 tile from registers (a warp's rows as
// mma.m16n8k8's A fragment), b 8 x N from shared memory through its
// descriptor, d the m64nN float32 accumulators (d[4 j + 2 h + e] = row g +
// 8 h, column 8 j + 2 t + e of the warp's 16 rows); scale_d = 0 writes d.
template <int N>
__device__ __forceinline__ void mma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                    int scale_d);

template <>
__device__ __forceinline__ void mma<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                        int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                        int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma<96>(float (&d)[48], const uint32_t (&a)[4], uint64_t b,
                                        int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                        int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// The A fragments of slab s (k8 steps 4 s .. 4 s + 3) of the warp's rows
// at ap (row g, column t of the warp's first row), split; AFFINE: x0 =
// relu(A * mul0 + add0) on the way.
template <bool AFFINE>
__device__ __forceinline__ void load_a(const float* ap, int lda, int s, const float* mul0,
                                       const float* add0, uint32_t (&ah)[kSlabK8][4],
                                       uint32_t (&al)[kSlabK8][4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < kSlabK8; ++kk) {
    const int col = kSlabK * s + 8 * kk;
    const float* p = ap + col;
    float v[4] = {p[0], p[8 * lda], p[4], p[8 * lda + 4]};
    if (AFFINE) {
      const float m0 = mul0[col + t], a0 = add0[col + t];
      const float m1 = mul0[col + t + 4], a1 = add0[col + t + 4];
      v[0] = fmaxf(fmaf(v[0], m0, a0), 0.f);
      v[1] = fmaxf(fmaf(v[1], m0, a0), 0.f);
      v[2] = fmaxf(fmaf(v[2], m1, a1), 0.f);
      v[3] = fmaxf(fmaf(v[3], m1, a1), 0.f);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(v[e], ah[kk][e], al[kk][e]);
  }
}

// One slab of a chunk's product: part = the slab's products of the
// fragments (ch, cl) and the slab in the ring, the small ones first, then
// acc += part; while they run, the next slab's fragments go into (nh,
// nl) if there is one.
template <int NCW, bool AFFINE>
__device__ __forceinline__ void slab_product(const float* ap, int lda, int s, int slabs,
                                             const float* mul0, const float* add0,
                                             const uint32_t (&ch)[kSlabK8][4],
                                             const uint32_t (&cl)[kSlabK8][4],
                                             uint32_t (&nh)[kSlabK8][4],
                                             uint32_t (&nl)[kSlabK8][4], const Ring& ring,
                                             Cursor& cur, float (&part)[NCW / 2],
                                             float (&acc)[NCW / 2]) {
  tma::wait(&ring.full[cur.stage], cur.phase);
  const float* slot = ring.slot + (size_t)cur.stage * ring.slot_floats;
  fence_regs<NCW / 2>(part);
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < kSlabK8; ++kk)
    mma<NCW>(part, cl[kk], desc(slot + 8 * NCW * kk), kk != 0);
#pragma unroll
  for (int kk = 0; kk < kSlabK8; ++kk)
    mma<NCW>(part, ch[kk], desc(slot + kSlabK * NCW + 8 * NCW * kk), 1);
#pragma unroll
  for (int kk = 0; kk < kSlabK8; ++kk) mma<NCW>(part, ch[kk], desc(slot + 8 * NCW * kk), 1);
  wg::commit();
  if (s + 1 < slabs) load_a<AFFINE>(ap, lda, s + 1, mul0, add0, nh, nl);
  wg::wait<0>();
  fence_regs<NCW / 2>(part);
  __syncwarp();
  if ((threadIdx.x & 31) == 0) arrive(&ring.empty[cur.stage]);
  cur.next(ring.stages);
  // the slab's sums join the running ones in float32, rounded to nearest
#pragma unroll
  for (int i = 0; i < NCW / 2; ++i) acc[i] += part[i];
}

// acc = rows 16 w .. 16 w + 15 (w the warp in its warpgroup) of A (shared,
// lda, the warpgroup's 64 rows) times the current chunk of NCW columns,
// its pad32(K) / 32 slabs taken from the ring in order. AFFINE: A is the
// raw input, x0 = relu(A * mul0 + add0) is formed on the way into the
// fragments (mul0 and add0 in shared memory, zero past the input width).
// Two sets of fragments take turns: one feeds a slab's products while the
// next slab's are loaded into the other.
template <int NCW, bool AFFINE>
__device__ __forceinline__ void chunk_product(const float* A, int lda, int kp,
                                              const float* mul0, const float* add0,
                                              const Ring& ring, Cursor& cur,
                                              float (&acc)[NCW / 2]) {
  const float* ap = A + (16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2)) * lda +
                    (threadIdx.x & 3);
#pragma unroll
  for (int i = 0; i < NCW / 2; ++i) acc[i] = 0.f;
  float part[NCW / 2];
  const int slabs = kp / kSlabK;
  uint32_t h0[kSlabK8][4], l0[kSlabK8][4], h1[kSlabK8][4], l1[kSlabK8][4];
  load_a<AFFINE>(ap, lda, 0, mul0, add0, h0, l0);
  for (int s = 0; s < slabs; s += 2) {
    slab_product<NCW, AFFINE>(ap, lda, s, slabs, mul0, add0, h0, l0, h1, l1, ring, cur, part,
                              acc);
    if (s + 1 < slabs)
      slab_product<NCW, AFFINE>(ap, lda, s + 1, slabs, mul0, add0, h1, l1, h0, l0, ring, cur,
                                part, acc);
  }
}

// Y (shared, ldy, the warpgroup's 64 rows) = relu(acc + b) in the chunk's
// columns n0 .. n0 + NCW - 1 (zero past co): a hidden layer's epilogue
// into the next layer's input.
template <int NCW>
__device__ __forceinline__ void store_relu(const float (&acc)[NCW / 2],
                                           const float* __restrict__ bias, int co, int n0,
                                           float* Y, int ldy) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float* y = Y + (16 * ((threadIdx.x >> 5) & 3) + g) * ldy;
#pragma unroll
  for (int j = 0; j < NCW / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;
    const float b0 = col < co ? __ldg(bias + col) : 0.f;
    const float b1 = col + 1 < co ? __ldg(bias + col + 1) : 0.f;
    *reinterpret_cast<float2*>(y + col) =
        make_float2(fmaxf(acc[4 * j] + b0, 0.f), fmaxf(acc[4 * j + 1] + b1, 0.f));
    *reinterpret_cast<float2*>(y + 8 * ldy + col) =
        make_float2(fmaxf(acc[4 * j + 2] + b0, 0.f), fmaxf(acc[4 * j + 3] + b1, 0.f));
  }
}

// Where the max over each group of s consecutive rows of a tile goes: a
// group within one warp's 16 rows (s divides 16) is reduced by shuffles
// and stored to out (device memory of O, float or bf16_t, the tile's first
// group at row 0); any other is combined in shared memory, otile (groups x
// co, the float bits of values >= 0 as ints, zero to start), by atomicMax:
// s a multiple of 16 after a shuffle max over each warp's 16 rows, else
// value by value. A bf16 output is the max rounded to bf16 once, which is
// the max of the rounded values (rounding is monotone).
template <typename O>
struct MaxOut {
  O* out;
  int* otile;
  int s, groups, row0;  // row0: the warpgroup's first row in the tile
};

// The chunk's columns n0 .. n0 + NCW - 1 of the last layer: relu(acc + b)
// reduced into the max over each group.
template <int NCW, typename O>
__device__ __forceinline__ void store_max(const float (&acc)[NCW / 2],
                                          const float* __restrict__ bias, int co, int n0,
                                          const MaxOut<O>& mo) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wrow = mo.row0 + 16 * ((threadIdx.x >> 5) & 3);  // the warp's first row
  const int s = mo.s;
#pragma unroll
  for (int j = 0; j < NCW / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = n0 + 8 * j + 2 * t + e;
      const bool in = col < co;
      const float bv = in ? __ldg(bias + col) : 0.f;
      const float v0 = fmaxf(acc[4 * j + e] + bv, 0.f);      // row wrow + g
      const float v1 = fmaxf(acc[4 * j + 2 + e] + bv, 0.f);  // row wrow + g + 8
      if (s % 16 == 0) {
        float x = fmaxf(v0, v1);
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
        const int q = wrow / s;
        if (g == 0 && in && q < mo.groups) {
          if (s == 16) mo.out[(size_t)q * co + col] = elem_from_float<O>(x);
          else atomicMax(mo.otile + q * co + col, __float_as_int(x));
        }
      } else if (16 % s == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float x = h ? v1 : v0;
          for (int o = 1; o < s; o <<= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, 4 * o));
          const int q = (wrow + 8 * h + g) / s;
          if (g % s == 0 && in && q < mo.groups)
            mo.out[(size_t)q * co + col] = elem_from_float<O>(x);
        }
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = (wrow + 8 * h + g) / s;
          if (in && q < mo.groups) atomicMax(mo.otile + q * co + col, __float_as_int(h ? v1 : v0));
        }
      }
    }
  }
}

// One chunk of layer l: its product, then into Y (hidden) or the max (last)
template <int NCW, bool AFFINE>
__device__ __forceinline__ void chunk(const Chain& ch, int l, int n0, const float* A, int lda,
                                      const float* mul0, const float* add0, const Ring& ring,
                                      Cursor& cur, float* Y, int ldy, const MaxOut<float>& mo) {
  float acc[NCW / 2];
  chunk_product<NCW, AFFINE>(A, lda, pad32(ch.c[l]), mul0, add0, ring, cur, acc);
  if (l + 1 < ch.layers) store_relu<NCW>(acc, ch.b[l], ch.c[l + 1], n0, Y, ldy);
  else store_max<NCW>(acc, ch.b[l], ch.c[l + 1], n0, mo);
}

// Layer l over the warpgroup's 64 rows of A (shared, lda), chunk by chunk
// of ch.nc columns (the last one 32, 64 or 96 wide where pad32(c[l + 1])
// is not a multiple of nc), into Y (ldy, the warpgroup's rows) or, for
// the last layer, the max over each group (mo).
template <bool AFFINE>
__device__ void layer(const Chain& ch, int l, const float* A, int lda, const float* mul0,
                      const float* add0, const Ring& ring, Cursor& cur, float* Y, int ldy,
                      const MaxOut<float>& mo) {
  const int np = pad32(ch.c[l + 1]);
  for (int n0 = 0; n0 < np; n0 += ch.nc) {
    const int ncw = min(ch.nc, np - n0);
    if (ncw == 128)
      chunk<128, AFFINE>(ch, l, n0, A, lda, mul0, add0, ring, cur, Y, ldy, mo);
    else if (ncw == 96)
      chunk<96, AFFINE>(ch, l, n0, A, lda, mul0, add0, ring, cur, Y, ldy, mo);
    else if (ncw == 64)
      chunk<64, AFFINE>(ch, l, n0, A, lda, mul0, add0, ring, cur, Y, ldy, mo);
    else
      chunk<32, AFFINE>(ch, l, n0, A, lda, mul0, add0, ring, cur, Y, ldy, mo);
  }
}

// ---------------------------------------------------------------------------
// The bf16 form: a bf16 model's chain (the TPU kernel's arithmetic,
// disprcnn_tpu/ops/pallas/grouped_mlp.py:26-40). The activations are bf16
// in shared memory (rows of lead_bf16 values), the weights one bf16 image
// (rounded to nearest even by the packing), and each k16 step one product
// wgmma.mma_async.m64nNk16.f32.bf16.bf16: a product of two bf16 values is
// exact in float32, so the chain is the float32 sums of exact products, in
// another order than the TPU's or the plain version's. A is mma.m16n8k16's
// A fragment from registers (a0 (row g, K 2t, 2t + 1), a1 (g + 8, 2t,
// 2t + 1), a2 (g, 2t + 8, 2t + 9), a3 (g + 8, 2t + 8, 2t + 9), two bf16 a
// 32-bit word, the lower K in the lower half), read as words at the
// float32 form's bank pattern; the first layer forms x0 = bf16(relu(x *
// mul0 + add0)) on the way in (the product and the sum each rounded in
// float32, as the TPU kernel and the plain version compute them). B comes
// from shared memory through the same descriptor as the TF32 form's: its
// core matrices are 8 columns x 8 K values, again 8 rows of 16 bytes, so
// the leading byte offset (the second K half of a k16 step) is 128 and the
// stride byte offset (the next 8 columns) 256. A slab is 32 K values, two
// k16 steps, a quarter of a TF32 slab's bytes; its sums are promoted into
// the running float32 sums as the TF32 form's are (the tensor cores' adds
// truncate). Each layer's epilogue adds the float32 bias, applies the ReLU
// and rounds to bf16; the last layer's max is taken in float32 and rounded
// once at the store.

// d (+)= a * b: a 64 x 16 bf16 tile from registers, b 16 x N bf16 from
// shared memory through its descriptor; d as in mma<N>.
template <int N>
__device__ __forceinline__ void mma_bf16(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d);

template <>
__device__ __forceinline__ void mma_bf16<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_bf16<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_bf16<96>(float (&d)[48], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_bf16<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ uint32_t lds32(const bf16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A fragments of slab s (k16 steps 2 s, 2 s + 1) of the warp's rows at
// ap (row g, column 2 t of the warp's first row); AFFINE: x0 = bf16(relu(x
// * mul0 + add0)) on the way.
template <bool AFFINE>
__device__ __forceinline__ void load_a_bf16(const bf16_t* ap, int lda, int s, const float* mul0,
                                            const float* add0, uint32_t (&a)[2][4]) {
  const int t2 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const int col = kSlabK * s + 16 * kk;
    const bf16_t* p = ap + col;
    a[kk][0] = lds32(p);
    a[kk][1] = lds32(p + 8 * lda);
    a[kk][2] = lds32(p + 8);
    a[kk][3] = lds32(p + 8 * lda + 8);
    if (AFFINE) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = col + t2 + (e >= 2 ? 8 : 0);
        const float lo = bf16_to_float(static_cast<bf16_t>(a[kk][e] & 0xFFFFu));
        const float hi = bf16_to_float(static_cast<bf16_t>(a[kk][e] >> 16));
        a[kk][e] = bf16x2_rn(fmaxf(__fadd_rn(__fmul_rn(lo, mul0[c]), add0[c]), 0.f),
                             fmaxf(__fadd_rn(__fmul_rn(hi, mul0[c + 1]), add0[c + 1]), 0.f));
      }
    }
  }
}

// One slab of a chunk's product in bf16: part = the slab's two k16
// products of the fragments ca and the slab in the ring, then acc += part;
// while they run, the next slab's fragments go into na if there is one.
template <int NCW, bool AFFINE>
__device__ __forceinline__ void slab_product_bf16(const bf16_t* ap, int lda, int s, int slabs,
                                                  const float* mul0, const float* add0,
                                                  const uint32_t (&ca)[2][4],
                                                  uint32_t (&na)[2][4], const Ring& ring,
                                                  Cursor& cur, float (&part)[NCW / 2],
                                                  float (&acc)[NCW / 2]) {
  tma::wait(&ring.full[cur.stage], cur.phase);
  const float* slot = ring.slot + (size_t)cur.stage * ring.slot_floats;
  fence_regs<NCW / 2>(part);
  wg::fence();
  mma_bf16<NCW>(part, ca[0], desc(slot), 0);
  mma_bf16<NCW>(part, ca[1], desc(slot + 8 * NCW), 1);
  wg::commit();
  if (s + 1 < slabs) load_a_bf16<AFFINE>(ap, lda, s + 1, mul0, add0, na);
  wg::wait<0>();
  fence_regs<NCW / 2>(part);
  __syncwarp();
  if ((threadIdx.x & 31) == 0) arrive(&ring.empty[cur.stage]);
  cur.next(ring.stages);
#pragma unroll
  for (int i = 0; i < NCW / 2; ++i) acc[i] += part[i];
}

// chunk_product of the bf16 form: acc = the warp's 16 rows of A (bf16,
// lda) times the current chunk of NCW columns, slab by slab from the ring.
template <int NCW, bool AFFINE>
__device__ __forceinline__ void chunk_product_bf16(const bf16_t* A, int lda, int kp,
                                                   const float* mul0, const float* add0,
                                                   const Ring& ring, Cursor& cur,
                                                   float (&acc)[NCW / 2]) {
  const bf16_t* ap = A + (16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2)) * lda +
                     2 * (threadIdx.x & 3);
#pragma unroll
  for (int i = 0; i < NCW / 2; ++i) acc[i] = 0.f;
  float part[NCW / 2];
  const int slabs = kp / kSlabK;
  uint32_t a0[2][4], a1[2][4];
  load_a_bf16<AFFINE>(ap, lda, 0, mul0, add0, a0);
  for (int s = 0; s < slabs; s += 2) {
    slab_product_bf16<NCW, AFFINE>(ap, lda, s, slabs, mul0, add0, a0, a1, ring, cur, part, acc);
    if (s + 1 < slabs)
      slab_product_bf16<NCW, AFFINE>(ap, lda, s + 1, slabs, mul0, add0, a1, a0, ring, cur,
                                     part, acc);
  }
}

// Y (bf16, ldy, the warpgroup's 64 rows) = bf16(relu(acc + b)) in the
// chunk's columns n0 .. n0 + NCW - 1 (zero past co).
template <int NCW>
__device__ __forceinline__ void store_relu_bf16(const float (&acc)[NCW / 2],
                                                const float* __restrict__ bias, int co, int n0,
                                                bf16_t* Y, int ldy) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  bf16_t* y = Y + (16 * ((threadIdx.x >> 5) & 3) + g) * ldy;
#pragma unroll
  for (int j = 0; j < NCW / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;
    const float b0 = col < co ? __ldg(bias + col) : 0.f;
    const float b1 = col + 1 < co ? __ldg(bias + col + 1) : 0.f;
    *reinterpret_cast<uint32_t*>(y + col) =
        bf16x2_rn(fmaxf(acc[4 * j] + b0, 0.f), fmaxf(acc[4 * j + 1] + b1, 0.f));
    *reinterpret_cast<uint32_t*>(y + 8 * ldy + col) =
        bf16x2_rn(fmaxf(acc[4 * j + 2] + b0, 0.f), fmaxf(acc[4 * j + 3] + b1, 0.f));
  }
}

template <int NCW, bool AFFINE>
__device__ __forceinline__ void chunk_bf16(const Chain& ch, int l, int n0, const bf16_t* A,
                                           int lda, const float* mul0, const float* add0,
                                           const Ring& ring, Cursor& cur, bf16_t* Y, int ldy,
                                           const MaxOut<bf16_t>& mo) {
  float acc[NCW / 2];
  chunk_product_bf16<NCW, AFFINE>(A, lda, pad32(ch.c[l]), mul0, add0, ring, cur, acc);
  if (l + 1 < ch.layers) store_relu_bf16<NCW>(acc, ch.b[l], ch.c[l + 1], n0, Y, ldy);
  else store_max<NCW>(acc, ch.b[l], ch.c[l + 1], n0, mo);
}

// layer of the bf16 form: A and Y bf16, the max into bf16.
template <bool AFFINE>
__device__ void layer(const Chain& ch, int l, const bf16_t* A, int lda, const float* mul0,
                      const float* add0, const Ring& ring, Cursor& cur, bf16_t* Y, int ldy,
                      const MaxOut<bf16_t>& mo) {
  const int np = pad32(ch.c[l + 1]);
  for (int n0 = 0; n0 < np; n0 += ch.nc) {
    const int ncw = min(ch.nc, np - n0);
    if (ncw == 128)
      chunk_bf16<128, AFFINE>(ch, l, n0, A, lda, mul0, add0, ring, cur, Y, ldy, mo);
    else if (ncw == 96)
      chunk_bf16<96, AFFINE>(ch, l, n0, A, lda, mul0, add0, ring, cur, Y, ldy, mo);
    else if (ncw == 64)
      chunk_bf16<64, AFFINE>(ch, l, n0, A, lda, mul0, add0, ring, cur, Y, ldy, mo);
    else
      chunk_bf16<32, AFFINE>(ch, l, n0, A, lda, mul0, add0, ring, cur, Y, ldy, mo);
  }
}

// The producer's side: the whole packed chain of T (float: the TF32 hi and
// lo images; bf16_t: one bf16 image), slab after slab in the consumers'
// order, each into the next free slot of the ring by one bulk copy. One
// thread.
template <typename T>
__device__ void produce_chain(const Chain& ch, const Ring& ring, Cursor& cur) {
  const float* src = ch.wpk;
  for (int l = 0; l < ch.layers; ++l) {
    const int kp = pad32(ch.c[l]), np = pad32(ch.c[l + 1]);
    for (int n0 = 0; n0 < np; n0 += ch.nc) {
      const int floats = slab_words<T>(min(ch.nc, np - n0));
      for (int s = 0; s < kp / kSlabK; ++s) {
        tma::wait(&ring.empty[cur.stage], cur.phase ^ 1u);
        tma::expect(&ring.full[cur.stage], 4u * floats);
        tma::load(ring.slot + (size_t)cur.stage * ring.slot_floats, src, 4u * floats,
                  &ring.full[cur.stage]);
        src += floats;
        cur.next(ring.stages);
      }
    }
  }
}

}  // namespace mlp_wgmma
