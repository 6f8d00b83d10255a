// The bf16 forms of the PSMNet convolutions with Co 32 or 64 redesigned for
// Hopper (sm_90a): the feature tower's 3x3 stride-1 2D conv, the trunk's
// 3x3x3 stride-1 and stride-2 convs, and the hourglass's stride-2
// transposed 3x3x3 conv, each + folded BN + optional residual + optional
// ReLU, NC(D)HW bf16 in and out. One kernel body in three forms
// (ConvForm): stride 1 (the 2D conv is the 3D one at depth 1), transposed,
// stride 2.
//
// Replaces four TPU kernels of disprcnn_tpu/ops/pallas/packed_conv.py as the
// JAX package's bf16 model runs them (TPU.COMPUTE_DTYPE bfloat16):
//   - _kernel_w (wpacked_conv_bn, :188): out[n, o, y, x] = epi(sum_{c, kh,
//     kw} in(n, c, y + kh - 1, x + kw - 1) * wt[o, c, kh, kw]), zero
//     outside the image (conv2d_bf16_wgmma_cuda);
//   - _kernel (packed_conv_bn via _conv_call, :540/:652) and _kernel_s2
//     (packed_conv_bn_s2, :288): out[n, o, z, y, x] = epi(sum_{c, kd, kh,
//     kw} in(n, c, S z + kd - 1, S y + kh - 1, S x + kw - 1) * wt[o, c, kd,
//     kh, kw]), stride S 1 or 2, zero outside the volume
//     (conv3d_bf16_wgmma_cuda); through the first also packed_conv_train
//     (:689), whose forward is that conv and whose input gradient is the
//     stride-1 conv of the output gradient with the weights flipped in
//     space and channel-transposed (packed by form kPackFlip);
//   - _kernel_dc (packed_deconv_bn, :405): torch ConvTranspose3d(k 3,
//     stride 2, padding 1, output_padding 1), (N, Ci, D, H, W) -> (N, Co, 2D,
//     2H, 2W) (deconv3d_bf16_wgmma_cuda).
// The arithmetic is the TPU kernels' (jnp.dot of bf16 operands with
// preferred_element_type float32): the weights rounded to bf16 by their
// packing, exact products, float32 sums, then in float32 v * mul + add, +
// residual (bf16, read as float), ReLU, and one rounding to bf16 (nearest
// even). The sums run in the tensor cores' float32 accumulators over all K
// (9 Ci or 27 Ci terms); their adds truncate, within the 2^-22 a term that
// ops/cuda/conv3d.py's bf16_agreement allows (F32_SUM_ERR).
//
// Bound on an H100 SXM: bytes for the 2D, transposed and stride-2 convs,
// operations for the stride-1 3D conv. A tower launch at 112^2 (N 256, 32
// -> 32) moves 0.41 GB of bf16 input and output (+ 0.21 GB of residual)
// and does 59 GFLOP: 0.12-0.19 ms of memory traffic against 0.06 ms at the
// dense bf16 rate (989 TFLOP/s). The transposed conv at 28^2 -> 56^2 (N
// 128, 64 -> 32, D 12 -> 24) reads 0.15 GB and writes 0.62 GB (+ 0.62 GB of
// residual), 0.41 ms, against 0.13 TFLOP, 0.14 ms. The trunk's stride-1
// conv at (24, 56^2) (N 128, 32 -> 32) does 0.53 TFLOP, 0.54 ms, against
// 1.23 GB, 0.37 ms; the stride-2 conv (24, 56^2) -> (12, 28^2), 32 -> 64,
// reads 0.62 GB and writes 0.15 GB, 0.23 ms, against 0.13 TFLOP.
//
// Design.
// GEMM view: M = positions of a tile, N = Co (32 or 64), K = 16 input
// channels x the taps of a stage. One warpgroup instruction,
// wgmma.mma_async.m64nCOk16.f32.bf16.bf16, per (64-position M-tile, tap),
// both operands from shared memory through matrix descriptors, K-major
// without swizzle (core matrices of 8 rows x 16 bytes: wgmma.cuh's
// descriptor, which mlp_wgmma.cuh's chains use for their B).
// Taps as address offsets. A stage's input halo is laid channels-innermost
// in shared memory: slot s of a halo holds the 8 channels of one position
// (16 bytes), the second 8 channels of the stage SLOTS slots on (the
// descriptor's leading byte offset), and successive positions are
// successive slots (stride byte offset 128: 8 positions). An M-tile is 64
// consecutive slots of the halo grid, whose rows are hs = W + 1 slots: W
// positions and one zero slot that is the right padding of one row and the
// left padding of the next. Tap (kh, kw) of the 2D conv is then the same
// M-tile's descriptor shifted by kh hs + kw slots, any whole number of
// slots keeping the 16-byte alignment the descriptors need; the one junk
// column a row is computed and not stored (0.9% extra work at 112, 1.8% at
// 56). The stride-2 conv lays a stage's input rows as their four (row
// parity, column parity) planes, each of (TH + 1) rows of hs = OW + 1
// slots (OW the output width): plane (rp, cp) holds input rows 2 y0 - 1 +
// 2 i + rp and columns 2 j - 1 + cp, so tap (kh, kw) of output (r, c)
// reads plane (kh == 1, kw == 1) at (r + (kh == 2), c + (kw == 2)): again
// an offset of the M-tile's descriptor, and the left padding column is
// slot 0 of the odd-column planes, never written. The relayout sends each
// position to its plane: stmatrix takes one address a row, so 8 staged
// positions split 4 + 4 over two planes at no cost. (TMA's element
// strides could load one parity, but only along the flattened positions,
// where a stride of 2 picks alternate columns only for an even W, and
// each parity would be a box of its own.) Laying the halo
// channels-innermost is the choice the position-
// contiguous NCHW layout leaves: MN-major A wants 8 consecutive positions of
// 8 channels as one 128-byte core matrix, so a one-position kw shift breaks
// its alignment and would need a copy of the halo per column offset.
// Operands by asynchronous copy. A producer warpgroup feeds a ring of
// stages with mbarriers: one thread issues TMA tiled loads of the stage's
// input rows in their NCDHW order into a staging slot (a 3D tensor map
// (D H W flattened, Ci, N), boxes of BL positions x 16 channels; the
// flattened positions make the row strides of 28 or 56 bytes at row 5's 14-
// and 28-wide inputs no TMA stride, and the out-of-bounds fill zeroes
// channels past Ci and positions before the first or past the last), and
// the stage's packed weights by one bulk copy into the ring slot; the
// warpgroup's 4 warps then turn the staged rows channels-innermost in
// shared memory, ldmatrix (8 channels x 8 positions) and stmatrix.trans
// into the position slots (their addresses by multiplications, no integer
// division), zero the halo rows outside the image, fence the writes for
// the tensor cores (fence.proxy.async) and arrive, each warp on its own;
// the last warp done with a staging slot refills it. The input crosses the
// chip once; the relayout is shared-memory traffic, and overlaps the
// consumers' products. Where the tensor map is not legal (D H W not a
// multiple of 8, a misaligned base, Ci under 16) the warpgroup fills the
// staging slot with plain loads instead; no main-path site does. Waiting
// threads suspend in mbarrier.try_wait (a time hint) rather than poll, so
// the producer's warps keep the issue slots they share with the consumers':
// at the transposed conv's small stages the producer sets the pace.
// Enough K per block: persistent blocks (one a multiprocessor) walk the
// tiles, and the ring runs on across them, so the next tile's loads and
// relayout overlap this tile's products and epilogue. Each stage brings its
// own weight slab (9 taps x 16 channels x Co, 9 or 18 KB, L2-resident) by
// one bulk copy into its ring slot: one mechanism for every form, and at 64
// -> 64 two or three slabs in the ring take less shared memory than the 72
// KB of resident weights, which the output tile needs.
// Consumers: two warpgroups, with the producer's registers (setmaxnreg: 56
// a producer thread, 224 a consumer's), 112 or 128 float32 accumulators a
// thread. The stride-1 and stride-2 convs: M-tiles w, w + 2, ... of a tile
// of TH whole output rows of one output slice, 7 (Co 32) or 4 (Co 64) a
// warpgroup at stride 1 and 2 at stride 2 (mtiles), so TH hs <= 896, 512
// or 256 positions; TH is balanced over the slice's row tiles, or made a
// little larger where that lets TMA boxes of whole output rows store the
// tile, or smaller where shared memory asks. A 3D tile's stages are
// (16-channel chunk, depth tap kd) with input slice S z + kd - 1 inside the
// volume, 2 or 3 a chunk, all 27 Ci / 16 k16 steps into the same
// accumulators. An input slice feeds three output slices, and each of
// their tiles stages it anew: tiles are numbered with the rows fastest, so
// the 132 persistent blocks work on neighbouring slices at once and the
// restaged rows come from L2. Where the M-tiles hold two whole output
// slices (the trunk's 14^2 ones: 2 x 14 rows + 2 at hs 15, 450 of 512
// positions at Co 64), a tile is a slice pair: the second slice's halo
// lies 2 rows below the first's, so the pair is one stride-1 tile of 2 H +
// 2 rows whose 2 middle rows are computed and not stored, and a stage
// stages both input slices z + kd - 1 and z + kd (contiguous in (D H W))
// for one weight slab. A stage's fixed costs (its waits, its weight slab,
// the copies' latency) set the pace at 14^2, and a pair halves the stages
// an output slice; plan() takes pairs only where they take fewer rounds of
// the persistent blocks. Elsewhere a tile holds one slice: K slices as
// accumulator sets in the same 7 or 4 M-tiles would give each slice 1 / K
// of the rows, and staged rows an output row fall from 3.4 (K = 1, 14 rows
// at 56^2) only to 2.7 (K = 2) or 2.5 (K = 3). The producer sets the pace
// at every trunk site (builds that left out one side's work timed the
// other alone). The
// transposed conv: a tile of TH whole input rows of one
// input slice for one output slice (its depth parity fixes the depth taps:
// kd 1 at slice m for an even output slice 2m, kd 2 at m and kd 0 at m + 1
// for an odd one, a stage each); its 8 output parity classes are stride-1
// convs over the input grid with input offsets {0} or {0, +1} per axis (an
// even output 2i takes tap 1 at input i, an odd one 2i + 1 taps 2 at i and
// 0 at i + 1), so tap (kh, kw) reads the halo at offset (kh == 0) hs + (kw
// == 0) and feeds the (row, column) class (kh != 1, kw != 1): all four
// classes of an M-tile in its warpgroup's registers, 2 M-tiles (Co 32) or
// 1 (Co 64) a warpgroup, so that at the 14^2 and 28^2 inputs both
// warpgroups have M-tiles. Every M-tile's products are issued (a ragged
// last tile's past-the-image ones too): a product under a branch would
// serialize the warpgroup's wgmma. A stage's products are one commit group;
// its slot is released once the next stage's group is issued and it has
// completed (wgmma.wait_group 1).
// Epilogue: the tile's output, each channel's whole output rows, is a tile
// in shared memory ([boxes][Co][bt], bt whole output rows of at most 256
// positions), two of them where they fit. While a tile's first products
// run, one thread waits until the store that last read its output tile is
// done and brings the tile's residual into it by TMA (4D boxes of
// (positions, slice, Co, sample)); each consumer thread then reads the
// residual of its accumulators' positions in place, adds v * mul + add,
// applies the ReLU, rounds once and writes the result over it, and one
// TMA store per box writes the tile, each output row once and whole (the
// transposed conv's two column classes side by side). Where the output's
// tensor map is not legal (an output slice's positions not a multiple of
// 8, e.g. the trunk's 14^2 slices, or no whole rows of a tile making a box
// of a multiple of 8 positions), and for slice pairs, the consumers store
// straight to device memory: at 14^2 those stores take about 1% of the
// time (a build without them), so a flattened (D H W, Co, N) output map,
// legal there, would gain no more.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "bf16.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kThreads = 384;       // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kMaxSmem = 232448;    // bytes of shared memory a block may take on sm_90
constexpr int kMaxRing = 4;          // halo stages, staging slots, in flight at most
constexpr int kFixedBytes = 1024;    // barriers, mul and add
constexpr int kBoxes[3] = {72, 136, 200};  // staging box lengths: = 8 (mod 64) positions

// The forms of the body: the stride-1 conv (2D or 3D), the transposed
// conv, the stride-2 3D conv.
enum ConvForm { kStride1 = 0, kTransposed = 1, kStride2 = 2 };

// M-tiles a consumer warpgroup holds (128 or 112 float32 accumulators a
// thread): the stride-1 conv at Co 32 takes 7 so that two staging slots,
// two halo stages and the output tile fit at 112^2. The stride-2 conv takes
// 2 (256 output positions a tile): its staged rows and four-plane halo hold
// four input positions an output position, and at 4 M-tiles its tile of
// the trunk's 28^2 output would not fit in shared memory twice.
__host__ __device__ constexpr int mtiles(int co, int form) {
  return form == kTransposed ? (co == 32 ? 2 : 1)
         : form == kStride2  ? 2
                             : (co == 32 ? 7 : 4);
}

// A launch's geometry, the same for every block.
struct Geo {
  int n, ci, d, h, w;  // the input (N, Ci, D, H, W); D = 1 for the 2D conv
  int od, oh, ow;      // the output's depth, rows and columns
  int zs, odt;         // output slices a tile (1, or 2: slice pairs), tiles along the depth
  int wkd;             // depth taps of the packed weights: 3, or 1 (the 2D conv)
  int hs;              // halo row stride in slots: W + 1, or OW + 1 (stride 2)
  int ps;              // slots of one parity plane (stride 2): (th + 1) hs
  int th;              // rows of a tile (output rows, or input rows of the transposed conv)
  int tiles_h;         // row tiles of a slice
  int items;           // tiles in all: N odt tiles_h
  int nch;             // 16-channel chunks of Ci
  int slots;           // halo slots of one 8-channel half of a stage
  int bl;              // staging box length (positions)
  int rr, ring, no;    // staging slots, halo stages, output tiles in shared memory
  int raw_bytes;       // one staging slot: boxes x 16 channels x bl
  int a_bytes;         // one halo (both channel halves), 1024-aligned
  int w_bytes;         // one stage's weights: 9 taps x Co x 16 channels
  int t_len;           // output elements of a tile, a channel: th OW, or 4 th W
  int bk, bt;          // output rows a box, and its length bk ow
  int o_bytes;         // one output tile: Co t_len bf16, 1024-aligned
  int off_raw, off_a, off_o;  // shared memory offsets (bytes)
  int relu, tma, tma_out;     // ReLU; TMA staging; the output tile by TMA
  unsigned long long w_magic, oct_magic;  // ceil(2^40 / d) for d = W, bl / 8 (div_magic)
  unsigned long long th_magic, od_magic;  // and for d = tiles_h, odt
};

// One stage of a tile: channels 16 cc.. of sample n at input slice zi, the
// weight slab `wslab`, and the channel-relative flattened positions [f0,
// f1) of the halo's rows inside the image (staged from fs = f0 rounded down
// to 8).
struct Stage {
  int n, cc, zi, wslab, y0, f0, f1, fs;
};

// n / d for 0 <= n < 2^24 and 1 <= d < 2^16 as a product with m =
// ceil(2^40 / d): exact there (the error n (m - 2^40 / d) / 2^40 < 2^-16
// stays under 1 / d), and no division
__device__ __forceinline__ int div_magic(int n, unsigned long long m) {
  return static_cast<int>((static_cast<unsigned long long>(static_cast<unsigned>(n)) * m) >> 40);
}

// A tile: sample n, output slice zo (0 for the 2D conv), row tile t, and
// its stages: nkd depth taps a channel chunk, from kd0 (the 3D convs; the
// transposed conv's are its slice parity's).
struct Item {
  int n, zo, t, kd0, nkd, nst;
};

template <int FORM, bool PAIR>
__device__ __forceinline__ Item item_of(const Geo& g, int item) {
  Item it;
  const int q = div_magic(item, g.th_magic);  // item / tiles_h
  it.t = item - q * g.tiles_h;
  it.n = div_magic(q, g.od_magic);
  it.zo = (q - it.n * g.odt) * (PAIR ? 2 : 1);
  if (FORM == kTransposed) {
    it.kd0 = 0;
    it.nkd = (it.zo & 1) && (it.zo >> 1) + 1 < g.d ? 2 : 1;
  } else {
    // the depth taps whose input slice zc + kd - 1 lies in [0, D), for the
    // pair's second slice zc + kd too
    const int zc = FORM == kStride2 ? 2 * it.zo : it.zo;
    it.kd0 = max(0, 1 - zc - (PAIR && it.zo + 1 < g.od));
    it.nkd = min(2, g.d - zc) - it.kd0 + 1;
  }
  it.nst = g.nch * it.nkd;
  return it;
}

// stage k of a tile
template <int FORM, bool PAIR>
__device__ __forceinline__ Stage stage_of(const Geo& g, const Item& it, int k) {
  Stage st;
  st.n = it.n;
  st.y0 = it.t * g.th;
  st.cc = it.nkd == 1 ? k : it.nkd == 2 ? k >> 1 : k / 3;
  const int tz = k - st.cc * it.nkd;
  if (FORM == kTransposed) {
    st.zi = (it.zo >> 1) + tz;
    st.wslab = st.cc * 3 + ((it.zo & 1) == 0 ? 1 : (tz == 0 ? 2 : 0));
    const int plane = st.zi * g.h * g.w;
    st.f0 = plane + st.y0 * g.w;
    st.f1 = plane + min(g.h, st.y0 + g.th + 1) * g.w;
  } else {
    const int kd = it.kd0 + tz;
    st.zi = (FORM == kStride2 ? 2 * it.zo : it.zo) + kd - 1;
    st.wslab = st.cc * g.wkd + (g.wkd == 3 ? kd : 0);
    const int plane = st.zi * g.h * g.w;
    // input rows y0 - 1 .. y0 + th, or 2 y0 - 1 .. 2 y0 + 2 th - 1 (stride
    // 2); a slice pair's two whole input slices, zi and zi + 1 (either may
    // lie outside the volume: the staging fills it with zeros)
    const int r0 = FORM == kStride2 ? 2 * st.y0 - 1 : st.y0 - 1;
    const int r1 = FORM == kStride2 ? 2 * (st.y0 + g.th) : st.y0 + g.th + 1;
    st.f0 = plane + max(0, r0) * g.w;
    st.f1 = plane + min((PAIR ? 2 : 1) * g.h, r1) * g.w;
  }
  st.fs = st.f0 & ~7;
  return st;
}

// The walk of a block over its tiles' stages: items blockIdx.x,
// blockIdx.x + gridDim.x, ..., each its stages in order.
template <int FORM, bool PAIR>
struct Walk {
  int item, k;
  Item it;
  __device__ explicit Walk(const Geo& g) : item(blockIdx.x), k(0) {
    if (item < g.items) it = item_of<FORM, PAIR>(g, item);
  }
  __device__ bool valid(const Geo& g) const { return item < g.items; }
  __device__ Stage stage(const Geo& g) const { return stage_of<FORM, PAIR>(g, it, k); }
  __device__ void next(const Geo& g) {
    if (++k == it.nst) {
      item += gridDim.x;
      k = 0;
      if (item < g.items) it = item_of<FORM, PAIR>(g, item);
    }
  }
};

__device__ __forceinline__ int staged_len(const Stage& st) { return ((st.f1 + 7) & ~7) - st.fs; }

// element index of (channel ch, staged position j) in a staging slot: boxes
// of 16 channels x bl positions
__device__ __forceinline__ int raw_index(const Geo& g, int ch, int j) {
  return ((j / g.bl) * 16 + ch) * g.bl + j % g.bl;
}

// a box of the 3D tensor map (flattened positions, channels, samples)
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(tma::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(tma::smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// d += a * b: a 64 x 16 bf16 tile and b 16 x N bf16 from shared memory
// through their descriptors, d the m64nN float32 accumulators (d[4 j + 2 h +
// e] = row 16 w + g + 8 h, column 8 j + 2 t + e, w the warp of the
// warpgroup, g = lane / 4, t = lane % 4)
template <int N>
__device__ __forceinline__ void mma(float (&d)[N / 2], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void mma<32>(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void mma<64>(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// ----- the producer warpgroup -----

// the stage's input rows into a staging slot by TMA (one thread)
__device__ __forceinline__ void issue_raw(const Geo& g, const Stage& st, const CUtensorMap* map,
                                          bf16_t* raw, uint64_t* bar) {
  const int nb = (staged_len(st) + g.bl - 1) / g.bl;
  tma::expect(bar, nb * 16 * g.bl * 2);
  for (int b = 0; b < nb; ++b)
    tma_load_3d(raw + b * 16 * g.bl, map, st.fs + b * g.bl, st.cc * 16, st.n, bar);
}

// the same by plain loads (a shape whose tensor map is not legal), zero
// past Ci and outside the volume
__device__ void fill_raw(const Geo& g, const Stage& st, const bf16_t* __restrict__ x,
                         bf16_t* raw, int ptid) {
  const int len = staged_len(st);
  const int dhw = g.d * g.h * g.w;
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
  for (int i = ptid; i < 16 * len; i += 128) {
    const int ch = i / len, j = i % len;
    const int c = st.cc * 16 + ch, f = st.fs + j;
    bf16_t v = 0;
    if (c < g.ci && f >= 0 && f < dhw) v = __ldg(xs + ((size_t)st.n * g.ci + c) * dhw + f);
    raw[raw_index(g, ch, j)] = v;
  }
}

// The staged rows channels-innermost into the halo slot at shared address
// `a`: each 8 x 8 matrix (8 channels x 8 staged positions) by ldmatrix,
// written transposed by stmatrix, row by row, to the slots of its
// positions (a slot past the halo for a position outside it; at stride 2
// the slot of its parity plane); then the halo rows outside the image
// zeroed. The halo's padding column is never written and stays zero.
// PAIR: a slice pair's tile (stride 1), its second slice 2 rows down and
// no halo row outside the image (its layout is the same every time: its
// padding rows are never written).
template <int FORM, bool PAIR>
__device__ void relayout(const Geo& g, const Stage& st, const bf16_t* raw, uint32_t a,
                         int ptid) {
  const int lane = ptid & 31, pw = ptid >> 5, row = lane & 7, q = lane >> 3;
  const int total = staged_len(st) >> 2;  // matrices: (octet, channel half)
  const int noct = g.bl >> 3;             // octets a staging box
  const int plane = st.zi * g.h * g.w;
  const uint32_t raw_s = tma::smem_u32(raw);
  // matrix mi: the staged octet mi / 2 (in box b), channel half mi % 2; this
  // lane reads its row `row` and writes the transposed row to the slot of
  // that row's position (a slot past the halo for a position outside it, or
  // for a matrix past the staged rows, which reads the slot's start). No
  // branch, so that the compiler interleaves the groups' address chains:
  // the loop's pace is their latency, one producer warp a scheduler.
  auto addresses = [&](int mi, uint32_t& src, uint32_t& dst) {
    const int o = mi >> 1, half = mi & 1;
    const int b = div_magic(o, g.oct_magic);
    const int f = st.fs + 8 * o + row;
    const int rel = max(f - plane, 0);
    const int y = div_magic(rel, g.w_magic), x = rel - y * g.w;
    int slot;
    if (FORM == kTransposed) {
      slot = (y - st.y0) * g.hs + x;
    } else if (FORM == kStride1) {
      // a slice pair's second slice (y >= H) lies 2 halo rows further down,
      // past the first one's bottom and its own top padding row
      slot = (y + (PAIR && y >= g.h ? 2 : 0) - st.y0 + 1) * g.hs + x + 1;
    } else {
      // row 2 y0 - 1 + ry: plane (ry & 1, x even), its row ry / 2 and
      // column (x + 1) / 2
      const int ry = y - 2 * st.y0 + 1;
      slot = (2 * (ry & 1) + (~x & 1)) * g.ps + (ry >> 1) * g.hs + ((x + 1) >> 1);
    }
    const bool staged = mi < total;
    src = raw_s + (staged ? 2 * ((b * 16 + half * 8 + row) * g.bl + 8 * (o - b * noct)) : 0);
    dst = a + (half * g.slots + (staged && f >= st.f0 && f < st.f1 ? slot : g.slots - 1)) * 16;
  };
  // x4 groups a warp and iteration: four, or two at stride 2, whose longer
  // address chains ran slower at four
  constexpr int kGroups = FORM == kStride2 ? 2 : 4;
  __syncwarp();  // ldmatrix and stmatrix want the whole warp
  for (int base = pw * 4; base < total; base += 16 * kGroups) {
    uint32_t s[kGroups], d[kGroups], r[kGroups][4];
#pragma unroll
    for (int j = 0; j < kGroups; ++j) addresses(base + 16 * j + q, s[j], d[j]);
#pragma unroll
    for (int j = 0; j < kGroups; ++j) ldmatrix_x4(s[j], r[j]);
#pragma unroll
    for (int j = 0; j < kGroups; ++j) stmatrix_x4_trans(d[j], r[j]);
  }
  if (FORM == kStride2) {
    // plane rows: input row 2 y0 - 1 + pr is row pr / 2 of planes 2 (pr &
    // 1) and 2 (pr & 1) + 1; each zeroed whole (both halves) outside the image
    for (int pr = 0; pr < 2 * g.th + 1; ++pr) {
      const int y = 2 * st.y0 - 1 + pr;
      if (y >= 0 && y < g.h) continue;
      const int base = 2 * (pr & 1) * g.ps + (pr >> 1) * g.hs;
      for (int i = ptid; i < 4 * g.hs; i += 128) {
        const int half = i & 1, cp = (i >> 1) / g.hs, j = (i >> 1) - cp * g.hs;
        const uint32_t p = a + (half * g.slots + base + cp * g.ps + j) * 16;
        asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(p), "r"(0) : "memory");
      }
    }
    return;
  }
  const int hrows = PAIR ? 0 : FORM == kTransposed ? g.th + 1 : g.th + 2;
  for (int hr = 0; hr < hrows; ++hr) {
    const int y = FORM == kTransposed ? st.y0 + hr : st.y0 - 1 + hr;
    if (y >= 0 && y < g.h) continue;
    for (int i = ptid; i < 2 * g.w; i += 128) {
      const int half = i / g.w, x = i % g.w;
      const uint32_t p =
          a + (half * g.slots + hr * g.hs + x + (FORM == kTransposed ? 0 : 1)) * 16;
      asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(p), "r"(0) : "memory");
    }
  }
}

// a box of the 4D tensor map (P, OD, Co, N) of out or res: bt positions of
// slice z, all Co channels, sample n
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(tma::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(0), "r"(c3),
      "r"(tma::smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%1, %2, %3, %4}], [%5];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(0), "r"(c3), "r"(tma::smem_u32(src))
      : "memory");
}

// ----- the kernel -----

// x (N, Ci, D, H, W) bf16; wpk the packed weights (pack_wgmma_weight's
// layout: (ceil(Ci / 16), wkd, 9 taps, Co / 8, 2, 8, 8) bf16, a stage's slab
// contiguous); mul, add (Co,) float32; res of the output's shape or null;
// out (N, Co, OD, OH, OW) (the 2D conv: (N, Co, H, W); the transposed
// conv: (N, Co, 2D, 2H, 2W)). xmap: x as (D H W, Ci, N) in boxes of bl x 16
// x 1 (if g.tma); omap,
// rmap: out and res as (P, OD, Co, N), P an output slice's positions, in
// boxes of bt x 1 x Co x 1 (if g.tma_out). PAIR: slice pairs (g.zs 2; the
// stride-1 conv at Co 64 alone, a kernel of its own, so that the other
// kernels' registers and address chains stay as they are).
template <int CO, int FORM, bool PAIR>
__global__ void __launch_bounds__(kThreads, 1)
conv_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap omap,
                  const __grid_constant__ CUtensorMap rmap, const bf16_t* __restrict__ x,
                  const bf16_t* __restrict__ wpk, const float* __restrict__ mul,
                  const float* __restrict__ add, const bf16_t* __restrict__ res,
                  bf16_t* __restrict__ out, const Geo g) {
  constexpr bool DC = FORM == kTransposed;
  constexpr int MT = mtiles(CO, FORM);
  constexpr int kCls = DC ? 4 : 1;   // accumulator sets an M-tile: output parity classes
  constexpr int kAcc = CO / 2;       // accumulators of one m64nCO product a thread
  constexpr int kPx = DC ? 2 : 1;    // outputs a thread stores side by side (column parity)
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* a_full = raw_full + kMaxRing;
  uint64_t* a_empty = a_full + kMaxRing;
  uint64_t* res_full = a_empty + kMaxRing;  // one an output tile
  int* raw_left = reinterpret_cast<int*>(smem + 128);  // producer warps yet to read a slot
  float* smul = reinterpret_cast<float*>(smem + 256);
  float* sadd = smul + CO;
  bf16_t* raw_ring = reinterpret_cast<bf16_t*>(smem + g.off_raw);
  unsigned char* a_ring = smem + g.off_a;
  const int a_stride = g.a_bytes + g.w_bytes;

  if (threadIdx.x == 0) {
    for (int i = 0; i < g.rr; ++i) {
      wg::bar_init(&raw_full[i], 1);
      raw_left[i] = 4;
    }
    for (int i = 0; i < g.ring; ++i) {
      wg::bar_init(&a_full[i], 5);   // the weights' bulk copy (with its bytes), each producer warp
      wg::bar_init(&a_empty[i], 8);  // one arrival of each consumer warp
    }
    for (int i = 0; i < g.no; ++i) wg::bar_init(&res_full[i], 1);
    tma::bar_init_fence();
  }
  for (int i = threadIdx.x; i < CO; i += kThreads) {
    smul[i] = mul[i];
    sadd[i] = add[i];
  }
  // the halos' padding slots are never written: zero every halo once
  for (int r = 0; r < g.ring; ++r) {
    uint4* a4 = reinterpret_cast<uint4*>(a_ring + r * a_stride);
    for (int i = threadIdx.x; i < g.a_bytes / 16; i += kThreads) a4[i] = make_uint4(0, 0, 0, 0);
  }
  tma::fence_to_async();
  __syncthreads();

  if (threadIdx.x >= 256) {
    // the producer warpgroup: its registers go to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const int ptid = threadIdx.x - 256;
    Walk<FORM, PAIR> work(g);
    if (g.tma && ptid == 0) {
      Walk<FORM, PAIR> issue = work;
      for (int k = 0; k < g.rr && issue.valid(g); ++k, issue.next(g))
        issue_raw(g, issue.stage(g), &xmap, raw_ring + k * (g.raw_bytes / 2), &raw_full[k]);
    }
    for (int s = 0; work.valid(g); ++s, work.next(g)) {
      const int rslot = s % g.rr, slot = s % g.ring;
      const Stage st = work.stage(g);
      bf16_t* raw = raw_ring + rslot * (g.raw_bytes / 2);
      if (g.tma) {
        wg::wait_suspended(&raw_full[rslot], (s / g.rr) & 1);
      } else {
        fill_raw(g, st, x, raw, ptid);
        wg::named_sync(3, 128);
      }
      wg::wait_suspended(&a_empty[slot], ((s / g.ring) & 1) ^ 1u);
      unsigned char* aslot = a_ring + slot * a_stride;
      if (ptid == 0) {
        tma::expect(&a_full[slot], g.w_bytes);
        tma::load(aslot + g.a_bytes, wpk + (size_t)st.wslab * (g.w_bytes / 2), g.w_bytes,
                  &a_full[slot]);
      }
      relayout<FORM, PAIR>(g, st, raw, tma::smem_u32(aslot), ptid);
      // each warp fences its halo writes for the tensor cores and arrives;
      // the last warp done reading the staging slot refills it with stage
      // s + rr, so no warp waits for another
      tma::fence_to_async();
      __syncwarp();
      if ((ptid & 31) == 0) {
        wg::arrive(&a_full[slot]);
        if (g.tma) {
          __threadfence_block();
          if (atomicSub(&raw_left[rslot], 1) == 1) {
            __threadfence_block();
            raw_left[rslot] = 4;
            Walk<FORM, PAIR> ahead = work;
            for (int i = 0; i < g.rr && ahead.valid(g); ++i) ahead.next(g);
            if (ahead.valid(g)) issue_raw(g, ahead.stage(g), &xmap, raw, &raw_full[rslot]);
          }
        }
      }
    }
    return;
  }

  // the consumer warpgroups: M-tiles cw, cw + 2, ... of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
  const int cw = threadIdx.x >> 7;
  const int ctid = threadIdx.x & 127;
  const int wq = ctid >> 5, lane = ctid & 31, gq = lane >> 2, tq = lane & 3;
  const int ow = g.ow, oh = g.oh;
  float acc[MT][kCls][kAcc];
  int s = 0, it = 0;
  for (int item = blockIdx.x; item < g.items; item += gridDim.x, ++it) {
    const Item itm = item_of<FORM, PAIR>(g, item);
    const int y0 = itm.t * g.th;
    // the tile's rows in the image (a slice pair: both slices and the 2
    // rows between them)
    const int thv = min(g.th, (DC ? g.h : PAIR ? 2 * oh + 2 : oh) - y0);
    const int n = itm.n, zo = itm.zo;
    const int o0 = (DC ? 2 * y0 : y0) * ow;  // the tile's first output position in its slice
    const int ob = it % g.no;                 // its output tile in shared memory
    bf16_t* O = reinterpret_cast<bf16_t*>(smem + g.off_o + ob * g.o_bytes);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int c = 0; c < kCls; ++c)
#pragma unroll
        for (int e = 0; e < kAcc; ++e) acc[i][c][e] = 0.f;
    for (int k = 0; k < itm.nst; ++k, ++s) {
      const int slot = s % g.ring;
      wg::wait_suspended(&a_full[slot], (s / g.ring) & 1);
      const uint32_t abase = tma::smem_u32(a_ring + slot * a_stride);
      const uint64_t da = wg::desc(abase, g.slots * 16, 128);
      const uint64_t db = wg::desc(abase + g.a_bytes, 128, 256);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int c = 0; c < kCls; ++c) wg::fence_regs<kAcc>(acc[i][c]);
      __syncwarp();
      wg::fence();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int kh = tap / 3, kw = tap % 3;
        const int cls = DC ? 2 * (kh != 1) + (kw != 1) : 0;
        const int off = DC                  ? (kh == 0) * g.hs + (kw == 0)
                        : FORM == kStride2 ? (2 * (kh == 1) + (kw == 1)) * g.ps +
                                                 (kh == 2) * g.hs + (kw == 2)
                                           : kh * g.hs + kw;
        const uint64_t dbt = db + (uint64_t)(tap * CO * 2);  // CO x 16 bf16 a tap, in 16-byte units
#pragma unroll
        for (int i = 0; i < MT; ++i)
          mma<CO>(acc[i][cls], da + (uint64_t)((cw + 2 * i) * 64 + off), dbt);
      }
      wg::commit();
      if (k == 0 && threadIdx.x == 0 && g.tma_out) {
        // while the first products run: the store that last read this
        // output tile is done with it, which now takes this tile's residual
        if (g.no == 2) tma::wait_read<1>();
        else tma::wait_read<0>();
        if (res != nullptr) {
          tma::expect(&res_full[ob], CO * g.t_len * 2);
          for (int b = 0; b * g.bt < g.t_len; ++b)
            tma_load_4d(O + b * CO * g.bt, &rmap, o0 + b * g.bt, zo, n, &res_full[ob]);
        }
      }
      __syncwarp();
      wg::wait<1>();
      if (k > 0) {
        __syncwarp();
        if (lane == 0) wg::arrive(&a_empty[(s - 1) % g.ring]);
      }
    }
    wg::wait<0>();
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int c = 0; c < kCls; ++c) wg::fence_regs<kAcc>(acc[i][c]);
    __syncwarp();
    if (lane == 0) wg::arrive(&a_empty[(s - 1) % g.ring]);

    // the epilogue: v * mul + add, + residual, ReLU, one rounding, into the
    // output tile in shared memory (the residual read from it in place,
    // each thread's residual values loaded before its stores), then TMA
    // stores of the tile; or, where the tensor maps are not legal, straight
    // to device memory
    if (g.tma_out) {
      if (res != nullptr) wg::wait_suspended(&res_full[ob], (it / g.no) & 1);
      else wg::named_sync(1, 256);
    }
    const int nmt = (thv * g.hs + 63) >> 6;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (cw + 2 * i >= nmt) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (cw + 2 * i) * 64 + 16 * wq + gq + 8 * h;
        const int r = p / g.hs, c = p - r * g.hs;
        if (c >= (DC ? g.w : ow) || r >= thv) continue;
        // a slice pair: rows oh + 2 on are its second slice's; the 2 rows
        // between the slices, and a second slice past the volume, are not
        // stored
        const int b = PAIR && r >= oh + 2;
        const int rs = r - b * (oh + 2), zq = zo + b;
        if (PAIR && (rs >= oh || zq >= g.od)) continue;
#pragma unroll
        for (int py = 0; py < (DC ? 2 : 1); ++py) {
          const int orow = DC ? 2 * rs + py : rs;   // the output row in the tile
          const int x0 = DC ? 2 * c : c;
          float v[CO / 4][kPx];  // channels 8 j + 2 tq + e, column parities
          if (g.tma_out) {
            const int ob_ = orow / g.bk;
            bf16_t* base = O + ob_ * CO * g.bt + (orow - ob_ * g.bk) * ow + x0;
#pragma unroll
            for (int q = 0; q < CO / 4; ++q) {
              const int o = 8 * (q >> 1) + 2 * tq + (q & 1);
              if (DC) {
                if (res != nullptr) {
                  const uint32_t rv = *reinterpret_cast<const uint32_t*>(base + o * g.bt);
                  v[q][0] = bf16_to_float(static_cast<bf16_t>(rv & 0xFFFFu));
                  v[q][kPx - 1] = bf16_to_float(static_cast<bf16_t>(rv >> 16));
                } else {
                  v[q][0] = v[q][kPx - 1] = 0.f;
                }
              } else {
                v[q][0] = res != nullptr ? bf16_to_float(base[o * g.bt]) : 0.f;
              }
            }
#pragma unroll
            for (int q = 0; q < CO / 4; ++q) {
              const int o = 8 * (q >> 1) + 2 * tq + (q & 1);
              const int idx = 4 * (q >> 1) + 2 * h + (q & 1);
              const float m = smul[o], ad = sadd[o];
              float a0 = fmaf(acc[i][DC ? 2 * py : 0][idx], m, ad) + v[q][0];
              if (g.relu) a0 = fmaxf(a0, 0.f);
              if (DC) {
                float a1 = fmaf(acc[i][2 * py + 1][idx], m, ad) + v[q][kPx - 1];
                if (g.relu) a1 = fmaxf(a1, 0.f);
                *reinterpret_cast<uint32_t*>(base + o * g.bt) = bf16x2_rn(a0, a1);
              } else {
                base[o * g.bt] = bf16_rn(a0);
              }
            }
          } else {
            const size_t f0 = ((size_t)n * CO * g.od + zq) * oh * (size_t)ow + o0 +
                              (size_t)orow * ow + x0;
            const size_t cs = (size_t)g.od * oh * ow;  // channel stride
#pragma unroll
            for (int q = 0; q < CO / 4; ++q) {
              const int o = 8 * (q >> 1) + 2 * tq + (q & 1);
              const int idx = 4 * (q >> 1) + 2 * h + (q & 1);
              const float m = smul[o], ad = sadd[o];
#pragma unroll
              for (int px = 0; px < kPx; ++px) {
                const size_t f = f0 + o * cs + px;
                float a0 = fmaf(acc[i][DC ? 2 * py + px : 0][idx], m, ad);
                if (res != nullptr) a0 += ldg_float(res + f);
                if (g.relu) a0 = fmaxf(a0, 0.f);
                out[f] = bf16_rn(a0);
              }
            }
          }
        }
      }
    }
    if (g.tma_out) {
      tma::fence_to_async();
      wg::named_sync(1, 256);
      if (threadIdx.x == 0) {
        for (int b = 0; b * g.bt < g.t_len; ++b)
          tma_store_4d(&omap, O + b * CO * g.bt, o0 + b * g.bt, zo, n);
        tma::commit();
      }
    }
  }
  if (threadIdx.x == 0) tma::wait_all();
}

// ----- the host side -----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point (no link
// against libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) != cudaSuccess)
      p = nullptr;
#endif
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

long long round1024(long long b) { return (b + 1023) / 1024 * 1024; }

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The rows of an output box: the most whole output rows of the tile (bk |
// its rows) whose bk ow positions are a multiple of 8 and at most 256 (a
// TMA box dimension); 0 if none.
int output_box_rows(int rows, int ow) {
  for (int k = rows; k >= 1; --k)
    if (rows % k == 0 && k * ow % 8 == 0 && k * ow <= 256) return k;
  return 0;
}

// The geometry of a launch of form `form` on x (N, Ci, D, H, W), weights of
// wkd depth taps, on sms multiprocessors: tiles (slice pairs where they
// take fewer rounds), the staging boxes, which copies go by TMA (tma: x's
// (D H W) a multiple of 8, Ci >= 16, x aligned; tma_out: an output slice's
// positions and every tile's start a multiple of 8, whole output rows a
// box, out and res aligned, no slice pair), and shared memory: two staging
// slots, two halo stages and one output tile at least, then a second output tile,
// a third staging slot and up to four halo stages as they fit. A tile takes
// as many whole rows as the M-tiles hold, balanced over the slice's row
// tiles, and fewer where that does not fit in shared memory (the stride-2
// halo's four planes take four times the M-tiles' positions). False if no
// tile fits (a row past what the consumers' M-tiles hold, or shared memory).
bool plan(int form, int sms, int n, int ci, int d, int h, int w, int co, int wkd,
          const void* x, const void* res, const void* out, Geo& g) {
  const int mt = mtiles(co, form);
  const int span = 2 * mt * 64;  // positions a tile's M-tiles cover
  g = Geo{};
  g.n = n;
  g.ci = ci;
  g.d = d;
  g.h = h;
  g.w = w;
  g.wkd = wkd;
  const int s = form == kStride2 ? 2 : 1;
  g.od = form == kTransposed ? 2 * d : (d - 1) / s + 1;
  g.oh = form == kTransposed ? 2 * h : (h - 1) / s + 1;
  g.ow = form == kTransposed ? 2 * w : (w - 1) / s + 1;
  g.hs = form == kStride2 ? g.ow + 1 : w + 1;
  g.nch = (ci + 15) / 16;
  if ((long long)h * w >= (1 << 24) || g.od >= (1 << 16)) return false;  // div_magic's range
  g.w_magic = ((1ULL << 40) + w - 1) / w;
  g.zs = 1;
  g.odt = g.od;
  g.w_bytes = 9 * co * 32;
  g.tma = (long long)d * h * w % 8 == 0 && ci >= 16 && aligned16(x);
  const long long slice = (long long)g.oh * g.ow;  // an output slice's positions
  auto fits = [&](int rr, int ring, int no) {
    return kFixedBytes + (long long)rr * g.raw_bytes + ring * ((long long)g.a_bytes + g.w_bytes) +
               (long long)no * g.o_bytes <=
           kMaxSmem;
  };
  // whole rows a tile (output rows; input rows of the transposed conv):
  // the tile geometry of th rows in tiles_h tiles, false if it does not fit
  const int rows = form == kTransposed ? h : g.oh;
  auto orows = [&](int th) { return form == kTransposed ? 2 * th : th; };  // its output rows
  auto try_rows = [&](int th, int tiles_h) {
    g.th = th;
    g.tiles_h = tiles_h;
    g.th_magic = ((1ULL << 40) + tiles_h - 1) / tiles_h;
    // the halo: the M-tiles' reads past their span (the largest tap
    // offset), a junk slot for staged positions outside the halo
    if (form == kStride2) {
      g.ps = (th + 1) * g.hs;
      g.slots = (max(4 * g.ps, 3 * g.ps + span) + 8 + 7) & ~7;
    } else {
      g.slots = (span + (form == kTransposed ? g.hs + 1 : 2 * g.hs + 2) + 8 + 7) & ~7;
    }
    g.a_bytes = (int)round1024(2LL * g.slots * 16);
    // staging boxes: the fewest bytes, a box counted as 16 rows of 128 more
    const int in_rows = form == kTransposed ? th + 1 : form == kStride2 ? 2 * th + 1 : th + 2;
    const int lmax = in_rows * w + 16;
    long long best_cost = 0;
    g.bl = 0;
    for (int bl : kBoxes) {
      const int boxes = (lmax + bl - 1) / bl;
      const long long cost = (long long)boxes * (bl + 64);
      if (g.bl == 0 || cost < best_cost) {
        g.bl = bl;
        best_cost = cost;
      }
    }
    g.raw_bytes = (int)round1024(2LL * 16 * ((lmax + g.bl - 1) / g.bl * g.bl));
    g.oct_magic = ((1ULL << 40) + g.bl / 8 - 1) / (g.bl / 8);
    g.t_len = orows(th) * g.ow;
    g.bk = output_box_rows(orows(th), g.ow);
    g.bt = g.bk * g.ow;
    g.tma_out =
        g.bk > 0 && slice % 8 == 0 && aligned16(out) && (res == nullptr || aligned16(res));
    g.o_bytes = g.tma_out ? (int)round1024(2LL * co * g.t_len) : 0;
    return fits(2, 2, 1);
  };
  for (int cap = min(rows, span / g.hs); cap >= 1; --cap) {
    const int tiles_h = (rows + cap - 1) / cap;
    const long long items = (long long)n * g.od * tiles_h;
    if (items >= (1 << 24) || tiles_h >= (1 << 16)) return false;
    g.items = (int)items;
    // the rows balanced over the tiles, or, where those make no TMA box of
    // output rows, the fewest more that do in as many tiles
    const int th = (rows + tiles_h - 1) / tiles_h;
    int thx = th;
    for (int t = th; slice % 8 == 0 && t <= cap && thx == th; ++t)
      if (output_box_rows(orows(t), g.ow) > 0) thx = t;
    if (!(thx != th && try_rows(thx, tiles_h))) {
      thx = th;
      if (!try_rows(th, tiles_h)) continue;
    }
    // A whole output slice a tile, and the M-tiles hold two: the stride-1
    // 3D conv at Co 64 takes slice pairs, the second slice's halo 2 rows below the
    // first's (H + 2 rows apart: the first's bottom padding row and the
    // second's top one), each stage both input slices, so that a stage's
    // weights and fixed costs serve twice the positions; its output is
    // stored straight to device memory. Only where the pairs take fewer
    // rounds of the sms persistent blocks: a pair's stage costs about what
    // a slice's does, but one round of half as many tiles leaves blocks idle.
    const long long pairs = (long long)n * ((g.od + 1) / 2);
    if (form == kStride1 && co == 64 && g.od >= 2 && tiles_h == 1 && (2 * h + 2) * g.hs <= span &&
        (pairs + sms - 1) / sms < (items + sms - 1) / sms) {
      if (try_rows(2 * h + 2, 1)) {
        g.zs = 2;
        g.odt = (g.od + 1) / 2;
        g.items = (int)pairs;
        g.tma_out = 0;
        g.o_bytes = 0;
      } else if (!try_rows(thx, tiles_h)) {
        continue;
      }
    }
    g.od_magic = ((1ULL << 40) + g.odt - 1) / g.odt;
    g.no = g.tma_out && fits(2, 2, 2) ? 2 : 1;
    g.rr = fits(3, 2, g.no) ? 3 : 2;
    g.ring = 2;
    while (g.ring < kMaxRing && fits(g.rr, g.ring + 1, g.no)) ++g.ring;
    g.off_raw = kFixedBytes;
    g.off_a = g.off_raw + g.rr * g.raw_bytes;
    g.off_o = g.off_a + g.ring * (g.a_bytes + g.w_bytes);
    return true;
  }
  return false;
}

int smem_bytes(const Geo& g) { return g.off_o + g.no * g.o_bytes; }

// out or res as the 4D tensor map (P, OD, Co, N) of bf16, P an output
// slice's positions, boxes of bt x 1 x Co x 1
bool output_map(EncodeTiled enc, CUtensorMap* map, const void* base, const Geo& g, int co) {
  const cuuint64_t p = (cuuint64_t)g.oh * g.ow, od = g.od;
  const cuuint64_t dims[4] = {p, od, (cuuint64_t)co, (cuuint64_t)g.n};
  const cuuint64_t strides[3] = {p * 2, od * p * 2, co * od * p * 2};
  const cuuint32_t box[4] = {(cuuint32_t)g.bt, 1, (cuuint32_t)co, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
             box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int CO, int FORM>
cudaError_t launch(const bf16_t* x, int n, int ci, int d, int h, int w, int wkd,
                   const bf16_t* wpk, const float* mul, const float* add, const bf16_t* res,
                   int relu, bf16_t* out, cudaStream_t stream, int device) {
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  Geo g;
  if (!plan(FORM, sms, n, ci, d, h, w, CO, wkd, x, res, out, g)) return cudaErrorInvalidValue;
  g.relu = relu;
  CUtensorMap xmap, omap, rmap;
  memset(&xmap, 0, sizeof(xmap));
  memset(&omap, 0, sizeof(omap));
  memset(&rmap, 0, sizeof(rmap));
  if (g.tma || g.tma_out) {
    EncodeTiled enc = encode_tiled();
    if (enc == nullptr) return cudaErrorNotSupported;
    if (g.tma) {
      const cuuint64_t dhw = (cuuint64_t)d * h * w;
      const cuuint64_t dims[3] = {dhw, (cuuint64_t)ci, (cuuint64_t)n};
      const cuuint64_t strides[2] = {dhw * 2, dhw * ci * 2};
      const cuuint32_t box[3] = {(cuuint32_t)g.bl, 16, 1};
      const cuuint32_t estr[3] = {1, 1, 1};
      if (enc(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<bf16_t*>(x), dims, strides,
              box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return cudaErrorInvalidValue;
    }
    if (g.tma_out && (!output_map(enc, &omap, out, g, CO) ||
                      (res != nullptr && !output_map(enc, &rmap, res, g, CO))))
      return cudaErrorInvalidValue;
  }
  const int bytes = smem_bytes(g);
  auto kernel = conv_wgmma_kernel<CO, FORM, false>;
  if constexpr (CO == 64 && FORM == kStride1)
    if (g.zs == 2) kernel = conv_wgmma_kernel<CO, FORM, true>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int grid = g.items < sms ? g.items : sms;
  kernel<<<grid, kThreads, bytes, stream>>>(xmap, omap, rmap, x, wpk, mul, add, res, out, g);
  return cudaGetLastError();
}

// The weights' forms: the 2D conv's (Co, Ci, 3, 3); the transposed conv's
// torch ConvTranspose3d weight (Ci, Co, 3, 3, 3), unflipped; the 3D conv's
// (Co, Ci, 3, 3, 3); and, for the input gradient of a 3D conv with weight w
// (Ci, Co, 3, 3, 3), w flipped in every spatial dim and channel-transposed
// (ops/cuda/conv3d.py::flip_transpose).
enum PackForm { kPack2d = 0, kPackDeconv = 1, kPack3d = 2, kPackFlip = 3 };

// One bf16 of pack_wgmma_weight's layout, (ceil(Ci / 16), wkd, 9 taps, Co /
// 8, 2, 8, 8), per thread: element (cc, kd, tap, j, half, r, k) is the
// weight from input channel 16 cc + 8 half + k to output channel 8 j + r at
// depth tap kd and tap (kh, kw) = (tap / 3, tap % 3), rounded to bf16
// (nearest even), zero past Ci: a tap's B operand (16 K x Co N) in the
// K-major core matrices of wgmma (8 N rows x 8 K values, 16 bytes a row; the
// second 8 K values 128 bytes on, the next 8 N rows 256 bytes on).
__global__ void pack_kernel(const float* __restrict__ w, int co, int ci, int wkd, int form,
                            bf16_t* __restrict__ out, int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int k = i & 7, r = (i >> 3) & 7, half = (i >> 6) & 1;
  int q = i >> 7;
  const int j = q % (co / 8);
  q /= co / 8;
  const int tap = q % 9;
  q /= 9;
  const int kd = q % wkd, cc = q / wkd;
  const int c = 16 * cc + 8 * half + k, o = 8 * j + r;
  float v = 0.f;
  if (c < ci)
    v = form == kPackDeconv ? w[(((size_t)c * co + o) * 3 + kd) * 9 + tap]
        : form == kPackFlip ? w[(((size_t)c * co + o) * 3 + 2 - kd) * 9 + 8 - tap]
                            : w[(((size_t)o * ci + c) * wkd + kd) * 9 + tap];
  out[i] = bf16_rn(v);
}

cudaError_t run(int form, const void* x, int n, int ci, int d, int h, int w, int wkd,
                const void* wpk, int co, const void* mul, const void* add, const void* res,
                int relu, void* out, void* stream, int device) {
  if (n < 1 || ci < 1 || d < 1 || h < 1 || w < 1) return cudaErrorInvalidValue;
  const bf16_t* xt = static_cast<const bf16_t*>(x);
  const bf16_t* wt = static_cast<const bf16_t*>(wpk);
  const float* m = static_cast<const float*>(mul);
  const float* a = static_cast<const float*>(add);
  const bf16_t* rt = static_cast<const bf16_t*>(res);
  bf16_t* ot = static_cast<bf16_t*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CONV_WGMMA_LAUNCH(CO, FORM) \
  if (co == CO && form == FORM)     \
    return launch<CO, FORM>(xt, n, ci, d, h, w, wkd, wt, m, a, rt, relu, ot, s, device);
  CONV_WGMMA_LAUNCH(32, kStride1)
  CONV_WGMMA_LAUNCH(64, kStride1)
  CONV_WGMMA_LAUNCH(32, kTransposed)
  CONV_WGMMA_LAUNCH(64, kTransposed)
  CONV_WGMMA_LAUNCH(32, kStride2)
  CONV_WGMMA_LAUNCH(64, kStride2)
#undef CONV_WGMMA_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The packed weights of the convs below into wpk (bf16, ceil(Ci / 16) x wkd
// x 9 x Co x 16 values; ops/cuda/conv3d.py::pack_wgmma_weight is the plain
// version), Co and Ci the packed conv's: form 0, w (Co, Ci, 3, 3), wkd 1
// (conv2d_bf16_wgmma_cuda); form 1, w (Ci, Co, 3, 3, 3)
// (deconv3d_bf16_wgmma_cuda); form 2, w (Co, Ci, 3, 3, 3)
// (conv3d_bf16_wgmma_cuda); form 3, w (Ci, Co, 3, 3, 3), the weights of the
// conv whose input gradient this is, packed flipped and channel-transposed
// (conv3d_bf16_wgmma_cuda at stride 1 on the output gradient). w float32,
// contiguous, on `device`; Co is 32 or 64. Launches on `stream`, returns
// the cudaError_t of the launch.
int conv_bf16_wgmma_pack_cuda(const void* w, int co, int ci, int form, void* wpk, void* stream,
                              int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((co != 32 && co != 64) || ci < 1 || form < kPack2d || form > kPackFlip)
    return static_cast<int>(cudaErrorInvalidValue);
  const int wkd = form == kPack2d ? 1 : 3;
  const int total = (ci + 15) / 16 * wkd * 9 * co * 16;
  pack_kernel<<<(total + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), co, ci, wkd, form, static_cast<bf16_t*>(wpk), total);
  return static_cast<int>(cudaGetLastError());
}

// x (N, Ci, H, W) -> out (N, Co, H, W), the 3x3 stride-1 pad-1 2D conv; wpk
// from conv_bf16_wgmma_pack_cuda (form 0); mul, add (Co,) float32; res of
// the output's shape or null; x, res and out bf16. All contiguous, on
// `device`; Co is 32 or 64. Launches on `stream`, does not synchronise,
// returns the cudaError_t of the launch (0 on success).
int conv2d_bf16_wgmma_cuda(const void* x, int n, int ci, int h, int w, const void* wpk, int co,
                           const void* mul, const void* add, const void* res, int relu,
                           void* out, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      run(kStride1, x, n, ci, 1, h, w, 1, wpk, co, mul, add, res, relu, out, stream, device));
}

// x (N, Ci, D, H, W) -> out (N, Co, D', H', W'), the 3x3x3 pad-1 conv at
// stride 1 or 2 (D' = (D - 1) / stride + 1, the same for H and W); wpk from
// conv_bf16_wgmma_pack_cuda (form 2, or form 3 for an input gradient).
// Otherwise as conv2d_bf16_wgmma_cuda.
int conv3d_bf16_wgmma_cuda(const void* x, int n, int ci, int d, int h, int w, int stride,
                           const void* wpk, int co, const void* mul, const void* add,
                           const void* res, int relu, void* out, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (stride != 1 && stride != 2) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(run(stride == 2 ? kStride2 : kStride1, x, n, ci, d, h, w, 3, wpk, co,
                              mul, add, res, relu, out, stream, device));
}

// x (N, Ci, D, H, W) -> out (N, Co, 2D, 2H, 2W), the transposed conv of
// torch ConvTranspose3d(k 3, stride 2, padding 1, output_padding 1); wpk
// from conv_bf16_wgmma_pack_cuda (form 1). Otherwise as
// conv2d_bf16_wgmma_cuda.
int deconv3d_bf16_wgmma_cuda(const void* x, int n, int ci, int d, int h, int w, const void* wpk,
                             int co, const void* mul, const void* add, const void* res, int relu,
                             void* out, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(run(kTransposed, x, n, ci, d, h, w, 3, wpk, co, mul, add, res, relu,
                              out, stream, device));
}

// The widest input row a form (ConvForm: 0 stride 1, 2D or 3D; 1
// transposed; 2 stride 2) takes: every width up to it plans a tile at every
// height (its M-tiles hold a halo row, and two staging slots, two halo
// stages and the output tile fit in shared memory), on aligned tensors,
// whose output goes through the shared-memory tile where a box allows. A
// tile's rows are at most cap = (M-tile rows) / hs, the row stride hs W + 1
// (stride 2: its output width + 1), at most the rows to split, and fewer
// where shared memory asks: the heights of 1 .. cap rows, and 8 cap rows,
// whose output slice is a multiple of 8 positions, are every case plan()
// tells apart. The depth does not enter plan()'s shared memory. 0 for a Co
// or form the kernel does not take.
int conv_bf16_wgmma_max_width(int form, int co) {
  if ((co != 32 && co != 64) || form < kStride1 || form > kStride2) return 0;
  const int span = 2 * mtiles(co, form) * 64;
  const void* p = reinterpret_cast<const void*>(1024);
  Geo g;
  for (int w = 1;; ++w) {
    const int cap = span / (form == kStride2 ? (w - 1) / 2 + 2 : w + 1);
    if (cap < 1) return w - 1;
    for (int r = 1; r <= cap + 1; ++r) {
      const int rows = r <= cap ? r : 8 * cap;
      if (!plan(form, 1, 1, 16, 1, form == kStride2 ? 2 * rows : rows, w, co,
                form == kStride1 ? 1 : 3, p, p, p, g))
        return w - 1;
    }
  }
}

const char* conv_bf16_wgmma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
