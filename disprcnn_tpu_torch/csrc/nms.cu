// Greedy 2D NMS over score-sorted boxes, for Hopper (sm_90a).
//
// Replaces the TPU kernel disprcnn_tpu/ops/pallas/nms.py:_nms_kernel (entry
// nms_sorted_pallas). It computes the same function, not the TPU layout: per
// row of a (B, N) batch of boxes sorted by score, the sorted positions of
// the first k survivors of exact greedy NMS. Suppression is strict
// IoU > thresh with the legacy +1 pixel convention (to_remove); IoU is
// inter / max(area_i + area_j - inter, 1e-12) with i the earlier box. Ties
// go to the lowest sorted index (the walk is in index order). Where fewer
// than k boxes survive, the remaining slots hold n - 1 with ok = 0, as the
// JAX wrapper's min(idx, n - 1).
//
// Bound on an H100 SXM: operations, ~17 per IoU test of a survivor against
// each later box; the work is serial in the survivors, so a launch's time
// is set by its longest walk and by the IoU tests that walk needs.
//
// Design. Boxes fall in tiles of 64; bit j of word (i, c) says that box i
// suppresses box 64 c + j, a later box. Two kernels a pass:
//   (a) nms_mask_kernel, a linear grid over (row tile r, 4 column tiles
//       from c >= r on), 256 threads: thread (column tile, row) builds one
//       word from a column tile held in shared memory. The words of row
//       tile r lie as (column tile, row), so a warp's stores are coalesced
//       and a tile's words from column tile r on are one contiguous run.
//       The test decides IoU > thresh without a division wherever the
//       answer is certain: it compares inter with union times thresh
//       widened and narrowed by 2^-20 (th_hi, th_lo), and takes the exact
//       division only between the two, so it is bit-equal to
//       fl(inter / union) > thresh (ops/cuda/nms.py iou_above_band_plain).
//       The blocks of row tile 0 also write the valid bits as 64-bit words
//       (alive), so the walk reads no byte array.
//   (b) nms_walk_kernel, a block per image, walks the row tiles in order.
//       The run of tile t is brought into shared memory by a TMA bulk copy
//       nbuf - 2 tiles ahead of the walk (a ring of nbuf buffers counted
//       on mbarriers). Warp 0 resolves a tile: the candidates are its
//       valid boxes not yet removed; in index order, a row still a
//       candidate is kept and removes its victims (a test and two masks a
//       row, every row of a 32-row half unrolled with its word loaded
//       ahead, or only the rows that suppress another candidate where
//       those are few).
//       It emits the kept boxes with their ranks and stops at k. Meanwhile
//       the other warps fold the previous tile's kept rows into the
//       `removed` words of the tiles after it (a warp a word, OR across
//       lanes). One block barrier a tile. Where the ring does not fit in shared memory
//       (~9500 boxes a pass) the walk reads the words from global memory.
// A launch runs in two passes when k is small against N (8 ceil(k/64) < T
// tiles): the first builds and walks only the triangle of the first r1 =
// 4 ceil(k/64) row tiles and stores each tile's kept rows; the second, for
// the images whose walk has not stopped, builds the rest (those rows
// against the later columns, and the triangle after them), folds the
// stored kept rows into its `removed` words, and walks on. So the SRPN,
// whose walk stops after a few hundred of its 6000 boxes, builds 210 of
// its 4465 tile pairs an image. The kernels follow each other on one
// stream, which orders them. Build without fast math and with
// --fmad=false, so the IoU here is bit-equal to the plain PyTorch version:
// one flipped ulp at the threshold changes which boxes survive.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kTile = 64;
constexpr int kMaskThreads = 256;  // one row tile against 4 column tiles
constexpr int kWalkThreads = 256;
constexpr int kWalkWarps = kWalkThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxShared = 232448;
constexpr int kMaxBufs = 8;
constexpr int kSparseLinks = 6;  // links of a half walked one by one, at most

__device__ __forceinline__ float box_area(const float4 b, float to_remove) {
  return fmaxf(b.z - b.x + to_remove, 0.f) * fmaxf(b.w - b.y + to_remove, 0.f);
}

// Whether the earlier box a suppresses the later box b: fl(inter / union)
// > thresh. With kBand, the quotient is formed only where
// th_lo * union <= inter <= th_hi * union (the products rounded).
template <bool kBand>
__device__ __forceinline__ bool suppresses(const float4 a, float area_a, const float4 b,
                                           float area_b, float to_remove, float thresh,
                                           float th_hi, float th_lo) {
  const float w = fmaxf(fminf(a.z, b.z) - fmaxf(a.x, b.x) + to_remove, 0.f);
  const float h = fmaxf(fminf(a.w, b.w) - fmaxf(a.y, b.y) + to_remove, 0.f);
  const float inter = w * h;
  const float u = fmaxf(area_a + area_b - inter, 1e-12f);
  if (kBand) {
    if (inter > th_hi * u) return true;
    if (inter < th_lo * u) return false;
  }
  return inter / u > thresh;
}

// sum_{j=1..m} ceil(j / 4): the mask blocks of the row tiles with at most m
// column tiles from the diagonal on (a row tile with j of them takes
// ceil(j / 4) blocks of 4 column tiles)
__host__ __device__ inline long long blocks_upto(long long m) {
  const long long p = m / 4, s = m % 4;
  return 2 * p * (p + 1) + s * (p + 1);
}

// The words a pass builds: a rectangle (row tiles [0, rect_rows), column
// tiles [rect_c0, tri_end)) and a triangle (row and column tiles
// [tri_begin, tri_end), column >= row).
struct Part {
  int rect_rows, rect_c0, tri_begin, tri_end;
  __host__ __device__ int rect_groups() const { return (tri_end - rect_c0 + 3) / 4; }
  __host__ __device__ long long blocks() const {
    return static_cast<long long>(rect_rows) * rect_groups() + blocks_upto(tri_end - tri_begin);
  }
};

// Block x: a row tile r against 4 column tiles from c0 on. The rectangle's
// blocks come first, row by row; then the triangle's, its row tiles by
// their number of column tiles j = tri_end - r, ascending: items
// [blocks_upto(j - 1), blocks_upto(j)) are row tile tri_end - j, column
// tiles from r + 4 q on. Images whose walk has stopped (done) are skipped.
// The blocks of row tile 0 also write their columns' valid bits (alive).
template <bool kBand>
__global__ void __launch_bounds__(kMaskThreads)
nms_mask_kernel(const float4* __restrict__ boxes, const uint8_t* __restrict__ valid, int n,
                int tiles, Part part, const int* __restrict__ done, float thresh, float th_hi,
                float th_lo, float to_remove, u64* __restrict__ mask,
                unsigned* __restrict__ alive) {
  const int img = blockIdx.y;
  if (done != nullptr && done[img]) return;
  __shared__ float4 cbox[kMaskThreads];
  __shared__ float carea[kMaskThreads];
  const int tid = threadIdx.x;
  const int cc = tid / kTile, rho = tid % kTile;
  const float4* bb = boxes + static_cast<size_t>(img) * n;
  const int groups = part.rect_groups();
  const long long rect_items = static_cast<long long>(part.rect_rows) * groups;
  const long long items = part.blocks();
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    int r, c0;
    if (it < rect_items) {
      r = static_cast<int>(it / groups);
      c0 = part.rect_c0 + 4 * static_cast<int>(it % groups);
    } else {
      const long long item = it - rect_items;
      long long p = static_cast<long long>((sqrt(2.0 * item + 1.0) - 1.0) * 0.5);
      while (2 * (p + 1) * (p + 2) <= item) ++p;
      while (2 * p * (p + 1) > item) --p;
      const long long rem = item - 2 * p * (p + 1);
      r = part.tri_end - static_cast<int>(4 * p + rem / (p + 1) + 1);
      c0 = r + 4 * static_cast<int>(rem % (p + 1));
    }
    const int jc = c0 * kTile + tid;
    const float4 cb = jc < n ? bb[jc] : make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();  // the previous item's columns are read
    cbox[tid] = cb;
    carea[tid] = box_area(cb, to_remove);
    const int c = c0 + cc, i = r * kTile + rho;
    if (r == 0) {
      const unsigned bits =
          __ballot_sync(kFull, jc < n && valid[static_cast<size_t>(img) * n + jc]);
      if ((tid & 31) == 0 && c < part.tri_end)
        alive[static_cast<size_t>(img) * tiles * 2 + (jc >> 5)] = bits;
    }
    __syncthreads();
    if (c >= part.tri_end || i >= n) continue;
    const float4 rb = bb[i];
    const float ra = box_area(rb, to_remove);
    const float4* cs = cbox + cc * kTile;
    const float* ca = carea + cc * kTile;
    u64 bits = 0ULL;
#pragma unroll
    for (int x = 0; x < kTile; ++x) {
      if (suppresses<kBand>(rb, ra, cs[x], ca[x], to_remove, thresh, th_hi, th_lo))
        bits |= 1ULL << x;
    }
    if (c == r) bits &= ~((2ULL << rho) - 1ULL);  // in its own tile, only the later boxes
    mask[((static_cast<size_t>(img) * tiles + r) * tiles + c) * kTile + rho] = bits;
  }
}

__device__ __forceinline__ u64 warp_or(u64 w) {
  const unsigned lo = __reduce_or_sync(kFull, static_cast<unsigned>(w));
  const unsigned hi = __reduce_or_sync(kFull, static_cast<unsigned>(w >> 32));
  return static_cast<u64>(lo) | (static_cast<u64>(hi) << 32);
}

// Walks row tiles [t0, t1) of one image, whose words exist for column tiles
// [t, t1). Between passes, kept (the kept rows of each tile walked), count
// and done carry the walk: a later pass first folds the earlier tiles'
// kept rows into its `removed` words. An image whose walk has stopped (k
// survivors, or its last tile) writes its outputs and sets done.
template <bool kStaged>
__global__ void __launch_bounds__(kWalkThreads)
nms_walk_kernel(const u64* __restrict__ mask, const u64* __restrict__ alive_g, int n,
                int tiles, int k, int t0, int t1, int nbuf, u64* __restrict__ kept_g,
                int* __restrict__ count_g, int* __restrict__ done,
                int64_t* __restrict__ out_idx, uint8_t* __restrict__ out_ok) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ u64 kept_s[2];
  __shared__ int count_s[2];
  __shared__ u64 diag[kTile];  // the tile's own words, for warp 0's chain
  const int img = blockIdx.x;
  if (t0 > 0 && done[img]) return;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t tile_words = static_cast<size_t>(tiles) * kTile;  // a row tile's, in global
  const size_t buf_words = static_cast<size_t>(t1 - t0) * kTile;  // a buffer's
  u64* bufs = reinterpret_cast<u64*>(smem);  // nbuf runs (staged)
  u64* removed = bufs + (kStaged ? nbuf * buf_words : 0);
  u64* alive = removed + tiles;
  uint64_t* bars = reinterpret_cast<uint64_t*>(alive + tiles);
  const u64* gmask = mask + static_cast<size_t>(img) * tiles * tile_words;
  u64* kept_img = kept_g + static_cast<size_t>(img) * tiles;

  int count = t0 > 0 ? count_g[img] : 0;
  for (int v = t0 + tid; v < t1; v += kWalkThreads)
    alive[v] = alive_g[static_cast<size_t>(img) * tiles + v];
  // the earlier passes' kept rows, folded into this pass's words
  for (int v = t0 + warp; v < t1; v += kWalkWarps) {
    u64 w = 0ULL;
    for (int u = 0; u < t0; ++u) {
      const u64 kk = kept_img[u];
      const u64* row = gmask + u * tile_words + static_cast<size_t>(v) * kTile;
      if ((kk >> lane) & 1ULL) w |= __ldg(row + lane);
      if ((kk >> (lane + 32)) & 1ULL) w |= __ldg(row + lane + 32);
    }
    w = warp_or(w);
    if (lane == 0) removed[v] = w;
  }
  if (kStaged && tid == 0) {
    for (int b = 0; b < nbuf; ++b) tma::bar_init(bars + b);
    tma::bar_init_fence();
  }
  __syncthreads();

  // tile t's run (column tiles [t, t1) of its rows) into buffer (t - t0) %
  // nbuf; a buffer is read in its tile's step and the next, so the copies
  // run nbuf - 2 tiles ahead
  auto issue = [&](int t, int b) {
    const uint32_t bytes = static_cast<uint32_t>(t1 - t) * kTile * 8;
    tma::expect(bars + b, bytes);
    tma::load(bufs + b * buf_words, gmask + t * tile_words + static_cast<size_t>(t) * kTile,
              bytes, bars + b);
  };
  if (kStaged && tid == 32)
    for (int t = t0; t < t1 && t < t0 + nbuf - 1; ++t) issue(t, t - t0);

  u64 kprev = 0ULL;          // kept rows of the previous tile, not yet folded
  const u64* prev = nullptr;  // the previous tile's run
  int b = 0;                 // tile t's buffer, (t - t0) % nbuf
  unsigned phase = 0;        // and its barrier's phase, ((t - t0) / nbuf) & 1
  int t = t0;
  for (; t < t1; ++t) {
    // word (column tile v, row rho) of tile t at run[(v - t) * 64 + rho]
    const u64* run = kStaged ? bufs + b * buf_words
                             : gmask + t * tile_words + static_cast<size_t>(t) * kTile;
    if (kStaged && tid == 32 && t > t0 && t + nbuf - 2 < t1) {
      tma::fence_to_async();  // the buffer's last reads came before the barrier
      issue(t + nbuf - 2, b + nbuf - 2 < nbuf ? b + nbuf - 2 : b - 2);
    }
    if (warp == 0) {
      u64 rem = removed[t];
      if (kprev) {
        u64 w = 0ULL;
        if ((kprev >> lane) & 1ULL) w |= prev[kTile + lane];
        if ((kprev >> (lane + 32)) & 1ULL) w |= prev[kTile + lane + 32];
        rem |= warp_or(w);
      }
      if (kStaged) tma::wait(bars + b, phase);
      u64 cand = alive[t] & ~rem;
      // each candidate's own word (rows lane and lane + 32), staged for the
      // chain; only rows that suppress another candidate are links
      const u64 d0 = ((cand >> lane) & 1ULL) ? run[lane] & cand : 0ULL;
      const u64 d1 = ((cand >> (lane + 32)) & 1ULL) ? run[lane + 32] & cand : 0ULL;
      diag[lane] = d0;
      diag[lane + 32] = d1;
      __syncwarp();
      const unsigned links_lo = __ballot_sync(kFull, d0 != 0ULL);
      const unsigned links_hi = __ballot_sync(kFull, d1 != 0ULL);
      // the greedy order within the tile, a half of 32 rows at a time: each
      // row in turn, if still a candidate, removes its victims. Few links:
      // visit the links only (a load each on the dependent chain); more:
      // every row of the half, unrolled, so that the loads run ahead and
      // the chain is a test and a mask a row.
      unsigned lo = static_cast<unsigned>(cand), hi = static_cast<unsigned>(cand >> 32);
      if (__popc(links_lo) <= kSparseLinks) {
        for (unsigned l = links_lo; l; l &= l - 1u) {
          const int i = __ffs(l) - 1;
          if ((lo >> i) & 1u) {
            const u64 w = diag[i];
            lo &= ~static_cast<unsigned>(w);
            hi &= ~static_cast<unsigned>(w >> 32);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const u64 w = diag[i];
          if (lo & (1u << i)) {
            lo &= ~static_cast<unsigned>(w);
            hi &= ~static_cast<unsigned>(w >> 32);
          }
        }
      }
      if (__popc(links_hi) <= kSparseLinks) {
        for (unsigned l = links_hi; l; l &= l - 1u) {
          const int i = __ffs(l) - 1;
          if ((hi >> i) & 1u) hi &= ~static_cast<unsigned>(diag[32 + i] >> 32);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const unsigned w = static_cast<unsigned>(diag[32 + i] >> 32);
          if (hi & (1u << i)) hi &= ~w;
        }
      }
      cand = static_cast<u64>(lo) | (static_cast<u64>(hi) << 32);
      const int room = k - count;
      const u64 below = (1ULL << lane) - 1ULL;
      const int64_t first = static_cast<int64_t>(t) * kTile;
      int64_t* oi = out_idx + static_cast<size_t>(img) * k + count;
      if ((cand >> lane) & 1ULL) {
        const int rank = __popcll(cand & below);
        if (rank < room) oi[rank] = first + lane;
      }
      if ((cand >> (lane + 32)) & 1ULL) {
        const int rank = __popcll(cand & ((below << 32) | 0xffffffffULL));
        if (rank < room) oi[rank] = first + lane + 32;
      }
      count = min(count + __popcll(cand), k);
      if (lane == 0) {
        kept_s[t & 1] = cand;
        count_s[t & 1] = count;
        kept_img[t] = cand;
      }
    } else if (kprev) {
      // a warp a word: OR of the previous tile's kept rows' words
#pragma unroll 4
      for (int v = t + warp; v < t1; v += kWalkWarps - 1) {
        const u64* col = prev + static_cast<size_t>(v - t + 1) * kTile;
        u64 w = 0ULL;
        if ((kprev >> lane) & 1ULL) w |= col[lane];
        if ((kprev >> (lane + 32)) & 1ULL) w |= col[lane + 32];
        w = warp_or(w);
        if (lane == 0 && w) removed[v] |= w;
      }
    }
    __syncthreads();
    kprev = kept_s[t & 1];
    count = count_s[t & 1];
    prev = run;
    if (++b == nbuf) {
      b = 0;
      phase ^= 1u;
    }
    if (count >= k) {
      ++t;
      break;
    }
  }

  if (count >= k || t1 == tiles) {
    int64_t* oi = out_idx + static_cast<size_t>(img) * k;
    for (int c = count + tid; c < k; c += kWalkThreads) oi[c] = n - 1;
    for (int c = tid; c < k; c += kWalkThreads) out_ok[static_cast<size_t>(img) * k + c] = c < count;
    if (tid == 0) done[img] = 1;
  } else if (tid == 0) {
    count_g[img] = count;
    done[img] = 0;
  }
  // copies still in flight (issued ahead of a walk that stopped) land
  // before the block's shared memory is released; (b, phase) are tile t's
  if (kStaged && tid == 0)
    for (int j = 0; t + j < t1 && j < nbuf - 2; ++j)
      tma::wait(bars + (b + j) % nbuf, phase ^ (b + j >= nbuf ? 1u : 0u));
}

template <bool kBand>
cudaError_t launch_mask(const float4* boxes, const uint8_t* valid, int batch, int n, int tiles,
                        Part part, const int* done, float thresh, float to_remove, u64* mask,
                        unsigned* alive, int wave, cudaStream_t s) {
  const float th_hi = thresh * (1.f + 0x1p-20f), th_lo = thresh * (1.f - 0x1p-20f);
  // a block an item; in a pass that may be skipped (done), at most one wave
  // of blocks, each looping over its image's items, so that a pass whose
  // images have all stopped costs a wave of blocks that exit at once
  long long gx = part.blocks();
  if (done != nullptr && gx > wave / batch) gx = wave / batch > 1 ? wave / batch : 1;
  nms_mask_kernel<kBand><<<dim3(static_cast<unsigned>(gx), batch), kMaskThreads, 0, s>>>(
      boxes, valid, n, tiles, part, done, thresh, th_hi, th_lo, to_remove, mask, alive);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory the walk needs over `tiles` row tiles of which a pass
// walks `span`, and its ring of buffers (0: the walk reads global memory).
int nms_walk_plan(int tiles, int span, int* nbuf_out) {
  const int fixed = 2 * tiles * 8;
  int nbuf = (kMaxShared - 1024 - fixed) / (span * kTile * 8 + 8);
  if (nbuf > kMaxBufs) nbuf = kMaxBufs;
  if (nbuf < 3) nbuf = 0;
  *nbuf_out = nbuf;
  return fixed + nbuf * (span * kTile * 8 + 8);
}

// The row tiles of the first pass (all of them: one pass).
int nms_first_pass_tiles(int n, int k) {
  const int tiles = (n + kTile - 1) / kTile;
  const int r1 = 4 * ((k + kTile - 1) / kTile);
  return 2 * r1 >= tiles ? tiles : r1;
}

// boxes (B, N, 4) float32 and valid (B, N) uint8, both contiguous on
// `device`; scratch of B (T^2 64 + 2 T + 1) 64-bit words (T = ceil(N /
// 64)): the (row tile, column tile, row) suppression words, then per image
// the valid bits and the kept rows of each tile (a word a tile), then a
// count and a done flag per image; out_idx (B, k) int64 and out_ok (B, k) uint8. Launches on
// `stream` and returns the cudaError_t of the launches (0 on success). Does
// not synchronise.
int nms_sorted_cuda(const void* boxes, const void* valid, int batch, int n, int k,
                    float thresh, float to_remove, void* scratch, void* out_idx, void* out_ok,
                    void* stream, int device) {
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: set it to the tensors' device
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch < 1 || batch > 65535 || n < 1 || k < 1 || device < 0 || device >= 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (n + kTile - 1) / kTile;
  static bool attr_set[64] = {};
  static int wave[64] = {};  // resident mask blocks: 8 of 256 threads an SM
  if (!attr_set[device]) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    wave[device] = sms * (2048 / kMaskThreads);
    for (const void* fn : {reinterpret_cast<const void*>(nms_walk_kernel<true>),
                           reinterpret_cast<const void*>(nms_walk_kernel<false>)}) {
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxShared - 1024);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    attr_set[device] = true;
  }
  // the exact quotient everywhere where the band's products could leave
  // the normal range
  const bool band = thresh >= 0x1p-60f && thresh <= 1.f;
  const int r1 = nms_first_pass_tiles(n, k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* bx = static_cast<const float4*>(boxes);
  const uint8_t* vb = static_cast<const uint8_t*>(valid);
  u64* mask = static_cast<u64*>(scratch);
  u64* alive = mask + static_cast<size_t>(batch) * tiles * tiles * kTile;
  u64* kept = alive + static_cast<size_t>(batch) * tiles;
  int* count = reinterpret_cast<int*>(kept + static_cast<size_t>(batch) * tiles);
  int* done = count + batch;
  // one pass, or the triangle of the first r1 row tiles, then the rest
  const Part parts[2] = {{0, 0, 0, r1}, {r1, r1, r1, tiles}};
  for (int pass = 0; pass < 2; ++pass) {
    const Part& part = parts[pass];
    const int t0 = part.tri_begin, t1 = part.tri_end;
    if (t0 >= t1) break;
    const int* skip = pass > 0 ? done : nullptr;
    unsigned* al = reinterpret_cast<unsigned*>(alive);
    err = band ? launch_mask<true>(bx, vb, batch, n, tiles, part, skip, thresh, to_remove, mask,
                                   al, wave[device], s)
               : launch_mask<false>(bx, vb, batch, n, tiles, part, skip, thresh, to_remove, mask,
                                    al, wave[device], s);
    if (err != cudaSuccess) return static_cast<int>(err);
    int nbuf = 0;
    const int smem = nms_walk_plan(tiles, t1 - t0, &nbuf);
    if (smem > kMaxShared - 1024) return static_cast<int>(cudaErrorInvalidValue);
    if (nbuf > 0)
      nms_walk_kernel<true><<<batch, kWalkThreads, smem, s>>>(
          mask, alive, n, tiles, k, t0, t1, nbuf, kept, count, done,
          static_cast<int64_t*>(out_idx), static_cast<uint8_t*>(out_ok));
    else
      nms_walk_kernel<false><<<batch, kWalkThreads, smem, s>>>(
          mask, alive, n, tiles, k, t0, t1, 0, kept, count, done,
          static_cast<int64_t*>(out_idx), static_cast<uint8_t*>(out_ok));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

const char* nms_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
