// K7 bin_faces: per-tile face bins for the binned resolve (K8, resolve.cu).
//
// Replaces: _bin_faces in neural_renderer_v2_pytorch_tpu/ops/resolve_pallas.py:
//   1020, the prepass of _run_binned (:1073) that feeds _binned_kernel (:858).
//   The JAX package computes it in XLA as a stable argsort of an
//   [bs, tiles, nf] hit mask; K7 works on (tile, face) pairs instead, so its
//   memory grows with the pairs and not with tiles x nf.
//
// Computes, for the tiles of a row window (rows row_start .. row_start +
// num_rows - 1, tiles of kTile x kTile pixels, row-major), each tile's
// bin: the ids of the faces whose bbox meets the tile's pixel-centre range
// by K2's strict test, !(xmax < x_lo || x_hi < xmin || ymax < y_lo ||
// y_hi < ymin) with the range clipped at the canvas and window edges, in
// ascending id order.  Each pass forms a face's bbox and K1's kill rule
// from its six screen coordinates itself (face_constants.cuh: K1's
// expressions, so K1's bits), so the binned route launches no K1; killed
// faces (bbox 4,-4,4,-4) meet no tile.
// Outputs: cnt [bs, tiles], offsets [bs, tiles] into ids, ids [pairs],
// batch-major and tile-major.  The order must be ascending: the resolve's
// accept rule, zp <= depth - 1e-4 applied in id order, is not commutative.
//
// The capacity.  The pairs go into ids and an unsorted buffer of
// `capacity` slots each (4 bytes a slot in each).  Eagerly the wrapper reads
// the pair total back and passes it as the capacity, so every bin fits.  A
// CUDA graph cannot read anything back: it is captured with a capacity fixed
// beforehand (ops/graphs.py), and a bin whose pairs end past it in the
// exclusive scan (offset + cnt > capacity) is an overflow bin: its offset is
// written as -1, its cnt kept, and the fill and order passes skip it; K8
// then resolves it over every face, in ascending id order, which gives the
// exact bin's bits.  The scan's offsets are non-decreasing, so the overflow
// bins are the bins from the first one whose pairs end past the capacity
// on, in scan order: which bins overflow depends on the counts alone, never
// on the order of the atomics.  One control word counts the call's
// overflow bins.
//
// Four device operations, and eagerly one host readback (the wrapper in
// ops/resolve_cuda.py calls the two entries):
//   nr_bin_faces_count
//     1. memset: the per-tile counters [bs * tiles] and the control words.
//     2. count: one thread per face finds its tile rectangle, by binary
//        search over the tiles' pixel-centre bounds (non-decreasing in the
//        tile index, so the tiles a bbox meets are one interval per axis;
//        each block computes the bounds once into shared memory), and adds
//        1 to each covered tile's counter (one atomic per warp and tile,
//        lanes on one tile aggregated); the blocks sum the pair total.
//   (host, eager form only: reads the pair total back, to size ids)
//   nr_bin_faces
//     3. scan + fill: the first blocks to start take the counters' chunks
//        in ticket order and scan them with a decoupled look-back (a block
//        waits only on chunks whose blocks started before it): cnt,
//        offsets (-1 for an overflow bin, counted in the overflow word) and
//        each tile's fill cursor in place of its counter.  Once
//        every chunk is scanned, one thread per face recomputes its
//        rectangle and takes one slot per covered tile from the tile's
//        cursor (one atomic per warp and tile) and writes its id there if
//        the slot lies below the capacity: each bin's ids in the order the
//        atomics ran.  (Of the overflow bins only the first can own slots
//        below the capacity, past the last bin that fits.)
//     4. order: one warp per bin that fits, the warps of a block on bins
//        far apart on the canvas, so that crowded bins spread over blocks.  A bin of
//        at most kWarpCap ids is ranked by its warp (ids in a bin are
//        distinct, so each id's rank is the count of smaller ones), through
//        shuffles up to 32 ids and shared memory above; a larger one by
//        the block, through a bitmap of its id range [min, max] in shared
//        memory, in windows of 32 * kBitmapWords ids, so no bin is ever too
//        large.
//   Either way the sorted bin is the plain version's (a stable sort of
//   face-major pairs by tile), bit for bit, whatever order the atomics took.
//
// Bound: memory.  It reads each face's six x/y coordinates once (24 bytes) and
// writes 4 bytes per (tile, face) pair plus 8 per tile: at 81,920 faces and
// ~3 pairs per face about 3 MB, about a microsecond of HBM time.  Its
// scratch is the counters (4 bytes per tile, padded to a scan chunk), 8
// bytes per chunk and the unsorted pairs (4 bytes each): it grows with
// tiles + pairs, never with tiles x faces.  What it costs beyond the bound
// is four dependent device operations, the eager form's readback, the
// scan's wait, and the order pass's one warp (or block) per bin.

#include <cuda_runtime.h>

#include <climits>

#include "face_constants.cuh"
#include "nr_entry.cuh"

namespace {

// the tile edge in pixels: K8's (kBinEdge in resolve.cu, resolve_cuda.BIN_TILE)
constexpr int kTile = 8;
constexpr int kCountThreads = 256;
constexpr int kFillThreads = 256;
constexpr int kScanPer = 16;                      // counters per thread of a scan chunk
constexpr int kScanChunk = kScanPer * kFillThreads;  // counters are padded to this many
constexpr int kOrderWarps = 4;                    // bins per order block
constexpr int kWarpCap = 256;                     // the most ids a warp ranks
constexpr int kItems = kWarpCap / 32;
// a larger bin's bitmap window: 4096 words (16 KB of shared memory), 131,072 ids
constexpr int kBitmapWords = 4096;
constexpr int kLoads = 8;                         // ids a large bin's thread loads at once
// the tiles' bounds in shared memory: 2 floats per tile of each axis
constexpr int kMaxTableTiles = 48 * 1024 / (2 * sizeof(float));
// the control words after the padded counters: the scan's ticket, the pair
// total, the chunks scanned, the overflow bins; then one 64-bit state per
// chunk
constexpr int kTicket = 0, kTotal = 1, kScanned = 2, kOverflow = 3, kStates = 4;

struct Geometry {
  int size, row_start, num_rows, tiles_x, tiles_y, n_tiles, draw_backside;
};

struct Rect {
  int tx0, ty0, wx, wy;
};

__device__ __forceinline__ float pixel_centre(int i, float s) {
  return (2.0f * static_cast<float>(i) + 1.0f - s) / s;
}

// The pixel-centre range of every tile along both axes, into shared memory
// (tiles_x then tiles_y (lo, hi) pairs): tile t spans pixels start + t *
// kTile .. start + min((t + 1) * kTile, extent) - 1.
__device__ void tile_bounds(float2* bounds, const Geometry& g) {
  const float s = static_cast<float>(g.size);
  for (int i = threadIdx.x; i < g.tiles_x + g.tiles_y; i += blockDim.x) {
    const bool x = i < g.tiles_x;
    const int t = x ? i : i - g.tiles_x;
    const int start = x ? 0 : g.row_start, extent = x ? g.size : g.num_rows;
    bounds[i] = make_float2(pixel_centre(start + t * kTile, s),
                            pixel_centre(start + min((t + 1) * kTile, extent) - 1, s));
  }
  __syncthreads();
}

// The interval [first, end) of the n tiles along one axis whose pixel-centre
// range meets [vmin, vmax]: first = #tiles with hi < vmin, end = #tiles with
// lo <= vmax (both ends are non-decreasing in the tile).
__device__ __forceinline__ int2 tile_interval(float vmin, float vmax, const float2* b, int n) {
  int a = 0, z = n;
  while (a < z) {
    const int m = (a + z) >> 1;
    if (b[m].y < vmin) a = m + 1; else z = m;
  }
  int c = 0, y = n;
  while (c < y) {
    const int m = (c + y) >> 1;
    if (b[m].x <= vmax) c = m + 1; else y = m;
  }
  return make_int2(a, c);
}

// Face f of image b: the rectangle of tiles its bbox meets (empty: 0 x 0),
// from its screen coordinates fvp[b, coord, vertex, f] by K1's expressions
// and kill rule.
__device__ __forceinline__ Rect face_rect(const float* __restrict__ fvp, size_t b, int f,
                                          int nf, const float2* bounds, const Geometry& g) {
  const float* v = fvp + b * 9 * (size_t)nf + f;
  float c[nr_face::kConsts];
  nr_face::constants_xy(v[0], v[3 * (size_t)nf], v[(size_t)nf], v[4 * (size_t)nf],
                        v[2 * (size_t)nf], v[5 * (size_t)nf], c);
  nr_face::kill_invalid(c, g.draw_backside);
  // c[13..16] = xmin, xmax, ymin, ymax
  const int2 x = tile_interval(c[13], c[14], bounds, g.tiles_x);
  const int2 y = tile_interval(c[15], c[16], bounds + g.tiles_x, g.tiles_y);
  int wx = x.y - x.x, wy = y.y - y.x;
  if (wx <= 0 || wy <= 0) wx = wy = 0;
  return Rect{x.x, y.x, wx, wy};
}

// atomicAdd(p + i, 1) for every active lane, one atomic per distinct i in
// the warp; returns the lane's own old value (lanes on one i in lane order).
__device__ __forceinline__ int warp_add_one(int* p, int i) {
  const unsigned peers = __match_any_sync(__activemask(), i);
  const int lane = threadIdx.x & 31, leader = __ffs(peers) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(p + i, __popc(peers));
  return __shfl_sync(peers, base, leader) + __popc(peers & ((1u << lane) - 1u));
}

// Exclusive scan of one int per thread over the block; `total` gets the
// block's sum.  `sums`: 32 ints of shared memory.
__device__ __forceinline__ int block_exclusive_scan(int v, int* sums, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < warps ? sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    sums[lane] = s;
  }
  __syncthreads();
  total = sums[warps - 1];
  const int excl = x - v + (warp > 0 ? sums[warp - 1] : 0);
  __syncthreads();  // sums is written again by the next call
  return excl;
}

__global__ void __launch_bounds__(kCountThreads)
bin_count_kernel(const float* __restrict__ fvp, int* scratch, Geometry g, int nf,
                 int padded) {
  extern __shared__ float2 bounds[];
  __shared__ int block_pairs;
  if (threadIdx.x == 0) block_pairs = 0;
  tile_bounds(bounds, g);
  const int f = blockIdx.x * kCountThreads + threadIdx.x;
  int pairs = 0;
  if (f < nf) {
    const Rect r = face_rect(fvp, blockIdx.y, f, nf, bounds, g);
    int* counters = scratch + (size_t)blockIdx.y * g.n_tiles;
    for (int ty = r.ty0; ty < r.ty0 + r.wy; ++ty) {
      for (int tx = r.tx0; tx < r.tx0 + r.wx; ++tx) warp_add_one(counters, ty * g.tiles_x + tx);
    }
    pairs = r.wx * r.wy;
  }
  pairs = __reduce_add_sync(0xffffffffu, pairs);
  if ((threadIdx.x & 31) == 0 && pairs) atomicAdd(&block_pairs, pairs);
  __syncthreads();
  if (threadIdx.x == 0 && block_pairs) atomicAdd(scratch + padded + kTotal, block_pairs);
}

// Scan chunk t of the counters (kScanChunk of them from t * kScanChunk):
// its block's local scan, then its prefix from the chunks before it by a
// decoupled look-back over their 64-bit states (status << 32 | value:
// 1 = the chunk's own sum, 2 = its inclusive prefix); writes cnt, offsets
// and the fill cursors in place of the counters.  A bin whose pairs end past
// `capacity` gets offset -1, and adds one to the overflow word.
__device__ void scan_chunk(int t, int* scratch, int* __restrict__ cnt_out,
                           int* __restrict__ off_out, int n_bins, int padded, int capacity) {
  __shared__ int sums[32];
  __shared__ int chunk_prefix;
  constexpr int kVecs = kScanPer / 4;
  unsigned long long* states = reinterpret_cast<unsigned long long*>(scratch + padded + kStates);
  const int i = t * kScanChunk + kScanPer * threadIdx.x;
  int4 v[kVecs];
  int sum = 0;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    v[k] = __ldcg(reinterpret_cast<const int4*>(scratch + i) + k);
    sum += v[k].x + v[k].y + v[k].z + v[k].w;
  }
  int total;
  int run = block_exclusive_scan(sum, sums, total);
  if (threadIdx.x == 0) {
    int prefix = 0;
    if (t > 0) {
      atomicExch(states + t, (1ull << 32) | static_cast<unsigned>(total));
      for (int q = t - 1; q >= 0;) {
        const unsigned long long s = atomicAdd(states + q, 0ull);
        if ((s >> 32) == 0) {                            // not yet published
          __nanosleep(32);
          continue;
        }
        prefix += static_cast<int>(s & 0xffffffffu);
        if ((s >> 32) == 2) break;
        --q;
      }
    }
    atomicExch(states + t, (2ull << 32) | static_cast<unsigned>(prefix + total));
    chunk_prefix = prefix;
  }
  __syncthreads();
  run += chunk_prefix;
  int overflow = 0;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int j = i + 4 * k;
    const int4 o = make_int4(run, run + v[k].x, run + v[k].x + v[k].y,
                             run + v[k].x + v[k].y + v[k].z);
    run = o.w + v[k].w;
    reinterpret_cast<int4*>(scratch + j)[0] = o;
    const int4 f = make_int4(o.x + v[k].x > capacity ? -1 : o.x,
                             o.y + v[k].y > capacity ? -1 : o.y,
                             o.z + v[k].z > capacity ? -1 : o.z, run > capacity ? -1 : o.w);
    if (j + 3 < n_bins) {       // the outputs are 16-byte aligned, exactly n_bins long
      reinterpret_cast<int4*>(cnt_out + j)[0] = v[k];
      reinterpret_cast<int4*>(off_out + j)[0] = f;
      overflow += (f.x < 0) + (f.y < 0) + (f.z < 0) + (f.w < 0);
    } else {
      const int c[4] = {v[k].x, v[k].y, v[k].z, v[k].w}, s[4] = {f.x, f.y, f.z, f.w};
      for (int q = 0; q < 4 && j + q < n_bins; ++q) {
        cnt_out[j + q] = c[q];
        off_out[j + q] = s[q];
        overflow += s[q] < 0;
      }
    }
  }
  overflow = __reduce_add_sync(0xffffffffu, overflow);
  if ((threadIdx.x & 31) == 0 && overflow) atomicAdd(scratch + padded + kOverflow, overflow);
}

__global__ void __launch_bounds__(kFillThreads)
bin_fill_kernel(const float* __restrict__ fvp, int* scratch, int* __restrict__ cnt_out,
                int* __restrict__ off_out, int* __restrict__ unsorted, Geometry g, int nf,
                int n_bins, int padded, int capacity) {
  extern __shared__ float2 bounds[];
  __shared__ int ticket;
  const int chunks = padded / kScanChunk;
  int* control = scratch + padded;
  if (threadIdx.x == 0) ticket = atomicAdd(control + kTicket, 1);
  tile_bounds(bounds, g);
  // the first blocks to start scan the chunks, each waiting only on blocks
  // that started before it; then every block waits for the whole scan
  if (ticket < chunks) {
    scan_chunk(ticket, scratch, cnt_out, off_out, n_bins, padded, capacity);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) atomicAdd(control + kScanned, 1);
  }
  if (threadIdx.x == 0) {
    while (atomicAdd(control + kScanned, 0) < chunks) __nanosleep(64);
  }
  __syncthreads();
  const int f = blockIdx.x * kFillThreads + threadIdx.x;
  if (f >= nf) return;
  const size_t b = blockIdx.y;
  const Rect r = face_rect(fvp, b, f, nf, bounds, g);
  int* cur = scratch + b * g.n_tiles;
  for (int ty = r.ty0; ty < r.ty0 + r.wy; ++ty) {
    for (int tx = r.tx0; tx < r.tx0 + r.wx; ++tx) {
      const int slot = warp_add_one(cur, ty * g.tiles_x + tx);
      if (slot < capacity) unsorted[slot] = f;
    }
  }
}

// The warp ranks the c <= kWarpCap ids of unsorted[o ..) into ids[o ..):
// through shuffles up to 32 ids, else through s in shared memory.
__device__ __forceinline__ void warp_rank(const int* __restrict__ unsorted,
                                          int* __restrict__ ids, int o, int c, int* s) {
  const int lane = threadIdx.x & 31;
  if (c <= 32) {
    const int v = lane < c ? unsorted[o + lane] : INT_MAX;
    int r = 0;
    for (int j = 0; j < c; ++j) r += __shfl_sync(0xffffffffu, v, j) < v;
    if (lane < c) ids[o + r] = v;
    return;
  }
  for (int i = lane; i < c; i += 32) s[i] = unsorted[o + i];
  __syncwarp();
  const int items = (c + 31) / 32;
  int v[kItems], r[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    v[k] = lane + 32 * k < c ? s[lane + 32 * k] : INT_MAX;
    r[k] = 0;
  }
  for (int j = 0; j < c; ++j) {
    const int x = s[j];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (k < items) r[k] += x < v[k];
    }
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (lane + 32 * k < c) ids[o + r[k]] = v[k];
  }
}

// v[k] = bin[i0 + k * blockDim.x], -1 past its c ids: a thread's kLoads
// loads issued before any is used.  One block alone orders a large bin, so
// its passes over the bin are bound by the loads' latency.
__device__ __forceinline__ void load_ids(const int* __restrict__ bin, int i0, int c,
                                         int (&v)[kLoads]) {
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const int i = i0 + k * static_cast<int>(blockDim.x);
    v[k] = i < c ? bin[i] : -1;
  }
}

// The block orders the c ids of unsorted[o ..) into ids[o ..) through a
// bitmap over their range [min, max], a window of 32 * kBitmapWords ids at a
// time.
__device__ void block_bitmap(const int* __restrict__ unsorted, int* __restrict__ ids, int o,
                             int c, unsigned* bitmap, int* range, int* sums) {
  const int lane = threadIdx.x & 31;
  int lo = INT_MAX, hi = -1;
  for (int i0 = threadIdx.x; i0 < c; i0 += kLoads * blockDim.x) {
    int v[kLoads];
    load_ids(unsorted + o, i0, c, v);
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      if (v[k] >= 0) {
        lo = min(lo, v[k]);
        hi = max(hi, v[k]);
      }
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (threadIdx.x == 0) {
    range[0] = INT_MAX;
    range[1] = -1;
  }
  __syncthreads();
  if (lane == 0) {
    atomicMin(range, lo);
    atomicMax(range + 1, hi);
  }
  __syncthreads();
  lo = range[0];
  hi = range[1];
  int run = 0;
  for (int base = lo; base <= hi; base += 32 * kBitmapWords) {
    const int words = min(kBitmapWords, (hi - base) / 32 + 1);
    for (int i = threadIdx.x; i < words; i += blockDim.x) bitmap[i] = 0u;
    __syncthreads();
    for (int i0 = threadIdx.x; i0 < c; i0 += kLoads * blockDim.x) {
      int v[kLoads];
      load_ids(unsorted + o, i0, c, v);
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int d = v[k] - base;
        if (v[k] >= 0 && d >= 0 && d < 32 * words) atomicOr(bitmap + (d >> 5), 1u << (d & 31));
      }
    }
    __syncthreads();
    const int per = (words + blockDim.x - 1) / blockDim.x;
    const int w0 = min(words, static_cast<int>(threadIdx.x) * per);
    const int w1 = min(words, w0 + per);
    int n = 0;
    for (int i = w0; i < w1; ++i) n += __popc(bitmap[i]);
    int total;
    int pos = o + run + block_exclusive_scan(n, sums, total);
    for (int i = w0; i < w1; ++i) {
      for (unsigned m = bitmap[i]; m; m &= m - 1) ids[pos++] = base + 32 * i + __ffs(m) - 1;
    }
    run += total;
    __syncthreads();  // the bitmap and the range are written again next
  }
}

__global__ void __launch_bounds__(kOrderWarps * 32)
bin_order_kernel(const int* __restrict__ cnt, const int* __restrict__ off,
                 const int* __restrict__ unsorted, int* __restrict__ ids, int n_bins) {
  __shared__ int warp_ids[kOrderWarps][kWarpCap];
  __shared__ int bin_cnt[kOrderWarps], bin_off[kOrderWarps], range[2], sums[32];
  extern __shared__ unsigned bitmap[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // warp w of block b takes bin b + w * gridDim.x; an overflow bin (offset
  // -1) has nothing to order (both loads issued at once, the count's not
  // waiting on the offset)
  const int bin = blockIdx.x + warp * gridDim.x;
  const int n = bin < n_bins ? cnt[bin] : 0;
  const int o = bin < n_bins ? off[bin] : 0;
  const int c = o >= 0 ? n : 0;
  if (lane == 0) {
    bin_cnt[warp] = c;
    bin_off[warp] = o;
  }
  if (c <= kWarpCap) warp_rank(unsorted, ids, o, c, warp_ids[warp]);
  __syncthreads();

  // the larger bins, each by the whole block
  for (int w = 0; w < kOrderWarps; ++w) {
    if (bin_cnt[w] > kWarpCap) {
      block_bitmap(unsorted, ids, bin_off[w], bin_cnt[w], bitmap, range, sums);
    }
  }
}

Geometry geometry(int size, int row_start, int num_rows, int draw_backside) {
  Geometry g{size, row_start, num_rows, 0, 0, 0, draw_backside};
  g.tiles_x = (size + kTile - 1) / kTile;
  g.tiles_y = (num_rows + kTile - 1) / kTile;
  g.n_tiles = g.tiles_x * g.tiles_y;
  return g;
}

int padded_bins(int n_bins) { return (n_bins + kScanChunk - 1) / kScanChunk * kScanChunk; }

// Passes 1 and 2.  fvp: f32 [bs, 3, 3, nf]; scratch: i32
// [padded + 4 + 2 * padded / kScanChunk], padded = bs * tiles rounded up to
// kScanChunk (4096).  Afterwards scratch[padded + 1] holds the pair total
// (and scratch[padded + 3], zeroed here, is the overflow word that
// bin_faces fills).
// At most kMaxTableTiles tiles along both axes together.
int bin_faces_count(void* stream, const float* fvp, int* scratch, int bs, int nf, int size,
                    int row_start, int num_rows, int draw_backside) {
  const Geometry g = geometry(size, row_start, num_rows, draw_backside);
  const int n_bins = bs * g.n_tiles;
  if (n_bins == 0) return 0;
  if (g.tiles_x + g.tiles_y > kMaxTableTiles) return static_cast<int>(cudaErrorInvalidValue);
  const int padded = padded_bins(n_bins);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t words = padded + kStates + 2 * (padded / kScanChunk);
  const cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(int) * words, s);
  if (err != cudaSuccess || nf == 0) return static_cast<int>(err);
  const dim3 grid((nf + kCountThreads - 1) / kCountThreads, bs);
  bin_count_kernel<<<grid, kCountThreads, sizeof(float2) * (g.tiles_x + g.tiles_y), s>>>(
      fvp, scratch, g, nf, padded);
  return static_cast<int>(cudaGetLastError());
}

// Passes 3 and 4 (the launch counted as bin_faces).  scratch from passes 1
// and 2; cnt, off: i32 [bs, tiles] out (off -1 for an overflow bin);
// unsorted and ids: i32 [capacity], ids defined in the bins that fit.
int bin_faces(void* stream, const float* fvp, int* scratch, int* cnt, int* off, int* unsorted,
              int* ids, int bs, int nf, int size, int row_start, int num_rows,
              int draw_backside, int capacity) {
  const Geometry g = geometry(size, row_start, num_rows, draw_backside);
  const int n_bins = bs * g.n_tiles;
  if (n_bins == 0) return 0;
  if (g.tiles_x + g.tiles_y > kMaxTableTiles) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int padded = padded_bins(n_bins);
  // enough blocks for every chunk of the scan, even for few faces
  const int chunks = padded / kScanChunk;
  const dim3 fill_grid(max((nf + kFillThreads - 1) / kFillThreads, (chunks + bs - 1) / bs), bs);
  bin_fill_kernel<<<fill_grid, kFillThreads, sizeof(float2) * (g.tiles_x + g.tiles_y), s>>>(
      fvp, scratch, cnt, off, unsorted, g, nf, n_bins, padded, capacity);
  // the bitmap for bins above kWarpCap: a window spans at most the nf ids
  const size_t shared = sizeof(unsigned) * max(1, min(kBitmapWords, (nf + 31) / 32));
  bin_order_kernel<<<(n_bins + kOrderWarps - 1) / kOrderWarps, kOrderWarps * 32, shared, s>>>(
      cnt, off, unsorted, ids, n_bins);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

NR_PACKED_ENTRY(bin_faces_count)
NR_PACKED_ENTRY(bin_faces)
