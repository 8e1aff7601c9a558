// K7 bin_faces: per-tile face bins for the binned resolve (K8, resolve.cu).
//
// Replaces: _bin_faces in neural_renderer_v2_pytorch_tpu/ops/resolve_pallas.py:
//   1020, the prepass of _run_binned (:1073) that feeds _binned_kernel (:858).
//   The JAX package computes it in XLA as a stable argsort of an
//   [bs, tiles, nf] hit mask; K7 works on (tile, face) pairs instead, so its
//   memory grows with the pairs and not with tiles x nf.
//
// Computes, for the tiles of a row window (rows row_start .. row_start +
// num_rows - 1, tiles of tile_h x tile_w pixels, row-major), each tile's
// bin: the ids of the faces whose bbox meets the tile's pixel-centre range
// by K2's strict test, !(xmax < x_lo || x_hi < xmin || ymax < y_lo ||
// y_hi < ymin) with the range clipped at the canvas and window edges, in
// ascending id order.  Killed faces (bbox 4,-4,4,-4 from K1) meet no tile.
// Outputs: cnt [bs, tiles], offsets [bs, tiles] into ids, ids [pairs],
// batch-major and tile-major.  The order must be stable: the resolve's
// accept rule, zp <= depth - 1e-4 applied in id order, is not commutative.
//
// Three passes (the wrapper in ops/resolve_cuda.py runs them):
//   1. count (here): one thread per face finds its tile rectangle, by binary
//      search over the tiles' pixel centres (non-decreasing in the tile
//      index, so the tiles a bbox meets are one interval per axis), stores
//      it and adds it, by atomics, into per-(tile, face chunk) counts laid
//      out [bs, tiles, chunks].
//   2. scan (torch.cumsum in the wrapper): the exclusive scan of the counts
//      in that order gives each (tile, chunk) its slot range, and so each
//      tile its offset; its total, read on the host, sizes ids.
//   3. fill (here): one warp owns one face chunk and walks its faces in id
//      order, its lanes spread over each face's tiles.  Each (tile, chunk)
//      cursor has exactly one writer, and the writes of one face are
//      ordered before the next face's by __syncwarp, so every bin comes out
//      ascending: bit-equal to the plain version's stable sort.
//
// Bound: memory.  It reads each face's 4 bbox constants once (16 bytes) and
// writes 4 bytes per (tile, face) pair plus 8 per tile: at 81,920 faces
// and ~3 pairs per face about 3 MB, about a microsecond of HBM time.  What
// it costs beyond that is the per-(tile, chunk) count array (zeroed,
// scanned and read once: tiles x nf / chunk entries) and the fill's
// dependent cursor updates, one per face along each warp's chunk.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float pixel_centre(int i, float s) {
  return (2.0f * static_cast<float>(i) + 1.0f - s) / s;
}

// Pixel-centre range of tile t along one axis: pixels start + t * tile ..
// start + min((t + 1) * tile, extent) - 1.
__device__ __forceinline__ float tile_lo(int t, int tile, int start, float s) {
  return pixel_centre(start + t * tile, s);
}

__device__ __forceinline__ float tile_hi(int t, int tile, int start, int extent, float s) {
  return pixel_centre(start + min((t + 1) * tile, extent) - 1, s);
}

// The interval [first, end) of the n tiles along one axis whose pixel-centre
// range meets [vmin, vmax]: first = #tiles with hi < vmin, end = #tiles with
// lo <= vmax (both ranges' ends are non-decreasing in t).
__device__ __forceinline__ int2 tile_interval(float vmin, float vmax, int n, int tile,
                                              int start, int extent, float s) {
  int a = 0, z = n;
  while (a < z) {
    const int m = (a + z) >> 1;
    if (tile_hi(m, tile, start, extent, s) < vmin) a = m + 1; else z = m;
  }
  int c = 0, y = n;
  while (c < y) {
    const int m = (c + y) >> 1;
    if (tile_lo(m, tile, start, s) <= vmax) c = m + 1; else y = m;
  }
  return make_int2(a, c);
}

__global__ void __launch_bounds__(256)
bin_count_kernel(const float* __restrict__ consts, int4* __restrict__ rects,
                 int* __restrict__ counts, int nf, int size, int row_start,
                 int num_rows, int tile_h, int tile_w, int tiles_x, int tiles_y,
                 int chunk, int n_chunks) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= nf) return;
  const size_t b = blockIdx.y;
  const float s = static_cast<float>(size);
  // c[13..16] = xmin, xmax, ymin, ymax
  const float* c = consts + b * 17 * (size_t)nf + f;
  const int2 x = tile_interval(c[13 * (size_t)nf], c[14 * (size_t)nf], tiles_x, tile_w, 0,
                               size, s);
  const int2 y = tile_interval(c[15 * (size_t)nf], c[16 * (size_t)nf], tiles_y, tile_h,
                               row_start, num_rows, s);
  int wx = x.y - x.x, wy = y.y - y.x;
  if (wx <= 0 || wy <= 0) wx = wy = 0;
  rects[b * nf + f] = make_int4(x.x, y.x, wx, wy);
  int* cb = counts + b * (size_t)tiles_x * tiles_y * n_chunks + f / chunk;
  for (int ty = y.x; ty < y.x + wy; ++ty) {
    for (int tx = x.x; tx < x.x + wx; ++tx) {
      atomicAdd(cb + (size_t)(ty * tiles_x + tx) * n_chunks, 1);
    }
  }
}

__global__ void __launch_bounds__(128)
bin_fill_kernel(const int4* __restrict__ rects, int* cursors, int* __restrict__ ids,
                int bs, int nf, int tiles_x, int n_tiles, int chunk, int n_chunks) {
  const int warp = static_cast<int>((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= bs * n_chunks) return;  // whole warps only
  const int b = warp / n_chunks, ch = warp % n_chunks;
  const int begin = ch * chunk, end = min(begin + chunk, nf);
  volatile int* cur = cursors + (size_t)b * n_tiles * n_chunks + ch;
  for (int base = begin; base < end; base += 32) {
    const int f = base + lane;
    const int4 r = f < end ? rects[(size_t)b * nf + f] : make_int4(0, 0, 0, 0);
    const int m = min(32, end - base);
    for (int j = 0; j < m; ++j) {
      const int tx0 = __shfl_sync(0xffffffffu, r.x, j);
      const int ty0 = __shfl_sync(0xffffffffu, r.y, j);
      const int wx = __shfl_sync(0xffffffffu, r.z, j);
      const int n = wx * __shfl_sync(0xffffffffu, r.w, j);
      for (int k = lane; k < n; k += 32) {
        volatile int* p = cur + (size_t)((ty0 + k / wx) * tiles_x + tx0 + k % wx) * n_chunks;
        const int slot = *p;
        ids[slot] = base + j;
        *p = slot + 1;
      }
      __syncwarp();  // this face's cursor updates before the next face reads them
    }
  }
}

}  // namespace

// Pass 1.  consts: f32 [bs, 17, nf] from K1; rects: i32 [bs, nf, 4] out
// (first tile column, first tile row, width, height in tiles); counts: i32
// [bs, tiles_y * tiles_x, ceil(nf / chunk)], zeroed by the caller.
// Returns cudaGetLastError().
extern "C" int nr_bin_faces_count(const float* consts, int* rects, int* counts, int bs,
                                  int nf, int size, int row_start, int num_rows,
                                  int tile_h, int tile_w, int chunk, void* stream) {
  if (bs == 0 || nf == 0) return 0;
  const int tiles_x = (size + tile_w - 1) / tile_w;
  const int tiles_y = (num_rows + tile_h - 1) / tile_h;
  const int n_chunks = (nf + chunk - 1) / chunk;
  const dim3 grid((nf + 255) / 256, bs);
  bin_count_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      consts, reinterpret_cast<int4*>(rects), counts, nf, size, row_start, num_rows,
      tile_h, tile_w, tiles_x, tiles_y, chunk, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

// Pass 3 (the launch counted as bin_faces).  rects from pass 1; cursors: i32 [bs, tiles, ceil(nf / chunk)],
// the exclusive scan of the counts, advanced in place; ids: i32 [pairs] out.
// Returns cudaGetLastError().
extern "C" int nr_bin_faces(const int* rects, int* cursors, int* ids, int bs, int nf,
                                 int tiles_x, int n_tiles, int chunk, void* stream) {
  if (bs == 0 || nf == 0) return 0;
  const int n_chunks = (nf + chunk - 1) / chunk;
  const long long threads = 32LL * bs * n_chunks;
  bin_fill_kernel<<<static_cast<unsigned>((threads + 127) / 128), 128, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int4*>(rects), cursors, ids, bs, nf, tiles_x, n_tiles, chunk,
      n_chunks);
  return static_cast<int>(cudaGetLastError());
}
