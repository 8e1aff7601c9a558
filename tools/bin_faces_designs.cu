// Designs of K7 bin_faces under test beside the shipped one
// (neural_renderer_v2_pytorch_tpu_torch/csrc/bin_faces.cu), built and timed
// by chip_smoke.py (phase 19) and tools/bin_faces_times.py --designs.  Each
// gives the same bins: per tile, the faces whose bbox meets its pixel-centre
// range, in ascending id order.
//
//   parent: K7 as the port first had it.  Its count pass adds each face's
//     tiles into a [bs, tiles, ceil(nf / 256)] count array (zeroed, scanned
//     with torch.cumsum, summed and read back by its Python glue); its fill
//     gives one warp to each 256-face chunk, which walks the chunk face by
//     face through single-writer cursors, so every bin comes out ascending.
//   radix: the plain version's own algorithm by hand.  Each face writes its
//     (tile key, face) pairs face-major at its scanned pair offset; a stable
//     LSD radix sort by key, 8 bits a pass (a block histogram, a scan of
//     the histograms, a stable scatter ranking equal digits by warp match
//     and per-warp counts), keeps each bin ascending; a binary search per
//     tile over the sorted keys gives cnt and offsets.
//
// Plain C entries with typed arguments (ctypes argtypes in the loader).

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
parent_count_kernel(const float* __restrict__ consts, int4* __restrict__ rects,
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
parent_fill_kernel(const int4* __restrict__ rects, int* cursors, int* __restrict__ ids,
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


constexpr int kScanThreads = 1024;
constexpr int kScanTile = 4 * kScanThreads;
constexpr int kRadixThreads = 256;
constexpr int kRadixItems = 8 * kRadixThreads;   // keys per histogram/scatter block

struct Geometry {
  int size, row_start, num_rows, tile_h, tile_w, tiles_x, tiles_y, n_tiles;
};

Geometry geometry(int size, int row_start, int num_rows, int tile_h, int tile_w) {
  Geometry g{size, row_start, num_rows, tile_h, tile_w, 0, 0, 0};
  g.tiles_x = (size + tile_w - 1) / tile_w;
  g.tiles_y = (num_rows + tile_h - 1) / tile_h;
  g.n_tiles = g.tiles_x * g.tiles_y;
  return g;
}

__device__ __forceinline__ int4 face_rect(const float* __restrict__ consts, size_t b, int f,
                                          int nf, const Geometry& g) {
  const float s = static_cast<float>(g.size);
  const float* c = consts + b * 17 * (size_t)nf + f;
  const int2 x = tile_interval(c[13 * (size_t)nf], c[14 * (size_t)nf], g.tiles_x, g.tile_w, 0,
                               g.size, s);
  const int2 y = tile_interval(c[15 * (size_t)nf], c[16 * (size_t)nf], g.tiles_y, g.tile_h,
                               g.row_start, g.num_rows, s);
  int wx = x.y - x.x, wy = y.y - y.x;
  if (wx <= 0 || wy <= 0) wx = wy = 0;
  return make_int4(x.x, y.x, wx, wy);
}

__device__ __forceinline__ int block_exclusive_scan(int v, int* sums, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < warps ? sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    sums[lane] = s;
  }
  __syncthreads();
  total = sums[warps - 1];
  const int excl = x - v + (warp > 0 ? sums[warp - 1] : 0);
  __syncthreads();
  return excl;
}

// In-place exclusive scan of data[0 .. padded) (padded a multiple of
// kScanTile, zero past the data) by one block; *total gets the sum.
__global__ void __launch_bounds__(kScanThreads)
radix_scan_kernel(int* data, int padded, int* total) {
  __shared__ int sums[32];
  int carry = 0;
  for (int base = 0; base < padded; base += kScanTile) {
    int4* p = reinterpret_cast<int4*>(data + base) + threadIdx.x;
    const int4 v = *p;
    int t;
    const int e = carry + block_exclusive_scan(v.x + v.y + v.z + v.w, sums, t);
    *p = make_int4(e, e + v.x, e + v.x + v.y, e + v.x + v.y + v.z);
    carry += t;
  }
  if (threadIdx.x == 0) *total = carry;
}

__global__ void __launch_bounds__(256)
radix_count_kernel(const float* __restrict__ consts, int* __restrict__ pairs_of, Geometry g,
                   int nf) {
  const int f = blockIdx.x * 256 + threadIdx.x;
  if (f >= nf) return;
  const int4 r = face_rect(consts, blockIdx.y, f, nf, g);
  pairs_of[(size_t)blockIdx.y * nf + f] = r.z * r.w;
}

__global__ void __launch_bounds__(256)
radix_emit_kernel(const float* __restrict__ consts, const int* __restrict__ first_pair,
                  int* __restrict__ keys, int* __restrict__ vals, Geometry g, int nf) {
  const int f = blockIdx.x * 256 + threadIdx.x;
  if (f >= nf) return;
  const size_t b = blockIdx.y;
  const int4 r = face_rect(consts, b, f, nf, g);
  int k = first_pair[b * nf + f];
  for (int ty = r.y; ty < r.y + r.w; ++ty) {
    for (int tx = r.x; tx < r.x + r.z; ++tx, ++k) {
      keys[k] = static_cast<int>(b) * g.n_tiles + ty * g.tiles_x + tx;
      vals[k] = f;
    }
  }
}

// hist[d * n_blocks + block] = the keys of this block with digit d
__global__ void __launch_bounds__(kRadixThreads)
radix_hist_kernel(const int* __restrict__ keys, int* __restrict__ hist, int n, int shift,
                  int n_blocks) {
  __shared__ int h[256];
  h[threadIdx.x] = 0;
  __syncthreads();
  const int first = blockIdx.x * kRadixItems;
  for (int j = 0; j < kRadixItems; j += kRadixThreads) {
    const int i = first + j + threadIdx.x;
    if (i < n) atomicAdd(h + ((keys[i] >> shift) & 255), 1);
  }
  __syncthreads();
  hist[threadIdx.x * n_blocks + blockIdx.x] = h[threadIdx.x];
}

// Stable scatter by digit: a key's slot is its digit's start for this block
// (the scanned histograms) plus the keys with that digit before it here,
// counted per 256-key step by warp match and per-warp counts.
__global__ void __launch_bounds__(kRadixThreads)
radix_scatter_kernel(const int* __restrict__ keys_in, const int* __restrict__ vals_in,
                     int* __restrict__ keys_out, int* __restrict__ vals_out,
                     const int* __restrict__ starts, int n, int shift, int n_blocks) {
  constexpr int kWarps = kRadixThreads / 32;
  __shared__ int base[256];
  __shared__ int counts[kWarps][257];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  base[t] = starts[t * n_blocks + blockIdx.x];
  for (int w = 0; w < kWarps; ++w) counts[w][t] = 0;
  __syncthreads();
  const int first = blockIdx.x * kRadixItems;
  for (int j = 0; j < kRadixItems; j += kRadixThreads) {
    const int i = first + j + t;
    const bool ok = i < n;
    const int key = ok ? keys_in[i] : 0;
    const int d = ok ? (key >> shift) & 255 : 256;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (lane == __ffs(peers) - 1) counts[warp][d] = __popc(peers);
    __syncthreads();
    int pos = 0;
    if (ok) {
      pos = base[d] + rank;
      for (int w = 0; w < warp; ++w) pos += counts[w][d];
    }
    __syncthreads();
    int add = 0;
    for (int w = 0; w < kWarps; ++w) {
      add += counts[w][t];
      counts[w][t] = 0;
    }
    base[t] += add;
    __syncthreads();
    if (ok) {
      keys_out[pos] = key;
      vals_out[pos] = vals_in[i];
    }
  }
}

// cnt and offsets of every bin: a binary search over the sorted keys
__global__ void __launch_bounds__(256)
radix_bounds_kernel(const int* __restrict__ keys, int n, int* __restrict__ cnt,
                    int* __restrict__ off, int n_bins) {
  const int t = blockIdx.x * 256 + threadIdx.x;
  if (t >= n_bins) return;
  int a = 0, z = n;
  while (a < z) {
    const int m = (a + z) >> 1;
    if (keys[m] < t) a = m + 1; else z = m;
  }
  int c = a, y = n;
  while (c < y) {
    const int m = (c + y) >> 1;
    if (keys[m] <= t) c = m + 1; else y = m;
  }
  off[t] = a;
  cnt[t] = c - a;
}

}  // namespace

extern "C" int nr_parent_bin_count(const float* consts, int* rects, int* counts, int bs, int nf,
                                   int size, int row_start, int num_rows, int tile_h,
                                   int tile_w, int chunk, void* stream) {
  if (bs == 0 || nf == 0) return 0;
  const int tiles_x = (size + tile_w - 1) / tile_w;
  const int tiles_y = (num_rows + tile_h - 1) / tile_h;
  const int n_chunks = (nf + chunk - 1) / chunk;
  const dim3 grid((nf + 255) / 256, bs);
  parent_count_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      consts, reinterpret_cast<int4*>(rects), counts, nf, size, row_start, num_rows, tile_h,
      tile_w, tiles_x, tiles_y, chunk, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nr_parent_bin_fill(const int* rects, int* cursors, int* ids, int bs, int nf,
                                  int tiles_x, int n_tiles, int chunk, void* stream) {
  if (bs == 0 || nf == 0) return 0;
  const int n_chunks = (nf + chunk - 1) / chunk;
  const long long threads = 32LL * bs * n_chunks;
  parent_fill_kernel<<<static_cast<unsigned>((threads + 127) / 128), 128, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int4*>(rects), cursors, ids, bs, nf, tiles_x, n_tiles, chunk,
      n_chunks);
  return static_cast<int>(cudaGetLastError());
}

// pairs_of: i32 [bs * nf padded to 4096], zeroed; scanned in place into
// each face's first pair; *total = the pair count.
extern "C" int nr_radix_count(const float* consts, int* pairs_of, int* total, int bs, int nf,
                              int size, int row_start, int num_rows, int tile_h, int tile_w,
                              int padded, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geometry g = geometry(size, row_start, num_rows, tile_h, tile_w);
  if (nf > 0) {
    radix_count_kernel<<<dim3((nf + 255) / 256, bs), 256, 0, s>>>(consts, pairs_of, g, nf);
  }
  radix_scan_kernel<<<1, kScanThreads, 0, s>>>(pairs_of, padded, total);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nr_radix_emit(const float* consts, const int* first_pair, int* keys, int* vals,
                             int bs, int nf, int size, int row_start, int num_rows, int tile_h,
                             int tile_w, void* stream) {
  if (nf == 0) return 0;
  const Geometry g = geometry(size, row_start, num_rows, tile_h, tile_w);
  radix_emit_kernel<<<dim3((nf + 255) / 256, bs), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      consts, first_pair, keys, vals, g, nf);
  return static_cast<int>(cudaGetLastError());
}

// One LSD pass over the digit at `shift`: hist i32 [256 * n_blocks padded
// to 4096], zeroed; total: i32 [1] scratch.
extern "C" int nr_radix_pass(const int* keys_in, const int* vals_in, int* keys_out,
                             int* vals_out, int* hist, int* total, int n, int shift,
                             int hist_padded, void* stream) {
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_blocks = (n + kRadixItems - 1) / kRadixItems;
  radix_hist_kernel<<<n_blocks, kRadixThreads, 0, s>>>(keys_in, hist, n, shift, n_blocks);
  radix_scan_kernel<<<1, kScanThreads, 0, s>>>(hist, hist_padded, total);
  radix_scatter_kernel<<<n_blocks, kRadixThreads, 0, s>>>(keys_in, vals_in, keys_out, vals_out,
                                                         hist, n, shift, n_blocks);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nr_radix_bounds(const int* keys, int n, int* cnt, int* off, int n_bins,
                               void* stream) {
  if (n_bins == 0) return 0;
  radix_bounds_kernel<<<(n_bins + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      keys, n, cnt, off, n_bins);
  return static_cast<int>(cudaGetLastError());
}
