// The z-buffer resolve: two face sources, three latch forms, one per-pixel
// test (test_face) and one epilogue (write_pixel).
//
// Face sources:
//   tiled (K2, K2L, resolve_depth): every CTA streams all nf faces' vertices
//     and keeps those that are live and whose bbox touches its 16x16 tile.
//   binned (K8: resolve_binned_xy, resolve_binned_latch,
//     resolve_binned_depth): a CTA of 64 threads per 8x8 bin; the bin holds
//     the ascending ids of the faces that K7 (bin_faces.cu) found live and
//     touching the tile, and each entry's nine coordinates are gathered.
//     An overflow bin (offset -1: its pairs did not fit K7's capacity)
//     takes every face instead, ids 0 .. nf - 1 in order.
// Both form the 17 constants and the kill rule themselves
// (face_constants.cuh, K1's own expressions), so no path launches K1.
// Latch forms:
//   XY: the winner's screen coordinates x0,y0,x1,y1,x2,y2 in registers, for
//     the silhouette path.  Outputs: id (-1 on background), depth (far on
//     background), coordinates [bs, 6, rows, S] (0 on background).
//   copy: only the id in registers; the epilogue copies the winner's nine
//     coordinates (plane 3 * vertex + coord) and A attribute planes, for the
//     RGB and depth paths.  Outputs: id, depth, [bs, 9, rows, S],
//     [bs, A, rows, S], 0 on background.
//   none: id and depth only (compute_face_index_map).
// Every form renders the image rows row_start .. row_start + num_rows - 1
// into outputs of num_rows rows.
//
// Replaces, in neural_renderer_v2_pytorch_tpu/ops/resolve_pallas.py:
//   tiled: _windowed_kernel (:348, driven by _run_windowed, :584): K2 its
//     XY-latch form, K2L its latch_z form with attribute planes,
//     resolve_depth its latch=False form (compute_face_index_map_pallas).
//   binned: _binned_kernel (:858, driven by _run_binned, :1073), in the same
//     three forms.  The TPU kernel read host-binned constants chunk by chunk
//     from SMEM and latched into VMEM-resident planes.
//
// Semantics (neural_renderer_v2_pytorch_tpu/ops/resolve.py:157-179 and the
// sequential fold at :259-269): for each pixel, faces are taken in
// ascending id order and face f is accepted when it covers the pixel and
// zp <= depth - 1e-4f against the running depth.
//
// Bound: the per-pixel face tests (~30 flops and one divide each, for each
// face whose bbox holds the pixel's centre) and the output planes, written
// once; the face inputs once (36 bytes a face).  A pixel outside a staged
// face's bbox skips its test (a warp of pixels all outside skips the face at
// once), which the rejection it would compute makes exact.
//
// Tiled design: one CTA of 256 threads per 16x16 tile and batch image, one
// thread per pixel, depth and id (and the XY latch) in registers for the
// whole stream.  Each thread holds one face's nine coordinates (36 bytes,
// the next batch's loaded while a batch resolves), tests its bbox against
// the tile, and for a face that touches forms its x/y constants, det and
// the kill rule; the batch is compacted, order-preserving (warp ballot +
// prefix over warps), to the faces that are live and touch, which form 1/z
// and write all 17 constants to shared memory.  A batch none of whose faces
// touches skips staging and the loop.  Every tile reads every face from
// L2, 36 bytes a face and tile.  (Sharing that stream across a cluster of
// CTAs, each batch multicast by bulk copies into a ring of shared memory,
// measured 1.9-2.4x slower on an H100 at every cluster size tried:
// tools/resolve_designs.cu, PERF.md.)
//
// Binned design: a CTA of 64 threads per 8x8 bin, one pixel a thread; the
// bin's entries are staged 64 at a time, each thread one entry: a gather of
// its nine coordinates (36 bytes, against the 68 of K1's constants), the
// constants formed in registers.  The chain of dependent round trips
// (count/offset -> ids -> vertices) is kept in flight: while a batch
// resolves, the next batch's coordinates and the batch after's ids load.
// (One warp per bin, two pixels a lane, persistent warps walking the bins
// with the next bin's chain in flight, measured slower on an H100:
// tools/resolve_designs.cu.)
//
// Overflow bins: a loop of their own over the ids 0 .. nf - 1, the same
// batches.  A face absent from the exact bin misses the tile's pixel
// centres by K7's strict test, or was killed (bbox 4,-4,4,-4), so every
// pixel of the tile rejects it at its bbox test, and the pixels accept the
// same faces in the same order: the exact bin's bits.  A batch none of
// whose faces' bboxes meets the tile skips its staging and its loop (the
// first test of the tiled forms), and a bin in which K7 counted no face
// skips them all, so an overflow bin costs a pass over the face
// coordinates, not a test of every face at every pixel.
//
// The copy form latches only the id during the stream, so its registers
// and shared memory do not depend on A.  The TPU kernels instead latched
// every plane during the stream, with all planes resident in VMEM; that is
// what made their resident budget (and the probe, resolve_pallas.py:1318)
// depend on A.
//
// Exactness: per-pixel expressions are face_candidate's in the same order;
// --fmad=false keeps products and sums separately rounded, and division is
// correctly rounded (no fast-math), so the index map and depth are
// bit-identical to the plain versions and the tiled and binned forms to
// each other (the staged constants are K1's bits), and the latched planes,
// being copies, are too.  The near/far test is written !(near < zp && zp <
// far) so that a NaN zp rejects.

#include <cuda_runtime.h>

#include "face_constants.cuh"
#include "nr_entry.cuh"

namespace {

constexpr int kTile = 16;                      // the tiled forms' tile edge in pixels
constexpr int kTileThreads = kTile * kTile;    // a CTA's pixels, and faces a batch
constexpr int kBinEdge = 8;                    // K8's (resolve_cuda.BIN_TILE)
constexpr int kConsts = nr_face::kConsts;
constexpr int kCoordsXY = 6;

enum Latch { kNone, kXY, kCopy };

__device__ __forceinline__ float pixel_centre(int i, float s) {
  return (2.0f * static_cast<float>(i) + 1.0f - s) / s;
}

struct Args {
  const float* fvp;      // [bs, 3, 3, nf]
  const float* attrs;    // [bs, nf, A]
  const int* bin_cnt;    // [bs, tiles] (binned only)
  const int* bin_off;    // [bs, tiles]
  const int* bin_ids;    // [pairs]
  int* index_out;
  float* depth_out;
  float* coords_out;
  float* attrs_out;
  int bs, nf, num_attrs, size, row_start, num_rows;
  int tiles_x, tiles;    // the binned route's 8x8 tiles per row, per image
  int draw_backside;
  float z_near, z_far;
};

// One pixel's running z-buffer: depth, winner, and the XY latch.
struct Pixel {
  float depth;
  int id;
  float l[kCoordsXY];
};

__device__ __forceinline__ Pixel empty_pixel(float z_far) {
  Pixel p;
  p.depth = z_far;
  p.id = -1;
#pragma unroll
  for (int j = 0; j < kCoordsXY; ++j) p.l[j] = 0.f;
  return p;
}

// The per-pixel test of one staged face: its constant j at c[j * kStride],
// its latch row j at x[j * kStride], its id at *id.
template <int kLatch, int kStride>
__device__ __forceinline__ void test_face(const float* c, const float* x, const int* id, float xp,
                                          float yp, float z_near, float z_far, Pixel& p) {
  const float xmin = c[13 * kStride], xmax = c[14 * kStride];
  const float ymin = c[15 * kStride], ymax = c[16 * kStride];
  // outside the face's bbox the full test rejects the face: skip it
  if ((xp < xmin) | (xmax < xp) | (yp < ymin) | (ymax < yp)) return;
  const float A0 = c[0], B0 = c[kStride], C0 = c[2 * kStride];
  const float A1 = c[3 * kStride], B1 = c[4 * kStride], C1 = c[5 * kStride];
  const float A2 = c[6 * kStride], B2 = c[7 * kStride], C2 = c[8 * kStride];
  const float iz0 = c[9 * kStride], iz1 = c[10 * kStride], iz2 = c[11 * kStride];
  const float det = c[12 * kStride];

  bool out = false;
  const float w0 = yp * A0 + xp * B0 + C0;
  const float w1 = yp * A1 + xp * B1 + C1;
  const float w2 = yp * A2 + xp * B2 + C2;
  out |= (w2 * w0 < 0.0f);
  out |= (w0 * w1 < 0.0f);
  const float zp = det / (w0 * iz0 + w1 * iz1 + w2 * iz2);
  out |= !((z_near < zp) & (zp < z_far));
  if (!out && zp <= p.depth - 1e-4f) {
    p.depth = zp;
    p.id = *id;
    if constexpr (kLatch == kXY) {
#pragma unroll
      for (int j = 0; j < kCoordsXY; ++j) p.l[j] = x[j * kStride];
    }
  }
}

// The outputs of output pixel (row, col) of image b, if it lies in the window.
template <int kLatch>
__device__ __forceinline__ void write_pixel(const Args& a, size_t b, int row, int col,
                                            const Pixel& p) {
  if (row >= a.num_rows || col >= a.size) return;
  const int nf = a.nf, id = p.id;
  const size_t plane = (size_t)a.num_rows * a.size;
  const size_t pix = (size_t)row * a.size + col;
  a.index_out[b * plane + pix] = id;
  a.depth_out[b * plane + pix] = p.depth;
  if constexpr (kLatch == kXY) {
    // latch rows x0,y0,x1,y1,x2,y2
    float* co = a.coords_out + b * kCoordsXY * plane + pix;
#pragma unroll
    for (int j = 0; j < kCoordsXY; ++j) co[j * plane] = p.l[j];
  } else if constexpr (kLatch == kCopy) {
    // plane 3 * vertex + coord <- fvp[b, coord, vertex, id]
    const float* vb = a.fvp + b * 9 * (size_t)nf;
    float* co = a.coords_out + b * 9 * plane + pix;
#pragma unroll
    for (int v = 0; v < 3; ++v) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        co[(3 * v + c) * plane] = id >= 0 ? vb[(size_t)(3 * c + v) * nf + id] : 0.0f;
      }
    }
    float* ao = a.attrs_out + b * a.num_attrs * plane + pix;
    const float* ab = a.attrs + (b * nf + (id >= 0 ? id : 0)) * (size_t)a.num_attrs;
    for (int j = 0; j < a.num_attrs; ++j) ao[j * plane] = id >= 0 ? ab[j] : 0.0f;
  }
}

// ---- the tiled forms: a CTA per 16x16 tile ------------------------------

// face f's nine coordinates fvp[b, coord, vertex, f] (vb: image b's), in
// the order x0,x1,x2, y0,y1,y2, z0,z1,z2.  Unconditional loads: selecting
// zeros per coordinate (as K8's entries do) made the tiled forms' loads a
// batch ahead predicated, 2-10% slower on an H100.
__device__ __forceinline__ void load_face(const float* __restrict__ vb, int nf, int f, float* v) {
#pragma unroll
  for (int j = 0; j < 9; ++j) v[j] = vb[(size_t)j * nf + f];
}

template <int kLatch>
__global__ void __launch_bounds__(kTileThreads) tiled_kernel(const Args a) {
  constexpr int kWarps = kTileThreads / 32;
  __shared__ float s_c[kConsts][kTileThreads];
  __shared__ float s_x[kLatch == kXY ? kCoordsXY : 1][kTileThreads];
  __shared__ int s_id[kTileThreads];
  __shared__ int s_count[2][kWarps];   // by batch parity (an empty batch skips a barrier)

  const size_t b = blockIdx.z;
  const int nf = a.nf;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int col0 = blockIdx.x * kTile;
  const int row0 = blockIdx.y * kTile;  // output row, image row row_start + r
  const int col = col0 + t % kTile;
  const int row = row0 + t / kTile;
  const float s = static_cast<float>(a.size);
  const float xp = pixel_centre(col, s);
  const float yp = pixel_centre(a.row_start + row, s);
  // pixel-centre range of the tile's valid pixels (ragged edge masked)
  const float x_lo = pixel_centre(col0, s);
  const float x_hi = pixel_centre(min(col0 + kTile, a.size) - 1, s);
  const float y_lo = pixel_centre(a.row_start + row0, s);
  const float y_hi = pixel_centre(a.row_start + min(row0 + kTile, a.num_rows) - 1, s);
  const float* vb = a.fvp + b * 9 * (size_t)nf;

  // this thread's face of the next batch, loaded while a batch resolves, so
  // a batch costs no L2 round trip of its own
  float next[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (t < nf) load_face(vb, nf, t, next);
  Pixel p = empty_pixel(a.z_far);
  for (int base = 0; base < nf; base += kTileThreads) {
    const int e = base + t;   // this thread's face
    float v[9];
#pragma unroll
    for (int j = 0; j < 9; ++j) v[j] = next[j];
    if (e + kTileThreads < nf) load_face(vb, nf, e + kTileThreads, next);

    bool touches = false;
    float c[kConsts];
    if (e < nf) {
      // a first bbox test on fminf / fmaxf, which give min_nan's and
      // max_nan's values unless a coordinate is NaN; such a face's det is
      // NaN, so the kill rule drops it either way
      touches = !(fmaxf(fmaxf(v[0], v[1]), v[2]) < x_lo || x_hi < fminf(fminf(v[0], v[1]), v[2]) ||
                  fmaxf(fmaxf(v[3], v[4]), v[5]) < y_lo || y_hi < fminf(fminf(v[3], v[4]), v[5]));
      if (touches) {
        nr_face::constants_xy(v[0], v[3], v[1], v[4], v[2], v[5], c);
        nr_face::kill_invalid(c, a.draw_backside);
        // c[13..16] = xmin, xmax, ymin, ymax (4,-4,4,-4 when killed, which
        // touches no tile)
        touches = !(c[14] < x_lo || x_hi < c[13] || c[16] < y_lo || y_hi < c[15]);
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, touches);
    const int parity = (base / kTileThreads) & 1;
    if (lane == 0) s_count[parity][warp] = __popc(ballot);
    __syncthreads();
    int offset = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int n = s_count[parity][w];
      offset += (w < warp) ? n : 0;
      total += n;
    }
    // no face of the batch touches the tile: nothing to stage or test (the
    // counts are double-buffered, so the next batch's cannot overwrite
    // these before every thread has read them)
    if (total == 0) continue;
    if (touches) {
      const int slot = offset + __popc(ballot & ((1u << lane) - 1u));
      nr_face::constants_z(v[6], v[7], v[8], c);
#pragma unroll
      for (int j = 0; j < kConsts; ++j) s_c[j][slot] = c[j];
      if constexpr (kLatch == kXY) {
        s_x[0][slot] = v[0];
        s_x[1][slot] = v[3];
        s_x[2][slot] = v[1];
        s_x[3][slot] = v[4];
        s_x[4][slot] = v[2];
        s_x[5][slot] = v[5];
      }
      s_id[slot] = e;
    }
    __syncthreads();
    for (int k = 0; k < total; ++k) {
      test_face<kLatch, kTileThreads>(&s_c[0][k], &s_x[0][k], &s_id[k], xp, yp, a.z_near,
                                      a.z_far, p);
    }
    __syncthreads();  // the next batch overwrites the staged faces
  }
  write_pixel<kLatch>(a, b, row, col, p);
}

// ---- K8: a CTA per bin ---------------------------------------------------

// bin entry f's nine coordinates (zeros for f < 0, no entry)
__device__ __forceinline__ void load_entry(const float* __restrict__ vb, int nf, int f, float* v) {
#pragma unroll
  for (int j = 0; j < 9; ++j) v[j] = f >= 0 ? vb[(size_t)j * nf + f] : 0.0f;
}

// Whether a face's bbox (fminf / fmaxf over its coordinates v: min_nan's and
// max_nan's values unless a coordinate is NaN, and such a face's det is NaN,
// so the kill rule drops it anyway) meets the pixel-centre range tile = x_lo,
// x_hi, y_lo, y_hi.
__device__ __forceinline__ bool meets_tile(const float* v, const float* tile) {
  return !(fmaxf(fmaxf(v[0], v[1]), v[2]) < tile[0] || tile[1] < fminf(fminf(v[0], v[1]), v[2]) ||
           fmaxf(fmaxf(v[3], v[4]), v[5]) < tile[2] || tile[3] < fminf(fminf(v[3], v[4]), v[5]));
}

constexpr int kBinThreads = kBinEdge * kBinEdge;

// One batch of K8: each thread stages its face f (coordinates v; none for
// f < 0) into shared memory, then every pixel tests the batch's first
// `count` faces in order.
template <int kLatch>
__device__ __forceinline__ void binned_batch(const Args& a, int f, const float* v, int count,
                                             float (&s_c)[kConsts][kBinThreads],
                                             float (&s_x)[kLatch == kXY ? kCoordsXY : 1]
                                                         [kBinThreads],
                                             int (&s_id)[kBinThreads], float xp, float yp,
                                             Pixel& p) {
  const int t = threadIdx.x;
  if (f >= 0) {
    float c[kConsts];
    nr_face::constants_xy(v[0], v[3], v[1], v[4], v[2], v[5], c);
    nr_face::kill_invalid(c, a.draw_backside);
    nr_face::constants_z(v[6], v[7], v[8], c);
#pragma unroll
    for (int j = 0; j < kConsts; ++j) s_c[j][t] = c[j];
    if constexpr (kLatch == kXY) {
      s_x[0][t] = v[0];
      s_x[1][t] = v[3];
      s_x[2][t] = v[1];
      s_x[3][t] = v[4];
      s_x[4][t] = v[2];
      s_x[5][t] = v[5];
    }
    s_id[t] = f;
  }
  __syncthreads();
  for (int k = 0; k < count; ++k) {
    test_face<kLatch, kBinThreads>(&s_c[0][k], &s_x[0][k], &s_id[k], xp, yp, a.z_near, a.z_far,
                                   p);
  }
  __syncthreads();  // the next batch overwrites the staged faces
}

// K8: a CTA of 64 threads per 8x8 bin, one pixel a thread; the bin's
// entries staged 64 at a time, the next batch's coordinates and the batch
// after's ids loading while a batch resolves.  An overflow bin (offset -1)
// takes the faces 0 .. nf - 1 in a loop of its own.
template <int kLatch>
__global__ void __launch_bounds__(kBinThreads) binned_kernel(const Args a) {
  constexpr int kN = kBinThreads;
  __shared__ float s_c[kConsts][kN];
  __shared__ float s_x[kLatch == kXY ? kCoordsXY : 1][kN];
  __shared__ int s_id[kN];
  __shared__ float s_tile[4];   // an overflow bin's pixel-centre range
  const int t = threadIdx.x, nf = a.nf;
  const int g = blockIdx.x;
  const int b = g / a.tiles, tile = g - b * a.tiles;
  const int col = (tile % a.tiles_x) * kBinEdge + (t & 7);
  const int row = (tile / a.tiles_x) * kBinEdge + (t >> 3);
  const float s = static_cast<float>(a.size);
  const float xp = pixel_centre(col, s);
  const float yp = pixel_centre(a.row_start + row, s);
  const float* vb = a.fvp + (size_t)b * 9 * nf;
  // the count and the offset load together, whatever the offset says (both
  // branches read the count): a count loaded only once the offset was known
  // put one more round trip on the chain count/offset -> ids -> vertices,
  // which at hires (65,536 bins, most of one batch) cost 11-13% on an H100
  const int n = a.bin_cnt[g], offset = a.bin_off[g];
  Pixel p = empty_pixel(a.z_far);
  if (offset >= 0) {
    const int* ids = a.bin_ids + offset;
    int f = t < n ? ids[t] : -1;
    int f1 = kN + t < n ? ids[kN + t] : -1;
    float v[9];
    load_entry(vb, nf, f, v);
    for (int base = 0; base < n; base += kN) {
      float v1[9];
      load_entry(vb, nf, f1, v1);
      const int f2 = base + 2 * kN + t < n ? ids[base + 2 * kN + t] : -1;
      binned_batch<kLatch>(a, f, v, min(kN, n - base), s_c, s_x, s_id, xp, yp, p);
      f = f1;
      f1 = f2;
#pragma unroll
      for (int j = 0; j < 9; ++j) v[j] = v1[j];
    }
  } else if (n > 0) {
    // (an overflow bin in which K7 counted no face holds background only)
    // the pixel-centre range of the tile's valid pixels (thread 0's pixel is
    // its first); a batch none of whose faces' bboxes meets it is skipped
    if (t == 0) {
      s_tile[0] = xp;
      s_tile[1] = pixel_centre(min(col + kBinEdge, a.size) - 1, s);
      s_tile[2] = yp;
      s_tile[3] = pixel_centre(a.row_start + min(row + kBinEdge, a.num_rows) - 1, s);
    }
    __syncthreads();
    int f = t < nf ? t : -1;
    float v[9];
    load_entry(vb, nf, f, v);
    for (int base = 0; base < nf; base += kN) {
      const int f1 = base + kN + t < nf ? base + kN + t : -1;
      float v1[9];
      load_entry(vb, nf, f1, v1);
      if (__syncthreads_or(f >= 0 && meets_tile(v, s_tile))) {
        binned_batch<kLatch>(a, f, v, min(kN, nf - base), s_c, s_x, s_id, xp, yp, p);
      }
      f = f1;
#pragma unroll
      for (int j = 0; j < 9; ++j) v[j] = v1[j];
    }
  }
  write_pixel<kLatch>(a, b, row, col, p);
}

// ---- launches -------------------------------------------------------------

template <int kLatch>
int launch_tiled(const Args& a, void* stream) {
  if (a.bs == 0 || a.size == 0 || a.num_rows == 0) return 0;
  const dim3 grid((a.size + kTile - 1) / kTile, (a.num_rows + kTile - 1) / kTile, a.bs);
  tiled_kernel<kLatch><<<grid, kTileThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int kLatch>
int launch_binned(Args a, void* stream) {
  if (a.bs == 0 || a.size == 0 || a.num_rows == 0) return 0;
  a.tiles_x = (a.size + kBinEdge - 1) / kBinEdge;
  a.tiles = a.tiles_x * ((a.num_rows + kBinEdge - 1) / kBinEdge);
  binned_kernel<kLatch><<<a.bs * a.tiles, kBinThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const float* fvp, const float* attrs, const int* bin_cnt, const int* bin_off,
               const int* bin_ids, int* index_out, float* depth_out, float* coords_out,
               float* attrs_out, int bs, int nf, int num_attrs, int size, int row_start,
               int num_rows, int draw_backside, float z_near, float z_far) {
  return Args{fvp,        attrs,     bin_cnt,   bin_off,   bin_ids,   index_out,
              depth_out,  coords_out, attrs_out, bs,        nf,        num_attrs,
              size,       row_start, num_rows,  0,         0,         draw_backside,
              z_near,     z_far};
}

// Shapes for every entry: fvp f32 [bs, 3, 3, nf]; attrs f32 [bs, nf, A]
// (may be null when A = 0); bins from K7: cnt and off i32 [bs, tiles] over
// the 8x8 tiles of the row window, ids i32 [pairs]; index_out i32 and
// depth_out f32 [bs, num_rows, S]; coords_out f32 [bs, 6 (XY) or 9 (copy),
// num_rows, S]; attrs_out f32 [bs, A, num_rows, S].  Every form applies
// the kill rule with draw_backside itself.  Each returns
// cudaGetLastError().

int resolve_xy(void* stream, const float* fvp, int* index_out, float* depth_out,
               float* coords_out, int bs, int nf, int size, int row_start, int num_rows,
               int draw_backside, float z_near, float z_far) {
  return launch_tiled<kXY>(
      make_args(fvp, nullptr, nullptr, nullptr, nullptr, index_out, depth_out, coords_out,
                nullptr, bs, nf, 0, size, row_start, num_rows, draw_backside, z_near, z_far),
      stream);
}

int resolve_latch(void* stream, const float* fvp, const float* attrs, int* index_out,
                  float* depth_out, float* coords_out, float* attrs_out, int bs, int nf,
                  int num_attrs, int size, int row_start, int num_rows, int draw_backside,
                  float z_near, float z_far) {
  return launch_tiled<kCopy>(
      make_args(fvp, attrs, nullptr, nullptr, nullptr, index_out, depth_out, coords_out,
                attrs_out, bs, nf, num_attrs, size, row_start, num_rows, draw_backside, z_near,
                z_far),
      stream);
}

int resolve_depth(void* stream, const float* fvp, int* index_out, float* depth_out, int bs,
                  int nf, int size, int row_start, int num_rows, int draw_backside,
                  float z_near, float z_far) {
  return launch_tiled<kNone>(
      make_args(fvp, nullptr, nullptr, nullptr, nullptr, index_out, depth_out, nullptr, nullptr,
                bs, nf, 0, size, row_start, num_rows, draw_backside, z_near, z_far),
      stream);
}

int resolve_binned_xy(void* stream, const float* fvp, const int* cnt, const int* off,
                      const int* ids, int* index_out, float* depth_out, float* coords_out, int bs,
                      int nf, int size, int row_start, int num_rows, int draw_backside,
                      float z_near, float z_far) {
  return launch_binned<kXY>(
      make_args(fvp, nullptr, cnt, off, ids, index_out, depth_out, coords_out, nullptr, bs, nf, 0,
                size, row_start, num_rows, draw_backside, z_near, z_far),
      stream);
}

int resolve_binned_latch(void* stream, const float* fvp, const float* attrs, const int* cnt,
                         const int* off, const int* ids, int* index_out, float* depth_out,
                         float* coords_out, float* attrs_out, int bs, int nf, int num_attrs,
                         int size, int row_start, int num_rows, int draw_backside, float z_near,
                         float z_far) {
  return launch_binned<kCopy>(
      make_args(fvp, attrs, cnt, off, ids, index_out, depth_out, coords_out, attrs_out, bs, nf,
                num_attrs, size, row_start, num_rows, draw_backside, z_near, z_far),
      stream);
}

int resolve_binned_depth(void* stream, const float* fvp, const int* cnt, const int* off,
                         const int* ids, int* index_out, float* depth_out, int bs, int nf,
                         int size, int row_start, int num_rows, int draw_backside, float z_near,
                         float z_far) {
  return launch_binned<kNone>(
      make_args(fvp, nullptr, cnt, off, ids, index_out, depth_out, nullptr, nullptr, bs, nf, 0,
                size, row_start, num_rows, draw_backside, z_near, z_far),
      stream);
}

}  // namespace

NR_PACKED_ENTRY(resolve_xy)
NR_PACKED_ENTRY(resolve_latch)
NR_PACKED_ENTRY(resolve_depth)
NR_PACKED_ENTRY(resolve_binned_xy)
NR_PACKED_ENTRY(resolve_binned_latch)
NR_PACKED_ENTRY(resolve_binned_depth)

// What one block of a copy-form kernel (binned 0: K2L's; 1: K8's) needs
// and what the compiled kernel allows: threads per block, the most threads
// per block its register use permits, and its static shared memory in
// bytes.  Returns the cudaFuncGetAttributes error.
extern "C" int nr_resolve_latch_limits(int binned, int* threads, int* max_threads,
                                       int* shared_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = binned ? cudaFuncGetAttributes(&attr, binned_kernel<kCopy>)
                                 : cudaFuncGetAttributes(&attr, tiled_kernel<kCopy>);
  if (err != cudaSuccess) return static_cast<int>(err);
  *threads = binned ? kBinEdge * kBinEdge : kTileThreads;
  *max_threads = attr.maxThreadsPerBlock;
  *shared_bytes = static_cast<int>(attr.sharedSizeBytes);
  return 0;
}
