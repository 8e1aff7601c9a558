// The z-buffer resolve: one template, two face sources, three latch forms.
//
// Face sources:
//   tiled (K2, K2L, resolve_depth): every CTA streams all nf faces from the
//     face vertices, computes their constants itself and keeps those that
//     are live and whose bbox touches its tile.  No K1 runs before it.
//   binned (K8: resolve_binned_xy, resolve_binned_latch,
//     resolve_binned_depth): every CTA streams only its tile's bin, the
//     ascending face ids that K7 (bin_faces.cu) found to touch the tile,
//     and gathers each one's constants from K1's output.
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
//     from SMEM and latched into VMEM-resident planes; K8 gathers each bin
//     entry's constants from L2 into shared memory.
//
// Semantics (neural_renderer_v2_pytorch_tpu/ops/resolve.py:157-179 and the
// sequential fold at :259-269): for each pixel, faces are taken in
// ascending id order and face f is accepted when it covers the pixel and
// zp <= depth - 1e-4f against the running depth.
//
// Bound: the per-pixel face tests (~30 flops and one divide each, for each
// face whose bbox holds the pixel's centre) and the output planes, written
// once.  A pixel outside a staged face's bbox skips its test (a warp of
// pixels all outside skips the face at once), which the rejection it would
// compute makes exact.  Design: one CTA per pixel tile and batch image, one thread per
// pixel, with depth and id (and the XY latch) in registers for the whole
// stream; faces stream through shared memory one per thread at a time, in
// id order, so the per-pixel loop skips a face for the whole CTA at once.
// The tiled forms use 16x16 tiles, K8 8x8 (kBinEdge, K7's kTile): a smaller
// tile tests fewer pixels against each small face and gives more CTAs; with
// K7's bins growing with tiles + pairs, K7 + K8 measured faster at 8x8 than
// at 16x16 at every binned configuration on an H100 (PERF.md).
//   tiled: each thread holds one face's nine coordinates (36 bytes,
//     loaded while the batch before is resolved), tests its bbox against
//     the tile, and for a face that touches forms its x/y constants, det
//     and the kill rule (face_constants.cuh, K1's own expressions); the
//     batch is compacted, order-preserving (warp ballot + prefix over
//     warps), to the faces that are live and touch the tile, which form
//     1/z and write all 17 constants to shared memory.  The face stream
//     is 36 bytes per face per tile from L2, O(tiles x nf), from K1's 68,
//     and the route launches no K1 and allocates no [bs, 17, nf].  (Reading
//     z only for the faces that touch, 24 bytes + 12, cost an L2 round trip
//     a batch after the ballot: slower than the parent's K2 on an H100,
//     PERF.md.)
//   binned: the bin already holds exactly those faces, in id order, so the
//     CTA reads each of them once (the 4-byte id and a gather of its 17
//     constants) and the stream is O(face-tile pairs).
// The skip is exact in both: the tile's pixel centres are computed by the
// same expression as each pixel's, the per-pixel bbox test is strict, and
// killed faces (bbox 4,-4,4,-4, the kill rule of face_constants.cuh, in K1
// or in the staging) touch no tile.
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
// bit-identical to the plain versions, the tiled and binned forms to each
// other (the tiled forms' staged constants are K1's bits), and the latched
// planes, being copies, are too.  The near/far test
// is written !(near < zp && zp < far) so that a NaN zp rejects.

#include <cuda_runtime.h>

#include "face_constants.cuh"
#include "nr_entry.cuh"

namespace {

constexpr int kTile = 16;              // the tiled forms' tile edge in pixels
constexpr int kBinEdge = 8;            // K8's (resolve_cuda.BIN_TILE)
constexpr int kConsts = nr_face::kConsts;
constexpr int kCoordsXY = 6;

enum Latch { kNone, kXY, kCopy };

__device__ __forceinline__ float pixel_centre(int i, float s) {
  return (2.0f * static_cast<float>(i) + 1.0f - s) / s;
}

// face e's nine coordinates fvp[b, coord, vertex, e] (vb: image b's), in
// the order x0,x1,x2, y0,y1,y2, z0,z1,z2
__device__ __forceinline__ void load_face(const float* __restrict__ vb, int nf, int e,
                                          float* v) {
#pragma unroll
  for (int j = 0; j < 9; ++j) v[j] = vb[(size_t)j * nf + e];
}

struct Args {
  const float* consts;   // [bs, 17, nf] from K1 (binned only)
  const float* fvp;      // [bs, 3, 3, nf]
  const float* attrs;    // [bs, nf, A]
  const int* bin_cnt;    // [bs, tiles] (binned only)
  const int* bin_off;    // [bs, tiles]
  const int* bin_ids;    // [pairs]
  int* index_out;
  float* depth_out;
  float* coords_out;
  float* attrs_out;
  int nf, num_attrs, size, row_start, num_rows;
  int draw_backside;     // the kill rule's (tiled only; K1 applied it for binned)
  float z_near, z_far;
};

// kEdge: the tile edge in pixels, one thread per pixel (at most 16: a 32x32
// block's staged constants would pass the 48 KB of static shared memory).
template <int kLatch, bool kBinned, int kEdge>
__global__ void __launch_bounds__(kEdge * kEdge) resolve_kernel(const Args a) {
  constexpr int kThreads = kEdge * kEdge;
  constexpr int kBatch = kThreads;       // faces staged per pass, one per thread
  constexpr int kWarps = kThreads / 32;
  __shared__ float s_c[kConsts][kBatch];
  __shared__ float s_x[kLatch == kXY ? kCoordsXY : 1][kBatch];
  __shared__ int s_id[kBatch];
  __shared__ int s_count[2][kWarps];   // by batch parity (an empty batch skips a barrier)

  const size_t b = blockIdx.z;
  const int nf = a.nf;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col0 = blockIdx.x * kEdge;
  const int row0 = blockIdx.y * kEdge;  // output row, image row row_start + r
  const int col = col0 + static_cast<int>(threadIdx.x % kEdge);
  const int row = row0 + static_cast<int>(threadIdx.x / kEdge);
  const float s = static_cast<float>(a.size);
  const float xp = pixel_centre(col, s);
  const float yp = pixel_centre(a.row_start + row, s);
  // pixel-centre range of the tile's valid pixels (ragged edge masked)
  const float x_lo = pixel_centre(col0, s);
  const float x_hi = pixel_centre(min(col0 + kEdge, a.size) - 1, s);
  const float y_lo = pixel_centre(a.row_start + row0, s);
  const float y_hi = pixel_centre(a.row_start + min(row0 + kEdge, a.num_rows) - 1, s);

  const float* cb = kBinned ? a.consts + b * kConsts * (size_t)nf : nullptr;
  const float* vb = a.fvp + b * 9 * (size_t)nf;

  int n_src = nf;
  const int* ids = nullptr;
  if constexpr (kBinned) {
    const size_t tile = b * gridDim.x * gridDim.y + blockIdx.y * gridDim.x + blockIdx.x;
    n_src = a.bin_cnt[tile];
    ids = a.bin_ids + a.bin_off[tile];
  }

  float depth = a.z_far;
  int id = -1;
  float lx0 = 0.f, ly0 = 0.f, lx1 = 0.f, ly1 = 0.f, lx2 = 0.f, ly2 = 0.f;
  // tiled: the face vertices of this thread's face in the next batch,
  // loaded while the current batch is tested and resolved, so a batch costs
  // no L2 round trip of its own
  float next[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if constexpr (!kBinned) {
    if (static_cast<int>(threadIdx.x) < nf) load_face(vb, nf, threadIdx.x, next);
  }

  for (int base = 0; base < n_src; base += kBatch) {
    const int e = base + static_cast<int>(threadIdx.x);  // this thread's entry
    int f = -1, slot = threadIdx.x, total;
    float c[kConsts];
    // the face's screen coordinates fvp[b, coord, vertex, f], for the XY
    // latch (the tiled forms read them anyway)
    float x0 = 0.f, y0 = 0.f, x1 = 0.f, y1 = 0.f, x2 = 0.f, y2 = 0.f;
    if constexpr (kBinned) {
      // every bin entry touches the tile
      total = min(kBatch, n_src - base);
      if (e < n_src) {
        f = ids[e];
#pragma unroll
        for (int j = 0; j < kConsts; ++j) c[j] = cb[(size_t)j * nf + f];
        if constexpr (kLatch == kXY) {
          x0 = vb[f];
          x1 = vb[(size_t)nf + f];
          x2 = vb[2 * (size_t)nf + f];
          y0 = vb[3 * (size_t)nf + f];
          y1 = vb[4 * (size_t)nf + f];
          y2 = vb[5 * (size_t)nf + f];
        }
      }
    } else {
      float v[9];
#pragma unroll
      for (int j = 0; j < 9; ++j) v[j] = next[j];
      if (e + kBatch < nf) load_face(vb, nf, e + kBatch, next);
      bool touches = false;
      if (e < nf) {
        x0 = v[0];
        x1 = v[1];
        x2 = v[2];
        y0 = v[3];
        y1 = v[4];
        y2 = v[5];
        // a first bbox test on fminf / fmaxf, which give min_nan's and
        // max_nan's values unless a coordinate is NaN; such a face's det is
        // NaN, so the kill rule drops it either way
        touches = !(fmaxf(fmaxf(x0, x1), x2) < x_lo || x_hi < fminf(fminf(x0, x1), x2) ||
                    fmaxf(fmaxf(y0, y1), y2) < y_lo || y_hi < fminf(fminf(y0, y1), y2));
        if (touches) {
          nr_face::constants_xy(x0, y0, x1, y1, x2, y2, c);
          nr_face::kill_invalid(c, a.draw_backside);
          // c[13..16] = xmin, xmax, ymin, ymax (4,-4,4,-4 when killed,
          // which touches no tile)
          touches = !(c[14] < x_lo || x_hi < c[13] || c[16] < y_lo || y_hi < c[15]);
        }
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, touches);
      const int parity = (base / kBatch) & 1;
      if (lane == 0) s_count[parity][warp] = __popc(ballot);
      __syncthreads();
      int offset = 0;
      total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int n = s_count[parity][w];
        offset += (w < warp) ? n : 0;
        total += n;
      }
      // no face of the batch touches the tile: nothing to stage or test
      // (the counts are double-buffered, so the next batch's cannot
      // overwrite these before every thread has read them)
      if (total == 0) continue;
      if (touches) {
        f = e;
        slot = offset + __popc(ballot & ((1u << lane) - 1u));
        nr_face::constants_z(v[6], v[7], v[8], c);
      }
    }
    if (f >= 0) {
#pragma unroll
      for (int j = 0; j < kConsts; ++j) s_c[j][slot] = c[j];
      if constexpr (kLatch == kXY) {
        // latch rows x0,y0,x1,y1,x2,y2
        s_x[0][slot] = x0;
        s_x[1][slot] = y0;
        s_x[2][slot] = x1;
        s_x[3][slot] = y1;
        s_x[4][slot] = x2;
        s_x[5][slot] = y2;
      }
      s_id[slot] = f;
    }
    __syncthreads();

    for (int k = 0; k < total; ++k) {
      const float xmin = s_c[13][k], xmax = s_c[14][k];
      const float ymin = s_c[15][k], ymax = s_c[16][k];
      // outside the face's bbox the full test rejects the face: skip it (a
      // warp whose 32 pixels are all outside skips the face at once)
      if ((xp < xmin) | (xmax < xp) | (yp < ymin) | (ymax < yp)) continue;
      const float A0 = s_c[0][k], B0 = s_c[1][k], C0 = s_c[2][k];
      const float A1 = s_c[3][k], B1 = s_c[4][k], C1 = s_c[5][k];
      const float A2 = s_c[6][k], B2 = s_c[7][k], C2 = s_c[8][k];
      const float iz0 = s_c[9][k], iz1 = s_c[10][k], iz2 = s_c[11][k];
      const float det = s_c[12][k];

      bool out = false;
      const float w0 = yp * A0 + xp * B0 + C0;
      const float w1 = yp * A1 + xp * B1 + C1;
      const float w2 = yp * A2 + xp * B2 + C2;
      out |= (w2 * w0 < 0.0f);
      out |= (w0 * w1 < 0.0f);
      const float zp = det / (w0 * iz0 + w1 * iz1 + w2 * iz2);
      out |= !((a.z_near < zp) & (zp < a.z_far));
      if (!out && zp <= depth - 1e-4f) {
        depth = zp;
        id = s_id[k];
        if constexpr (kLatch == kXY) {
          lx0 = s_x[0][k];
          ly0 = s_x[1][k];
          lx1 = s_x[2][k];
          ly1 = s_x[3][k];
          lx2 = s_x[4][k];
          ly2 = s_x[5][k];
        }
      }
    }
    __syncthreads();  // the next batch overwrites the staged faces
  }

  if (row < a.num_rows && col < a.size) {
    const size_t plane = (size_t)a.num_rows * a.size;
    const size_t pix = (size_t)row * a.size + col;
    a.index_out[b * plane + pix] = id;
    a.depth_out[b * plane + pix] = depth;
    if constexpr (kLatch == kXY) {
      float* co = a.coords_out + b * kCoordsXY * plane + pix;
      co[0 * plane] = lx0;
      co[1 * plane] = ly0;
      co[2 * plane] = lx1;
      co[3 * plane] = ly1;
      co[4 * plane] = lx2;
      co[5 * plane] = ly2;
    } else if constexpr (kLatch == kCopy) {
      // plane 3 * vertex + coord <- fvp[b, coord, vertex, id]
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
      for (int j = 0; j < a.num_attrs; ++j) {
        ao[j * plane] = id >= 0 ? ab[j] : 0.0f;
      }
    }
  }
}

template <int kLatch, bool kBinned, int kEdge = kTile>
int launch(const Args& a, int bs, void* stream) {
  if (bs == 0 || a.size == 0 || a.num_rows == 0) return 0;
  const dim3 grid((a.size + kEdge - 1) / kEdge, (a.num_rows + kEdge - 1) / kEdge, bs);
  resolve_kernel<kLatch, kBinned, kEdge>
      <<<grid, kEdge * kEdge, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const float* consts, const float* fvp, const float* attrs,
               const int* bin_cnt, const int* bin_off, const int* bin_ids,
               int* index_out, float* depth_out, float* coords_out,
               float* attrs_out, int nf, int num_attrs, int size,
               int row_start, int num_rows, float z_near, float z_far,
               int draw_backside = 0) {   // tiled forms only: K1 applied it for binned
  return Args{consts,    fvp,        attrs,     bin_cnt,    bin_off,
              bin_ids,   index_out,  depth_out, coords_out, attrs_out,
              nf,        num_attrs,  size,      row_start,  num_rows,
              draw_backside, z_near, z_far};
}

// Shapes for every entry: fvp f32 [bs, 3, 3, nf]; consts f32 [bs, 17, nf]
// from K1 (binned forms); attrs f32 [bs, nf, A] (may be null when A = 0);
// bins from K7: cnt and off i32 [bs, tiles] over the 8x8 tiles of the row
// window, ids i32 [pairs]; index_out i32 and depth_out f32
// [bs, num_rows, S]; coords_out f32 [bs, 6 (XY) or 9 (copy), num_rows, S];
// attrs_out f32 [bs, A, num_rows, S].  The tiled forms apply the kill rule
// with draw_backside themselves.  Each returns cudaGetLastError().

int resolve_xy(void* stream, const float* fvp, int* index_out, float* depth_out,
               float* coords_out, int bs, int nf, int size, int row_start, int num_rows,
               int draw_backside, float z_near, float z_far) {
  return launch<kXY, false>(
      make_args(nullptr, fvp, nullptr, nullptr, nullptr, nullptr, index_out, depth_out,
                coords_out, nullptr, nf, 0, size, row_start, num_rows, z_near, z_far,
                draw_backside),
      bs, stream);
}

int resolve_latch(void* stream, const float* fvp, const float* attrs, int* index_out,
                  float* depth_out, float* coords_out, float* attrs_out, int bs, int nf,
                  int num_attrs, int size, int row_start, int num_rows, int draw_backside,
                  float z_near, float z_far) {
  return launch<kCopy, false>(
      make_args(nullptr, fvp, attrs, nullptr, nullptr, nullptr, index_out, depth_out,
                coords_out, attrs_out, nf, num_attrs, size, row_start, num_rows, z_near,
                z_far, draw_backside),
      bs, stream);
}

int resolve_depth(void* stream, const float* fvp, int* index_out, float* depth_out, int bs,
                  int nf, int size, int row_start, int num_rows, int draw_backside,
                  float z_near, float z_far) {
  return launch<kNone, false>(
      make_args(nullptr, fvp, nullptr, nullptr, nullptr, nullptr, index_out, depth_out,
                nullptr, nullptr, nf, 0, size, row_start, num_rows, z_near, z_far,
                draw_backside),
      bs, stream);
}

int resolve_binned_xy(void* stream, const float* consts, const float* fvp, const int* cnt,
                      const int* off, const int* ids, int* index_out, float* depth_out,
                      float* coords_out, int bs, int nf, int size, int row_start, int num_rows,
                      float z_near, float z_far) {
  return launch<kXY, true, kBinEdge>(
      make_args(consts, fvp, nullptr, cnt, off, ids, index_out, depth_out, coords_out,
                nullptr, nf, 0, size, row_start, num_rows, z_near, z_far),
      bs, stream);
}

int resolve_binned_latch(void* stream, const float* consts, const float* fvp,
                         const float* attrs, const int* cnt, const int* off, const int* ids,
                         int* index_out, float* depth_out, float* coords_out, float* attrs_out,
                         int bs, int nf, int num_attrs, int size, int row_start, int num_rows,
                         float z_near, float z_far) {
  return launch<kCopy, true, kBinEdge>(
      make_args(consts, fvp, attrs, cnt, off, ids, index_out, depth_out, coords_out,
                attrs_out, nf, num_attrs, size, row_start, num_rows, z_near, z_far),
      bs, stream);
}

int resolve_binned_depth(void* stream, const float* consts, const int* cnt, const int* off,
                         const int* ids, int* index_out, float* depth_out, int bs, int nf,
                         int size, int row_start, int num_rows, float z_near, float z_far) {
  return launch<kNone, true, kBinEdge>(
      make_args(consts, nullptr, nullptr, cnt, off, ids, index_out, depth_out, nullptr,
                nullptr, nf, 0, size, row_start, num_rows, z_near, z_far),
      bs, stream);
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
  const cudaError_t err =
      binned ? cudaFuncGetAttributes(&attr, resolve_kernel<kCopy, true, kBinEdge>)
             : cudaFuncGetAttributes(&attr, resolve_kernel<kCopy, false, kTile>);
  if (err != cudaSuccess) return static_cast<int>(err);
  *threads = binned ? kBinEdge * kBinEdge : kTile * kTile;
  *max_threads = attr.maxThreadsPerBlock;
  *shared_bytes = static_cast<int>(attr.sharedSizeBytes);
  return static_cast<int>(err);
}
