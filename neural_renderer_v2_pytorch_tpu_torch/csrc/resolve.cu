// The z-buffer resolve, in its two forms:
//
// K2 resolve_xy: the winner's XY coordinates latched, for the silhouette
//   path.  Outputs: the winning id (-1 on background), its depth (far on
//   background) and its six screen coordinates x0,y0,x1,y1,x2,y2 (0 on
//   background).
// K2L resolve_latch: the winner's nine coordinates (x,y,z of each vertex)
//   and A per-face attribute planes, for the RGB and depth paths.  Outputs:
//   id and depth as K2, coordinates [bs, 9, S, S] (plane 3 * vertex +
//   coord) and attributes [bs, A, S, S], 0 on background.
//
// Replaces: _windowed_kernel in
//   neural_renderer_v2_pytorch_tpu/ops/resolve_pallas.py:348 (driven by
//   _run_windowed, :584, from resolve_gather_pallas, :1391): K2 its
//   XY-latch form without attribute planes, K2L its latch_z form with
//   attribute planes.
//
// Semantics (neural_renderer_v2_pytorch_tpu/ops/resolve.py:157-179 and the
// sequential fold at :259-269): for each pixel, faces are taken in
// ascending id order and face f is accepted when it covers the pixel and
// zp <= depth - 1e-4f against the running depth.
//
// Bound: compute and shared-memory throughput.  Each pixel evaluates ~30 flops
// and one divide per face whose bbox touches its tile; the face stream
// itself is 92 (K2) or 72 (K2L) bytes per face per tile, read from L2.
// Design: one CTA per 16x16 pixel tile and batch image, one thread per
// pixel, with depth and id (and K2's six latched coordinates) in registers
// for the whole stream.  Faces stream through shared memory 256 at a time,
// in id order.  While staging a batch each thread tests one face's bbox
// against the tile and the batch is compacted, order-preserving (warp
// ballot + prefix over warps), to the faces that can touch the tile; so
// the per-pixel loop skips a face for the whole CTA at once, and killed
// faces (bbox 4,-4,4,-4 from K1) never reach it.  The skip is exact: the
// tile's pixel centres are computed by the same expression as each
// pixel's, and the per-pixel bbox test is strict.
//
// K2L latches only the id during the stream, so its registers and shared
// memory do not depend on A.  In the epilogue each pixel copies row `id`
// of the face coordinates ([bs, 3, 3, nf]) and of the attributes
// ([bs, nf, A]) from L2 into the planar outputs.  The TPU kernel instead
// latched every plane during the stream, with all planes resident in VMEM;
// that is what made its resident budget (and the probe, resolve_pallas.py:
// 1318) depend on A.
//
// Exactness: per-pixel expressions are face_candidate's in the same order;
// --fmad=false keeps products and sums separately rounded, and division is
// correctly rounded (no fast-math), so the index map and depth are
// bit-identical to the plain version, and the latched planes, being
// copies, are too.  The near/far test is written !(near < zp && zp < far)
// so that a NaN zp rejects.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;              // tile edge in pixels
constexpr int kThreads = kTile * kTile;
constexpr int kBatch = kThreads;       // faces staged per pass, one per thread
constexpr int kWarps = kThreads / 32;
constexpr int kConsts = 17;
constexpr int kCoordsXY = 6;

__device__ __forceinline__ float pixel_centre(int i, float s) {
  return (2.0f * static_cast<float>(i) + 1.0f - s) / s;
}

// kLatchXY: K2 (latch XY in registers); otherwise K2L (latch the id, copy
// coordinates and attributes in the epilogue).
template <bool kLatchXY>
__global__ void __launch_bounds__(kThreads)
resolve_kernel(const float* __restrict__ consts, const float* __restrict__ fvp,
               const float* __restrict__ attrs, int* __restrict__ index_out,
               float* __restrict__ depth_out, float* __restrict__ coords_out,
               float* __restrict__ attrs_out, int nf, int num_attrs, int size,
               float z_near, float z_far) {
  __shared__ float s_c[kConsts][kBatch];
  __shared__ float s_x[kLatchXY ? kCoordsXY : 1][kBatch];
  __shared__ int s_id[kBatch];
  __shared__ int s_count[kWarps];

  const size_t b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col0 = blockIdx.x * kTile;
  const int row0 = blockIdx.y * kTile;
  const int col = col0 + static_cast<int>(threadIdx.x % kTile);
  const int row = row0 + static_cast<int>(threadIdx.x / kTile);
  const float s = static_cast<float>(size);
  const float xp = pixel_centre(col, s);
  const float yp = pixel_centre(row, s);
  // pixel-centre range of the tile's valid pixels (ragged edge masked)
  const float x_lo = pixel_centre(col0, s);
  const float x_hi = pixel_centre(min(col0 + kTile, size) - 1, s);
  const float y_lo = pixel_centre(row0, s);
  const float y_hi = pixel_centre(min(row0 + kTile, size) - 1, s);

  const float* cb = consts + b * kConsts * (size_t)nf;
  const float* vb = fvp + b * 9 * (size_t)nf;

  float depth = z_far;
  int id = -1;
  float lx0 = 0.f, ly0 = 0.f, lx1 = 0.f, ly1 = 0.f, lx2 = 0.f, ly2 = 0.f;

  for (int base = 0; base < nf; base += kBatch) {
    const int f = base + static_cast<int>(threadIdx.x);
    float c[kConsts];
    bool touches = false;
    if (f < nf) {
#pragma unroll
      for (int j = 0; j < kConsts; ++j) c[j] = cb[(size_t)j * nf + f];
      // c[13..16] = xmin, xmax, ymin, ymax
      touches = !(c[14] < x_lo || x_hi < c[13] || c[16] < y_lo || y_hi < c[15]);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, touches);
    if (lane == 0) s_count[warp] = __popc(ballot);
    __syncthreads();
    int offset = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int n = s_count[w];
      offset += (w < warp) ? n : 0;
      total += n;
    }
    if (touches) {
      const int slot = offset + __popc(ballot & ((1u << lane) - 1u));
#pragma unroll
      for (int j = 0; j < kConsts; ++j) s_c[j][slot] = c[j];
      if constexpr (kLatchXY) {
        // latch rows x0,y0,x1,y1,x2,y2 from fvp[b, coord, vertex, f]
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          s_x[2 * v][slot] = vb[(size_t)v * nf + f];
          s_x[2 * v + 1][slot] = vb[(size_t)(3 + v) * nf + f];
        }
      }
      s_id[slot] = f;
    }
    __syncthreads();

    for (int k = 0; k < total; ++k) {
      const float A0 = s_c[0][k], B0 = s_c[1][k], C0 = s_c[2][k];
      const float A1 = s_c[3][k], B1 = s_c[4][k], C1 = s_c[5][k];
      const float A2 = s_c[6][k], B2 = s_c[7][k], C2 = s_c[8][k];
      const float iz0 = s_c[9][k], iz1 = s_c[10][k], iz2 = s_c[11][k];
      const float det = s_c[12][k];
      const float xmin = s_c[13][k], xmax = s_c[14][k];
      const float ymin = s_c[15][k], ymax = s_c[16][k];

      bool out = (xp < xmin) | (xmax < xp) | (yp < ymin) | (ymax < yp);
      const float w0 = yp * A0 + xp * B0 + C0;
      const float w1 = yp * A1 + xp * B1 + C1;
      const float w2 = yp * A2 + xp * B2 + C2;
      out |= (w2 * w0 < 0.0f);
      out |= (w0 * w1 < 0.0f);
      const float zp = det / (w0 * iz0 + w1 * iz1 + w2 * iz2);
      out |= !((z_near < zp) & (zp < z_far));
      if (!out && zp <= depth - 1e-4f) {
        depth = zp;
        id = s_id[k];
        if constexpr (kLatchXY) {
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

  if (row < size && col < size) {
    const size_t plane = (size_t)size * size;
    const size_t pix = (size_t)row * size + col;
    index_out[b * plane + pix] = id;
    depth_out[b * plane + pix] = depth;
    if constexpr (kLatchXY) {
      float* co = coords_out + b * kCoordsXY * plane + pix;
      co[0 * plane] = lx0;
      co[1 * plane] = ly0;
      co[2 * plane] = lx1;
      co[3 * plane] = ly1;
      co[4 * plane] = lx2;
      co[5 * plane] = ly2;
    } else {
      // plane 3 * vertex + coord <- fvp[b, coord, vertex, id]
      float* co = coords_out + b * 9 * plane + pix;
#pragma unroll
      for (int v = 0; v < 3; ++v) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          co[(3 * v + c) * plane] =
              id >= 0 ? vb[(size_t)(3 * c + v) * nf + id] : 0.0f;
        }
      }
      float* ao = attrs_out + b * num_attrs * plane + pix;
      const float* ab =
          attrs + (b * nf + (id >= 0 ? id : 0)) * (size_t)num_attrs;
      for (int a = 0; a < num_attrs; ++a) {
        ao[a * plane] = id >= 0 ? ab[a] : 0.0f;
      }
    }
  }
}

dim3 tile_grid(int bs, int size) {
  return dim3((size + kTile - 1) / kTile, (size + kTile - 1) / kTile, bs);
}

}  // namespace

// consts: f32 [bs, 17, nf] from K1; fvp: f32 [bs, 3, 3, nf];
// index_out: i32 [bs, S, S]; depth_out: f32 [bs, S, S];
// coords_out: f32 [bs, 6, S, S].  Returns cudaGetLastError().
extern "C" int nr_resolve_xy(const float* consts, const float* fvp,
                             int* index_out, float* depth_out,
                             float* coords_out, int bs, int nf, int size,
                             float z_near, float z_far, void* stream) {
  if (bs == 0 || size == 0) return 0;
  resolve_kernel<true><<<tile_grid(bs, size), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      consts, fvp, nullptr, index_out, depth_out, coords_out, nullptr, nf, 0,
      size, z_near, z_far);
  return static_cast<int>(cudaGetLastError());
}

// consts: f32 [bs, 17, nf] from K1; fvp: f32 [bs, 3, 3, nf];
// attrs: f32 [bs, nf, A] (may be null when A = 0);
// index_out: i32 [bs, S, S]; depth_out: f32 [bs, S, S];
// coords_out: f32 [bs, 9, S, S]; attrs_out: f32 [bs, A, S, S].
// Returns cudaGetLastError().
extern "C" int nr_resolve_latch(const float* consts, const float* fvp,
                                const float* attrs, int* index_out,
                                float* depth_out, float* coords_out,
                                float* attrs_out, int bs, int nf,
                                int num_attrs, int size, float z_near,
                                float z_far, void* stream) {
  if (bs == 0 || size == 0) return 0;
  resolve_kernel<false><<<tile_grid(bs, size), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      consts, fvp, attrs, index_out, depth_out, coords_out, attrs_out, nf,
      num_attrs, size, z_near, z_far);
  return static_cast<int>(cudaGetLastError());
}

// What one K2L block needs and what the compiled kernel allows: threads per
// block, the most threads per block its register use permits, and its
// static shared memory in bytes.  Returns the cudaFuncGetAttributes error.
extern "C" int nr_resolve_latch_limits(int* threads, int* max_threads,
                                       int* shared_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, resolve_kernel<false>);
  *threads = kThreads;
  *max_threads = attr.maxThreadsPerBlock;
  *shared_bytes = static_cast<int>(attr.sharedSizeBytes);
  return static_cast<int>(err);
}
