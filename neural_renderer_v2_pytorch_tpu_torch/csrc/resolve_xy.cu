// K2 resolve_xy: the z-buffer resolve with the winner's XY coordinates
// latched, for the silhouette path.
//
// Replaces: _windowed_kernel in
//   neural_renderer_v2_pytorch_tpu/ops/resolve_pallas.py:348 (driven by
//   _run_windowed, :584, from resolve_gather_pallas, :1391), in its XY-latch
//   form without attribute planes.
//
// Semantics (neural_renderer_v2_pytorch_tpu/ops/resolve.py:157-179 and the
// sequential fold at :259-269): for each pixel, faces are taken in
// ascending id order and face f is accepted when it covers the pixel and
// zp <= depth - 1e-4f against the running depth.  Outputs: the winning id
// (-1 on background), its depth (far on background), and its six screen
// coordinates x0,y0,x1,y1,x2,y2 (0 on background).
//
// Bound: compute and shared-memory issue.  Each pixel evaluates ~30 flops
// and one divide per face whose bbox touches its tile; the face stream
// itself is 92 bytes per face per tile, read from L2.  Design: one CTA per
// 16x16 pixel tile and batch image, one thread per pixel, with depth, id
// and the six latched coordinates in registers for the whole stream.
// Faces stream through shared memory 256 at a time, in id order.  While
// staging a batch each thread tests one face's bbox against the tile and
// the batch is compacted, order-preserving (warp ballot + prefix over
// warps), to the faces that can touch the tile; so the per-pixel loop
// skips a face for the whole CTA at once, and killed faces (bbox
// 4,-4,4,-4 from K1) never reach it.  The skip is exact: the tile's pixel
// centres are computed by the same expression as each pixel's, and the
// per-pixel bbox test is strict.
//
// Exactness: per-pixel expressions are face_candidate's in the same order;
// --fmad=false keeps products and sums separately rounded, and division is
// correctly rounded (no fast-math), so the index map, depth and latched
// coordinates are bit-identical to the plain version.  The near/far test is
// written !(near < zp && zp < far) so that a NaN zp rejects.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;              // tile edge in pixels
constexpr int kThreads = kTile * kTile;
constexpr int kBatch = kThreads;       // faces staged per pass, one per thread
constexpr int kWarps = kThreads / 32;
constexpr int kConsts = 17;
constexpr int kCoords = 6;

__device__ __forceinline__ float pixel_centre(int i, float s) {
  return (2.0f * static_cast<float>(i) + 1.0f - s) / s;
}

__global__ void __launch_bounds__(kThreads)
resolve_xy_kernel(const float* __restrict__ consts,
                  const float* __restrict__ fvp, int* __restrict__ index_out,
                  float* __restrict__ depth_out,
                  float* __restrict__ coords_out, int nf, int size,
                  float z_near, float z_far) {
  __shared__ float s_c[kConsts][kBatch];
  __shared__ float s_x[kCoords][kBatch];
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
      // latch rows x0,y0,x1,y1,x2,y2 from fvp[b, coord, vertex, f]
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        s_x[2 * v][slot] = vb[(size_t)v * nf + f];
        s_x[2 * v + 1][slot] = vb[(size_t)(3 + v) * nf + f];
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
        lx0 = s_x[0][k];
        ly0 = s_x[1][k];
        lx1 = s_x[2][k];
        ly1 = s_x[3][k];
        lx2 = s_x[4][k];
        ly2 = s_x[5][k];
      }
    }
    __syncthreads();  // the next batch overwrites the staged faces
  }

  if (row < size && col < size) {
    const size_t plane = (size_t)size * size;
    const size_t p = b * plane + (size_t)row * size + col;
    index_out[p] = id;
    depth_out[p] = depth;
    float* co = coords_out + b * kCoords * plane + (size_t)row * size + col;
    co[0 * plane] = lx0;
    co[1 * plane] = ly0;
    co[2 * plane] = lx1;
    co[3 * plane] = ly1;
    co[4 * plane] = lx2;
    co[5 * plane] = ly2;
  }
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
  const dim3 grid((size + kTile - 1) / kTile, (size + kTile - 1) / kTile, bs);
  resolve_xy_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      consts, fvp, index_out, depth_out, coords_out, nf, size, z_near, z_far);
  return static_cast<int>(cudaGetLastError());
}
