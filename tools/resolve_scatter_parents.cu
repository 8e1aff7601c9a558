// The parent designs of K3 and of the tiled resolve forms, kept beside the
// shipped kernels for turns (chip_smoke.py phase 19, built by
// chip_smoke.tool_library).  Each computes its shipped counterpart's
// function; the shipped kernels are neural_renderer_v2_pytorch_tpu_torch/
// csrc/scatter_pixels_to_faces.cu and resolve.cu.
//
//   parent K3: one thread per (pixel, image) over every pixel; a covered
//     pixel sends its D gradients straight to global memory, one atomicAdd
//     each.  The caller zeroes the output.
//   parent K2, K2L, K2D: the tiled forms as they read K1's constants
//     [bs, 17, nf]: every CTA loads all 17 constants of every face (68
//     bytes per face and tile) before its bbox test.  Paired with the
//     shipped K1 (face_setup), whose output these forms read, they are the
//     parent's K1 + tiled-form pair.
//
// Plain C entries with typed arguments (ctypes argtypes in the loader), the
// stream last.

#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256)
parent_scatter_kernel(const float* __restrict__ g, const int* __restrict__ fim,
                      float* __restrict__ out, int D, int P, int nf) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const size_t b = blockIdx.y;
  const int f = fim[b * P + p];
  if (f < 0 || f >= nf) return;
  const float* gb = g + b * D * (size_t)P + p;
  float* ob = out + b * D * (size_t)nf + f;
  for (int d = 0; d < D; ++d) atomicAdd(ob + (size_t)d * nf, gb[(size_t)d * P]);
}

constexpr int kTile = 16;              // the tiled forms' tile edge in pixels
constexpr int kConsts = 17;
constexpr int kCoordsXY = 6;

enum Latch { kNone, kXY, kCopy };

__device__ __forceinline__ float pixel_centre(int i, float s) {
  return (2.0f * static_cast<float>(i) + 1.0f - s) / s;
}

struct Args {
  const float* consts;   // [bs, 17, nf] from K1
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
  float z_near, z_far;
};

// kEdge: the tile edge in pixels, one thread per pixel (at most 16: a 32x32
// block's staged constants would pass the 48 KB of static shared memory).
template <int kLatch, bool kBinned, int kEdge>
__global__ void __launch_bounds__(kEdge * kEdge) parent_resolve_kernel(const Args a) {
  constexpr int kThreads = kEdge * kEdge;
  constexpr int kBatch = kThreads;       // faces staged per pass, one per thread
  constexpr int kWarps = kThreads / 32;
  __shared__ float s_c[kConsts][kBatch];
  __shared__ float s_x[kLatch == kXY ? kCoordsXY : 1][kBatch];
  __shared__ int s_id[kBatch];
  __shared__ int s_count[kWarps];

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

  const float* cb = a.consts + b * kConsts * (size_t)nf;
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

  for (int base = 0; base < n_src; base += kBatch) {
    const int e = base + static_cast<int>(threadIdx.x);  // this thread's entry
    int f = -1, slot = threadIdx.x, total;
    float c[kConsts];
    if constexpr (kBinned) {
      // every bin entry touches the tile
      total = min(kBatch, n_src - base);
      if (e < n_src) {
        f = ids[e];
#pragma unroll
        for (int j = 0; j < kConsts; ++j) c[j] = cb[(size_t)j * nf + f];
      }
    } else {
      bool touches = false;
      if (e < nf) {
#pragma unroll
        for (int j = 0; j < kConsts; ++j) c[j] = cb[(size_t)j * nf + e];
        // c[13..16] = xmin, xmax, ymin, ymax
        touches = !(c[14] < x_lo || x_hi < c[13] || c[16] < y_lo || y_hi < c[15]);
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, touches);
      if (lane == 0) s_count[warp] = __popc(ballot);
      __syncthreads();
      int offset = 0;
      total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int n = s_count[w];
        offset += (w < warp) ? n : 0;
        total += n;
      }
      if (touches) {
        f = e;
        slot = offset + __popc(ballot & ((1u << lane) - 1u));
      }
    }
    if (f >= 0) {
#pragma unroll
      for (int j = 0; j < kConsts; ++j) s_c[j][slot] = c[j];
      if constexpr (kLatch == kXY) {
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

template <int kLatch>
int parent_launch(const Args& a, int bs, void* stream) {
  if (bs == 0 || a.size == 0 || a.num_rows == 0) return 0;
  const dim3 grid((a.size + kTile - 1) / kTile, (a.num_rows + kTile - 1) / kTile, bs);
  parent_resolve_kernel<kLatch, false, kTile>
      <<<grid, kTile * kTile, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g: f32 [bs, D, P]; fim: i32 [bs, P]; out: f32 [bs, D, nf], zeroed.
extern "C" int nr_parent_scatter_pixels_to_faces(const float* g, const int* fim, float* out,
                                                 int bs, int D, int P, int nf, void* stream) {
  if (bs == 0 || P == 0 || D == 0) return 0;
  const dim3 grid((P + 255) / 256, bs);
  parent_scatter_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(g, fim, out, D,
                                                                             P, nf);
  return static_cast<int>(cudaGetLastError());
}

// consts f32 [bs, 17, nf] from K1; the rest as the shipped entries'.
extern "C" int nr_parent_resolve_xy(const float* consts, const float* fvp, int* index_out,
                                    float* depth_out, float* coords_out, int bs, int nf,
                                    int size, int row_start, int num_rows, float z_near,
                                    float z_far, void* stream) {
  const Args a{consts, fvp, nullptr, nullptr, nullptr, nullptr, index_out, depth_out,
               coords_out, nullptr, nf, 0, size, row_start, num_rows, z_near, z_far};
  return parent_launch<kXY>(a, bs, stream);
}

extern "C" int nr_parent_resolve_latch(const float* consts, const float* fvp, const float* attrs,
                                       int* index_out, float* depth_out, float* coords_out,
                                       float* attrs_out, int bs, int nf, int num_attrs, int size,
                                       int row_start, int num_rows, float z_near, float z_far,
                                       void* stream) {
  const Args a{consts, fvp, attrs, nullptr, nullptr, nullptr, index_out, depth_out,
               coords_out, attrs_out, nf, num_attrs, size, row_start, num_rows, z_near, z_far};
  return parent_launch<kCopy>(a, bs, stream);
}

extern "C" int nr_parent_resolve_depth(const float* consts, int* index_out, float* depth_out,
                                       int bs, int nf, int size, int row_start, int num_rows,
                                       float z_near, float z_far, void* stream) {
  const Args a{consts, nullptr, nullptr, nullptr, nullptr, nullptr, index_out, depth_out,
               nullptr, nullptr, nf, 0, size, row_start, num_rows, z_near, z_far};
  return parent_launch<kNone>(a, bs, stream);
}
