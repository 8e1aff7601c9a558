// The NMR passes of the pipeline, each per-pixel chain in one kernel:
//
//   K10 nmr_planes            the clamped barycentric weights of the resolve's
//                             winner (recomputed from its screen XY), the
//                             coordinate map [bs, 2, rows, W], the foreground
//                             [bs, 1, rows, W] and, where the render reads
//                             them, the weight planes [bs, 3, rows, W]
//   K11 nmr_planes_vjp        the coordinate map's VJP onto the winner planes
//                             [bs, 9, rows, W], the weights recomputed in
//                             registers
//   K12 nmr_coordinate_grad   the NMR backward's coordinate gradient
//                             [bs, 2, rows, W] from the images and their
//                             gradient [bs, C, rows, W] (and a band's halo
//                             rows), its x and y terms in one launch
//
// Replaces: no kernel of neural_renderer_v2_pytorch_tpu/ops/resolve_pallas.py.
// The JAX package leaves these chains to XLA, which fuses each into a loop
// over the pixels; in PyTorch they were some 50 (forward), 40 (VJP) and 55
// (NMR gradient) elementwise kernels over whole planes, with zero-filled
// nine-plane gradients for each of the coordinate map's six plane reads.
//
// The plain versions (ops/resolve.py weight_planes_from_gathered and
// coordinate_planes, resolve_cuda.nmr_planes_vjp_plain, ops/differentiation.py
// band_coordinate_grad_plain) are the arithmetic these kernels repeat: every
// product, sum and quotient in their order and association (no contraction:
// cuda_build's --fmad=false), the pixel centres read from the same tensors,
// torch.clamp's and torch.maximum's NaN rules, and the channel sum in the
// order of torch.sum's CUDA reduction over a non-innermost dimension (one
// thread per output, element k into accumulator k % 4, the four summed
// left to right), so on the card each kernel gives its plain version's
// bits.
//
// Bound: memory.  Per pixel, K10 reads the six XY planes and the index map
// and writes the coordinate map and the foreground (40 bytes; 52 with the
// weights), K11 reads the gradient, the XY planes and the index map and
// writes nine planes (72 bytes), K12 reads C image and C gradient planes and
// writes two (8C + 8 bytes).  Each is one thread per pixel, a warp over 32
// consecutive pixels of one row, so every plane is read and written in
// coalesced lines.  K12's thread walks a strip of rows down a column, a
// warp 32 columns: each pair of neighbouring pixels is formed about once,
// its channel sums and two quotients (a multiply by the reciprocal where
// the step is a power of two, which gives the quotient's bits), and the
// row below is the line the next step reads, from L1.

#include <cuda_runtime.h>

#include <cmath>

#include "nr_entry.cuh"

namespace {

constexpr int kThreads = 256;
// K12's block: 32 columns (a warp) by 8 strips of kGradStrip rows
constexpr int kGradCols = 32, kGradStrips = 8, kGradStrip = 8;
constexpr int kMaxGridYZ = 65535;
// differentiation.maximum's tie band, compared in float32 as torch compares
// a float32 tensor with a Python scalar
constexpr float kTieEps = 1e-4f;

// torch.clamp(v, min=0) and torch.clamp(v, 0, 1) on CUDA: NaN passes
__device__ __forceinline__ float clamp_min0(float v) { return isnan(v) ? v : fmaxf(v, 0.0f); }

__device__ __forceinline__ float clamp01(float v) {
  return isnan(v) ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}

// resolve._clamped_weights of the winner's (x0, y0, x1, y1, x2, y2) at the
// pixel centre (xp, yp): flip the sign when the weights sum below 0, clamp
// each to >= 0, divide by their new sum, clamp to [0, 1]
__device__ __forceinline__ void clamped_weights(const float xy[6], float xp, float yp,
                                                float w[3]) {
  const float x0 = xy[0], y0 = xy[1], x1 = xy[2], y1 = xy[3], x2 = xy[4], y2 = xy[5];
  float a0 = yp * (x2 - x1) + xp * (y1 - y2) + (x1 * y2 - x2 * y1);
  float a1 = yp * (x0 - x2) + xp * (y2 - y0) + (x2 * y0 - x0 * y2);
  float a2 = yp * (x1 - x0) + xp * (y0 - y1) + (x0 * y1 - x1 * y0);
  if ((a0 + a1) + a2 < 0.0f) {
    a0 = -a0;
    a1 = -a1;
    a2 = -a2;
  }
  a0 = clamp_min0(a0);
  a1 = clamp_min0(a1);
  a2 = clamp_min0(a2);
  const float total = (a0 + a1) + a2;
  w[0] = clamp01(a0 / total);
  w[1] = clamp01(a1 / total);
  w[2] = clamp01(a2 / total);
}

// The winner's XY (planes 0, 1, 3, 4, 6, 7 of nine, `plane` elements apart)
// and its weights at pixel p of row r; the weights are 0 on background.
__device__ __forceinline__ void winner_weights(const float* __restrict__ fvm, size_t plane,
                                               int fg, float xp, float yp, float xy[6],
                                               float w[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    xy[2 * k] = fvm[(3 * k) * plane];
    xy[2 * k + 1] = fvm[(3 * k + 1) * plane];
  }
  if (fg) {
    clamped_weights(xy, xp, yp, w);
  } else {
    w[0] = w[1] = w[2] = 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
nmr_planes_kernel(const float* __restrict__ fvm, const int* __restrict__ index,
                  const float* __restrict__ xps, const float* __restrict__ yps,
                  float* __restrict__ coords, float* __restrict__ weights,
                  float* __restrict__ foreground, int bs, int rows, int W,
                  long long fvm_batch) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const int n = rows * W;
  if (p >= n) return;
  const float xp = xps[p % W], yp = yps[p / W];
  const size_t plane = n;
  for (int b = blockIdx.y; b < bs; b += gridDim.y) {
    const int fg = index[(size_t)b * n + p] >= 0;
    float xy[6], w[3];
    winner_weights(fvm + b * fvm_batch + p, plane, fg, xp, yp, xy, w);
    float* c = coords + (size_t)b * 2 * n + p;
    c[0] = (xy[0] * w[0] + xy[2] * w[1]) + xy[4] * w[2];
    c[plane] = (xy[1] * w[0] + xy[3] * w[1]) + xy[5] * w[2];
    foreground[(size_t)b * n + p] = fg ? 1.0f : 0.0f;
    if (weights != nullptr) {
      float* out = weights + (size_t)b * 3 * n + p;
      out[0] = w[0];
      out[plane] = w[1];
      out[2 * plane] = w[2];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
nmr_planes_vjp_kernel(const float* __restrict__ grad, const float* __restrict__ fvm,
                      const int* __restrict__ index, const float* __restrict__ xps,
                      const float* __restrict__ yps, float* __restrict__ out, int bs, int rows,
                      int W, long long fvm_batch) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const int n = rows * W;
  if (p >= n) return;
  const float xp = xps[p % W], yp = yps[p / W];
  const size_t plane = n;
  for (int b = blockIdx.y; b < bs; b += gridDim.y) {
    const int fg = index[(size_t)b * n + p] >= 0;
    float xy[6], w[3];
    winner_weights(fvm + b * fvm_batch + p, plane, fg, xp, yp, xy, w);
    const float* g = grad + (size_t)b * 2 * n + p;
    const float gx = g[0], gy = g[plane];
    float* o = out + (size_t)b * 9 * n + p;
    // each XY plane's product as the mul's backward forms it, then + 0:
    // autograd summed it with the other plane reads' zero-filled gradients
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      o[(3 * k) * plane] = gx * w[k] + 0.0f;
      o[(3 * k + 1) * plane] = gy * w[k] + 0.0f;
      o[(3 * k + 2) * plane] = 0.0f;
    }
  }
}

// One image row of the NMR gradient's inputs: its images and gradient at
// channel 0 and the distance between channels (elements).
struct Row {
  const float* images;
  const float* grad;
  size_t channel;
};

// Channel c's products of the pair (a at column ja, b at column jb) added
// into the accumulators r and l.
__device__ __forceinline__ void add_channel(Row a, Row b, int ja, int jb, int c, float& r,
                                            float& l) {
  const float ia = a.images[c * a.channel + ja], ib = b.images[c * b.channel + jb];
  const float ga = a.grad[c * a.channel + ja], gb = b.grad[c * b.channel + jb];
  r = r + (ia - ib) * gb;
  l = l + (ib - ia) * ga;
}

// x / step, or x times its reciprocal where the step is a power of two
// (kPow2): then the product is the quotient, bit for bit
template <bool kPow2>
__device__ __forceinline__ float over_step(float x, float step, float inv_step) {
  return kPow2 ? x * inv_step : x / step;
}

// The pair terms of neighbours a then b (two rows at one column, or two
// columns of one row) at columns ja and jb: r = -sum_c (I_a - I_b) G_b /
// step, l = -sum_c (I_b - I_a) G_a / step, each channel sum as torch.sum
// adds it on the card: channel c into accumulator c % 4, from 0, then the
// four accumulators left to right.  kOne: C is 1 (a silhouette), known at
// compile time, so no channel loop or channel offsets.
template <bool kPow2, bool kOne>
__device__ __forceinline__ void pair_terms(Row a, Row b, int ja, int jb, int C, float step,
                                           float inv_step, float& r, float& l) {
  float r0 = 0.0f, r1 = 0.0f, r2 = 0.0f, r3 = 0.0f;
  float l0 = 0.0f, l1 = 0.0f, l2 = 0.0f, l3 = 0.0f;
  if (kOne) {
    add_channel(a, b, ja, jb, 0, r0, l0);
  } else {
    for (int c = 0; c < C; c += 4) {
      add_channel(a, b, ja, jb, c, r0, l0);
      if (c + 1 < C) add_channel(a, b, ja, jb, c + 1, r1, l1);
      if (c + 2 < C) add_channel(a, b, ja, jb, c + 2, r2, l2);
      if (c + 3 < C) add_channel(a, b, ja, jb, c + 3, r3, l3);
    }
  }
  r = over_step<kPow2>(-(((r0 + r1) + r2) + r3), step, inv_step);
  l = over_step<kPow2>(-(((l0 + l1) + l2) + l3), step, inv_step);
}

// differentiation.maximum: 0 where max(r, l) <= 0 (false when either is
// NaN, as torch.maximum gives NaN) or |r - l| < eps, else -r if r > l,
// else l
__device__ __forceinline__ float nmr_maximum(float r, float l) {
  const bool zero = (r <= 0.0f && l <= 0.0f) || fabsf(r - l) < kTieEps;
  return zero ? 0.0f : (r > l ? -r : l);
}

// Each pair of neighbours is formed once: a thread walks a strip of
// kGradStrip rows down one column and forms the pair of its pixel and the
// one to its right, and of its pixel and the one below, which is the next
// row's pair with the pixel above; the pair with the pixel to its left
// comes from the lane before it (a warp is 32 columns of one row).  The
// strip's first row and the block's first column form those pairs
// themselves.  No shared memory, no barrier.
template <bool kPow2, bool kOne>
__global__ void __launch_bounds__(kGradCols * kGradStrips)
nmr_coordinate_grad_kernel(const float* __restrict__ images, const float* __restrict__ grad,
                           const float* above_images, const float* above_grad,
                           const float* below_images, const float* below_grad,
                           float* __restrict__ out, int bs, int C, int rows, int W,
                           long long above_batch, long long above_channel,
                           long long below_batch, long long below_channel, float step) {
  const int tx = threadIdx.x;
  const int j = blockIdx.x * kGradCols + tx;
  const int first = (blockIdx.y * kGradStrips + threadIdx.y) * kGradStrip;
  // lanes past the last column stay for the shuffle
  const bool inside = j < W;
  const int n = rows * W;
  const float inv_step = 1.0f / step;
  for (int b = blockIdx.z; b < bs; b += gridDim.z) {
    const size_t base = (size_t)b * C * n;
    // y: the pair of the strip's first row and the one above it (the
    // padded entry `first`); past the image edge (no halo row) the zero pad
    float ry0 = 0.0f, ly0 = 0.0f;
    if (inside && first < rows) {
      const Row row = {images + base + (size_t)first * W, grad + base + (size_t)first * W,
                       (size_t)n};
      if (first > 0) {
        pair_terms<kPow2, kOne>({row.images - W, row.grad - W, row.channel}, row, j, j, C, step,
                          inv_step, ry0, ly0);
      } else if (above_images != nullptr) {
        const Row up = {above_images + b * above_batch, above_grad + b * above_batch,
                        (size_t)above_channel};
        pair_terms<kPow2, kOne>(up, row, j, j, C, step, inv_step, ry0, ly0);
      }
    }
    const int last = first + kGradStrip < rows ? first + kGradStrip : rows;
    for (int i = first; i < last; ++i) {
      const Row row = {images + base + (size_t)i * W, grad + base + (size_t)i * W, (size_t)n};
      // x: this column and the one to its right (gxr[j], gxl[j]), past the
      // last column the zero pad; this column and the one to its left
      float rx1 = 0.0f, lx1 = 0.0f;
      if (inside && j + 1 < W) {
        pair_terms<kPow2, kOne>(row, row, j, j + 1, C, step, inv_step, rx1, lx1);
      }
      float rx0 = __shfl_up_sync(0xffffffffu, rx1, 1);
      float lx0 = __shfl_up_sync(0xffffffffu, lx1, 1);
      if (tx == 0) {
        rx0 = lx0 = 0.0f;
        if (inside && j > 0) {
          pair_terms<kPow2, kOne>(row, row, j - 1, j, C, step, inv_step, rx0, lx0);
        }
      }
      // y: this row and the one below (the padded entry i + 1)
      float ry1 = 0.0f, ly1 = 0.0f;
      if (inside) {
        if (i + 1 < rows) {
          pair_terms<kPow2, kOne>(row, {row.images + W, row.grad + W, row.channel}, j, j, C, step,
                            inv_step, ry1, ly1);
        } else if (below_images != nullptr) {
          const Row down = {below_images + b * below_batch, below_grad + b * below_batch,
                            (size_t)below_channel};
          pair_terms<kPow2, kOne>(row, down, j, j, C, step, inv_step, ry1, ly1);
        }
        float* o = out + (size_t)b * 2 * n + (size_t)i * W + j;
        o[0] = nmr_maximum(rx1 + rx0, lx0 + lx1);
        o[n] = nmr_maximum(ry1 + ry0, ly0 + ly1);
      }
      ry0 = ry1;
      ly0 = ly1;
    }
  }
}

dim3 pixel_grid(int n, int bs) {
  return dim3((n + kThreads - 1) / kThreads, bs < kMaxGridYZ ? bs : kMaxGridYZ);
}

// fvm: f32, image b's nine planes [9, rows, W] contiguous from fvm + b *
// fvm_batch; index: i32 [bs, rows, W]; xp: f32 [W] and yp: f32 [rows], the
// pixel centres; coords: f32 [bs, 2, rows, W]; weights: f32 [bs, 3, rows, W]
// or null (not written); foreground: f32 [bs, rows, W].  Returns
// cudaGetLastError().
int nmr_planes(void* stream, const float* fvm, const int* index, const float* xp,
               const float* yp, float* coords, float* weights, float* foreground, int bs,
               int rows, int W, long long fvm_batch) {
  if (bs == 0 || rows == 0 || W == 0) return 0;
  nmr_planes_kernel<<<pixel_grid(rows * W, bs), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(fvm, index, xp, yp, coords, weights,
                                                          foreground, bs, rows, W, fvm_batch);
  return static_cast<int>(cudaGetLastError());
}

// grad: f32 [bs, 2, rows, W]; fvm, index, xp, yp as nmr_planes; out: f32
// [bs, 9, rows, W].  Returns cudaGetLastError().
int nmr_planes_vjp(void* stream, const float* grad, const float* fvm, const int* index,
                   const float* xp, const float* yp, float* out, int bs, int rows, int W,
                   long long fvm_batch) {
  if (bs == 0 || rows == 0 || W == 0) return 0;
  nmr_planes_vjp_kernel<<<pixel_grid(rows * W, bs), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(grad, fvm, index, xp, yp, out, bs,
                                                              rows, W, fvm_batch);
  return static_cast<int>(cudaGetLastError());
}

// images, grad: f32 [bs, C, rows, W]; the halo rows above and below: f32
// [bs, C, 1, W] (images and gradient with one layout: image b's channel c at
// + b * batch + c * channel, columns contiguous), or null at the image edge;
// out: f32 [bs, 2, rows, W], x on channel 0; step: 2 / the render size.
// Returns cudaGetLastError().
int nmr_coordinate_grad(void* stream, const float* images, const float* grad,
                        const float* above_images, const float* above_grad,
                        const float* below_images, const float* below_grad, float* out, int bs,
                        int C, int rows, int W, long long above_batch, long long above_channel,
                        long long below_batch, long long below_channel, float step) {
  if (bs == 0 || rows == 0 || W == 0) return 0;
  const int block_rows = kGradStrips * kGradStrip;
  const dim3 grid((W + kGradCols - 1) / kGradCols, (rows + block_rows - 1) / block_rows,
                  bs < kMaxGridYZ ? bs : kMaxGridYZ);
  int exponent;
  const bool pow2 = std::frexp(step, &exponent) == 0.5f;
  const auto kernel = pow2 ? (C == 1 ? nmr_coordinate_grad_kernel<true, true>
                                     : nmr_coordinate_grad_kernel<true, false>)
                           : (C == 1 ? nmr_coordinate_grad_kernel<false, true>
                                     : nmr_coordinate_grad_kernel<false, false>);
  kernel<<<grid, dim3(kGradCols, kGradStrips), 0, static_cast<cudaStream_t>(stream)>>>(
      images, grad, above_images, above_grad, below_images, below_grad, out, bs, C, rows, W,
      above_batch, above_channel, below_batch, below_channel, step);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

NR_PACKED_ENTRY(nmr_planes)
NR_PACKED_ENTRY(nmr_planes_vjp)
NR_PACKED_ENTRY(nmr_coordinate_grad)
