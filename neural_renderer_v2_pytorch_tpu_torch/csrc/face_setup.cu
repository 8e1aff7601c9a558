// K1 face_setup: per-face rasterization constants for the z-buffer resolve.
//
// Replaces: _face_chunks_kernel in
//   neural_renderer_v2_pytorch_tpu/ops/resolve_pallas.py:180 (reached through
//   _face_chunks_pallas, :282).  The TPU kernel also wrote a per-group window
//   table, which scheduled the TPU's sequential grid; the Hopper resolve
//   bins faces per pixel tile itself, so that table is not computed here.
//
// Computes, for every (batch, face), the 17 constants of
//   face_constants_planar (neural_renderer_v2_pytorch_tpu/ops/resolve.py:98):
//   A0,B0,C0, A1,B1,C1, A2,B2,C2, 1/z0,1/z1,1/z2, det, xmin,xmax,ymin,ymax,
// and writes the killed bbox (4,-4,4,-4) over degenerate faces
// (|det| < 1e-8, or NaN) and, unless draw_backside, over backfacing ones.
//
// Bound: memory.  36 bytes in and 68 bytes out per face, ~10 flops; at 82K
// faces that is 8.5 MB, a few microseconds of HBM time, so the launch itself
// dominates.  Design: one thread per (batch, face); the planar layouts
// [bs, 3, 3, nf] in and [bs, 17, nf] out put neighbouring faces on
// neighbouring addresses, so every load and store is coalesced.
//
// Exactness: the expressions are those of the plain version in the same
// order.  Built with --fmad=false (no multiply-add contraction) and
// correctly rounded division, so the result is bit-identical to it.

#include <cuda_runtime.h>

#include "nr_entry.cuh"

namespace {

// torch.minimum / torch.maximum (and jnp's) propagate NaN; fminf does not.
__device__ __forceinline__ float min_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return (b < a) ? b : a;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return (a < b) ? b : a;
}

__global__ void __launch_bounds__(256)
face_setup_kernel(const float* __restrict__ fvp, float* __restrict__ consts,
                  int nf, int draw_backside) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= nf) return;
  const size_t b = blockIdx.y;
  // fvp[b, coord, vertex, f] at ((coord * 3 + vertex) * nf + f)
  const float* v = fvp + b * 9 * (size_t)nf + f;
  const float x0 = v[0 * nf], x1 = v[1 * nf], x2 = v[2 * nf];
  const float y0 = v[3 * nf], y1 = v[4 * nf], y2 = v[5 * nf];
  const float z0 = v[6 * nf], z1 = v[7 * nf], z2 = v[8 * nf];

  const float C0 = x1 * y2 - x2 * y1;
  const float C1 = x2 * y0 - x0 * y2;
  const float C2 = x0 * y1 - x1 * y0;
  const float A0 = x2 - x1, B0 = y1 - y2;
  const float A1 = x0 - x2, B1 = y2 - y0;
  const float A2 = x1 - x0, B2 = y0 - y1;
  const float det = C0 + C1 + C2;
  float xmin = min_nan(min_nan(x0, x1), x2);
  float xmax = max_nan(max_nan(x0, x1), x2);
  float ymin = min_nan(min_nan(y0, y1), y2);
  float ymax = max_nan(max_nan(y0, y1), y2);

  bool valid = fabsf(det) >= 1e-8f;
  if (!draw_backside) valid = valid && !(B1 * A2 < B2 * A1);
  if (!valid) {
    xmin = 4.0f;
    xmax = -4.0f;
    ymin = 4.0f;
    ymax = -4.0f;
  }

  float* o = consts + b * 17 * (size_t)nf + f;
  o[0 * nf] = A0;
  o[1 * nf] = B0;
  o[2 * nf] = C0;
  o[3 * nf] = A1;
  o[4 * nf] = B1;
  o[5 * nf] = C1;
  o[6 * nf] = A2;
  o[7 * nf] = B2;
  o[8 * nf] = C2;
  o[9 * nf] = 1.0f / z0;
  o[10 * nf] = 1.0f / z1;
  o[11 * nf] = 1.0f / z2;
  o[12 * nf] = det;
  o[13 * nf] = xmin;
  o[14 * nf] = xmax;
  o[15 * nf] = ymin;
  o[16 * nf] = ymax;
}

// fvp: f32 [bs, 3, 3, nf]; consts: f32 [bs, 17, nf].  Returns cudaGetLastError().
int face_setup(void* stream, const float* fvp, float* consts, int bs, int nf, int draw_backside) {
  if (bs == 0 || nf == 0) return 0;
  const dim3 grid((nf + 255) / 256, bs);
  face_setup_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      fvp, consts, nf, draw_backside);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

NR_PACKED_ENTRY(face_setup)
