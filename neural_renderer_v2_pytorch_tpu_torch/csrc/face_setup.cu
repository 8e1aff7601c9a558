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
// The binned route launches it (K7's count pass and K8 read its output);
// the tiled forms (K2, K2L, K2D) compute the same constants themselves
// while staging faces, so the tiled route launches no K1.
//
// Exactness: the expressions (face_constants.cuh, shared with the tiled
// resolve) are those of the plain version in the same order.  Built with
// --fmad=false (no multiply-add contraction) and correctly rounded
// division, so the result is bit-identical to it.

#include <cuda_runtime.h>

#include "face_constants.cuh"
#include "nr_entry.cuh"

namespace {

__global__ void __launch_bounds__(256)
face_setup_kernel(const float* __restrict__ fvp, float* __restrict__ consts,
                  int nf, int draw_backside) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= nf) return;
  const size_t b = blockIdx.y;
  // fvp[b, coord, vertex, f] at ((coord * 3 + vertex) * nf + f)
  const float* v = fvp + b * 9 * (size_t)nf + f;
  float c[nr_face::kConsts];
  nr_face::constants_xy(v[0 * nf], v[3 * nf], v[1 * nf], v[4 * nf], v[2 * nf], v[5 * nf], c);
  nr_face::constants_z(v[6 * nf], v[7 * nf], v[8 * nf], c);
  nr_face::kill_invalid(c, draw_backside);
  float* o = consts + b * nr_face::kConsts * (size_t)nf + f;
#pragma unroll
  for (int j = 0; j < nr_face::kConsts; ++j) o[j * nf] = c[j];
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
