// K3 scatter_pixels_to_faces: the backward of the resolve's winner latch,
//   out[b, d, fim[b, p]] += g[b, d, p]   for every pixel p with fim >= 0.
//
// Replaces: _scatter_kernel and _scatter_kernel_patch in
//   neural_renderer_v2_pytorch_tpu/ops/resolve_pallas.py:1512 and :1616
//   (reached through scatter_to_faces_pallas, :1874, and
//   _scatter_patch_blockspec, :1796).  The TPU has no fast scatter, so it
//   built the sum from predicated one-hot matmuls in two bf16 halves, and
//   the patch variant only reordered pixels for those matmuls; on Hopper one
//   kernel with float32 atomics serves both.
//
// Bound: memory and atomic throughput.  Each pixel reads D planes (4*D
// bytes) and issues at most D atomics, which land in L2; at 512^2 with
// D = 6 that is 6 MB read and at most 1.6M atomics.  Design: one thread per
// (pixel, batch image), reading each plane coalesced.  The output [bs, D, nf]
// is zeroed by the caller.  Atomics sum in a different order on every run,
// so results agree with any exact-order sum to float32 rounding (the JAX
// backward's own bound is 1e-4 relative).  Ids outside [0, nf) add nothing.

#include <cuda_runtime.h>

#include "nr_entry.cuh"

namespace {

__global__ void __launch_bounds__(256)
scatter_pixels_to_faces_kernel(const float* __restrict__ g,
                               const int* __restrict__ fim,
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

// g: f32 [bs, D, P]; fim: i32 [bs, P]; out: f32 [bs, D, nf], zeroed.
// Returns cudaGetLastError().
int scatter_pixels_to_faces(void* stream, const float* g, const int* fim, float* out, int bs,
                            int D, int P, int nf) {
  if (bs == 0 || P == 0 || D == 0) return 0;
  const dim3 grid((P + 255) / 256, bs);
  scatter_pixels_to_faces_kernel<<<grid, 256, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      g, fim, out, D, P, nf);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

NR_PACKED_ENTRY(scatter_pixels_to_faces)
