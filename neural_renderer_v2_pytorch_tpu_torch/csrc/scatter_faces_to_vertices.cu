// K4 scatter_faces_to_vertices: the transpose of the face-vertex gather,
//   out[b, faces[f, k], c] += g[b, c, k, f],
// i.e. the shared-vertex gradient of the planar face vertices.
//
// Replaces: _scatter3_kernel in
//   neural_renderer_v2_pytorch_tpu/ops/resolve_pallas.py:2741 (reached
//   through scatter_slots3_pallas, :2808, from gather_resolve._gfv_bwd).
//   The TPU built it from one-hot matmuls over host-listed vertex chunks in
//   two bf16 halves; on Hopper the scatter is float32 atomics.
//
// Bound: memory and atomic throughput: 36 bytes of gradient and 12 bytes of
// ids per face, and 9 atomics per face that land in L2 (a vertex is shared
// by ~6 faces, so contention is low).  Design: one thread per (slot, batch
// image) with slot = k * nf + f, so neighbouring threads read neighbouring
// faces of one vertex plane of g (coalesced).  The output [bs, nv, 3] is
// zeroed by the caller.  Atomics sum in a different order on every run (the
// JAX backward's bound is 1e-4 relative).  Ids outside [0, nv) add nothing.

#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256)
scatter_faces_to_vertices_kernel(const float* __restrict__ g,
                                 const int* __restrict__ faces,
                                 float* __restrict__ out, int nf, int nv) {
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= 3 * nf) return;
  const size_t b = blockIdx.y;
  const int k = slot / nf;
  const int f = slot - k * nf;
  const int v = faces[(size_t)f * 3 + k];
  if (v < 0 || v >= nv) return;
  // g[b, coord, k, f] at ((coord * 3 + k) * nf + f)
  const float* gb = g + b * 9 * (size_t)nf + (size_t)k * nf + f;
  float* ob = out + (b * nv + v) * 3;
  for (int c = 0; c < 3; ++c) atomicAdd(ob + c, gb[(size_t)c * 3 * nf]);
}

}  // namespace

// g: f32 [bs, 3, 3, nf]; faces: i32 [nf, 3]; out: f32 [bs, nv, 3], zeroed.
// Returns cudaGetLastError().
extern "C" int nr_scatter_faces_to_vertices(const float* g, const int* faces,
                                            float* out, int bs, int nf, int nv,
                                            void* stream) {
  if (bs == 0 || nf == 0) return 0;
  const dim3 grid((3 * nf + 255) / 256, bs);
  scatter_faces_to_vertices_kernel<<<grid, 256, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      g, faces, out, nf, nv);
  return static_cast<int>(cudaGetLastError());
}
