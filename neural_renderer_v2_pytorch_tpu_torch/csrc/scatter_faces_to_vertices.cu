// K4 scatter_faces_to_vertices: the transpose of the face-vertex gather,
//   out[b, v, c] = sum of g[b, c, k, f] over the slots with faces[f, k] == v,
// i.e. the shared-vertex gradient of the planar face vertices.
//
// Replaces: _scatter3_kernel in
//   neural_renderer_v2_pytorch_tpu/ops/resolve_pallas.py:2741 (reached
//   through scatter_slots3_pallas, :2808, from gather_resolve._gfv_bwd).
//   The TPU built it from one-hot matmuls over host-listed vertex chunks in
//   two bf16 halves.  A scatter by atomics (this kernel's first form) needs
//   a zero-filled output, a second device operation, and sums in an order
//   that changes from run to run.
//
// Bound: bytes: 36 bytes of gradient and 12 bytes of ids per face, 12
// bytes of output per vertex (the vertex -> slot table adds 4 per vertex
// and per slot).  Design: a gather by vertex, not a scatter by slot.  The
// caller builds the vertex -> slot table once per faces tensor (CSR:
// offsets [nv + 1], the face-major slots s = 3 f + k ascending within each
// vertex; resolve_cuda.vertex_slots).  One thread per (vertex, image) sums
// its ~6 slots' three coordinates from 0 in that order and writes them:
// no atomics, no fill, every output written once.  The gradient reads are
// gathers of single floats (from L2: the whole gradient is 36 bytes a
// face); the output stores are coalesced.
//
// Exactness: the order is index_add_'s on the CPU (ascending slots), and
// the build contracts no additions (--fmad=false), so the result is the
// plain version's on the CPU, bit for bit, on every run.  Ids outside
// [0, nv) own no slot and add nothing; a vertex with no slot writes 0.

#include <cuda_runtime.h>

#include "nr_entry.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
scatter_faces_to_vertices_kernel(const float* __restrict__ g,
                                 const int* __restrict__ offsets,
                                 const int* __restrict__ slots,
                                 float* __restrict__ out, int nf, int nv) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= nv) return;
  const size_t b = blockIdx.y;
  // g[b, c, k, f] at ((c * 3 + k) * nf + f)
  const float* gb = g + b * 9 * (size_t)nf;
  const size_t plane = 3 * (size_t)nf;
  float x = 0.0f, y = 0.0f, z = 0.0f;
  const int end = offsets[v + 1];
  for (int i = offsets[v]; i < end; ++i) {
    const int s = slots[i];
    const int f = s / 3;
    const float* p = gb + (size_t)(s - 3 * f) * nf + f;
    x += p[0];
    y += p[plane];
    z += p[2 * plane];
  }
  float* o = out + (b * nv + v) * 3;
  o[0] = x;
  o[1] = y;
  o[2] = z;
}

// g: f32 [bs, 3, 3, nf]; offsets: i32 [nv + 1] and slots: i32 [3 nf], the
// vertex -> slot table; out: f32 [bs, nv, 3], every element written.
// Returns cudaGetLastError().
int scatter_faces_to_vertices(void* stream, const float* g, const int* offsets, const int* slots,
                              float* out, int bs, int nf, int nv) {
  if (bs == 0 || nv == 0) return 0;
  const dim3 grid((nv + kThreads - 1) / kThreads, bs);
  scatter_faces_to_vertices_kernel<<<grid, kThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      g, offsets, slots, out, nf, nv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

NR_PACKED_ENTRY(scatter_faces_to_vertices)
