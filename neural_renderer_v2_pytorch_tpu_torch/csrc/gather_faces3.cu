// K5 gather_faces3: the face-vertex gather into the planar layout,
//   out[b, d, k, f] = table[b, faces[f, k], d],
// e.g. the planar face vertices [bs, 3 (coord), 3 (vertex), nf] from
// vertices [bs, nv, 3].
//
// Replaces: _gather3_kernel in
//   neural_renderer_v2_pytorch_tpu/ops/resolve_pallas.py:2605 (reached
//   through gather_faces3_pallas, :2672, from gather_resolve._gfv_primal).
//   The TPU has no fast gather, so it built the rows from one-hot matmuls
//   over host-listed vertex chunks, in three bf16 parts to stay bit-exact,
//   behind a cost model that chose it over XLA's gather from 250,000 slots
//   up; on Hopper one plain gather serves every mesh, with no cost model.
//
// Bound: memory.  Per face: 12 bytes of ids and 36 bytes written, and
// 3 rows of D floats read from the table (a vertex is shared by ~6 faces,
// so most rows come from L2).  Design: one thread per (slot, batch image)
// with slot = k * nf + f, so neighbouring threads write neighbouring faces
// of one output plane (coalesced stores); the row reads are gathers.
//
// Exactness: a copy, so bit-identical to the plain version.  Ids outside
// [0, n) write 0 (the plain version's indexing raises on them).

#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256)
gather_faces3_kernel(const float* __restrict__ table,
                     const int* __restrict__ faces, float* __restrict__ out,
                     int n, int D, int nf) {
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= 3 * nf) return;
  const size_t b = blockIdx.y;
  const int k = slot / nf;
  const int f = slot - k * nf;
  const int v = faces[(size_t)f * 3 + k];
  const bool ok = v >= 0 && v < n;
  const float* row = table + (b * n + (ok ? v : 0)) * (size_t)D;
  // out[b, d, k, f] at ((d * 3 + k) * nf + f)
  float* ob = out + b * D * 3 * (size_t)nf + (size_t)k * nf + f;
  for (int d = 0; d < D; ++d) ob[(size_t)d * 3 * nf] = ok ? row[d] : 0.0f;
}

}  // namespace

// table: f32 [bs, n, D]; faces: i32 [nf, 3]; out: f32 [bs, D, 3, nf].
// Returns cudaGetLastError().
extern "C" int nr_gather_faces3(const float* table, const int* faces,
                                float* out, int bs, int n, int D, int nf,
                                void* stream) {
  if (bs == 0 || nf == 0 || D == 0) return 0;
  const dim3 grid((3 * nf + 255) / 256, bs);
  gather_faces3_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      table, faces, out, n, D, nf);
  return static_cast<int>(cudaGetLastError());
}
