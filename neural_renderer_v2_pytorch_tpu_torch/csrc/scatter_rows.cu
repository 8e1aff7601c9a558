// K6 scatter_rows: row scatter-add into a large table,
//   out[b, ids[b, p], d] += g[b, d, p]   for every p with ids[b, p] >= 0;
// the texture-atlas gradient, with the four bilinear taps of a pixel as 12
// channels at the quad's anchor texel (ops/shading.py, _AtlasTaps).
//
// Replaces: _scatter_rows_kernel in
//   neural_renderer_v2_pytorch_tpu/ops/resolve_pallas.py:2090 (reached
//   through scatter_rows_pallas, :2182, from shading._atlas_taps_bwd).
//   The TPU has no fast scatter, so it built the sum from one-hot matmuls
//   in two bf16 halves (~2^-17 relative), one VMEM-resident part of the
//   table at a time, with bit-packed occupancy to skip empty
//   (part, strip, chunk) triples; on Hopper the scatter is float32
//   atomics into the table in device memory.
//
// Bound: memory and atomic throughput.  Per point: 4 * D bytes read and D
// atomics; at 512^2 with D = 12 that is 12.6 MB read and 3.1M atomics,
// which land in L2.  The table itself (1190 x 1920 texels x 12 channels,
// 110 MB) is zeroed by the caller and touched only at the rows hit.
// Design: one thread per (point, batch image), reading each plane
// coalesced; a thread's D atomics go to one 4*D-byte row.  Neighbouring
// pixels mostly hit neighbouring or equal rows, so contention is low at
// the sizes an atlas has.  Atomics sum in a different order on every run,
// so the result agrees with any exact-order sum to float32 rounding.
// Ids outside [0, T) add nothing.

#include <cuda_runtime.h>

#include "nr_entry.cuh"

namespace {

__global__ void __launch_bounds__(256)
scatter_rows_kernel(const float* __restrict__ g, const int* __restrict__ ids,
                    float* __restrict__ out, int D, int P, int T) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const size_t b = blockIdx.y;
  const int t = ids[b * P + p];
  if (t < 0 || t >= T) return;
  const float* gb = g + b * D * (size_t)P + p;
  float* ob = out + (b * T + t) * (size_t)D;
  for (int d = 0; d < D; ++d) atomicAdd(ob + d, gb[(size_t)d * P]);
}

// g: f32 [bs, D, P]; ids: i32 [bs, P]; out: f32 [bs, T, D], zeroed.
// Returns cudaGetLastError().
int scatter_rows(void* stream, const float* g, const int* ids, float* out, int bs, int D, int P,
                 int T) {
  if (bs == 0 || P == 0 || D == 0) return 0;
  const dim3 grid((P + 255) / 256, bs);
  scatter_rows_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      g, ids, out, D, P, T);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

NR_PACKED_ENTRY(scatter_rows)
