// K6 atlas_taps_grad: the texture-atlas gradient of the four bilinear taps,
//   out[b, c, a + k_i] += g[b, 3 i + c, p]   for k = (0, 1, tw, tw + 1),
// for every pixel p whose anchor a = anchors[b, p] lies in [0, T), each tap
// only where a + k_i < T (ops/shading.py, _AtlasTaps.backward).
//
// Replaces: _scatter_rows_kernel in
//   neural_renderer_v2_pytorch_tpu/ops/resolve_pallas.py:2090 (reached
//   through scatter_rows_pallas, :2182, from shading._atlas_taps_bwd), and
//   the three shifted adds after it there.  The TPU has no fast scatter, so
//   it built the sum from one-hot matmuls with one column per row id: all
//   four taps of a pixel rode as 12 channels at the anchor texel of a
//   [bs, T, 12] table, and three shifted adds folded them onto their
//   texels.  An atomic on Hopper goes to any address, so here each tap adds
//   its three channels at its own texel, straight into the planar [bs, 3, T]
//   gradient that autograd takes as it is: no 12-channel table (110 MB at
//   1190 x 1920 texels), no fold passes, no copy into the atlas's layout.
//
// Bound: memory.  The anchors once (4 bytes a pixel), the 12 planes of the
// covered pixels (48 bytes each) and the gradient written once (12 bytes a
// texel: the caller's zero fill, 27.4 MB at 1190 x 1920, which fits in the
// 50 MB L2, so the atomics after it mostly land there).
//
// Design: one thread per (pixel, image).  A warp reads 32 consecutive
// anchors and then each of the 12 planes coalesced; a background pixel's
// thread returns after its anchor.  In each channel plane the taps a and
// a + 1 are neighbours, and so are a + tw and a + tw + 1: where such a pair
// is 8-byte aligned it goes as one float2 atomicAdd (sm_90, global memory),
// else as two float ones.  No result is used, so every atomic compiles to
// a reduction (RED): a covered pixel sends 6 to 12 of them.  Atomics sum
// in a different order on every run, so the result agrees with any
// exact-order sum to float32 rounding.  Anchors outside [0, T) add
// nothing.

#include <cuda_runtime.h>

#include <cstdint>

#include "nr_entry.cuh"

namespace {

constexpr int kThreads = 256;

// out[0] += x, and out[1] += y where `second`
__device__ __forceinline__ void add_pair(float* out, float x, float y, bool second) {
  if (second && (reinterpret_cast<std::uintptr_t>(out) & 7) == 0) {
    atomicAdd(reinterpret_cast<float2*>(out), make_float2(x, y));
  } else {
    atomicAdd(out, x);
    if (second) atomicAdd(out + 1, y);
  }
}

__global__ void __launch_bounds__(kThreads)
atlas_taps_grad_kernel(const float* __restrict__ g, const int* __restrict__ anchors,
                       float* __restrict__ out, int P, int tw, int T) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  const size_t b = blockIdx.y;
  const int a = anchors[b * P + p];
  if (a < 0 || a >= T) return;
  const float* gb = g + b * 12 * (size_t)P + p;
  float v[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) v[k] = gb[(size_t)k * P];
  const long long at = a;
  const bool right = at + 1 < T;
  const bool below = at + tw < T;
  const bool below_right = at + tw + 1 < T;
  float* ob = out + b * 3 * (size_t)T + a;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float* plane = ob + (size_t)c * T;
    add_pair(plane, v[c], v[3 + c], right);
    if (below) add_pair(plane + tw, v[6 + c], v[9 + c], below_right);
  }
}

// g: f32 [bs, 12, P], tap i's channel c on plane 3 i + c; anchors: i32
// [bs, P]; out: f32 [bs, 3, T], zeroed by the caller.  Returns
// cudaGetLastError().
int atlas_taps_grad(void* stream, const float* g, const int* anchors, float* out, int bs, int P,
                    int tw, int T) {
  if (bs == 0 || P == 0 || T == 0) return 0;
  const dim3 grid((P + kThreads - 1) / kThreads, bs);
  atlas_taps_grad_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      g, anchors, out, P, tw, T);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

NR_PACKED_ENTRY(atlas_taps_grad)
