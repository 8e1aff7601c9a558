// Designs of K6 (atlas_taps_grad) and the parent's K6, kept beside the
// shipped kernel for turns (chip_smoke.py phase 19, built by
// chip_smoke.tool_library).  Each design computes the shipped kernel's
// function (neural_renderer_v2_pytorch_tpu_torch/csrc/atlas_taps_grad.cu):
// the four bilinear taps' gradients g f32 [bs, 12, P] added at texels
// a, a + 1, a + tw, a + tw + 1 of a planar [bs, 3, T], zeroed by the caller.
//
//   design<pair, match>: one thread per (pixel, image), as shipped;
//     pair:  the neighbouring taps (a, a + 1) and (a + tw, a + tw + 1) of
//            a plane as one float2 atomicAdd where 8-byte aligned (else
//            two float ones); without it, 12 float atomics a pixel;
//     match: warp aggregation: the lanes of a warp with equal anchors
//            (__match_any_sync) put their 12 values in shared memory, and
//            the lowest of them sums them in lane order and alone sends
//            the atomics.  It pays only where the atlas is magnified, so
//            that neighbouring pixels share an anchor.
//   parent: K6 as the port had it before (csrc/scatter_rows.cu):
//     out[b, ids[b, p], d] += g[b, d, p] into a [bs, T, D] table (all four
//     taps as 12 channels at the anchor), which the caller zeroes and then
//     folds onto the taps' texels.
//
// Plain C entries with typed arguments, the stream last (ctypes argtypes
// in the loader).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <bool kPair>
__device__ __forceinline__ void add_pair(float* out, float x, float y, bool second) {
  if (kPair && second && (reinterpret_cast<std::uintptr_t>(out) & 7) == 0) {
    atomicAdd(reinterpret_cast<float2*>(out), make_float2(x, y));
  } else {
    atomicAdd(out, x);
    if (second) atomicAdd(out + 1, y);
  }
}

template <bool kPair, bool kMatch>
__global__ void __launch_bounds__(kThreads)
design_kernel(const float* __restrict__ g, const int* __restrict__ anchors,
              float* __restrict__ out, int P, int tw, int T) {
  __shared__ float s_v[kMatch ? 12 : 1][kThreads];
  const int tid = threadIdx.x;
  const int p = blockIdx.x * kThreads + tid;
  const size_t b = blockIdx.y;
  const int a = p < P ? anchors[b * P + p] : -1;
  const bool valid = a >= 0 && a < T;
  const float* gb = g + b * 12 * (size_t)P + p;
  float v[12];
  if constexpr (kMatch) {
    const unsigned full = 0xffffffffu;
    const int lane = tid & 31;
    if (!__any_sync(full, valid)) return;          // a whole warp of background
    // every lane a key of its own but the valid ones' anchors
    const unsigned peers = __match_any_sync(full, valid ? a : -1 - lane);
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      v[k] = valid ? gb[(size_t)k * P] : 0.0f;
      s_v[k][tid] = v[k];
    }
    __syncwarp();
    if (!valid || lane != __ffs(peers) - 1) return;
    for (unsigned bits = peers & (peers - 1); bits; bits &= bits - 1) {
      const int t = (tid & ~31) + __ffs(bits) - 1;
#pragma unroll
      for (int k = 0; k < 12; ++k) v[k] += s_v[k][t];
    }
  } else {
    if (!valid) return;
#pragma unroll
    for (int k = 0; k < 12; ++k) v[k] = gb[(size_t)k * P];
  }
  const long long at = a;
  const bool right = at + 1 < T;
  const bool below = at + tw < T;
  const bool below_right = at + tw + 1 < T;
  float* ob = out + b * 3 * (size_t)T + a;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float* plane = ob + (size_t)c * T;
    add_pair<kPair>(plane, v[c], v[3 + c], right);
    if (below) add_pair<kPair>(plane + tw, v[6 + c], v[9 + c], below_right);
  }
}

__global__ void __launch_bounds__(kThreads)
parent_scatter_rows_kernel(const float* __restrict__ g, const int* __restrict__ ids,
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

template <bool kPair, bool kMatch>
int launch(const float* g, const int* anchors, float* out, int bs, int P, int tw, int T,
           void* stream) {
  const dim3 grid((P + kThreads - 1) / kThreads, bs);
  design_kernel<kPair, kMatch><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      g, anchors, out, P, tw, T);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g: f32 [bs, 12, P]; anchors: i32 [bs, P]; out: f32 [bs, 3, T], zeroed.
extern "C" int nr_design_atlas_taps_grad(int pair, int match, const float* g,
                                         const int* anchors, float* out, int bs, int P,
                                         int tw, int T, void* stream) {
  if (bs == 0 || P == 0 || T == 0) return 0;
  if (pair) {
    return match ? launch<true, true>(g, anchors, out, bs, P, tw, T, stream)
                 : launch<true, false>(g, anchors, out, bs, P, tw, T, stream);
  }
  return match ? launch<false, true>(g, anchors, out, bs, P, tw, T, stream)
               : launch<false, false>(g, anchors, out, bs, P, tw, T, stream);
}

// g: f32 [bs, D, P]; ids: i32 [bs, P]; out: f32 [bs, T, D], zeroed.
extern "C" int nr_parent_scatter_rows(const float* g, const int* ids, float* out, int bs, int D,
                                      int P, int T, void* stream) {
  if (bs == 0 || P == 0 || D == 0) return 0;
  const dim3 grid((P + kThreads - 1) / kThreads, bs);
  parent_scatter_rows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      g, ids, out, D, P, T);
  return static_cast<int>(cudaGetLastError());
}
