// K3 scatter_pixels_to_faces: the backward of the resolve's winner latch,
//   out[b, d, fim[b, p]] += g[b, d, p]   for every pixel p with 0 <= fim < nf.
//
// Replaces: _scatter_kernel and _scatter_kernel_patch in
//   neural_renderer_v2_pytorch_tpu/ops/resolve_pallas.py:1512 and :1616
//   (reached through scatter_to_faces_pallas, :1874, and
//   _scatter_patch_blockspec, :1796).  The TPU has no fast scatter, so it
//   built the sum from predicated one-hot matmuls in two bf16 halves, and
//   the patch variant only reordered pixels for those matmuls; on Hopper one
//   kernel with float32 atomics serves both.
//
// Bound: memory.  The ids once (4 bytes a pixel), the D planes of covered
// pixels (4 * D bytes each) and the output once (4 * D * nf).  What held the
// parent design (one thread per pixel, D atomics per covered pixel straight
// to global memory) back: neighbouring pixels mostly share a winner (about
// 34 pixels per visible face at 512^2 over 2,560 faces), so its atomics
// queued on a few thousand L2 addresses, and every background pixel's
// thread ran for one id read.
//
// Design: a block of 256 threads owns a run of 256 consecutive pixels of
// one image (of a row at 512^2), one thread per pixel, so every plane is
// read coalesced.  On an H100 that run beat a 32 x 8 tile at 512^2 with
// D = 6, 15 and 36 (fewer faces span several warps, so the merge across
// warps is shorter; PERF.md), and K9's transpose, a map of one row, takes
// it as it is.  A block with no covered pixel returns after its id read.
// Otherwise the block groups its pixels by winner once:
//   1. runs: lanes with the same id next to each other in a warp; the run
//      of lanes head .. end is found from a ballot of the heads;
//   2. in each warp, the heads of runs of the same face (__match_any_sync);
//      the lowest is the warp's leader for that face;
//   3. across warps, through shared memory: each warp leader puts its face
//      in an open-addressing table (one slot a face) and sets its warp's bit
//      in the slot; the leader of the lowest warp is the block's leader.
// Then, eight planes a pass (their loads in flight together, one pair of
// barriers a pass, not a pair a plane):
//   - a segmented shuffle reduction sums each run into its head (a tree in
//     a fixed order);
//   - each warp leader sums its face's runs in lane order;
//   - each block leader sums the face's warp sums in warp order and
//     issues ONE atomicAdd for its (face, plane).
// So a block issues one atomic per (distinct face, plane), not one per
// (pixel, plane), and the sum inside a block is in a fixed order; only the
// order of the blocks' atomics varies from run to run, so results agree
// with any exact-order sum to float32 rounding (the JAX backward's own
// bound is 1e-4 relative).  The entry zeroes the output itself
// (cudaMemsetAsync on the same stream), so one call is both operations.
// Ids outside [0, nf) add nothing.

#include <cuda_runtime.h>

#include "nr_entry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 512;        // twice the most distinct faces a block holds
constexpr int kPlanes = 8;         // planes a pass: their loads in flight, one barrier pair

__global__ void __launch_bounds__(kThreads)
scatter_pixels_to_faces_kernel(const float* __restrict__ g, const int* __restrict__ fim,
                               float* __restrict__ out, int D, int P, int nf) {
  __shared__ int s_key[kSlots];                   // face id, -1 empty
  __shared__ unsigned s_warps[kSlots];            // bit w: warp w holds the face
  __shared__ unsigned char s_lane[kSlots][kWarps];  // lane of warp w's leader
  __shared__ float s_run[kPlanes][kThreads];      // each run's sum, at its head
  __shared__ float s_part[kPlanes][kThreads];     // each warp's sum of a face, at its leader

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t b = blockIdx.y;
  const size_t p = (size_t)blockIdx.x * kThreads + tid;
  int f = -1;
  if (p < (size_t)P) {
    f = fim[b * P + p];
    if (f < 0 || f >= nf) f = -1;
  }
  if (!__syncthreads_or(f >= 0)) return;    // background: one id read

  for (int i = tid; i < kSlots; i += kThreads) {
    s_key[i] = -1;
    s_warps[i] = 0u;
  }

  // 1. runs of equal ids in lane order; this lane's run ends at `end`
  const unsigned full = 0xffffffffu;
  const int up = __shfl_up_sync(full, f, 1);
  const bool head = lane == 0 || up != f;
  const unsigned heads = __ballot_sync(full, head);
  const unsigned later = lane == 31 ? 0u : heads & (full << (lane + 1));
  const int end = later ? __ffs(later) - 2 : 31;

  // 2. the heads of one face's runs in this warp (every other lane a key
  // of its own)
  const bool face_head = head && f >= 0;
  const unsigned same = __match_any_sync(full, face_head ? f : -2 - lane);
  const bool warp_leader = face_head && lane == __ffs(same) - 1;
  __syncthreads();                          // the table is empty

  // 3. one slot a face in the block: the warps that hold it, each one's
  // leader lane
  int slot = 0;
  if (warp_leader) {
    slot = static_cast<int>((static_cast<unsigned>(f) * 2654435761u) >> 23);  // 9 bits
    for (;;) {
      const int prev = atomicCAS(&s_key[slot], -1, f);
      if (prev == -1 || prev == f) break;
      slot = (slot + 1) & (kSlots - 1);
    }
    s_lane[slot][warp] = static_cast<unsigned char>(lane);
    atomicOr(&s_warps[slot], 1u << warp);
  }
  __syncthreads();
  const unsigned warps = warp_leader ? s_warps[slot] : 0u;
  const bool block_leader = warp_leader && warp == __ffs(warps) - 1;

  const float* gb = g + b * D * (size_t)P + p;
  float* ob = out + b * D * (size_t)nf + (f >= 0 ? f : 0);
  for (int d0 = 0; d0 < D; d0 += kPlanes) {
    float v[kPlanes];
#pragma unroll
    for (int k = 0; k < kPlanes; ++k) {
      v[k] = (f >= 0 && d0 + k < D) ? gb[(size_t)(d0 + k) * P] : 0.0f;
    }
    // each run's sum into its head, in a fixed tree order
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
      for (int k = 0; k < kPlanes; ++k) {
        const float o = __shfl_down_sync(full, v[k], off);
        if (lane + off <= end) v[k] += o;
      }
    }
#pragma unroll
    for (int k = 0; k < kPlanes; ++k) s_run[k][tid] = v[k];
    __syncwarp();
    if (warp_leader) {                      // the face's runs in lane order
      unsigned bits = same;
      int t = warp * 32 + __ffs(bits) - 1;
      float sum[kPlanes];
#pragma unroll
      for (int k = 0; k < kPlanes; ++k) sum[k] = s_run[k][t];
      for (bits &= bits - 1; bits; bits &= bits - 1) {
        t = warp * 32 + __ffs(bits) - 1;
#pragma unroll
        for (int k = 0; k < kPlanes; ++k) sum[k] += s_run[k][t];
      }
#pragma unroll
      for (int k = 0; k < kPlanes; ++k) s_part[k][tid] = sum[k];
    }
    __syncthreads();
    if (block_leader) {                     // the face's warps in warp order
      unsigned bits = warps;
      float sum[kPlanes];
#pragma unroll
      for (int k = 0; k < kPlanes; ++k) sum[k] = s_part[k][tid];
      for (bits &= bits - 1; bits; bits &= bits - 1) {
        const int w = __ffs(bits) - 1;
        const int t = w * 32 + s_lane[slot][w];
#pragma unroll
        for (int k = 0; k < kPlanes; ++k) sum[k] += s_part[k][t];
      }
#pragma unroll
      for (int k = 0; k < kPlanes; ++k) {
        if (d0 + k < D) atomicAdd(ob + (size_t)(d0 + k) * nf, sum[k]);
      }
    }
    __syncthreads();                        // the next pass reuses s_run, s_part
  }
}

// g: f32 [bs, D, P]; fim: i32 [bs, P]; out: f32 [bs, D, nf], zeroed here.
// Returns the first CUDA error.
int scatter_pixels_to_faces(void* stream, const float* g, const int* fim, float* out, int bs,
                            int D, int P, int nf) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = (size_t)bs * D * nf * sizeof(float);
  if (bytes) {
    const cudaError_t err = cudaMemsetAsync(out, 0, bytes, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (bs == 0 || D == 0 || P == 0 || nf == 0) return 0;
  const dim3 grid((P + kThreads - 1) / kThreads, bs);
  scatter_pixels_to_faces_kernel<<<grid, kThreads, 0, s>>>(g, fim, out, D, P, nf);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

NR_PACKED_ENTRY(scatter_pixels_to_faces)
