// Other designs of kernel K5, the face-vertex gather
//   out[b, d, k, f] = table[b, faces[f, k], d]   ([bs, D, 3, nf], D = 3),
// with 0 for an id outside the table, for `tools/face_vertex_times.py
// --designs` to time beside the port's own kernel
// (neural_renderer_v2_pytorch_tpu_torch/csrc/gather_rows.cu: one thread per
// (face, image), its three ids loaded from the faces array, the nine row
// loads issued before the nine planar stores).  Each is a copy, so each
// gives the plain version's bits.
//
//   staged_batch_loop: one block per 256 faces; the block's 768 ids staged
//     in shared memory with coalesced 4-byte loads, once for all images;
//     a loop over the images inside the block.
//   staged_per_image: the same staging, with a block per (256 faces,
//     image) and no loop: the staging without the loop.
//   direct_run_time_d: the port's design with D read at run time, so each
//     row load waits in turn: the port's kernel without its unrolled D.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kD = 3;

__device__ __forceinline__ void copy_rows(const float* __restrict__ tb,
                                          float* __restrict__ ob, const int* row,
                                          const bool* ok, size_t plane, int nf) {
  float val[3][kD];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int d = 0; d < kD; ++d) val[k][d] = ok[k] ? tb[(size_t)row[k] * kD + d] : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int d = 0; d < kD; ++d) ob[d * plane + (size_t)k * nf] = val[k][d];
  }
}

__global__ void __launch_bounds__(kThreads)
staged_kernel(const float* __restrict__ table, const int* __restrict__ faces,
              float* __restrict__ out, int bs, int n, int nf, bool batch_loop) {
  __shared__ int ids[3 * kThreads];
  const int f0 = blockIdx.x * kThreads;
  const int count = min(kThreads, nf - f0);
  for (int i = threadIdx.x; i < 3 * count; i += kThreads) ids[i] = faces[(size_t)f0 * 3 + i];
  __syncthreads();
  if ((int)threadIdx.x >= count) return;
  int row[3];
  bool ok[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int v = ids[threadIdx.x * 3 + k];   // stride 3: no bank conflicts
    ok[k] = v >= 0 && v < n;
    row[k] = ok[k] ? v : 0;
  }
  const size_t plane = 3 * (size_t)nf;
  const int f = f0 + threadIdx.x;
  const int b_end = batch_loop ? bs : blockIdx.y + 1;
  for (int b = batch_loop ? 0 : blockIdx.y; b < b_end; ++b) {
    copy_rows(table + (size_t)b * n * kD, out + (size_t)b * kD * plane + f, row, ok, plane,
              nf);
  }
}

__global__ void __launch_bounds__(kThreads)
direct_kernel(const float* __restrict__ table, const int* __restrict__ faces,
              float* __restrict__ out, int n, int D, int nf) {
  const int f = blockIdx.x * kThreads + threadIdx.x;
  if (f >= nf) return;
  const size_t b = blockIdx.y;
  const float* tb = table + b * n * D;
  const size_t plane = 3 * (size_t)nf;
  float* ob = out + b * D * plane + f;
  for (int k = 0; k < 3; ++k) {
    const int v = faces[(size_t)f * 3 + k];
    const bool ok = v >= 0 && v < n;
    for (int d = 0; d < D; ++d) ob[d * plane + (size_t)k * nf] = ok ? tb[(size_t)v * D + d] : 0.0f;
  }
}

int staged(const float* table, const int* faces, float* out, int bs, int n, int D, int nf,
           void* stream, bool batch_loop) {
  if (D != kD) return static_cast<int>(cudaErrorInvalidValue);
  if (bs == 0 || nf == 0) return 0;
  const dim3 grid((nf + kThreads - 1) / kThreads, batch_loop ? 1 : bs);
  staged_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, faces, out, bs, n, nf, batch_loop);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each: table f32 [bs, n, D], faces i32 [nf, 3], out f32 [bs, D, 3, nf];
// returns cudaGetLastError() (the staged designs refuse D != 3).
extern "C" int nr_gather_faces3_staged_batch_loop(const float* table, const int* faces,
                                                  float* out, int bs, int n, int D, int nf,
                                                  void* stream) {
  return staged(table, faces, out, bs, n, D, nf, stream, true);
}

extern "C" int nr_gather_faces3_staged_per_image(const float* table, const int* faces,
                                                 float* out, int bs, int n, int D, int nf,
                                                 void* stream) {
  return staged(table, faces, out, bs, n, D, nf, stream, false);
}

extern "C" int nr_gather_faces3_direct_run_time_d(const float* table, const int* faces,
                                                  float* out, int bs, int n, int D, int nf,
                                                  void* stream) {
  if (bs == 0 || nf == 0 || D == 0) return 0;
  const dim3 grid((nf + kThreads - 1) / kThreads, bs);
  direct_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(table, faces, out, n,
                                                                         D, nf);
  return static_cast<int>(cudaGetLastError());
}
