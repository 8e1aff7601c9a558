// K9 gather_rows: the row gather, in a planar and a row layout,
//   planar: out[b, d, p] = table[b, ids[b, p], d]   ([bs, D, P])
//   row:    out[b, p, d] = table[b, ids[b, p], d]   ([bs, P, D])
// with 0 where an id is negative (to_map's background) or past the table.
// The face-sharded path gathers its winners' per-face data in the planar
// form (the winner planes, [bs, D, rows, S]); the public to_map gathers in
// the row form.
//
// K5 gather_faces3 is the planar form over the face slots p = k * nf + f
// with the ids faces[f, k] shared by every batch image: the planar
// face-vertex gather out[b, d, k, f] = table[b, faces[f, k], d], e.g. the
// planar face vertices [bs, 3 (coord), 3 (vertex), nf] from [bs, nv, 3].
// One kernel serves both: id p is read at
//   ids[b * ids_bstride + (p % inner) * inner_stride + p / inner],
// which is ids[b, p] for K9 (inner = P, inner_stride = 1) and faces[f, k]
// for K5 (inner = nf, inner_stride = 3, ids_bstride = 0).
//
// Replaces, in neural_renderer_v2_pytorch_tpu/ops/resolve_pallas.py:
//   K9: _gather_kernel (:2277, driven by gather_rows_pallas, :2433).
//   K5: _gather3_kernel (:2605, through gather_faces3_pallas, :2672).
//   The TPU has no fast gather, so both built each output row from one-hot
//   matmuls, in three bf16 parts to stay bit-exact, over host- or
//   device-built lists of the table chunks each strip of ids touches.  On
//   Hopper a gather is a load: no one-hot product, no bf16 split, no
//   occupancy list.
//
// Bound: bytes.  The ids read once (4 P), the output written once (4 P D)
// and the rows the ids name read once (4 D per distinct row).  Design:
//   planar: one thread per output position p; it loads its id once and
//     loops over D, so a warp's stores are coalesced along p in every plane
//     and its row reads are gathers of D contiguous floats (from L2 where
//     neighbouring pixels share a face).
//   row: one thread per (p, d), so the stores are coalesced along the
//     output and the D threads of one p read one row together.
//
// Exactness: a copy, so bit-identical to the plain version.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int load_id(const int* __restrict__ ids, size_t b, int p,
                                       long long ids_bstride, int inner,
                                       int inner_stride) {
  const int q = p / inner;
  return ids[b * ids_bstride + (size_t)(p - q * inner) * inner_stride + q];
}

__global__ void __launch_bounds__(kThreads)
gather_planar_kernel(const float* __restrict__ table, const int* __restrict__ ids,
                     float* __restrict__ out, int n, int D, int P,
                     long long ids_bstride, int inner, int inner_stride) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  const size_t b = blockIdx.y;
  const int id = load_id(ids, b, p, ids_bstride, inner, inner_stride);
  const bool ok = id >= 0 && id < n;
  const float* row = table + (b * n + (ok ? id : 0)) * (size_t)D;
  float* o = out + b * D * (size_t)P + p;
  for (int d = 0; d < D; ++d) o[(size_t)d * P] = ok ? row[d] : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float* __restrict__ table, const int* __restrict__ ids,
                   float* __restrict__ out, int n, int D, int P,
                   long long ids_bstride) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;   // p * D + d
  if (i >= (size_t)P * D) return;
  const size_t b = blockIdx.y;
  const int p = static_cast<int>(i / D);
  const int d = static_cast<int>(i - (size_t)p * D);
  const int id = ids[b * ids_bstride + p];
  const bool ok = id >= 0 && id < n;
  out[b * P * (size_t)D + i] = ok ? table[(b * n + id) * (size_t)D + d] : 0.0f;
}

int launch_planar(const float* table, const int* ids, float* out, int bs, int n, int D,
                  int P, long long ids_bstride, int inner, int inner_stride,
                  void* stream) {
  if (bs == 0 || P == 0 || D == 0) return 0;
  const dim3 grid((P + kThreads - 1) / kThreads, bs);
  gather_planar_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, ids, out, n, D, P, ids_bstride, inner, inner_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K9.  table: f32 [bs, n, D]; ids: i32 [bs, P] at a batch stride of
// ids_bstride elements (P, or 0 for ids shared by the batch); out: f32
// [bs, D, P] when planar, else [bs, P, D].  Returns cudaGetLastError().
extern "C" int nr_gather_rows(const float* table, const int* ids, float* out, int bs,
                              int n, int D, int P, long long ids_bstride, int planar,
                              void* stream) {
  if (planar) return launch_planar(table, ids, out, bs, n, D, P, ids_bstride, P, 1, stream);
  if (bs == 0 || P == 0 || D == 0) return 0;
  const size_t total = (size_t)P * D;
  const dim3 grid(static_cast<unsigned>((total + kThreads - 1) / kThreads), bs);
  gather_rows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, ids, out, n, D, P, ids_bstride);
  return static_cast<int>(cudaGetLastError());
}

// K5.  table: f32 [bs, n, D]; faces: i32 [nf, 3]; out: f32 [bs, D, 3, nf].
// Returns cudaGetLastError().
extern "C" int nr_gather_faces3(const float* table, const int* faces, float* out, int bs,
                                int n, int D, int nf, void* stream) {
  return launch_planar(table, faces, out, bs, n, D, 3 * nf, 0, nf, 3, stream);
}
