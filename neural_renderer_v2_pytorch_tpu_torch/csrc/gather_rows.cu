// K9 gather_rows: the row gather, in a planar and a row layout,
//   planar: out[b, d, p] = table[b, ids[b, p], d]   ([bs, D, P])
//   row:    out[b, p, d] = table[b, ids[b, p], d]   ([bs, P, D])
// with 0 where an id is negative (to_map's background) or past the table.
// The face-sharded path gathers its winners' per-face data in the planar
// form (the winner planes, [bs, D, rows, S]); the public to_map gathers in
// the row form.
//
// K5 gather_faces3: the planar face-vertex gather
//   out[b, d, k, f] = table[b, faces[f, k], d]   ([bs, D, 3, nf])
// e.g. the planar face vertices [bs, 3 (coord), 3 (vertex), nf] from the
// vertices [bs, nv, 3], with 0 for an id outside the table.
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
// Bound: bytes.  K9: the ids read once (4 P), the output written once
// (4 P D) and the rows the ids name read once (4 D per distinct row).  K5:
// the table (4 bs n D), the faces (12 nf) and the output (12 bs D nf).
// Design:
//   K9 planar: one thread per output position p; it loads its id once and
//     loops over D, so a warp's stores are coalesced along p in every plane
//     and its row reads are gathers of D contiguous floats (from L2 where
//     neighbouring pixels share a face).
//   K9 row: one thread per (p, d), so the stores are coalesced along the
//     output and the D threads of one p read one row together.
//   K5: one thread per (face, image).  It loads its face's three ids (a
//     warp's 32 faces are 384 contiguous bytes, so the loads use every
//     line they touch, and the images after the first find them in L1/L2),
//     reads the three rows (D contiguous floats each, from L2 where faces
//     share vertices), all loads issued before its 3 D planar stores,
//     which are coalesced along f.  Staging a block's 768 ids in shared
//     memory once for a loop over the images measured slower on an H100
//     at every shape (tools/face_vertex_times.py --designs, PERF.md): the
//     barrier cost more than the id loads it saved, and the loop left the
//     card idle at small meshes.
//
// Exactness: copies, so bit-identical to the plain versions.

#include <cuda_runtime.h>

#include "nr_entry.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_planar_kernel(const float* __restrict__ table, const int* __restrict__ ids,
                     float* __restrict__ out, int n, int D, int P, long long ids_bstride) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  const size_t b = blockIdx.y;
  const int id = ids[b * ids_bstride + p];
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

// kD > 0: D fixed at compile time (3 for the vertices), so a thread issues
// all 3 kD row loads before its stores; a loop over a run-time D waits on
// each load in turn.  kD == 0: D at run time.
template <int kD>
__global__ void __launch_bounds__(kThreads)
gather_faces3_kernel(const float* __restrict__ table, const int* __restrict__ faces,
                     float* __restrict__ out, int n, int run_time_d, int nf) {
  const int D = kD > 0 ? kD : run_time_d;
  const int f = blockIdx.x * kThreads + threadIdx.x;
  if (f >= nf) return;
  const size_t b = blockIdx.y;
  const float* tb = table + b * n * D;
  const size_t plane = 3 * (size_t)nf;  // one d plane [3, nf] of the output
  float* ob = out + b * D * plane + f;
  size_t row[3];
  bool ok[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int v = faces[(size_t)f * 3 + k];
    ok[k] = v >= 0 && v < n;
    row[k] = (size_t)(ok[k] ? v : 0) * D;
  }
  if constexpr (kD > 0) {
    float val[3][kD];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
#pragma unroll
      for (int d = 0; d < kD; ++d) val[k][d] = ok[k] ? tb[row[k] + d] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
#pragma unroll
      for (int d = 0; d < kD; ++d) ob[d * plane + (size_t)k * nf] = val[k][d];
    }
  } else {
    for (int k = 0; k < 3; ++k) {
      for (int d = 0; d < D; ++d) ob[d * plane + (size_t)k * nf] = ok[k] ? tb[row[k] + d] : 0.0f;
    }
  }
}

// K9.  table: f32 [bs, n, D]; ids: i32 [bs, P] at a batch stride of
// ids_bstride elements (P, or 0 for ids shared by the batch); out: f32
// [bs, D, P] when planar, else [bs, P, D].  Returns cudaGetLastError().
int gather_rows(void* stream, const float* table, const int* ids, float* out, int bs, int n,
                int D, int P, long long ids_bstride, int planar) {
  if (bs == 0 || P == 0 || D == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (planar) {
    const dim3 grid((P + kThreads - 1) / kThreads, bs);
    gather_planar_kernel<<<grid, kThreads, 0, s>>>(table, ids, out, n, D, P, ids_bstride);
  } else {
    const size_t total = (size_t)P * D;
    const dim3 grid(static_cast<unsigned>((total + kThreads - 1) / kThreads), bs);
    gather_rows_kernel<<<grid, kThreads, 0, s>>>(table, ids, out, n, D, P, ids_bstride);
  }
  return static_cast<int>(cudaGetLastError());
}

// K5.  table: f32 [bs, n, D]; faces: i32 [nf, 3]; out: f32 [bs, D, 3, nf].
// Returns cudaGetLastError().
int gather_faces3(void* stream, const float* table, const int* faces, float* out, int bs, int n,
                  int D, int nf) {
  if (bs == 0 || nf == 0 || D == 0) return 0;
  const dim3 grid((nf + kThreads - 1) / kThreads, bs);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 3) {
    gather_faces3_kernel<3><<<grid, kThreads, 0, s>>>(table, faces, out, n, D, nf);
  } else {
    gather_faces3_kernel<0><<<grid, kThreads, 0, s>>>(table, faces, out, n, D, nf);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

NR_PACKED_ENTRY(gather_rows)
NR_PACKED_ENTRY(gather_faces3)
