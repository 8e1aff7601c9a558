// Other designs of the shipped resolve forms, for turns against them
// (chip_smoke.py phase 19, built by chip_smoke.tool_library with -I on the
// port's csrc/).  They include the shipped source
// (neural_renderer_v2_pytorch_tpu_torch/csrc/resolve.cu) and share its
// Args, per-pixel test, epilogue and face math:
//
//   nr_design_resolve_xy / _latch / _depth(cluster, stages, runs, ...): the
//     tiled forms with the face stream shared by a cluster of CTAs along a
//     row of tiles (cudaLaunchKernelEx, cluster dimension attribute): 256
//     pixel threads and a producer warp a CTA; the first `runs` of a
//     batch's nine runs of the planar fvp come by multicast bulk copies
//     (cp.async.bulk...multicast::cluster, run j issued by rank j %
//     cluster) into a ring of `stages` stages of dynamic shared memory in
//     every CTA of the cluster, the rest loaded by each thread itself.  Each
//     stage has a full mbarrier (its batch's bytes, expect_tx) and an empty
//     one (one arrival from each CTA, a remote arrive by its thread 0 once
//     its pixel threads have read the stage); a producer refills a stage
//     only when it is empty.  Every CTA walks every batch, those whose tile
//     lies past the image edge too (the grid's x extent rounded up to the
//     cluster), so none leaves a barrier waiting.  A run's slot starts on
//     a 128-byte line and the run sits in it at its address's offset within
//     a line, so its 16-byte-aligned body lands aligned; its unaligned head
//     and tail (< 4 floats each) are loaded from global memory by the
//     threads whose faces they hold, a batch ahead.  Clusters of 2 with 5
//     stages were the fastest of these on an H100, 1.9-2.4x slower than the
//     shipped forms (each thread loading its own face a batch ahead).
//   nr_design_binned_xy / _latch / _depth(work, ...): K8 as one warp per
//     8x8 bin, two pixels a lane, warps persistent over the bins, each
//     keeping its next unit's coordinates, the unit after's ids and the
//     next bin's count and offset in flight; bins by a static stride over
//     the warps (work null) or from an atomic counter (`work`, one int,
//     zeroed by the entry).  The shipped K8 is a CTA of 64 threads per bin.
//
// Plain C entries with typed arguments, the stream last (ctypes argtypes in
// the loader); the arguments after the leading ones are the shipped
// entries'.

#include <cstdint>

#include "resolve.cu"

namespace {

constexpr int kMaxDevices = 64;

// ---- the cluster's shared face stream --------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Arrive on the barrier at *bar's offset in the shared memory of the
// cluster's CTA `rank` (this CTA's own included).
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar, unsigned rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(smem_addr(bar)),
               "r"(rank));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];" ::"r"(remote) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` of *bar has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// The copy plan of a run of `len` entries starting at `run`: a0, the first
// entry of its 16-byte-aligned body; body, the body's floats (a multiple of
// 4).  Entries a0 .. a0 + body - 1 of the run come by bulk copy, the rest
// (< 4 at each end) from global memory.
struct RunPlan {
  int a0, body;
};

__device__ __forceinline__ RunPlan run_plan(const float* run, int len) {
  RunPlan r;
  r.a0 = (4 - static_cast<int>((reinterpret_cast<uintptr_t>(run) >> 2) & 3)) & 3;
  r.body = len > r.a0 ? (len - r.a0) & ~3 : 0;
  return r;
}

// floats of a run's slot in the ring: a batch of the run, and 32 for its
// offset within 128 bytes (a slot starts on a 128-byte line, and a run sits
// in it at its global address's offset within a line)
constexpr int kRunSlot = kTileThreads + 32;

// the offset in floats of a run starting at `run` within its 128-byte line
__device__ __forceinline__ int line_offset(const float* run) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(run) >> 2) & 31);
}

// The producer warp of each CTA: lane 0 expects batch i's bytes on its
// stage's barrier, and lane j < kRuns of CTA rank j % kC issues run j's
// copy, multicast to every CTA of the cluster (the slot and the barrier at
// the same offsets there).  The bytes may land before they are expected:
// the phase completes when both have happened.
template <int kC, int kS, int kRuns>
__device__ void issue_batch(const float* vb, int nf, int i, float* ring, uint64_t* full,
                            unsigned rank, int lane) {
  const int stage = i % kS, base = i * kTileThreads;
  const int len = min(kTileThreads, nf - base);
  if (lane == 0) {
    unsigned bytes = 0;
#pragma unroll
    for (int j = 0; j < kRuns; ++j) {
      bytes += 4u * static_cast<unsigned>(run_plan(vb + (size_t)j * nf + base, len).body);
    }
    mbar_arrive_expect_tx(&full[stage], bytes);
  }
  if (lane >= kRuns || lane % kC != static_cast<int>(rank)) return;
  const float* run = vb + (size_t)lane * nf + base;
  const RunPlan r = run_plan(run, len);
  if (r.body == 0) return;
  const uint16_t mask = static_cast<uint16_t>((1u << kC) - 1u);
  const float* slot = ring + (stage * kRuns + lane) * kRunSlot + line_offset(run);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
      " [%0], [%1], %2, [%3], %4;" ::"r"(smem_addr(slot + r.a0)),
      "l"(run + r.a0), "r"(4 * r.body), "r"(smem_addr(&full[stage])), "h"(mask)
      : "memory");
}

// The pixel threads' own barrier (the producer warp never joins it).
__device__ __forceinline__ void pixels_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kTileThreads) : "memory");
}

template <int kLatch, int kC, int kS, int kRuns>
__global__ void __launch_bounds__(kTileThreads + 32, 3) ring_kernel(const Args a) {
  constexpr int kWarps = kTileThreads / 32;
  constexpr unsigned kRingRuns = (1u << kRuns) - 1u;
  extern __shared__ __align__(128) float ring[];   // [kS][kRuns][kRunSlot]
  __shared__ float s_c[kConsts][kTileThreads];
  __shared__ float s_x[kLatch == kXY ? kCoordsXY : 1][kTileThreads];
  __shared__ int s_id[kTileThreads];
  __shared__ int s_count[2][kWarps];   // by batch parity (an empty batch skips a barrier)
  // full[s]: stage s holds its batch (the batch's bytes landed); empty[s]:
  // every CTA of the cluster has read stage s (one arrival from each)
  __shared__ __align__(8) uint64_t full[kS], empty[kS];

  const size_t b = blockIdx.z;
  const int nf = a.nf;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int col0 = blockIdx.x * kTile;
  const int row0 = blockIdx.y * kTile;  // output row, image row row_start + r
  const int col = col0 + t % kTile;
  const int row = row0 + t / kTile;
  const float s = static_cast<float>(a.size);
  const float xp = pixel_centre(col, s);
  const float yp = pixel_centre(a.row_start + row, s);
  // pixel-centre range of the tile's valid pixels (ragged edge masked; a
  // tile past the image edge has x_hi < x_lo and touches no face)
  const float x_lo = pixel_centre(col0, s);
  const float x_hi = pixel_centre(min(col0 + kTile, a.size) - 1, s);
  const float y_lo = pixel_centre(a.row_start + row0, s);
  const float y_hi = pixel_centre(a.row_start + min(row0 + kTile, a.num_rows) - 1, s);
  const float* vb = a.fvp + b * 9 * (size_t)nf;
  const int batches = (nf + kTileThreads - 1) / kTileThreads;
  const unsigned rank = cluster_rank();

  if (t == 0) {
    for (int k = 0; k < kS; ++k) {
      mbar_init(&full[k], 1);
      mbar_init(&empty[k], kC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // every CTA's barriers exist before any copy or arrival reaches them
  cluster_arrive();
  cluster_wait();
  if (t >= kTileThreads) {
    // the producer warp: each batch into its stage once every CTA of the
    // cluster has released the batch before it there
    const int lane = t - kTileThreads;
    for (int i = 0; i < batches; ++i) {
      if (i >= kS) mbar_wait(&empty[i % kS], (i / kS - 1) & 1);
      issue_batch<kC, kS, kRuns>(vb, nf, i, ring, full, rank, lane);
    }
    return;
  }

  // which runs' entries this thread takes from the ring (bit j), the rest
  // from global memory (< 4 floats at each end of a run, as a rule); the
  // global ones of the next batch load while a batch resolves
  const auto mask_of = [&](int i) {   // batch i: run_plan's body, from the run's offset
    const int len = min(kTileThreads, nf - i * kTileThreads);
    if (len == kTileThreads && t >= 4 && t < kTileThreads - 4) return kRingRuns;
    unsigned mask = 0;
#pragma unroll
    for (int j = 0; j < kRuns; ++j) {
      const RunPlan r = run_plan(vb + (size_t)j * nf, len);   // every batch's a0
      mask |= (t >= r.a0 && t < r.a0 + r.body) ? 1u << j : 0u;
    }
    return mask & kRingRuns;
  };
  const auto load_global = [&](int i, unsigned mask, float* g) {
    const int len = min(kTileThreads, nf - i * kTileThreads);
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      g[j] = (!(mask >> j & 1) && t < len) ? vb[(size_t)j * nf + i * kTileThreads + t] : 0.0f;
    }
  };
  unsigned mask = batches > 0 ? mask_of(0) : 0u;
  float g[9];
  if (batches > 0) load_global(0, mask, g);

  Pixel p = empty_pixel(a.z_far);
  for (int i = 0; i < batches; ++i) {
    const int base = i * kTileThreads;
    const int len = min(kTileThreads, nf - base);
    const float* slots = ring + (i % kS) * kRuns * kRunSlot;
    mbar_wait(&full[i % kS], (i / kS) & 1);
    // face base + t's nine coordinates fvp[b, coord, vertex, f], in the
    // order x0,x1,x2, y0,y1,y2, z0,z1,z2
    float v[9];
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      v[j] = (mask >> j & 1) ? slots[j * kRunSlot + line_offset(vb + (size_t)j * nf) + t] : g[j];
    }
    if (i + 1 < batches) {
      mask = mask_of(i + 1);
      load_global(i + 1, mask, g);
    }

    bool touches = false;
    float c[kConsts];
    if (t < len) {
      // a first bbox test on fminf / fmaxf, which give min_nan's and
      // max_nan's values unless a coordinate is NaN; such a face's det is
      // NaN, so the kill rule drops it either way
      touches = !(fmaxf(fmaxf(v[0], v[1]), v[2]) < x_lo || x_hi < fminf(fminf(v[0], v[1]), v[2]) ||
                  fmaxf(fmaxf(v[3], v[4]), v[5]) < y_lo || y_hi < fminf(fminf(v[3], v[4]), v[5]));
      if (touches) {
        nr_face::constants_xy(v[0], v[3], v[1], v[4], v[2], v[5], c);
        nr_face::kill_invalid(c, a.draw_backside);
        // c[13..16] = xmin, xmax, ymin, ymax (4,-4,4,-4 when killed, which
        // touches no tile)
        touches = !(c[14] < x_lo || x_hi < c[13] || c[16] < y_lo || y_hi < c[15]);
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, touches);
    const int parity = i & 1;
    if (lane == 0) s_count[parity][warp] = __popc(ballot);
    pixels_sync();   // also: every pixel thread of this CTA has read stage i % kS
    // release the stage to every CTA of the cluster, where a later batch
    // will refill it
    if (t == 0 && i + kS < batches) {
      for (unsigned r = 0; r < kC; ++r) mbar_arrive_remote(&empty[i % kS], r);
    }
    int offset = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int n = s_count[parity][w];
      offset += (w < warp) ? n : 0;
      total += n;
    }
    // no face of the batch touches the tile: nothing to stage or test (the
    // counts are double-buffered, so the next batch's cannot overwrite
    // these before every thread has read them)
    if (total > 0) {
      if (touches) {
        const int slot = offset + __popc(ballot & ((1u << lane) - 1u));
        nr_face::constants_z(v[6], v[7], v[8], c);
#pragma unroll
        for (int j = 0; j < kConsts; ++j) s_c[j][slot] = c[j];
        if constexpr (kLatch == kXY) {
          s_x[0][slot] = v[0];
          s_x[1][slot] = v[3];
          s_x[2][slot] = v[1];
          s_x[3][slot] = v[4];
          s_x[4][slot] = v[2];
          s_x[5][slot] = v[5];
        }
        s_id[slot] = base + t;
      }
      pixels_sync();
      for (int k = 0; k < total; ++k) {
        test_face<kLatch, kTileThreads>(&s_c[0][k], &s_x[0][k], &s_id[k], xp, yp, a.z_near,
                                        a.z_far, p);
      }
      pixels_sync();  // the next batch overwrites the staged faces
    }
  }
  write_pixel<kLatch>(a, b, row, col, p);
}

// Dynamic shared memory above 48 KB is refused unless the kernel allows it:
// set it once per card (done: the kernel's flags) where the ring and the
// static shared memory need it.
cudaError_t allow_ring(void (*kernel)(Args), int dynamic_bytes, bool* done) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || device >= kMaxDevices || done[device]) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess && attr.sharedSizeBytes + dynamic_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dynamic_bytes);
  }
  if (err == cudaSuccess) done[device] = true;
  return err;
}

template <int kRuns>
constexpr int ring_bytes(int stages) {
  return stages * kRuns * kRunSlot * static_cast<int>(sizeof(float));
}

template <int kLatch, int kC, int kS, int kRuns>
int launch_ring(const Args& a, void* stream) {
  if (a.bs == 0 || a.size == 0 || a.num_rows == 0) return 0;
  const auto kernel = ring_kernel<kLatch, kC, kS, kRuns>;
  constexpr int kRingBytes = ring_bytes<kRuns>(kS);
  static bool ring_allowed[kMaxDevices] = {};
  cudaError_t err = allow_ring(kernel, kRingBytes, ring_allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (a.size + kTile - 1) / kTile;
  cudaLaunchConfig_t cfg = {};
  // every CTA of a cluster exists: the x extent rounded up to kC
  cfg.gridDim = dim3((tiles_x + kC - 1) / kC * kC, (a.num_rows + kTile - 1) / kTile, a.bs);
  cfg.blockDim = dim3(kTileThreads + 32);   // the pixels and the producer warp
  cfg.dynamicSmemBytes = kRingBytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int kLatch>
int ring_design(int cluster, int stages, int runs, const Args& a, void* stream) {
  switch (cluster * 10000 + stages * 100 + runs) {
    case 10000 + 500 + 9: return launch_ring<kLatch, 1, 5, 9>(a, stream);
    case 20000 + 500 + 9: return launch_ring<kLatch, 2, 5, 9>(a, stream);
    case 40000 + 500 + 9: return launch_ring<kLatch, 4, 5, 9>(a, stream);
    case 80000 + 500 + 9: return launch_ring<kLatch, 8, 5, 9>(a, stream);
    case 20000 + 1600 + 2: return launch_ring<kLatch, 2, 16, 2>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- K8 as a warp per bin --------------------------------------------------

constexpr int kBinWarps = 4;   // the warp-per-bin design's warps (bins at a time) per block

// A unit of a warp's stream: entries base .. base + 31 of bin g (g >= the
// bin count: none), whose n ids start at ids[off].
struct Unit {
  int g, base, n, off;
};

// The bins a warp starts, in order, and the count and offset of the next
// one, loaded while the units before it resolve.
template <bool kDynamic>
struct BinWalk {
  int next, n, off;

  __device__ __forceinline__ void load(const Args& a, int n_bins) {
    n = next < n_bins ? a.bin_cnt[next] : 0;
    off = next < n_bins ? a.bin_off[next] : 0;
  }

  __device__ __forceinline__ void step(const Args& a, int* work, int n_bins, int stride) {
    if constexpr (kDynamic) {
      int k = 0;
      if ((threadIdx.x & 31) == 0) k = atomicAdd(work, 1);
      next = stride + __shfl_sync(0xffffffffu, k, 0);
    } else {
      next += stride;
    }
    load(a, n_bins);
  }

  // the unit after u
  __device__ __forceinline__ Unit after(const Unit& u, const Args& a, int* work, int n_bins,
                                        int stride) {
    if (u.g >= n_bins) return u;
    if (u.base + 32 < u.n) return Unit{u.g, u.base + 32, u.n, u.off};
    const Unit v{next, 0, n, off};
    step(a, work, n_bins, stride);
    return v;
  }
};

// the lane's entry of unit u: its face id, or -1
__device__ __forceinline__ int entry_id(const Args& a, const Unit& u, int n_bins, int lane) {
  return (u.g < n_bins && u.base + lane < u.n) ? a.bin_ids[u.off + u.base + lane] : -1;
}

template <int kLatch, bool kDynamic>
__global__ void __launch_bounds__(kBinWarps * 32) warp_binned_kernel(const Args a, int* work) {
  __shared__ float s_c[kBinWarps][kConsts][32];
  __shared__ float s_x[kBinWarps][kLatch == kXY ? kCoordsXY : 1][32];
  __shared__ int s_id[kBinWarps][32];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nf = a.nf, n_bins = a.bs * a.tiles;
  const int stride = gridDim.x * kBinWarps;
  const float s = static_cast<float>(a.size);
  float* sc = &s_c[warp][0][0];
  float* sx = &s_x[warp][0][0];
  int* sid = s_id[warp];

  // unit i (u0, with its lane's id and coordinates), unit i + 1 (u1, its
  // lane's id), and the next bin to start
  BinWalk<kDynamic> walk{static_cast<int>(blockIdx.x) * kBinWarps + warp, 0, 0};
  walk.load(a, n_bins);
  Unit u0 = walk.after(Unit{-1, 0, 0, 0}, a, work, n_bins, stride);
  Unit u1 = walk.after(u0, a, work, n_bins, stride);
  int id0 = entry_id(a, u0, n_bins, lane), id1 = entry_id(a, u1, n_bins, lane);
  float v0[9];
  load_entry(a.fvp + (size_t)(u0.g / a.tiles) * 9 * nf, nf, id0, v0);

  Pixel p0 = empty_pixel(a.z_far), p1 = empty_pixel(a.z_far);
  while (u0.g < n_bins) {
    // in flight while unit i resolves: unit i + 1's coordinates, unit i +
    // 2's ids, and the count and offset of the bin after
    float v1[9];
    load_entry(a.fvp + (size_t)(u1.g / a.tiles) * 9 * nf, nf, id1, v1);
    const Unit u2 = walk.after(u1, a, work, n_bins, stride);
    const int id2 = entry_id(a, u2, n_bins, lane);

    const int b = u0.g / a.tiles, tile = u0.g - b * a.tiles;
    const int col = (tile % a.tiles_x) * kBinEdge + (lane & 7);
    const int row = (tile / a.tiles_x) * kBinEdge + (lane >> 3);
    const float xp = pixel_centre(col, s);
    const float yp0 = pixel_centre(a.row_start + row, s);
    const float yp1 = pixel_centre(a.row_start + row + 4, s);
    if (id0 >= 0) {
      // every bin entry is live and touches the tile (K7); the kill rule
      // still runs, so any bins give the plain version's bits
      float c[kConsts];
      nr_face::constants_xy(v0[0], v0[3], v0[1], v0[4], v0[2], v0[5], c);
      nr_face::kill_invalid(c, a.draw_backside);
      nr_face::constants_z(v0[6], v0[7], v0[8], c);
#pragma unroll
      for (int j = 0; j < kConsts; ++j) sc[j * 32 + lane] = c[j];
      if constexpr (kLatch == kXY) {
        sx[0 * 32 + lane] = v0[0];
        sx[1 * 32 + lane] = v0[3];
        sx[2 * 32 + lane] = v0[1];
        sx[3 * 32 + lane] = v0[4];
        sx[4 * 32 + lane] = v0[2];
        sx[5 * 32 + lane] = v0[5];
      }
      sid[lane] = id0;
    }
    __syncwarp();
    const int count = min(32, u0.n - u0.base);
    for (int k = 0; k < count; ++k) {
      test_face<kLatch, 32>(sc + k, sx + k, sid + k, xp, yp0, a.z_near, a.z_far, p0);
      test_face<kLatch, 32>(sc + k, sx + k, sid + k, xp, yp1, a.z_near, a.z_far, p1);
    }
    __syncwarp();   // the next unit overwrites the staged faces
    if (u0.base + 32 >= u0.n) {   // the bin's last unit
      write_pixel<kLatch>(a, b, row, col, p0);
      write_pixel<kLatch>(a, b, row + 4, col, p1);
      p0 = empty_pixel(a.z_far);
      p1 = empty_pixel(a.z_far);
    }
    u0 = u1;
    id0 = id1;
#pragma unroll
    for (int j = 0; j < 9; ++j) v0[j] = v1[j];
    u1 = u2;
    id1 = id2;
  }
}

// Persistent warps: as many blocks as the card holds at once (once per
// card), fewer when there are fewer bins.
template <int kLatch, bool kDynamic>
int launch_warp_binned(Args a, int* work, void* stream) {
  if (a.bs == 0 || a.size == 0 || a.num_rows == 0) return 0;
  const auto kernel = warp_binned_kernel<kLatch, kDynamic>;
  static int resident[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[device] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBinWarps * 32, 0);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    resident[device] = max(1, per_sm * sms);
  }
  a.tiles_x = (a.size + kBinEdge - 1) / kBinEdge;
  a.tiles = a.tiles_x * ((a.num_rows + kBinEdge - 1) / kBinEdge);
  const long long bins = (long long)a.bs * a.tiles;
  const long long wanted = (bins + kBinWarps - 1) / kBinWarps;
  const int blocks = static_cast<int>(wanted < resident[device] ? wanted : resident[device]);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (kDynamic) {
    err = cudaMemsetAsync(work, 0, sizeof(int), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<blocks, kBinWarps * 32, 0, s>>>(a, work);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int nr_design_resolve_xy(int cluster, int stages, int runs, const float* fvp,
                                    int* index_out, float* depth_out, float* coords_out, int bs,
                                    int nf, int size, int row_start, int num_rows,
                                    int draw_backside, float z_near, float z_far, void* stream) {
  return ring_design<kXY>(
      cluster, stages, runs,
      make_args(fvp, nullptr, nullptr, nullptr, nullptr, index_out, depth_out, coords_out,
                nullptr, bs, nf, 0, size, row_start, num_rows, draw_backside, z_near, z_far),
      stream);
}

extern "C" int nr_design_resolve_latch(int cluster, int stages, int runs, const float* fvp,
                                       const float* attrs, int* index_out, float* depth_out,
                                       float* coords_out, float* attrs_out, int bs, int nf,
                                       int num_attrs, int size, int row_start, int num_rows,
                                       int draw_backside, float z_near, float z_far,
                                       void* stream) {
  return ring_design<kCopy>(
      cluster, stages, runs,
      make_args(fvp, attrs, nullptr, nullptr, nullptr, index_out, depth_out, coords_out,
                attrs_out, bs, nf, num_attrs, size, row_start, num_rows, draw_backside, z_near,
                z_far),
      stream);
}

extern "C" int nr_design_resolve_depth(int cluster, int stages, int runs, const float* fvp,
                                       int* index_out, float* depth_out, int bs, int nf, int size,
                                       int row_start, int num_rows, int draw_backside,
                                       float z_near, float z_far, void* stream) {
  return ring_design<kNone>(
      cluster, stages, runs,
      make_args(fvp, nullptr, nullptr, nullptr, nullptr, index_out, depth_out, nullptr, nullptr,
                bs, nf, 0, size, row_start, num_rows, draw_backside, z_near, z_far),
      stream);
}

extern "C" int nr_design_binned_xy(int* work, const float* fvp, const int* cnt, const int* off,
                                   const int* ids, int* index_out, float* depth_out,
                                   float* coords_out, int bs, int nf, int size, int row_start,
                                   int num_rows, int draw_backside, float z_near, float z_far,
                                   void* stream) {
  const Args a = make_args(fvp, nullptr, cnt, off, ids, index_out, depth_out, coords_out,
                           nullptr, bs, nf, 0, size, row_start, num_rows, draw_backside, z_near,
                           z_far);
  return work == nullptr ? launch_warp_binned<kXY, false>(a, work, stream)
                         : launch_warp_binned<kXY, true>(a, work, stream);
}

extern "C" int nr_design_binned_latch(int* work, const float* fvp, const float* attrs,
                                      const int* cnt, const int* off, const int* ids,
                                      int* index_out, float* depth_out, float* coords_out,
                                      float* attrs_out, int bs, int nf, int num_attrs, int size,
                                      int row_start, int num_rows, int draw_backside,
                                      float z_near, float z_far, void* stream) {
  const Args a = make_args(fvp, attrs, cnt, off, ids, index_out, depth_out, coords_out,
                           attrs_out, bs, nf, num_attrs, size, row_start, num_rows, draw_backside,
                           z_near, z_far);
  return work == nullptr ? launch_warp_binned<kCopy, false>(a, work, stream)
                         : launch_warp_binned<kCopy, true>(a, work, stream);
}

extern "C" int nr_design_binned_depth(int* work, const float* fvp, const int* cnt,
                                      const int* off, const int* ids, int* index_out,
                                      float* depth_out, int bs, int nf, int size, int row_start,
                                      int num_rows, int draw_backside, float z_near,
                                      float z_far, void* stream) {
  const Args a = make_args(fvp, nullptr, cnt, off, ids, index_out, depth_out, nullptr, nullptr,
                           bs, nf, 0, size, row_start, num_rows, draw_backside, z_near, z_far);
  return work == nullptr ? launch_warp_binned<kNone, false>(a, work, stream)
                         : launch_warp_binned<kNone, true>(a, work, stream);
}
