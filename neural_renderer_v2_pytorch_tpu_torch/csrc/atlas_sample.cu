// The loaded-atlas texture sampler, forward and backward, each in one kernel:
//
//   K13 atlas_sample      RGB [bs, 3, H, W] from the winner's vertex depths,
//                         texel-coordinate triangle and weights: the
//                         perspective-correct texel coordinates, their clamp
//                         into the triangle's uv-bbox minus eps, the four
//                         bilinear taps and their weighted sum; 0 on
//                         background
//   K14 atlas_sample_vjp  the RGB gradient onto the depths, the texel
//                         coordinates (and the weights, where asked) and the
//                         atlas: everything K13 computed recomputed in
//                         registers, and each tap's three channels added at
//                         its own texel of the [bs, 3, T] atlas gradient, as
//                         K6 (atlas_taps_grad.cu) adds them
//
// Replaces: no kernel of neural_renderer_v2_pytorch_tpu/ops/resolve_pallas.py.
// The JAX package leaves the sampler's arithmetic to XLA, which fuses it into
// loops over the pixels around the taps' gathers and _scatter_rows_kernel
// (K6's counterpart).  In PyTorch it was some 60 elementwise kernels each
// way over whole planes: the forward kept x, y, the tap weights and the taps
// [bs, 4, 3, H, W] alive for the backward, and the backward filled a
// zero tensor of its base's shape for every plane or tap it selected and
// summed them with autograd's adds (ops/shading.py, _AtlasSample).
//
// The plain versions (resolve_cuda.atlas_sample_plain: shading._uv_coords,
// _bilinear_taps, the clamped anchors' gather and Python's sum; and
// resolve_cuda.atlas_sample_vjp_plain, the VJP derived by hand) are the
// arithmetic these kernels repeat: K13 forms every product, quotient and sum
// in their order and association (no contraction: cuda_build's
// --fmad=false), the 1e-10 terms and eps rounded to float32 as PyTorch
// rounds a Python scalar, torch.minimum/maximum's NaN rules, and the sum of
// the taps from 0 as Python's sum starts it (so a -0 tap sum reads +0); on
// the card K13 gives its plain version's bits.  K14 repeats the plain VJP's
// derivation (torch.minimum/maximum's even split of the gradient at ties,
// floor's zero gradient, the foreground mask) in its order and association,
// so its depth, texel-coordinate and weight gradients are the plain
// version's bits too; its atlas adds are atomics, in another order on every
// run, so the atlas gradient agrees with any exact-order sum to float32
// rounding.
//
// Bound: memory.  Per pixel, K13 reads the index map and writes RGB (16
// bytes); a covered pixel also reads three depths, six texel coordinates
// and three weights (48 bytes) and its four taps of three channels from the
// atlas.  K14 reads the index map and the RGB gradient and writes the depth
// and texel-coordinate gradients (52 bytes; 64 with the weights'); a
// covered pixel also reads what K13 read and adds 12 floats into the atlas
// gradient, which its caller zero-fills (12 bytes a texel and image).  The
// atlas at 1190 x 1920 texels is 27 MB, and at the benchmark's shapes every
// image reads the same one (batch stride 0), so its taps mostly come from
// the 50 MB L2.
//
// Design: one thread per (pixel, image), a warp over 32 consecutive pixels,
// so every plane is read and written in coalesced lines; a background
// pixel's thread reads its index and writes zeros.  The forward keeps no
// plane for the backward (its inputs are what the backward reads again, as
// K10 and K11 share the winner planes).  K14's atlas adds are K6's: in each
// channel plane the taps a and a + 1 are neighbours, and so are a + tw and
// a + tw + 1; where such a pair is 8-byte aligned it goes as one float2
// atomicAdd, else as two float ones, and with no result used each compiles
// to a reduction (RED).  The anchor is clamped to [0, T - tw - 2] as a unit,
// so every tap lies in the atlas.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "nr_entry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;
// the Python scalars 1e-10 of shading._uv_coords, rounded to float32 as
// PyTorch rounds a scalar operand of a float32 tensor
constexpr float kTiny = static_cast<float>(1e-10);

// one input's planes: image b's plane k at p + b * batch + k * plane, its
// pixels contiguous
struct Planes {
  const float* p;
  long long batch, plane;
};

// torch.minimum and torch.maximum on CUDA: a NaN operand wins, the first
// one first
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// the gradients of torch.minimum(a, b) (min) or torch.maximum(a, b) with
// respect to a and b: g split evenly at a tie, all to the operand taken (to
// both where a NaN makes every comparison false)
__device__ __forceinline__ void min_grad(float a, float b, float g, float& ga, float& gb) {
  if (a == b) {
    ga = gb = g / 2.0f;
  } else {
    ga = a > b ? 0.0f : g;
    gb = a < b ? 0.0f : g;
  }
}

__device__ __forceinline__ void max_grad(float a, float b, float g, float& ga, float& gb) {
  if (a == b) {
    ga = gb = g / 2.0f;
  } else {
    ga = a < b ? 0.0f : g;
    gb = a > b ? 0.0f : g;
  }
}

// The perspective-correct weights shared by both texel coordinates:
// zz_k = z_k + 1e-10, and depth = 1 / (w0 / zz0 + 1e-10 + w1 / zz1 + 1e-10
// + w2 / zz2 + 1e-10), summed left to right
struct Depth {
  float zz[3], depth;
};

__device__ __forceinline__ Depth perspective(const float z[3], const float w[3]) {
  Depth d;
  float a[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    d.zz[k] = z[k] + kTiny;
    a[k] = w[k] / d.zz[k];
  }
  float s = a[0] + kTiny;
  s = s + a[1];
  s = s + kTiny;
  s = s + a[2];
  s = s + kTiny;
  // 1.0 / tensor: PyTorch's reciprocal, then a multiply by 1.0
  d.depth = (1.0f / s) * 1.0f;
  return d;
}

// One texel coordinate's chain (shading._uv_coords's interp): the
// perspective-correct interpolation val of the triangle's coordinates c,
// clamped into [lo, hi] with lo = min(min(c0, c1), c2) and hi =
// max(max(c0, c1), c2) - eps, as torch.minimum(hi, torch.maximum(lo, val))
struct Coord {
  float s, val, mn01, lo, mx01, hmax, hi, m, out;
};

__device__ __forceinline__ Coord interp(const float c[3], const float w[3], const Depth& d,
                                        float eps) {
  Coord r;
  const float q0 = (w[0] * c[0]) / d.zz[0];
  const float q1 = (w[1] * c[1]) / d.zz[1];
  const float q2 = (w[2] * c[2]) / d.zz[2];
  r.s = (q0 + q1) + q2;
  r.val = r.s * d.depth;
  r.mn01 = tmin(c[0], c[1]);
  r.lo = tmin(r.mn01, c[2]);
  r.mx01 = tmax(c[0], c[1]);
  r.hmax = tmax(r.mx01, c[2]);
  r.hi = r.hmax - eps;
  r.m = tmax(r.lo, r.val);
  r.out = tmin(r.hi, r.m);
  return r;
}

// The four bilinear taps of texel coordinates (x, y) (shading.
// _bilinear_taps): the weights (floor/floor, floor-y/ceil-x, ceil-y/floor-x,
// ceil/ceil), the partial weights they are products of, and the anchor
// texel y0 * tw + x0 (int32, wrapping as PyTorch's int32 product does),
// clamped to [0, T - tw - 2]
struct Taps {
  float wx0, wx1, wy0, wy1, t[4];
  int anchor;
};

__device__ __forceinline__ Taps bilinear(float x, float y, int tw, int T) {
  Taps r;
  const float x0f = floorf(x), y0f = floorf(y);
  r.wx0 = (x0f + 1.0f) - x;
  r.wx1 = x - x0f;
  r.wy0 = (y0f + 1.0f) - y;
  r.wy1 = y - y0f;
  r.t[0] = r.wy0 * r.wx0;
  r.t[1] = r.wy0 * r.wx1;
  r.t[2] = r.wy1 * r.wx0;
  r.t[3] = r.wy1 * r.wx1;
  const unsigned idx = static_cast<unsigned>(static_cast<int>(y0f)) * static_cast<unsigned>(tw) +
                       static_cast<unsigned>(static_cast<int>(x0f));
  r.anchor = min(max(static_cast<int>(idx), 0), T - tw - 2);
  return r;
}

// A covered pixel's inputs, read: depths z, texel coordinates u and v (the
// triangle's u0, v0, u1, v1, u2, v2 planes), weights w
struct Pixel {
  float z[3], u[3], v[3], w[3];
};

__device__ __forceinline__ Pixel read_pixel(const Planes& z, const Planes& uv, const Planes& w,
                                            size_t b, int p) {
  Pixel px;
  const float* zb = z.p + b * z.batch + p;
  const float* uvb = uv.p + b * uv.batch + p;
  const float* wb = w.p + b * w.batch + p;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    px.z[k] = zb[k * z.plane];
    px.u[k] = uvb[(2 * k) * uv.plane];
    px.v[k] = uvb[(2 * k + 1) * uv.plane];
    px.w[k] = wb[k * w.plane];
  }
  return px;
}

// the four taps' three channels, tap i's channel c in tap[3 i + c]
__device__ __forceinline__ void read_taps(const float* __restrict__ atlas, int anchor, int tw,
                                          int T, float tap[12]) {
  const int off[4] = {0, 1, tw, tw + 1};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      tap[3 * i + c] = __ldg(atlas + (size_t)c * T + anchor + off[i]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
atlas_sample_kernel(Planes z, Planes uv, Planes w, const int* __restrict__ index,
                    const float* __restrict__ atlas, long long atlas_batch,
                    float* __restrict__ out, int bs, int P, int tw, int T, float eps) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  for (int b = blockIdx.y; b < bs; b += gridDim.y) {
    float* o = out + (size_t)b * 3 * P + p;
    if (index[(size_t)b * P + p] < 0) {
      o[0] = o[P] = o[2 * (size_t)P] = 0.0f;
      continue;
    }
    const Pixel px = read_pixel(z, uv, w, b, p);
    const Depth d = perspective(px.z, px.w);
    const Coord cx = interp(px.u, px.w, d, eps), cy = interp(px.v, px.w, d, eps);
    const Taps t = bilinear(cx.out, cy.out, tw, T);
    float tap[12];
    read_taps(atlas + b * atlas_batch, t.anchor, tw, T, tap);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      // Python's sum: 0 + the first term, then the others in order
      float acc = 0.0f + t.t[0] * tap[c];
      acc = acc + t.t[1] * tap[3 + c];
      acc = acc + t.t[2] * tap[6 + c];
      acc = acc + t.t[3] * tap[9 + c];
      o[(size_t)c * P] = acc;
    }
  }
}

// out[0] += x, and out[1] += y (K6's pairing)
__device__ __forceinline__ void add_pair(float* out, float x, float y) {
  if ((reinterpret_cast<std::uintptr_t>(out) & 7) == 0) {
    atomicAdd(reinterpret_cast<float2*>(out), make_float2(x, y));
  } else {
    atomicAdd(out, x);
    atomicAdd(out + 1, y);
  }
}

// The VJP of one texel coordinate's chain: its output's gradient g onto
// the triangle's coordinates (gc), the weights (gw), the zz_k (gzz) and the
// depth (returned), each sum in resolve_cuda._coord_vjp's order
__device__ __forceinline__ float interp_vjp(const float c[3], const float w[3], const Depth& d,
                                            const Coord& r, float g, float gc[3], float gw[3],
                                            float gzz[3]) {
  // out = minimum(hi, m); m = maximum(lo, val)
  float ghi, gm, glo, gval;
  min_grad(r.hi, r.m, g, ghi, gm);
  max_grad(r.lo, r.val, gm, glo, gval);
  // hi = maximum(maximum(c0, c1), c2) - eps; lo = minimum(minimum(c0, c1), c2)
  float gmx01, g0_hi, g1_hi, g2_hi, gmn01, g0_lo, g1_lo, g2_lo;
  max_grad(r.mx01, c[2], ghi, gmx01, g2_hi);
  max_grad(c[0], c[1], gmx01, g0_hi, g1_hi);
  min_grad(r.mn01, c[2], glo, gmn01, g2_lo);
  min_grad(c[0], c[1], gmn01, g0_lo, g1_lo);
  gc[0] = g0_hi + g0_lo;
  gc[1] = g1_hi + g1_lo;
  gc[2] = g2_hi + g2_lo;
  // val = s * depth, s = q0 + q1 + q2, q_k = (w_k * c_k) / zz_k
  const float gs = gval * d.depth;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float wc = w[k] * c[k];
    const float gwc = gs / d.zz[k];
    gc[k] = gc[k] + gwc * w[k];
    gw[k] = gwc * c[k];
    gzz[k] = ((-gs) * wc) / (d.zz[k] * d.zz[k]);
  }
  return gval * r.s;
}

__global__ void __launch_bounds__(kThreads)
atlas_sample_vjp_kernel(const float* __restrict__ grad, Planes z, Planes uv, Planes w,
                        const int* __restrict__ index, const float* __restrict__ atlas,
                        long long atlas_batch, float* __restrict__ gz, float* __restrict__ guv,
                        float* __restrict__ gw_out, float* __restrict__ gatlas, int bs, int P,
                        int tw, int T, float eps) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  for (int b = blockIdx.y; b < bs; b += gridDim.y) {
    float* gzb = gz == nullptr ? nullptr : gz + (size_t)b * 3 * P + p;
    float* guvb = guv == nullptr ? nullptr : guv + (size_t)b * 6 * P + p;
    float* gwb = gw_out == nullptr ? nullptr : gw_out + (size_t)b * 3 * P + p;
    if (index[(size_t)b * P + p] < 0) {
      // the foreground mask: a background pixel's gradient is 0
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        if (gzb != nullptr) gzb[(size_t)k * P] = 0.0f;
        if (gwb != nullptr) gwb[(size_t)k * P] = 0.0f;
      }
      if (guvb != nullptr) {
#pragma unroll
        for (int k = 0; k < 6; ++k) guvb[(size_t)k * P] = 0.0f;
      }
      continue;
    }
    const float* gb = grad + (size_t)b * 3 * P + p;
    const float g[3] = {gb[0], gb[P], gb[2 * (size_t)P]};
    const Pixel px = read_pixel(z, uv, w, b, p);
    const Depth d = perspective(px.z, px.w);
    const Coord cx = interp(px.u, px.w, d, eps), cy = interp(px.v, px.w, d, eps);
    const Taps t = bilinear(cx.out, cy.out, tw, T);
    float tap[12];
    read_taps(atlas + b * atlas_batch, t.anchor, tw, T, tap);

    // the atlas: tap i's channel c takes g_c * t_i at its texel
    if (gatlas != nullptr) {
      float* ob = gatlas + (size_t)b * 3 * T + t.anchor;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float* plane = ob + (size_t)c * T;
        add_pair(plane, g[c] * t.t[0], g[c] * t.t[1]);
        add_pair(plane + tw, g[c] * t.t[2], g[c] * t.t[3]);
      }
    }
    // the tap weights: t_i's gradient is its taps' channels against g
    float gt[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      gt[i] = (g[0] * tap[3 * i] + g[1] * tap[3 * i + 1]) + g[2] * tap[3 * i + 2];
    }
    // wx0 = x0f + 1 - x and wx1 = x - x0f, floor's gradient 0
    const float gx = (gt[1] * t.wy0 + gt[3] * t.wy1) - (gt[0] * t.wy0 + gt[2] * t.wy1);
    const float gy = (gt[2] * t.wx0 + gt[3] * t.wx1) - (gt[0] * t.wx0 + gt[1] * t.wx1);

    float gu[3], gv[3], gw_u[3], gw_v[3], gzz_u[3], gzz_v[3];
    const float gdepth_u = interp_vjp(px.u, px.w, d, cx, gx, gu, gw_u, gzz_u);
    const float gdepth_v = interp_vjp(px.v, px.w, d, cy, gy, gv, gw_v, gzz_v);
    // depth = 1 / S: S's gradient -gdepth * depth^2 reaches each w_k / zz_k
    const float gS = (-(gdepth_u + gdepth_v)) * (d.depth * d.depth);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (gzb != nullptr) {
        gzb[(size_t)k * P] = (gzz_u[k] + gzz_v[k]) + ((-gS) * px.w[k]) / (d.zz[k] * d.zz[k]);
      }
      if (gwb != nullptr) gwb[(size_t)k * P] = (gw_u[k] + gw_v[k]) + gS / d.zz[k];
      if (guvb != nullptr) {
        guvb[(size_t)(2 * k) * P] = gu[k];
        guvb[(size_t)(2 * k + 1) * P] = gv[k];
      }
    }
  }
}

dim3 pixel_grid(int P, int bs) {
  return dim3((P + kThreads - 1) / kThreads, bs < kMaxGridY ? bs : kMaxGridY);
}

// z: f32, image b's three depth planes at z + b * z_batch + k * z_plane,
// each [P] contiguous (P = H * W); uv: the six planes u0, v0, u1, v1, u2, v2
// likewise; w: the three weight planes likewise; index: i32 [bs, P]; atlas:
// f32, image b's [3, T] (T = th * tw) contiguous from atlas + b *
// atlas_batch (0: one atlas for every image); out: f32 [bs, 3, P].  T >= tw
// + 2.  Returns cudaGetLastError().
int atlas_sample(void* stream, const float* z, const float* uv, const float* w,
                 const int* index, const float* atlas, float* out, int bs, int P, int tw, int T,
                 long long z_batch, long long z_plane, long long uv_batch, long long uv_plane,
                 long long w_batch, long long w_plane, long long atlas_batch, float eps) {
  if (bs == 0 || P == 0) return 0;
  atlas_sample_kernel<<<pixel_grid(P, bs), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      Planes{z, z_batch, z_plane}, Planes{uv, uv_batch, uv_plane}, Planes{w, w_batch, w_plane},
      index, atlas, atlas_batch, out, bs, P, tw, T, eps);
  return static_cast<int>(cudaGetLastError());
}

// grad: f32 [bs, 3, P], RGB's gradient; z, uv, w, index, atlas as
// atlas_sample; gz: f32 [bs, 3, P], guv: f32 [bs, 6, P], gw: f32 [bs, 3, P],
// each null where not asked for (not written); gatlas: f32 [bs, 3, T],
// zeroed by the caller, or null.  Returns cudaGetLastError().
int atlas_sample_vjp(void* stream, const float* grad, const float* z, const float* uv,
                     const float* w, const int* index, const float* atlas, float* gz,
                     float* guv, float* gw, float* gatlas, int bs, int P, int tw, int T,
                     long long z_batch, long long z_plane, long long uv_batch,
                     long long uv_plane, long long w_batch, long long w_plane,
                     long long atlas_batch, float eps) {
  if (bs == 0 || P == 0) return 0;
  atlas_sample_vjp_kernel<<<pixel_grid(P, bs), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      grad, Planes{z, z_batch, z_plane}, Planes{uv, uv_batch, uv_plane},
      Planes{w, w_batch, w_plane}, index, atlas, atlas_batch, gz, guv, gw, gatlas, bs, P, tw, T,
      eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

NR_PACKED_ENTRY(atlas_sample)
NR_PACKED_ENTRY(atlas_sample_vjp)
