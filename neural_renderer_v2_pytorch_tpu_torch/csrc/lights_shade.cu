// The lights' per-pixel pass, forward and backward, each in one kernel:
//
//   K15 lights_shade      the shaded RGB [bs, 3, H, W] from the RGB, the
//                         winner's latched vertex normals [bs, 9, H, W]
//                         (plane 3 * vertex + xyz) and the weights
//                         [bs, 3, H, W] under a list of lights: the per-pixel
//                         normal w0 n0 + w1 n1 + w2 n2, the colour weight
//                         the lights give it, summed from 0 in their order,
//                         and its product with the RGB
//   K16 lights_shade_vjp  the shaded RGB's gradient onto the RGB, the nine
//                         normal planes (the weights take none) and, where
//                         asked, the light table: everything K15 computed
//                         recomputed in registers; the table's gradient as
//                         one partial sum per (image, block of pixels,
//                         light, field), which the wrapper adds over the
//                         blocks
//
// Replaces: no kernel of neural_renderer_v2_pytorch_tpu/ops/resolve_pallas.py.
// The JAX package leaves the lights to XLA, which fuses the normals, the
// colour weight and the product into loops over the pixels.  In PyTorch they
// were plain elementwise kernels over whole planes (ops/shading.py,
// normal_planes and color_weight_planes): a [bs, 3, 3, H, W] product for the
// normals, three to six kernels a light for the colour weight, and autograd
// saving the normal map, the colour weight and each light's intensity planes
// to run the chain backwards, with the pow's backward and the broadcasts'
// sums.
//
// The plain versions (resolve_cuda.lights_shade_plain: shading.normal_planes
// and shading.color_weight_planes, the expression these kernels replaced;
// and resolve_cuda.lights_shade_vjp_plain, its VJP derived by hand) are the
// arithmetic these kernels repeat: every product and sum in their order and
// association (no contraction: cuda_build's --fmad=false), torch.relu as
// CUDA's clamp_min (a NaN passes), shading._abs as where(x >= 0, x, -x), the
// specular's base ** alpha by powf as PyTorch's CUDA pow computes it, and the
// gradients as autograd forms them: relu's passes where its output is above
// 0, _abs's is +1 at 0, the pow's is 0 where alpha is 0 and its exponent's 0
// (not NaN) where the base is 0 and alpha >= 0.  So K15 gives its plain
// version's bits on the card, and K16 the plain VJP's bits for the RGB and
// normal gradients; the table's gradient sums the same terms in another
// order (a warp's shuffles, the block's warps in order, the blocks by the
// wrapper's torch.sum), so it agrees with the plain VJP's torch.sum to
// float32 rounding, and gives the same bits on every run.
//
// Bound: memory.  Per pixel, K15 reads RGB (3 floats), the normals (9) and
// the weights (3) and writes RGB (3): 72 bytes.  K16 reads the RGB gradient,
// RGB, normals and weights (72 bytes) and writes the RGB and normal
// gradients (48 bytes): 120 bytes.  The light table is a few floats an
// image.
//
// Design: one thread per (pixel, image), a warp over 32 consecutive pixels,
// so every plane is read and written in coalesced lines, and a plane read
// through its strides (the normals are a slice of the attribute planes,
// read in place).  Every pixel is computed as the plain expression computes
// it, background included: there is no mask.  The forward keeps nothing for
// the backward but its inputs.  The lights come in as launch integers (bit
// l of the directional, specular and backside masks; neither kind bit:
// ambient) and the [bs, L, 7] table (colour, direction, exponent) that the
// wrapper stacks on the card, so a captured step copies nothing from the
// host and reads nothing back; every thread of a block reads the same table
// entries, through the read-only cache.  Where no field takes a gradient,
// K16 makes no partial sums.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "nr_entry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGridY = 65535;
// at most this many lights a launch: one bit each in the kind masks
constexpr int kMaxLights = 64;
// a light's row of the table: colour r, g, b, direction x, y, z, exponent
constexpr int kFields = 7;

// one input's planes: image b's plane k at p + b * batch + k * plane, its
// pixels contiguous
struct Planes {
  const float* p;
  long long batch, plane;
};

// light l is directional where bit l of `directional` is set, specular
// where that of `specular` is, else ambient; `backside` as the light's flag
struct Kinds {
  unsigned long long directional, specular, backside;
};

// torch.relu on CUDA (clamp_min(x, 0)): a NaN passes
__device__ __forceinline__ float relu(float x) { return x != x ? x : fmaxf(x, 0.0f); }

// shading._abs: torch.where(x >= 0, x, -x)
__device__ __forceinline__ float abs_ge(float x) { return x >= 0.0f ? x : -x; }

// A pixel's inputs, read: RGB, the vertex normals n[3 k + c] (vertex k,
// coordinate c) and the weights
struct Pixel {
  float rgb[3], n[9], w[3];
};

__device__ __forceinline__ Pixel read_pixel(const Planes& rgb, const Planes& normals,
                                            const Planes& w, size_t b, int p) {
  Pixel px;
  const float* rb = rgb.p + b * rgb.batch + p;
  const float* nb = normals.p + b * normals.batch + p;
  const float* wb = w.p + b * w.batch + p;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    px.rgb[c] = rb[c * rgb.plane];
    px.w[c] = wb[c * w.plane];
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) px.n[k] = nb[k * normals.plane];
  return px;
}

// shading.normal_planes: N_c = (w0 n0c + w1 n1c) + w2 n2c
__device__ __forceinline__ void normal(const Pixel& px, float N[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    N[c] = (px.w[0] * px.n[c] + px.w[1] * px.n[3 + c]) + px.w[2] * px.n[6 + c];
  }
}

// A directional or specular light's intensity at the normal N
// (shading.light_intensity): pre, the directional dot product ((-d0) N0 +
// (-d1) N1) + (-d2) N2 or the specular's -N2; base, relu(pre) or with
// backside _abs(pre); value, the directional's base or the specular's
// base ** alpha
struct Intensity {
  float pre, base, value;
};

__device__ __forceinline__ Intensity intensity(const float* __restrict__ row, bool directional,
                                               bool backside, const float N[3]) {
  Intensity r;
  if (directional) {
    r.pre = ((-__ldg(row + 3)) * N[0] + (-__ldg(row + 4)) * N[1]) + (-__ldg(row + 5)) * N[2];
  } else {
    r.pre = -N[2];
  }
  r.base = backside ? abs_ge(r.pre) : relu(r.pre);
  r.value = directional ? r.base : powf(r.base, __ldg(row + 6));
  return r;
}

__global__ void __launch_bounds__(kThreads)
lights_shade_kernel(Planes rgb, Planes normals, Planes w, const float* __restrict__ table,
                    float* __restrict__ out, int bs, int P, int L, Kinds kinds) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  for (int b = blockIdx.y; b < bs; b += gridDim.y) {
    const Pixel px = read_pixel(rgb, normals, w, b, p);
    float N[3];
    normal(px, N);
    // the colour weight, from 0 as torch.zeros_like starts it
    float cw[3] = {0.0f, 0.0f, 0.0f};
    const float* row = table + (size_t)b * L * kFields;
    for (int l = 0; l < L; ++l, row += kFields) {
      const bool directional = (kinds.directional >> l) & 1ull;
      const bool specular = (kinds.specular >> l) & 1ull;
      if (!directional && !specular) {
#pragma unroll
        for (int c = 0; c < 3; ++c) cw[c] = cw[c] + __ldg(row + c);
        continue;
      }
      const Intensity it = intensity(row, directional, (kinds.backside >> l) & 1ull, N);
#pragma unroll
      for (int c = 0; c < 3; ++c) cw[c] = cw[c] + it.value * __ldg(row + c);
    }
    float* o = out + (size_t)b * 3 * P + p;
#pragma unroll
    for (int c = 0; c < 3; ++c) o[(size_t)c * P] = px.rgb[c] * cw[c];
  }
}

__global__ void __launch_bounds__(kThreads)
lights_shade_vjp_kernel(const float* __restrict__ grad, Planes rgb, Planes normals, Planes w,
                        const float* __restrict__ table, float* __restrict__ g_rgb,
                        float* __restrict__ g_normals, float* __restrict__ partials, int bs,
                        int P, int L, Kinds kinds) {
  // each warp's sums of the table's terms, light l's field j at l * kFields + j
  __shared__ float sums[kWarps][kMaxLights * kFields];
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const bool live = p < P;
  // with partial sums every thread of the block takes part in them
  if (!live && partials == nullptr) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int b = blockIdx.y; b < bs; b += gridDim.y) {
    Pixel px = {};
    float g[3] = {0.0f, 0.0f, 0.0f};
    if (live) {
      px = read_pixel(rgb, normals, w, b, p);
      const float* gb = grad + (size_t)b * 3 * P + p;
#pragma unroll
      for (int c = 0; c < 3; ++c) g[c] = gb[(size_t)c * P];
    }
    float N[3];
    normal(px, N);
    // out = rgb * cw: the colour weight's gradient g * rgb
    float g_cw[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) g_cw[c] = g[c] * px.rgb[c];
    float cw[3] = {0.0f, 0.0f, 0.0f}, gN[3] = {0.0f, 0.0f, 0.0f};
    const float* row = table + (size_t)b * L * kFields;
    for (int l = 0; l < L; ++l, row += kFields) {
      const bool directional = (kinds.directional >> l) & 1ull;
      const bool specular = (kinds.specular >> l) & 1ull;
      float col[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) col[c] = __ldg(row + c);
      // this pixel's terms of the row's gradient
      float term[kFields] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (!directional && !specular) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          cw[c] = cw[c] + col[c];
          term[c] = g_cw[c];
        }
      } else {
        const bool backside = (kinds.backside >> l) & 1ull;
        const Intensity it = intensity(row, directional, backside, N);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          cw[c] = cw[c] + it.value * col[c];
          term[c] = g_cw[c] * it.value;
        }
        // the intensity's gradient: the colour's channels against g_cw
        const float gi = (g_cw[0] * col[0] + g_cw[1] * col[1]) + g_cw[2] * col[2];
        float gbase = gi;
        if (specular) {
          // pow's backward: self's 0 where alpha is 0, the exponent's 0
          // where the base is 0 and alpha >= 0
          const float a = __ldg(row + 6);
          gbase = a == 0.0f ? 0.0f : gi * (a * powf(it.base, a - 1.0f));
          term[6] = gi * ((it.base == 0.0f && a >= 0.0f) ? 0.0f : it.value * logf(it.base));
        }
        // _abs's gradient +-1 (+1 at 0); relu's passes where its output
        // is above 0 (threshold_backward on the output)
        const float gpre = backside ? (it.pre >= 0.0f ? gbase : -gbase)
                                    : (it.base <= 0.0f ? 0.0f : gbase);
        if (directional) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            gN[c] = gN[c] + gpre * (-__ldg(row + 3 + c));
            term[3 + c] = -(gpre * N[c]);
          }
        } else {
          gN[2] = gN[2] + (-gpre);
        }
      }
      if (partials != nullptr) {
#pragma unroll
        for (int j = 0; j < kFields; ++j) {
          float v = live ? term[j] : 0.0f;
#pragma unroll
          for (int offset = 16; offset > 0; offset >>= 1) {
            v = v + __shfl_down_sync(0xffffffffu, v, offset);
          }
          if (lane == 0) sums[warp][l * kFields + j] = v;
        }
      }
    }
    if (live) {
      const size_t at = (size_t)b * 3 * P + p;
      if (g_rgb != nullptr) {
#pragma unroll
        for (int c = 0; c < 3; ++c) g_rgb[at + (size_t)c * P] = g[c] * cw[c];
      }
      if (g_normals != nullptr) {
        float* gn = g_normals + (size_t)b * 9 * P + p;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
#pragma unroll
          for (int c = 0; c < 3; ++c) gn[(size_t)(3 * k + c) * P] = gN[c] * px.w[k];
        }
      }
    }
    if (partials != nullptr) {
      __syncthreads();
      float* out = partials + ((size_t)b * gridDim.x + blockIdx.x) * L * kFields;
      for (int i = threadIdx.x; i < L * kFields; i += kThreads) {
        float s = sums[0][i];
#pragma unroll
        for (int k = 1; k < kWarps; ++k) s = s + sums[k][i];
        out[i] = s;
      }
      __syncthreads();
    }
  }
}

dim3 pixel_grid(int P, int bs) {
  return dim3((P + kThreads - 1) / kThreads, bs < kMaxGridY ? bs : kMaxGridY);
}

// rgb: f32, image b's three planes at rgb + b * rgb_batch + k * rgb_plane,
// each [P] contiguous (P = H * W); normals: the nine vertex-normal planes
// likewise; weights: the three weight planes likewise; table: f32 [bs, L, 7]
// contiguous (colour, direction, exponent a light); L <= 64 lights, their
// kinds in the masks (bit l: light l; neither kind bit: ambient); out: f32
// [bs, 3, P].  Returns cudaGetLastError().
int lights_shade(void* stream, const float* rgb, const float* normals, const float* weights,
                 const float* table, float* out, int bs, int P, int L, long long directional,
                 long long specular, long long backside, long long rgb_batch,
                 long long rgb_plane, long long normals_batch, long long normals_plane,
                 long long weights_batch, long long weights_plane) {
  if (bs == 0 || P == 0) return 0;
  if (L < 0 || L > kMaxLights) return static_cast<int>(cudaErrorInvalidValue);
  lights_shade_kernel<<<pixel_grid(P, bs), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      Planes{rgb, rgb_batch, rgb_plane}, Planes{normals, normals_batch, normals_plane},
      Planes{weights, weights_batch, weights_plane}, table, out, bs, P, L,
      Kinds{static_cast<unsigned long long>(directional),
            static_cast<unsigned long long>(specular), static_cast<unsigned long long>(backside)});
  return static_cast<int>(cudaGetLastError());
}

// grad: f32 [bs, 3, P], the shaded RGB's gradient; rgb, normals, weights,
// table and the masks as lights_shade; g_rgb: f32 [bs, 3, P], g_normals: f32
// [bs, 9, P], each null where not asked for (not written); partials: f32
// [bs, ceil(P / 256), L, 7], the table gradient's sum over each block of
// 256 pixels, or null.  Returns cudaGetLastError().
int lights_shade_vjp(void* stream, const float* grad, const float* rgb, const float* normals,
                     const float* weights, const float* table, float* g_rgb, float* g_normals,
                     float* partials, int bs, int P, int L, long long directional,
                     long long specular, long long backside, long long rgb_batch,
                     long long rgb_plane, long long normals_batch, long long normals_plane,
                     long long weights_batch, long long weights_plane) {
  if (bs == 0 || P == 0) return 0;
  if (L < 0 || L > kMaxLights) return static_cast<int>(cudaErrorInvalidValue);
  lights_shade_vjp_kernel<<<pixel_grid(P, bs), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      grad, Planes{rgb, rgb_batch, rgb_plane}, Planes{normals, normals_batch, normals_plane},
      Planes{weights, weights_batch, weights_plane}, table, g_rgb, g_normals, partials, bs, P,
      L,
      Kinds{static_cast<unsigned long long>(directional),
            static_cast<unsigned long long>(specular), static_cast<unsigned long long>(backside)});
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

NR_PACKED_ENTRY(lights_shade)
NR_PACKED_ENTRY(lights_shade_vjp)
