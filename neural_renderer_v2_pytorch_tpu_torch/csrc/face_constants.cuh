// The per-face math of the z-buffer resolve, in one place: the 17 constants
// of face_constants_planar (neural_renderer_v2_pytorch_tpu_torch/ops/
// resolve.py), NaN-propagating min/max, and the kill rule of kill_invalid.
//
//   c[0..8]   A0,B0,C0, A1,B1,C1, A2,B2,C2   (w_i = yp * A_i + xp * B_i + C_i)
//   c[9..11]  1/z0, 1/z1, 1/z2
//   c[12]     det = C0 + C1 + C2
//   c[13..16] xmin, xmax, ymin, ymax
//
// K1 (face_setup.cu) writes them for every face; the resolve forms
// (resolve.cu) compute them while staging faces (tiled: the x/y part and
// the kill rule for each face whose bbox touches the tile, the 1/z part for
// those that still touch it after the kill rule; binned: all of them for
// each bin entry), and K7 (bin_faces.cu) the x/y part and the kill rule for
// each face's bbox.  All include this header and build with --fmad=false
// and correctly rounded division, so the same expressions give the same
// bits, which are the plain version's: each expression is the plain
// version's, in its order.

#pragma once

#include <cuda_runtime.h>

namespace nr_face {

constexpr int kConsts = 17;
constexpr float kDegenerateEps = 1e-8f;

// torch.minimum / torch.maximum (and jnp's) propagate NaN; fminf does not.
__device__ __forceinline__ float min_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return (b < a) ? b : a;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return (a < b) ? b : a;
}

// c[0..8], c[12] and c[13..16]: everything but 1/z, from the screen
// coordinates alone.
__device__ __forceinline__ void constants_xy(float x0, float y0, float x1, float y1, float x2,
                                             float y2, float* c) {
  const float C0 = x1 * y2 - x2 * y1;
  const float C1 = x2 * y0 - x0 * y2;
  const float C2 = x0 * y1 - x1 * y0;
  c[0] = x2 - x1;
  c[1] = y1 - y2;
  c[2] = C0;
  c[3] = x0 - x2;
  c[4] = y2 - y0;
  c[5] = C1;
  c[6] = x1 - x0;
  c[7] = y0 - y1;
  c[8] = C2;
  c[12] = C0 + C1 + C2;
  c[13] = min_nan(min_nan(x0, x1), x2);
  c[14] = max_nan(max_nan(x0, x1), x2);
  c[15] = min_nan(min_nan(y0, y1), y2);
  c[16] = max_nan(max_nan(y0, y1), y2);
}

// c[9..11]
__device__ __forceinline__ void constants_z(float z0, float z1, float z2, float* c) {
  c[9] = 1.0f / z0;
  c[10] = 1.0f / z1;
  c[11] = 1.0f / z2;
}

// The kill rule: a face with |det| < 1e-8 (or a NaN det) can never win a
// pixel, and nor, unless draw_backside, can a backfacing one
// (B1 * A2 < B2 * A1); their bbox becomes 4,-4,4,-4, which no pixel
// centre's strict bbox test passes.  Returns whether the face lives.
__device__ __forceinline__ bool kill_invalid(float* c, int draw_backside) {
  bool valid = fabsf(c[12]) >= kDegenerateEps;
  if (!draw_backside) valid = valid && !(c[4] * c[6] < c[7] * c[3]);
  if (!valid) {
    c[13] = 4.0f;
    c[14] = -4.0f;
    c[15] = 4.0f;
    c[16] = -4.0f;
  }
  return valid;
}

}  // namespace nr_face
