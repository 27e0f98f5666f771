// The guide's two collision terms at one waypoint, as device code shared
// by collision_guide.cu (one guide evaluation a launch) and guide_loop.cu
// (a diffusion step's whole guide loop a launch). Both kernels compute
//
//   w * clip(d/dq objects(q)) + w * clip(d/dq boundaries(q))
//
// at an inner waypoint q = (x, y), unnormalized, where objects() is
// relu(margin - min(sdf0, sdf1)) on the scene's two SDF grids with the
// grid's surrogate gradient, boundaries() is the max over the four walls
// of relu(margin - signed distance), and clip() is the guide's
// per-waypoint norm clip with the `+ 1e-6` quirk. The plain PyTorch
// version is `collision_guide_plain` in mmd_torch/costs/guide.py.
//
// Arithmetic: the plain version's float32 operations in its order, with
// round-to-nearest intrinsics (and --fmad=false at build time, so that
// nothing is contracted). The cell index is grid_sdf.cu's,
// floor((x - lo) / span * n) clamped to [0, n - 1], so the cell is the JAX
// cell bit for bit. Ties split the gradient as torch and JAX do: 0.5/0.5
// between the two grids (torch.minimum), evenly among the walls that share
// the max (torch.amax), and relu(x) = max(x, 0) has gradient 0.5 at x = 0
// (torch.maximum). The clip's norm is taken over all four channels of
// g + 1e-6, as (a^2 + b^2) + (c^2 + d^2).
//
// Cells: a scene's two grids are one table of 32-byte records (v0, g0x,
// g0y, v1, g1x, g1y, 0, 0), read as two aligned float4 loads from one L2
// sector (`packed_cells` in mmd_torch/ops/sdf_kernel.py).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mmd {

constexpr float kClipEps = 1e-6f;

// A scene's table and constants as both kernels read them.
struct CollisionScene {
  int n0, n1;                    // grid cells a side
  float lo0, lo1, span0, span1;  // grid box
  float wall_lo0, wall_lo1, wall_hi0, wall_hi1;
  float margin, weight, max_norm;
};

__device__ __forceinline__ int cell_of(float x, float lo, float span, int n) {
  float f = floorf(__fmul_rn(__fdiv_rn(__fsub_rn(x, lo), span), (float)n));
  f = fminf(fmaxf(f, 0.0f), (float)(n - 1));
  return (int)f;
}

// d/dx of max(x, 0) times g, as torch.maximum's backward computes it.
__device__ __forceinline__ float relu_grad(float x, float g) {
  return x > 0.0f ? g : (x == 0.0f ? __fmul_rn(g, 0.5f) : 0.0f);
}

// The guide's _finish on one inner waypoint (g.x, g.y, g.z, g.w): scale by
// min(||g + 1e-6||, max_norm) / ||g + 1e-6||.
__device__ __forceinline__ float4 clip4(float4 g, float max_norm) {
  const float a = __fadd_rn(g.x, kClipEps), b = __fadd_rn(g.y, kClipEps);
  const float c = __fadd_rn(g.z, kClipEps), d = __fadd_rn(g.w, kClipEps);
  const float sq = __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)),
                             __fadd_rn(__fmul_rn(c, c), __fmul_rn(d, d)));
  const float norm = __fsqrt_rn(sq);
  const float scale = __fdiv_rn(fminf(fmaxf(norm, 0.0f), max_norm), norm);
  return make_float4(__fmul_rn(g.x, scale), __fmul_rn(g.y, scale),
                     __fmul_rn(g.z, scale), __fmul_rn(g.w, scale));
}

// clip4 of (gx, gy, 0, 0), then the weight: a position-only term.
__device__ __forceinline__ float2 clip_and_weigh(float gx, float gy,
                                                 float max_norm, float w) {
  const float4 c = clip4(make_float4(gx, gy, 0.0f, 0.0f), max_norm);
  return make_float2(__fmul_rn(w, c.x), __fmul_rn(w, c.y));
}

// Both collision terms at an inner waypoint (x, y), each clipped and
// weighted, summed; `cells` is the waypoint's scene's table.
__device__ __forceinline__ float2 collision_step(
    float x, float y, const float4* __restrict__ cells,
    const CollisionScene& s) {
  // Objects: relu(margin - min(v0, v1)); the gradient of the smaller grid's
  // cell (both halves on a tie) times the cell gradients.
  const int64_t cell = (int64_t)cell_of(x, s.lo0, s.span0, s.n0) * s.n1 +
                       cell_of(y, s.lo1, s.span1, s.n1);
  const float4 c0 = __ldg(cells + 2 * cell);      // v0, g0x, g0y, v1
  const float4 c1 = __ldg(cells + 2 * cell + 1);  // g1x, g1y, 0, 0
  const float v0 = c0.x, v1 = c0.w;
  const float g_sd = -relu_grad(__fsub_rn(s.margin, fminf(v0, v1)), 1.0f);
  const float g_half = __fmul_rn(g_sd, 0.5f);
  const float g0 = v0 == v1 ? g_half : (v0 < v1 ? g_sd : 0.0f);
  const float g1 = v0 == v1 ? g_half : (v1 < v0 ? g_sd : 0.0f);
  const float obj_x = __fadd_rn(__fmul_rn(g0, c0.y), __fmul_rn(g1, c1.x));
  const float obj_y = __fadd_rn(__fmul_rn(g0, c0.z), __fmul_rn(g1, c1.y));

  // Walls: signed distances (x - lo0, y - lo1, hi0 - x, hi1 - y), the max
  // of their relu(margin - sd), its gradient shared by the tied walls.
  const float xw[4] = {__fsub_rn(s.margin, __fsub_rn(x, s.wall_lo0)),
                       __fsub_rn(s.margin, __fsub_rn(y, s.wall_lo1)),
                       __fsub_rn(s.margin, __fsub_rn(s.wall_hi0, x)),
                       __fsub_rn(s.margin, __fsub_rn(s.wall_hi1, y))};
  float pen[4], pen_max = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    pen[k] = fmaxf(xw[k], 0.0f);
    pen_max = fmaxf(pen_max, pen[k]);
  }
  int n_tied = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) n_tied += pen[k] == pen_max;
  const float share = __fdiv_rn(1.0f, (float)n_tied);
  float gw[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) gw[k] = relu_grad(xw[k], pen[k] == pen_max ? share : 0.0f);
  // d sd / dq is +1 for the low walls and -1 for the high ones, and
  // d pen / d sd is -1: the low walls push by -gw, the high ones by +gw.
  const float bnd_x = __fadd_rn(-gw[0], gw[2]);
  const float bnd_y = __fadd_rn(-gw[1], gw[3]);

  const float2 a = clip_and_weigh(obj_x, obj_y, s.max_norm, s.weight);
  const float2 b = clip_and_weigh(bnd_x, bnd_y, s.max_norm, s.weight);
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}

}  // namespace mmd
