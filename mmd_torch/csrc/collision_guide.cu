// Collision guide for NVIDIA Hopper (sm_90a): the whole collision part of
// one guide evaluation in one launch. For each waypoint of u (..., H, 4),
// unnormalized, on the scene of its tile (below), it writes
//
//   out = w * clip(d/du objects(u)) + w * clip(d/du boundaries(u))
//
// where objects() is relu(margin - min(sdf0, sdf1)) on the scene's two SDF
// grids with the grid's surrogate gradient, boundaries() is the max over
// the four walls of relu(margin - signed distance), and clip() is the
// guide's per-waypoint norm clip with the `+ 1e-6` quirk, zeroed at the
// first and last waypoint. The velocity channels of out are 0. The plain
// PyTorch version is `collision_guide_plain` in mmd_torch/costs/guide.py
// (the autograd code of the two costs); it is held equal to the JAX
// package's mmd_tpu/costs/guide.py:106-136,147-152.
//
// Replaces, on the guide's path, the TPU kernel `_kernel` /
// `grid_lookup_pallas` of mmd_tpu/ops/sdf_kernel.py (a one-hot-matmul cell
// lookup), together with everything the guide did with its output.
//
// What bounds it: the launch. At the guide's B=64, H=64 the function needs
// the 3968 inner rows of 16 B (62 KB; the first and last waypoints' outputs
// are 0 whatever they hold), at most 3968 distinct cells of 24 B (two
// grids' value and gradient, 93 KB), and writes 4096 rows of 16 B (64 KB):
// at most 0.22 MB, under 0.07 us at 3.35 TB/s. A launch costs microseconds, and the port's guide spent about
// 70 launches (lookup, min, relu, their backward, cat, amax, the clips) on
// what this kernel does in one. So the design gives one launch all of that
// work and keeps every intermediate in registers.
//
// Tiles: a multi-tile plan guides T tiles, each on its own map, in one
// call. u is then (T, B, H, 4) and the table holds T scenes one after the
// other, (T, N0, N1, 8); row r reads tile r / tile_rows (tile_rows = B * H).
// Every map shares one grid box and one wall box, so those constants are
// the same for all tiles. A single scene is the case T = 1 (tile_rows =
// n_rows). The byte bound grows with T (each table's distinct cells); the
// launch count does not.
//
// Threads: one per waypoint row, 128 to a block (32 blocks at 64 x 64).
// Each thread's clip needs only its own row, so there is no reduction and
// no traffic between threads. Each thread reads its row as one 16-byte
// float4, neighbouring threads on neighbouring rows, and writes its output
// row as one float4.
//
// Cells: the scene's two grids are packed once per scene (SceneData) into
// one table of 32-byte records (v0, g0x, g0y, v1, g1x, g1y, 0, 0), so a
// lookup reads one 32-byte L2 sector (two aligned float4 loads) instead of
// four arrays; the 8 B of padding buy the alignment. The 400 x 400 table is
// 5.12 MB, three tiles' 15.4 MB, and stays in the 50 MB L2 across the guide
// loop.
//
// No shared memory, TMA or tensor cores: the cells a batch touches are
// scattered, and there is neither a product nor a reuse pattern between
// threads that they would serve.
//
// Arithmetic: the same float32 operations in the same order as the plain
// version, with round-to-nearest intrinsics and --fmad=false at build time
// so that nothing is contracted. The cell index is grid_sdf.cu's,
// floor((x - lo) / span * n) clamped to [0, n - 1], so the cell is the JAX
// cell bit for bit. Ties split the gradient as torch and JAX do: 0.5/0.5
// between the two grids (torch.minimum), evenly among the walls that share
// the max (torch.amax), and relu(x) = max(x, 0) has gradient 0.5 at x = 0
// (torch.maximum). The clip's norm is taken over all four channels of
// g + 1e-6, as (a^2 + b^2) + (c^2 + d^2).
//
// C interface (bound with ctypes): collision_guide(...) launches on the
// given stream and returns cudaGetLastError() as an int; 0 is success.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ int cell_of(float x, float lo, float span, int n) {
  float f = floorf(__fmul_rn(__fdiv_rn(__fsub_rn(x, lo), span), (float)n));
  f = fminf(fmaxf(f, 0.0f), (float)(n - 1));
  return (int)f;
}

// d/dx of max(x, 0) times g, as torch.maximum's backward computes it.
__device__ __forceinline__ float relu_grad(float x, float g) {
  return x > 0.0f ? g : (x == 0.0f ? __fmul_rn(g, 0.5f) : 0.0f);
}

// The guide's _finish on one waypoint (gx, gy, 0, 0): scale by
// min(||g + 1e-6||, max_norm) / ||g + 1e-6||, then the weight.
__device__ __forceinline__ float2 clip_and_weigh(float gx, float gy,
                                                 float max_norm, float w) {
  const float eps = 1e-6f;
  const float a = __fadd_rn(gx, eps), b = __fadd_rn(gy, eps);
  const float sq = __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)),
                             __fadd_rn(__fmul_rn(eps, eps), __fmul_rn(eps, eps)));
  const float norm = __fsqrt_rn(sq);
  const float scale = __fdiv_rn(fminf(fmaxf(norm, 0.0f), max_norm), norm);
  return make_float2(__fmul_rn(w, __fmul_rn(gx, scale)),
                     __fmul_rn(w, __fmul_rn(gy, scale)));
}

__global__ void __launch_bounds__(kThreads) collision_guide_kernel(
    const float4* __restrict__ u, int64_t n_rows, int horizon,
    int64_t tile_rows, const float4* __restrict__ cells, int n0, int n1,
    float lo0, float lo1,
    float span0, float span1, float wall_lo0, float wall_lo1,
    float wall_hi0, float wall_hi1, float margin, float weight,
    float max_norm, float4* __restrict__ out) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  const int h = (int)(r % horizon);
  if (h == 0 || h == horizon - 1) {  // the clip zeroes start and goal
    out[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return;
  }
  const float4 row = __ldg(u + r);
  const float x = row.x, y = row.y;

  // Objects: relu(margin - min(v0, v1)); the gradient of the smaller grid's
  // cell (both halves on a tie) times the cell gradients, in the row's
  // tile's table.
  const int64_t cell = (r / tile_rows) * n0 * n1 +
      (int64_t)cell_of(x, lo0, span0, n0) * n1 + cell_of(y, lo1, span1, n1);
  const float4 c0 = __ldg(cells + 2 * cell);      // v0, g0x, g0y, v1
  const float4 c1 = __ldg(cells + 2 * cell + 1);  // g1x, g1y, 0, 0
  const float v0 = c0.x, v1 = c0.w;
  const float g_sd = -relu_grad(__fsub_rn(margin, fminf(v0, v1)), 1.0f);
  const float g_half = __fmul_rn(g_sd, 0.5f);
  const float g0 = v0 == v1 ? g_half : (v0 < v1 ? g_sd : 0.0f);
  const float g1 = v0 == v1 ? g_half : (v1 < v0 ? g_sd : 0.0f);
  const float obj_x = __fadd_rn(__fmul_rn(g0, c0.y), __fmul_rn(g1, c1.x));
  const float obj_y = __fadd_rn(__fmul_rn(g0, c0.z), __fmul_rn(g1, c1.y));

  // Walls: signed distances (x - lo0, y - lo1, hi0 - x, hi1 - y), the max
  // of their relu(margin - sd), its gradient shared by the tied walls.
  const float xw[4] = {__fsub_rn(margin, __fsub_rn(x, wall_lo0)),
                       __fsub_rn(margin, __fsub_rn(y, wall_lo1)),
                       __fsub_rn(margin, __fsub_rn(wall_hi0, x)),
                       __fsub_rn(margin, __fsub_rn(wall_hi1, y))};
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

  const float2 a = clip_and_weigh(obj_x, obj_y, max_norm, weight);
  const float2 b = clip_and_weigh(bnd_x, bnd_y, max_norm, weight);
  out[r] = make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), 0.0f, 0.0f);
}

}  // namespace

extern "C" int collision_guide(
    const void* u, long long n_rows, int horizon, long long tile_rows,
    const void* cells, int n0, int n1, float lo0, float lo1, float span0,
    float span1, float wall_lo0, float wall_lo1, float wall_hi0,
    float wall_hi1, float margin, float weight, float max_norm, void* out,
    void* stream) {
  if (n_rows <= 0 || horizon < 2 || tile_rows <= 0 || tile_rows % horizon ||
      n_rows % tile_rows)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n_rows + kThreads - 1) / kThreads;
  collision_guide_kernel<<<(unsigned int)blocks, kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const float4*)u, (int64_t)n_rows, horizon, (int64_t)tile_rows,
      (const float4*)cells, n0, n1, lo0, lo1, span0, span1, wall_lo0, wall_lo1, wall_hi0, wall_hi1,
      margin, weight, max_norm, (float4*)out);
  return (int)cudaGetLastError();
}
