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
// The per-waypoint arithmetic is collision_terms.cuh's, shared with the
// guide-loop kernel (guide_loop.cu), which runs it in every iteration of
// a diffusion step's guide loop; this kernel serves the guide's single
// evaluations (`guide_gradient`).
//
// C interface (bound with ctypes): collision_guide(...) launches on the
// given stream and returns cudaGetLastError() as an int; 0 is success.

#include <cuda_runtime.h>
#include <stdint.h>

#include "collision_terms.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) collision_guide_kernel(
    const float4* __restrict__ u, int64_t n_rows, int horizon,
    int64_t tile_rows, const float4* __restrict__ cells,
    const mmd::CollisionScene scene, float4* __restrict__ out) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  const int h = (int)(r % horizon);
  if (h == 0 || h == horizon - 1) {  // the clip zeroes start and goal
    out[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return;
  }
  const float4 row = __ldg(u + r);
  // The row's tile's table.
  const float4* table = cells + 2 * (r / tile_rows) * scene.n0 * scene.n1;
  const float2 g = mmd::collision_step(row.x, row.y, table, scene);
  out[r] = make_float4(g.x, g.y, 0.0f, 0.0f);
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
  const mmd::CollisionScene scene{n0, n1, lo0, lo1, span0, span1, wall_lo0, wall_lo1,
                                  wall_hi0, wall_hi1, margin, weight, max_norm};
  const long long blocks = (n_rows + kThreads - 1) / kThreads;
  collision_guide_kernel<<<(unsigned int)blocks, kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const float4*)u, (int64_t)n_rows, horizon, (int64_t)tile_rows,
      (const float4*)cells, scene, (float4*)out);
  return (int)cudaGetLastError();
}
