// Grid-SDF lookup for NVIDIA Hopper (sm_90a): value and precomputed
// gradient of the floor cell of each query point, on a scene's two grids
// (its object grid and its extra-objects grid) in one launch.
//
// Replaces the Pallas TPU kernel `_kernel` / `grid_lookup_pallas` of
// mmd_tpu/ops/sdf_kernel.py. That kernel selected cells with one-hot
// matmuls on the TPU's matrix unit; here the function is a gather: one
// thread per point computes the cell index and reads the cell's record.
//
// The record. Both grids of a cell are one packed record of eight float32,
// (v0, g0x, g0y, v1, g1x, g1y, 0, 0): 32 bytes, one L2 sector, built once
// per scene (`packed_cells` in mmd_torch/ops/sdf_kernel.py; the collision
// guide reads the same table). A point reads it with two 16-byte
// read-only loads from that one sector, where reading the four separate
// arrays (values and gradients of two grids) took four loads from four
// sectors, all waiting on the point's own load. A 400x400 scene is 5.1 MB
// of records and stays in the 50 MB L2.
//
// Bound (each input read once, each output written once): 8 B of point,
// 24 B of outputs (two values, two gradients) per point, and the 24 B of
// the function's own data (two values, two gradients) of each distinct
// cell. At a plan's finalize, (64, 379, 2) points (24256; 18997 distinct
// cells in chip_smoke.py's EnvConveyor2D case), that is 1232120 B, 0.37 us
// at 3.35 TB/s: below the ~1.0 us a launch costs, so there the launch and
// the dependent round trips to L2 bound the kernel. At a batched finalize
// of 10 problems, (640, 379, 2) points (242560; 110612 distinct cells),
// it is 10416608 B, 3.1 us: bytes start to count, and the record cuts the
// cell traffic from four sectors a point to one.
//
// The launch. The kernel launches with programmatic dependent launch
// (cudaLaunchAttributeProgrammaticStreamSerialization): the grid may start
// while the kernel before it on the stream drains, and waits in
// `griddepcontrol.wait` before it reads its points, so its launch and
// block setup overlap that kernel's tail. Behind the kernel that writes
// its points, at (64, 379, 2), a plain stream launch of the same kernel
// took 4.67-5.12 us an iteration and this launch 3.59-3.83 us (three runs
// on an H100 80GB HBM3 at 700 W, PERF.md), so only this launch is kept.
//
// Cell index: floor((x - lo) / span * n) clamped to [0, n - 1], computed in
// float32 in that order with round-to-nearest intrinsics (and --fmad=false
// at build time), so that the index matches the JAX and plain PyTorch
// versions bit for bit at cell edges. A NaN coordinate reads cell 0
// (fmaxf(NaN, 0) is 0), as XLA's conversion of NaN to an integer does.
//
// C interface (bound with ctypes): `grid_sdf_lookup` launches on the given
// stream and returns cudaGetLastError() as an int; 0 is success.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int cell_of(float x, float lo, float span, int n) {
  float f = floorf(__fmul_rn(__fdiv_rn(__fsub_rn(x, lo), span), (float)n));
  f = fminf(fmaxf(f, 0.0f), (float)(n - 1));
  return (int)f;
}

__global__ void grid_sdf_lookup_kernel(
    const float2* __restrict__ pts, int64_t n_pts,
    const float4* __restrict__ cells, int n0, int n1, float lo0, float lo1,
    float span0, float span1, float* __restrict__ out_vals,
    float2* __restrict__ out_grads) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pts) return;
  // The points may come from the kernel launched before this one.
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const float2 x = pts[p];
  const int i = cell_of(x.x, lo0, span0, n0);
  const int j = cell_of(x.y, lo1, span1, n1);
  const float4* rec = cells + 2 * ((int64_t)i * n1 + j);
  const float4 a = __ldg(rec);      // v0, g0x, g0y, v1
  const float4 b = __ldg(rec + 1);  // g1x, g1y, 0, 0
  out_vals[p] = a.x;
  out_grads[p] = make_float2(a.y, a.z);
  out_vals[n_pts + p] = a.w;
  out_grads[n_pts + p] = make_float2(b.x, b.y);
}

}  // namespace

extern "C" int grid_sdf_lookup(
    const void* pts, long long n_pts, const void* cells, int n0, int n1,
    float lo0, float lo1, float span0, float span1, void* out_vals,
    void* out_grads, void* stream) {
  if (n_pts <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned int)((n_pts + threads - 1) / threads));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, grid_sdf_lookup_kernel, (const float2*)pts, (int64_t)n_pts,
      (const float4*)cells, n0, n1, lo0, lo1, span0, span1, (float*)out_vals,
      (float2*)out_grads);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
