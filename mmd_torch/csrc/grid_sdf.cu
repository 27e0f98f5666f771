// Grid-SDF lookup for NVIDIA Hopper (sm_90a): value and precomputed
// gradient of the floor cell of each query point, on a scene's two grids
// (its object grid and its extra-objects grid) in one launch.
//
// Replaces the Pallas TPU kernel `_kernel` / `grid_lookup_pallas` of
// mmd_tpu/ops/sdf_kernel.py. That kernel selected cells with one-hot
// matmuls on the TPU's matrix unit; here the function is a gather: one
// thread per point computes the cell index and reads the cell's value
// (4 bytes) and gradient (8 bytes, one float2) straight from the grids in
// device memory. A 400x400 grid with its gradients is 1.9 MB and stays in
// the 50 MB L2 across the guide loop.
//
// Bound: about 20 bytes of traffic per point and grid (8 read for the
// point, shared by both grids, 12 read from the cell, 12 written), so at
// the guide's 4032 points a launch moves ~0.2 MB, well under a microsecond
// at 3.35 TB/s. What a launch really meets is the launch latency of a few
// microseconds, which is why both grids of a scene are read in one launch.
//
// Cell index: floor((x - lo) / span * n) clamped to [0, n - 1], computed in
// float32 in that order with round-to-nearest intrinsics (and --fmad=false
// at build time), so that the index matches the JAX and plain PyTorch
// versions bit for bit at cell edges.
//
// C interface (bound with ctypes): grid_sdf_lookup(...) launches on the
// given stream and returns cudaGetLastError() as an int; 0 is success.

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
    const float* __restrict__ vals0, const float2* __restrict__ grads0,
    const float* __restrict__ vals1, const float2* __restrict__ grads1,
    int n0, int n1, float lo0, float lo1, float span0,
    float span1, float* __restrict__ out_vals,
    float2* __restrict__ out_grads) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pts) return;
  const float2 x = pts[p];
  const int i = cell_of(x.x, lo0, span0, n0);
  const int j = cell_of(x.y, lo1, span1, n1);
  const int64_t cell = (int64_t)i * n1 + j;
  out_vals[p] = __ldg(vals0 + cell);
  out_grads[p] = __ldg(grads0 + cell);
  out_vals[n_pts + p] = __ldg(vals1 + cell);
  out_grads[n_pts + p] = __ldg(grads1 + cell);
}

}  // namespace

extern "C" int grid_sdf_lookup(
    const void* pts, long long n_pts, const void* vals0, const void* grads0,
    const void* vals1, const void* grads1, int n0, int n1,
    float lo0, float lo1, float span0, float span1, void* out_vals,
    void* out_grads, void* stream) {
  if (n_pts <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long blocks = (n_pts + threads - 1) / threads;
  grid_sdf_lookup_kernel<<<(unsigned int)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
      (const float2*)pts, (int64_t)n_pts, (const float*)vals0,
      (const float2*)grads0, (const float*)vals1, (const float2*)grads1,
      n0, n1, lo0, lo1, span0, span1, (float*)out_vals,
      (float2*)out_grads);
  return (int)cudaGetLastError();
}
