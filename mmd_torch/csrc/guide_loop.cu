// The guide loop for NVIDIA Hopper (sm_90a): all n_steps iterations of
//
//   x <- hard(x + guide(x))
//
// of one guided diffusion step in one launch, for every trajectory row of
// x (G, B, H, 4), normalized. guide() is the guide's gradient step as
// mmd_torch/costs/guide.py (`guide_gradient`) and the JAX package's
// mmd_tpu/costs/guide.py:139-190 compute it, and hard() the hard
// conditions, x * (1 - mask) + values * mask. The plain PyTorch version is
// `guide_loop_plain` in mmd_torch/costs/guide.py; the kernel equals it bit
// for bit.
//
// Replaces, on the sampler's path, JAX's `jax.lax.fori_loop(0,
// n_guide_steps, guide_step, x)` (mmd_tpu/models/diffusion.py:105-110 and
// :274) and the TPU kernel it runs in every iteration, `_kernel` /
// `grid_lookup_pallas` of mmd_tpu/ops/sdf_kernel.py. It is the collision
// guide (collision_guide.cu) redesigned for this card: that kernel did the
// collision part of one iteration, and the port launched about 40 kernels
// around it in each of the 20 iterations.
//
// One iteration, per waypoint h of a row, in JAX's order of terms:
//   1. u = 0.5 * (clamp(x, -1, 1) + 1) * span + mins, span = max(maxs -
//      mins, 1e-12), the group's normalizer; the step is added to x with
//      no chain rule through it (the reference's quirk, guide.py:11-15).
//   2. the two collision terms (collision_terms.cuh), on the group's scene;
//   3. the GP prior's gradient of sum_t e_t^T Q e_t, e_t = s_{t+1} - Phi
//      s_t, which reads the row's waypoints h - 1 and h + 1;
//   4. each constraint k in order: the relu-ball gradient summed over its
//      points p in order where start <= h < end, clipped, weighted;
//   5. the soft paths: R balls at waypoint h, summed over r in order, one
//      clip, one weight;
//   each term clipped as the guide's _finish and zero at h = 0 and H - 1,
//   the weighted terms summed in that order; then
//   6. x <- x - total, then the hard conditions.
// A ball's gradient is (q - c) * (-(relu'(r - d) * m) / d), 0 where d ==
// 0, as torch's autograd of the norm gives it (JAX's gives NaN there).
//
// Threads and blocks: one block a trajectory row, one thread a waypoint
// (H rounded up to a warp, H <= 1024). A thread keeps its waypoint's x,
// hard mask and values, and its group's normalizer in registers for all
// n_steps iterations. The GP prior's neighbours u_{h-1} and u_{h+1} come
// by warp shuffles, and across warp boundaries through two slots a warp in
// shared memory, double-buffered by the iteration's parity: one
// __syncthreads an iteration. Nothing crosses rows, so no block waits on
// another and x goes to device memory once, at the end.
//
// Staging: the group's constraint set (centres, ranges, radii, point
// masks, weights, active flags: 6KP + 2K floats) and soft paths (R x H
// centres and masks: 3RH floats; R = 19 at H = 64 is 14.6 KB) go to shared
// memory once a block with cp.async, issued before the first iteration and
// waited for just before its barrier, so the copies overlap its cell
// loads. A thread reads its own waypoint's soft columns and every
// thread the same constraint entry at once (a broadcast). The wrapper
// refuses a (K, P, R, H) whose staging passes 227 KB and raises the
// kernel's dynamic shared memory limit above 48 KB when it needs to.
//
// Cells: read from L2 as in the collision guide: a scene's packed table is
// 5.12 MB (400 x 400 records of 32 B), three tiles' 15.4 MB, inside the 50
// MB L2.
//
// Arithmetic: the plain version's float32 operations in its order, with
// round-to-nearest intrinsics and --fmad=false at build time. The
// collision terms are collision_guide.cu's. The other terms follow JAX's
// float32 arithmetic on the CPU, where XLA fuses a norm's sum of squares
// and the rows of Q e into fused multiply-adds: each such step here is a
// * b + c rounded once, through double (fma32), as the plain version's
// `_fma` computes it, so that kernel and plain version agree bit for bit
// and both follow JAX's rounding (a GP prior gradient equal to JAX's in
// every bit on the CPU tests' inputs). A point or ball whose mask is 0 is
// skipped: its gradient is +-0 and adding it leaves a sum that starts at
// +0 unchanged, so the skip is exact.
//
// What bounds it. (a) Bytes: x read and written once (32 B a waypoint),
// the hard values and mask, the staged data once a group and 24 B for each
// distinct cell: at (1, 64, 64, 4) with no constraint about 0.2 MB, under
// 0.1 us at 3.35 TB/s. (b) Latency: n_steps dependent iterations, each an
// L2 round trip for the cell, a barrier and the sums over K x P and R;
// tens of microseconds a launch, far above (a). (c) The launches it
// replaces: about 40 host launches an iteration, ~840 a guided step at 20
// iterations, where this kernel is one. The port paid (c); the kernel
// trades it for (b).
//
// C interface (bound with ctypes): guide_loop(args, smem_bytes, stream)
// launches on the given stream with smem_bytes of dynamic shared memory
// and returns cudaGetLastError() as an int; 0 is success.

#include <cuda_runtime.h>
#include <stdint.h>

#include "collision_terms.cuh"

// The launch's arguments; mmd_torch/ops/guide_loop.py builds the same
// structure with ctypes. Strides are in floats (records for table_gs).
struct GuideLoopArgs {
  const float* x;       // (G, B, H, 4), contiguous
  float* out;           // (G, B, H, 4)
  const float* mins;    // group g's four at mins + g * norm_gs
  const float* maxs;
  const float* mask;    // hard mask (g, b, h) at g*mask_gs + b*mask_bs + h*mask_hs
  const float* values;  // hard values (g, b, h, c) at g*val_gs + b*val_bs + h*val_hs + c
  const float* cells;   // scene tables: group g's records at + g * table_gs
  const float* cq;      // constraint centres (Gc, K, P, 2), contiguous
  const float* ct;      // [start, end) (Gc, K, P, 2)
  const float* cr;      // radii (Gc, K, P)
  const float* cpm;     // point masks (Gc, K, P)
  const float* cw;      // weights (Gc, K)
  const float* ca;      // active flags (Gc, K)
  const float* sp;      // soft centres (g, r, h, c) at g*sp_gs + r*sp_rs + h*sp_hs + c
  const float* sm;      // soft mask (g, r, h) at g*sm_gs + r*sm_rs + h*sm_hs
  const float* sr;      // soft radius, group g's at g * sr_gs
  const float* sw;      // soft weight, group g's at g * sw_gs
  long long norm_gs, mask_gs, mask_bs, mask_hs, val_gs, val_bs, val_hs, table_gs;
  long long cset_gs;    // 0 (one set for all groups) or 1 (a set a group)
  long long sp_gs, sp_rs, sp_hs, sm_gs, sm_rs, sm_hs, sr_gs, sw_gs;
  int G, B, H, n_steps, K, P, R, n0, n1;
  float lo0, lo1, span0, span1, wall_lo0, wall_lo1, wall_hi0, wall_hi1;
  float margin, w_collision, max_norm;
  float dt, q_pp, q_pv, q_vv, w_smooth;  // Phi's dt and Q's three entries
};

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kSmallThreads = 256;
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void stage(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) cp_async4(dst + i, src + i);
}

// a * b + c rounded once to float32, through double (a * b is exact
// there): the fused multiply-add of JAX's CPU arithmetic, as the plain
// version's `_fma` computes it.
__device__ __forceinline__ float fma32(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

// The guide's _finish at an inner waypoint for the GP prior, constraint and
// soft-path terms: the clip by ||g + 1e-6||, its squares summed in order by
// fused multiply-adds (jnp.linalg.norm).
__device__ __forceinline__ float4 clip_rows(float4 g, float max_norm) {
  const float a = __fadd_rn(g.x, mmd::kClipEps), b = __fadd_rn(g.y, mmd::kClipEps);
  const float c = __fadd_rn(g.z, mmd::kClipEps), d = __fadd_rn(g.w, mmd::kClipEps);
  const float norm = __fsqrt_rn(fma32(d, d, fma32(c, c, fma32(b, b, __fmul_rn(a, a)))));
  const float scale = __fdiv_rn(fminf(fmaxf(norm, 0.0f), max_norm), norm);
  return make_float4(__fmul_rn(g.x, scale), __fmul_rn(g.y, scale), __fmul_rn(g.z, scale),
                     __fmul_rn(g.w, scale));
}

// clip_rows of a position-only term (gx, gy, 0, 0), then its weight.
__device__ __forceinline__ float2 clip_positions(float gx, float gy, float max_norm, float w) {
  const float4 c = clip_rows(make_float4(gx, gy, 0.0f, 0.0f), max_norm);
  return make_float2(__fmul_rn(w, c.x), __fmul_rn(w, c.y));
}

// e = t - Phi s, Phi = [[I, dt I], [0, I]].
__device__ __forceinline__ float4 gp_error(float4 s, float4 t, float dt) {
  return make_float4(__fsub_rn(t.x, __fadd_rn(s.x, __fmul_rn(dt, s.z))),
                     __fsub_rn(t.y, __fadd_rn(s.y, __fmul_rn(dt, s.w))),
                     __fsub_rn(t.z, s.z), __fsub_rn(t.w, s.w));
}

// d/de of e^T Q e = 2 Q e, Q = [[pp I, pv I], [pv I, vv I]], each row of
// Q e one fused multiply-add.
__device__ __forceinline__ float4 gp_error_grad(float4 e, const GuideLoopArgs& a) {
  const float px = fma32(e.z, a.q_pv, __fmul_rn(a.q_pp, e.x));
  const float py = fma32(e.w, a.q_pv, __fmul_rn(a.q_pp, e.y));
  const float vx = fma32(e.z, a.q_vv, __fmul_rn(a.q_pv, e.x));
  const float vy = fma32(e.w, a.q_vv, __fmul_rn(a.q_pv, e.y));
  return make_float4(__fmul_rn(2.0f, px), __fmul_rn(2.0f, py), __fmul_rn(2.0f, vx),
                     __fmul_rn(2.0f, vy));
}

// The GP prior's gradient at an inner waypoint u from its neighbours:
// d e_{h-1} - Phi^T d e_h.
__device__ __forceinline__ float4 gp_grad(float4 um, float4 u, float4 up,
                                          const GuideLoopArgs& a) {
  const float4 g1 = gp_error_grad(gp_error(um, u, a.dt), a);
  const float4 g2 = gp_error_grad(gp_error(u, up, a.dt), a);
  return make_float4(__fsub_rn(g1.x, g2.x), __fsub_rn(g1.y, g2.y),
                     __fsub_rn(g1.z, __fadd_rn(__fmul_rn(a.dt, g2.x), g2.z)),
                     __fsub_rn(g1.w, __fadd_rn(__fmul_rn(a.dt, g2.y), g2.w)));
}

// Adds d/dq of relu(radius - ||q - c||) * m to (gx, gy); nothing where the
// distance is 0 (torch's norm gradient there).
__device__ __forceinline__ void add_ball(float qx, float qy, float cx, float cy,
                                         float radius, float m, float& gx, float& gy) {
  const float dx = __fsub_rn(qx, cx), dy = __fsub_rn(qy, cy);
  const float d = __fsqrt_rn(fma32(dy, dy, __fmul_rn(dx, dx)));
  if (!(d > 0.0f)) return;
  const float s = __fdiv_rn(-mmd::relu_grad(__fsub_rn(radius, d), m), d);
  gx = __fadd_rn(gx, __fmul_rn(dx, s));
  gy = __fadd_rn(gy, __fmul_rn(dy, s));
}

// kThreads bounds the block: 256 leaves a thread up to 255 registers, 1024
// (H > 256) 64.
template <int kThreads>
__global__ void __launch_bounds__(kThreads) guide_loop_kernel(const GuideLoopArgs a) {
  extern __shared__ float4 smem[];
  const int H = a.H, K = a.K, P = a.P, R = a.R;
  const int64_t row = blockIdx.x;  // g * B + b
  const int g = (int)(row / a.B), b = (int)(row % a.B);
  const int h = threadIdx.x;
  const int lane = h & 31, warp = h >> 5, n_warps = blockDim.x >> 5;
  const bool live = h < H, inner = h > 0 && h < H - 1;
  const float hf = (float)h;

  // Shared memory: the warps' edge slots [2][n_warps][2], then the staged
  // constraint set and soft paths.
  float4* edges = smem;
  const int kp = K * P;
  float* s_cq = reinterpret_cast<float*>(smem + 4 * n_warps);
  float* s_ct = s_cq + 2 * kp;
  float* s_cr = s_ct + 2 * kp;
  float* s_cpm = s_cr + kp;
  float* s_cw = s_cpm + kp;
  float* s_ca = s_cw + K;
  float* s_sp = s_ca + K;
  float* s_sm = s_sp + 2 * R * H;
  if (K > 0) {
    const int64_t set = (int64_t)g * a.cset_gs;
    stage(s_cq, a.cq + set * 2 * kp, 2 * kp);
    stage(s_ct, a.ct + set * 2 * kp, 2 * kp);
    stage(s_cr, a.cr + set * kp, kp);
    stage(s_cpm, a.cpm + set * kp, kp);
    stage(s_cw, a.cw + set * K, K);
    stage(s_ca, a.ca + set * K, K);
  }
  for (int i = h; i < 2 * R * H; i += blockDim.x) {
    const int r = i / (2 * H), j = i % (2 * H);
    cp_async4(s_sp + i, a.sp + g * a.sp_gs + r * a.sp_rs + (j >> 1) * a.sp_hs + (j & 1));
  }
  for (int i = h; i < R * H; i += blockDim.x)
    cp_async4(s_sm + i, a.sm + g * a.sm_gs + (i / H) * a.sm_rs + (i % H) * a.sm_hs);
  cp_async_commit();

  // The thread's waypoint and everything constant across iterations.
  float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f), v = x;
  float m = 0.0f;
  if (live) {
    x = reinterpret_cast<const float4*>(a.x)[row * H + h];
    m = a.mask[g * a.mask_gs + b * a.mask_bs + h * a.mask_hs];
    const float* vp = a.values + g * a.val_gs + b * a.val_bs + h * a.val_hs;
    v = make_float4(vp[0], vp[1], vp[2], vp[3]);
  }
  const float keep = __fsub_rn(1.0f, m);
  const float* mn = a.mins + g * a.norm_gs;
  const float* mx = a.maxs + g * a.norm_gs;
  const float4 lo = make_float4(mn[0], mn[1], mn[2], mn[3]);
  const float4 span = make_float4(
      fmaxf(__fsub_rn(mx[0], mn[0]), 1e-12f), fmaxf(__fsub_rn(mx[1], mn[1]), 1e-12f),
      fmaxf(__fsub_rn(mx[2], mn[2]), 1e-12f), fmaxf(__fsub_rn(mx[3], mn[3]), 1e-12f));
  const mmd::CollisionScene scene{a.n0, a.n1, a.lo0, a.lo1, a.span0, a.span1,
                                  a.wall_lo0, a.wall_lo1, a.wall_hi0, a.wall_hi1,
                                  a.margin, a.w_collision, a.max_norm};
  const float4* cells = reinterpret_cast<const float4*>(a.cells) + 2 * g * a.table_gs;
  const float s_radius = R > 0 ? a.sr[g * a.sr_gs] : 0.0f;
  const float s_weight = R > 0 ? a.sw[g * a.sw_gs] : 0.0f;

  for (int it = 0; it < a.n_steps; ++it) {
    // 1. Unnormalize.
#define UNNORM(c) __fadd_rn(__fmul_rn(__fmul_rn(0.5f, __fadd_rn( \
        fminf(fmaxf(x.c, -1.0f), 1.0f), 1.0f)), span.c), lo.c)
    const float4 u = make_float4(UNNORM(x), UNNORM(y), UNNORM(z), UNNORM(w));
#undef UNNORM
    // 2. Collision: the cell load goes out before the barrier.
    float2 coll = make_float2(0.0f, 0.0f);
    if (inner) coll = mmd::collision_step(u.x, u.y, cells, scene);

    // The neighbours, by shuffles and the warps' edge slots.
    float4 um, up;
    um.x = __shfl_up_sync(0xffffffffu, u.x, 1);
    um.y = __shfl_up_sync(0xffffffffu, u.y, 1);
    um.z = __shfl_up_sync(0xffffffffu, u.z, 1);
    um.w = __shfl_up_sync(0xffffffffu, u.w, 1);
    up.x = __shfl_down_sync(0xffffffffu, u.x, 1);
    up.y = __shfl_down_sync(0xffffffffu, u.y, 1);
    up.z = __shfl_down_sync(0xffffffffu, u.z, 1);
    up.w = __shfl_down_sync(0xffffffffu, u.w, 1);
    float4* slot = edges + 2 * n_warps * (it & 1);
    if (lane == 0) slot[2 * warp] = u;
    if (lane == 31) slot[2 * warp + 1] = u;
    if (it == 0) cp_async_wait_all();
    __syncthreads();
    if (lane == 0 && warp > 0) um = slot[2 * warp - 1];
    if (lane == 31 && warp + 1 < n_warps) up = slot[2 * warp + 2];

    if (inner) {
      float4 total = make_float4(coll.x, coll.y, 0.0f, 0.0f);
      // 3. The GP prior.
      const float4 gp = clip_rows(gp_grad(um, u, up, a), a.max_norm);
      total.x = __fadd_rn(total.x, __fmul_rn(a.w_smooth, gp.x));
      total.y = __fadd_rn(total.y, __fmul_rn(a.w_smooth, gp.y));
      total.z = __fadd_rn(total.z, __fmul_rn(a.w_smooth, gp.z));
      total.w = __fadd_rn(total.w, __fmul_rn(a.w_smooth, gp.w));
      // 4. The constraints, each clipped and weighted, summed in order.
      if (K > 0) {
        float cx = 0.0f, cy = 0.0f;
        for (int k = 0; k < K; ++k) {
          float gx = 0.0f, gy = 0.0f;
          for (int p = 0; p < P; ++p) {
            const int i = k * P + p;
            if (!(hf >= s_ct[2 * i] && hf < s_ct[2 * i + 1])) continue;
            const float mk = __fmul_rn(__fmul_rn(1.0f, s_cpm[i]), s_ca[k]);
            if (mk == 0.0f) continue;
            add_ball(u.x, u.y, s_cq[2 * i], s_cq[2 * i + 1], s_cr[i], mk, gx, gy);
          }
          const float2 c = clip_positions(gx, gy, a.max_norm, s_cw[k]);
          cx = __fadd_rn(cx, c.x);
          cy = __fadd_rn(cy, c.y);
        }
        total.x = __fadd_rn(total.x, cx);
        total.y = __fadd_rn(total.y, cy);
      }
      // 5. The soft paths: one cost, one clip.
      if (R > 0) {
        float gx = 0.0f, gy = 0.0f;
        for (int r = 0; r < R; ++r) {
          const float mr = s_sm[r * H + h];
          if (mr == 0.0f) continue;
          add_ball(u.x, u.y, s_sp[2 * (r * H + h)], s_sp[2 * (r * H + h) + 1], s_radius, mr,
                   gx, gy);
        }
        const float2 c = clip_positions(gx, gy, a.max_norm, s_weight);
        total.x = __fadd_rn(total.x, c.x);
        total.y = __fadd_rn(total.y, c.y);
      }
      // 6. The step.
      x.x = __fsub_rn(x.x, total.x);
      x.y = __fsub_rn(x.y, total.y);
      x.z = __fsub_rn(x.z, total.z);
      x.w = __fsub_rn(x.w, total.w);
    }
    x.x = __fadd_rn(__fmul_rn(x.x, keep), __fmul_rn(v.x, m));
    x.y = __fadd_rn(__fmul_rn(x.y, keep), __fmul_rn(v.y, m));
    x.z = __fadd_rn(__fmul_rn(x.z, keep), __fmul_rn(v.z, m));
    x.w = __fadd_rn(__fmul_rn(x.w, keep), __fmul_rn(v.w, m));
  }
  cp_async_wait_all();
  if (live) reinterpret_cast<float4*>(a.out)[row * H + h] = x;
}

template <int kThreads>
cudaError_t launch(const GuideLoopArgs& a, long long smem_bytes, cudaStream_t stream) {
  static long long smem_limit = kDefaultSmem;
  if (smem_bytes > smem_limit) {
    const cudaError_t err = cudaFuncSetAttribute(
        guide_loop_kernel<kThreads>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes);
    if (err != cudaSuccess) return err;
    smem_limit = smem_bytes;
  }
  const int threads = (a.H + 31) / 32 * 32;
  const long long blocks = (long long)a.G * a.B;
  guide_loop_kernel<kThreads><<<(unsigned int)blocks, threads, (size_t)smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int guide_loop(const GuideLoopArgs* args, long long smem_bytes, void* stream) {
  const GuideLoopArgs& a = *args;
  if (a.G <= 0 || a.B <= 0 || (long long)a.G * a.B > 0x7fffffffLL || a.H < 2 ||
      a.H > kMaxThreads || a.n_steps < 0 || a.K < 0 || a.P < 0 || a.R < 0 || smem_bytes < 0)
    return (int)cudaErrorInvalidValue;
  return (int)(a.H <= kSmallThreads
                   ? launch<kSmallThreads>(a, smem_bytes, (cudaStream_t)stream)
                   : launch<kMaxThreads>(a, smem_bytes, (cudaStream_t)stream));
}
