"""Cost guidance: the gradient step added to the normalized trajectory.

Twin of `mmd_tpu/costs/guide.py` (reference: mmd/models/diffusion_models/
guides.py:152-234). Quirks kept as the JAX package keeps them:
- the guide unnormalizes the trajectory and takes each cost's gradient with
  respect to the unnormalized trajectory; that gradient is added to the
  normalized one with no chain rule through the normalizer (guides.py:181-226)
- each cost's gradient is clipped per waypoint by its norm, max 1.0, with
  the reference's `||g + 1e-6||` (guides.py:247-253), then zeroed at the
  start and goal waypoints (guides.py:217-218)
- costs: object-field and boundary-field collision (a clip and weight each,
  mpd.py:215-232), GP smoothness (mpd.py:234-238), one cost per constraint
  (hard 2e-1 / soft 2e-2, mpd.py:409-412)
- collision costs skip waypoint 0 (FieldFactor traj_range [1, None]) and use
  margin = 1.1 radius + 0.01 on the 64 support points: the reference's
  intended 1.5x interpolation never reaches its costs (guides.py:202);
  `interpolate_collision=True` turns the intended one on
- the result is the negative weighted gradient sum (guides.py:224-226)
The two collision terms run as one CUDA kernel on the card
(`mmd_torch/ops/collision_guide.py`) and as `collision_guide_plain`, their
autograd code, on the CPU.

The sampler runs a diffusion step's n_guide_steps iterations of
x <- hard.apply(x + guide_gradient(x)) through `guide_loop`, JAX's
`fori_loop` (mmd_tpu/models/diffusion.py:105-110): on the card one launch
of the guide-loop kernel (`mmd_torch/ops/guide_loop.py`) for all
iterations, on the CPU `guide_loop_plain`, the same arithmetic in plain
torch (each term's analytic gradient, sums in the kernel's order). A
config the kernel does not compute (a collision knob, a zoo term) keeps
the loop of `guide_gradient` calls on every device.

The optional knobs are JAX's (`mmd_tpu/costs/guide.py:67-78`): collision
on the 1.5x-interpolated trajectory, or on the extra objects only, and the
cost zoo's terms (`mmd_torch/costs/zoo.py`), each clipped, zeroed at the
endpoints and weighted; a zero weight adds no term. The collision kernel
covers neither collision knob, so a config that sets one takes the
autograd code on every device (its lookup is still the lookup kernel on
the card).

A multi-tile plan guides its T tiles in one call, as JAX's vmap of the
guided step over tiles does (mmd_tpu/models/ensemble.py:119-131): x is
(T, B, H, D) and the `GuideData` is stacked over tiles (a `SceneStack`,
per-tile normalizer limits of shape (T, 1, 1, D), constraint sets
(T, K, P, ...), soft paths (T, R, H, ...)); each term is batched over
(T, B), and tile m's rows see only tile m's data.

N problems on one scene (a team root, a repair round, a conflict's
children: JAX's vmapped programs) take the same shapes with a single
`SceneData`: x (N, B, H, D), constraint sets (N, K, P, ...), soft paths
(N, R, H, ...), the normalizer shared or (N, 1, 1, D). The collision term
then takes u as (N * B, H, 4) rows of the one scene, one kernel launch for
all N problems. A set's `n_active` counts all N problems' constraints, and
a problem whose rows are all inactive adds exactly zero.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mmd_torch.config import params as default_params
from mmd_torch.costs.constraints import (
    ConstraintSet,
    SoftPathConstraints,
    constraint_costs,
    relu,
    soft_path_cost,
)
from mmd_torch.costs.gp import gp_trajectory_cost
from mmd_torch.costs.zoo import cost_joint_limits, cost_max_velocity, cost_smoothness_chomp
from mmd_torch.datasets.normalization import LimitsNormalizer
from mmd_torch.envs.envs import SceneData, SceneStack
from mmd_torch.envs.grid_sdf import grid_sdf_pair
from mmd_torch.ops.collision_guide import collision_guide
from mmd_torch.ops.guide_loop import gp_constants, guide_loop_cuda
from mmd_torch.tasks.task import boundary_signed_distances, scene_object_sdf
from mmd_torch.utils.interp import interpolate_points


@dataclasses.dataclass(frozen=True)
class GuideConfig:
    q_dim: int = 2
    dt: float = default_params.trajectory_duration / default_params.horizon  # mpd.py:142
    robot_radius: float = default_params.robot_planar_disk_radius
    obstacle_cutoff_margin: float = 0.01   # tasks.py:29
    weight_collision: float = default_params.weight_grad_cost_collision
    weight_smoothness: float = default_params.weight_grad_cost_smoothness
    max_grad_norm: float = 1.0
    interpolate_collision: bool = False
    num_interpolated_points: int = 96      # ceil(64 * 1.5), mpd.py:263
    # Guide only on the env's extra objects (reference
    # use_guide_on_extra_objects_only, mmd_params.py:32, mpd.py:215-221).
    use_extra_objects_only: bool = False
    # Optional cost-zoo terms (costs/zoo.py); a zero weight adds no term.
    weight_max_velocity: float = 0.0
    max_velocity: float = 0.0
    weight_chomp_smoothness: float = 0.0
    weight_joint_limits: float = 0.0
    joint_limit_eps: float = 0.05236  # np.deg2rad(3), cost_functions.py:585

    @property
    def collision_margin(self) -> float:
        # link margin (1.1 r, robot_planar_disk.py:68) + cutoff margin
        return 1.1 * self.robot_radius + self.obstacle_cutoff_margin

    @property
    def collision_kernel_applies(self) -> bool:
        """Whether the collision-guide kernel computes this config's
        collision terms: it reads the 64 support points and both grids."""
        return not (self.interpolate_collision or self.use_extra_objects_only)

    @property
    def guide_loop_applies(self) -> bool:
        """Whether the guide-loop kernel computes this config's guide: the
        collision kernel's terms, the GP prior, the constraints and soft
        paths on planar positions, and no zoo term."""
        return (self.collision_kernel_applies and self.q_dim == 2
                and not (self.weight_max_velocity > 0.0 or self.weight_chomp_smoothness > 0.0
                         or self.weight_joint_limits > 0.0))


@dataclasses.dataclass(frozen=True)
class GuideData:
    """Per-plan guide inputs, or a tile stack's (module docstring)."""

    scene: SceneData  # or a SceneStack
    normalizer: LimitsNormalizer
    constraints: ConstraintSet
    soft_paths: Optional[SoftPathConstraints] = None

    def problems(self, rows: slice) -> "GuideData":
        """A batched call's guide data, stacked sets and soft rows leading
        with N problems, cut to problems `rows`; the scene and normalizer
        are every problem's."""
        return GuideData(scene=self.scene, normalizer=self.normalizer,
                         constraints=self.constraints.take(rows),
                         soft_paths=None if self.soft_paths is None
                         else self.soft_paths.take(rows))

    def tiles(self, rows: slice) -> "GuideData":
        """A tile stack's guide data cut to tiles `rows`: the scenes, the
        per-tile limits (T, 1, 1, D, `LimitsNormalizer.stack`), the sets
        and the soft rows."""
        norm = self.normalizer
        return dataclasses.replace(
            self.problems(rows), scene=SceneStack(self.scene.scenes[rows]),
            normalizer=LimitsNormalizer(mins=norm.mins[rows], maxs=norm.maxs[rows]))


def _collision_points(u: torch.Tensor, cfg: GuideConfig) -> torch.Tensor:
    if cfg.interpolate_collision:
        u = interpolate_points(u, cfg.num_interpolated_points)
    return u[..., 1:, : cfg.q_dim]  # skip waypoint 0 (FieldFactor range [1, None])


def collision_cost_objects(u: torch.Tensor, scene: SceneData, cfg: GuideConfig) -> torch.Tensor:
    """(B, H, D) unnormalized -> (B,): relu(margin - sdf) summed over H."""
    q = _collision_points(u, cfg)
    if cfg.use_extra_objects_only:
        sd = grid_sdf_pair(scene.grid, scene.extra_grid, q)[1]
    else:
        sd = scene_object_sdf(scene, q)
    return relu(cfg.collision_margin - sd).sum(dim=-1)


def collision_cost_boundaries(u: torch.Tensor, scene: SceneData, cfg: GuideConfig) -> torch.Tensor:
    """(B, H, D) -> (B,): max-over-walls relu(margin - sd) summed over H."""
    q = _collision_points(u, cfg)
    sd = boundary_signed_distances(scene, q)
    return relu(cfg.collision_margin - sd).amax(dim=-1).sum(dim=-1)


def _finish(g: torch.Tensor, max_norm: float) -> torch.Tensor:
    """Per-waypoint norm clip with the +1e-6 quirk, then zero the start and
    goal waypoints."""
    norm = torch.linalg.vector_norm(g + 1e-6, dim=-1, keepdim=True)
    g = g * (torch.clamp(norm, 0.0, max_norm) / norm)
    g[..., 0, :] = 0.0
    g[..., -1, :] = 0.0
    return g


def _grad(cost, u: torch.Tensor) -> torch.Tensor:
    v = u.detach().requires_grad_(True)
    (g,) = torch.autograd.grad(cost(v).sum(), v)
    return g


def collision_guide_plain(u: torch.Tensor, scene: SceneData, cfg: GuideConfig) -> torch.Tensor:
    """The collision-guide kernel's plain version: both collision terms of
    the guide, each through `_finish` and weighted, by autograd. With a
    `SceneStack` u is (T, ..., H, 4) and tile m's rows take scene m."""
    if isinstance(scene, SceneStack):
        return torch.stack([collision_guide_plain(u[m], s, cfg)
                            for m, s in enumerate(scene.scenes)])
    with torch.enable_grad():
        g_obj = _grad(lambda v: collision_cost_objects(v, scene, cfg), u)
        g_bound = _grad(lambda v: collision_cost_boundaries(v, scene, cfg), u)
    out = cfg.weight_collision * _finish(g_obj, cfg.max_grad_norm)
    return out + cfg.weight_collision * _finish(g_bound, cfg.max_grad_norm)


def collision_gradient(u: torch.Tensor, scene: SceneData, cfg: GuideConfig) -> torch.Tensor:
    """u (..., H, 4) unnormalized -> the guide's collision step (..., H, 4);
    (T, ..., H, 4) on a `SceneStack`.

    CUDA tensors go to the kernel, CPU tensors to the plain version.
    """
    if not cfg.collision_kernel_applies:
        # The kernel reads the 64 support points and both grids; the
        # interpolated or extra-objects-only terms are its autograd code,
        # whose lookup is the lookup kernel on the card.
        return collision_guide_plain(u, scene, cfg)
    if u.is_cuda:
        return collision_guide(u, scene, cfg)
    if u.device.type == "cpu":
        return collision_guide_plain(u, scene, cfg)
    raise ValueError(f"collision_gradient: unsupported device {u.device}")


def _constraint_gradient(u: torch.Tensor, cset: ConstraintSet, cfg: GuideConfig) -> torch.Tensor:
    """Every constraint's weighted, clipped gradient, summed. Constraint k
    acts on row k of a K-fold copy of u, so one backward pass gives each
    its own gradient to clip; a tile stack's T * K constraints act on T * K
    rows, tile m's on copies of u[m]."""
    K = cset.max_constraints
    batch = u.shape[cset.q.dim() - 3:]    # (B, H, D), after a stack's T
    flat = cset.flat()
    uk = u.detach().reshape(-1, 1, *batch).expand(-1, K, *batch).contiguous()
    uk = uk.view(-1, *batch).requires_grad_(True)
    (g,) = torch.autograd.grad(constraint_costs(uk[..., : cfg.q_dim], flat).sum(), uk)
    g_cons = flat.weight[:, None, None, None] * _finish(g, cfg.max_grad_norm)
    return g_cons.reshape(-1, K, *batch).sum(dim=1).reshape(u.shape)


def _zoo_terms(u: torch.Tensor, normalizer: LimitsNormalizer, cfg: GuideConfig):
    """The cost zoo's terms of nonzero weight, each clipped, zeroed at the
    endpoints and weighted, in JAX's order (guide.py:155-170); none when
    every weight is 0."""
    if cfg.weight_max_velocity > 0.0:
        g = _grad(lambda v: cost_max_velocity(v, cfg.dt, cfg.max_velocity, cfg.q_dim), u)
        yield cfg.weight_max_velocity * _finish(g, cfg.max_grad_norm)
    if cfg.weight_chomp_smoothness > 0.0:
        g = _grad(lambda v: cost_smoothness_chomp(v, cfg.dt), u)
        yield cfg.weight_chomp_smoothness * _finish(g, cfg.max_grad_norm)
    if cfg.weight_joint_limits > 0.0:
        lo = normalizer.mins[..., : cfg.q_dim]
        hi = normalizer.maxs[..., : cfg.q_dim]
        g = _grad(lambda v: cost_joint_limits(v, lo, hi, cfg.joint_limit_eps, cfg.q_dim), u)
        yield cfg.weight_joint_limits * _finish(g, cfg.max_grad_norm)


def guide_gradient(x_norm: torch.Tensor, gd: GuideData, cfg: GuideConfig) -> torch.Tensor:
    """One guide evaluation. x_norm (B, H, D), or (T, B, H, D) with a tile
    stack's `gd`, or N problems' (N, B, H, D) -> the step to add to it
    (x <- x + guide(x), sample_functions.py:100-107)."""
    with torch.enable_grad():
        u = gd.normalizer.unnormalize(x_norm.detach())
        # Both collision terms, weighted and clipped: one kernel launch on
        # the card, the autograd of the two costs above on the CPU or under
        # a collision knob (`collision_gradient`).
        total = collision_gradient(u, gd.scene, cfg)
        g_gp = _grad(lambda v: gp_trajectory_cost(v, cfg.dt), u)
        total = total + cfg.weight_smoothness * _finish(g_gp, cfg.max_grad_norm)
        for term in _zoo_terms(u, gd.normalizer, cfg):
            total = total + term

        if gd.constraints.n_active > 0:
            total = total + _constraint_gradient(u, gd.constraints, cfg)

        spc = gd.soft_paths
        if spc is not None:
            g_sp = _grad(lambda v: soft_path_cost(v[..., : cfg.q_dim], spc), u)
            total = total + spc.weight[..., None, None, None] * _finish(g_sp, cfg.max_grad_norm)
    return -total


# --------------------------------------------------------------- the loop
# The guide loop's GP prior, constraint and soft-path terms follow JAX's
# float32 arithmetic on the CPU, where XLA fuses a norm's sum of squares
# and the GP prior's products into fused multiply-adds: `_fma` rounds
# a * b + c once, through float64, and the kernel does the same. The
# collision terms are the collision kernel's (`collision_guide_plain`).
_EPS = float(np.float32(1e-6))


def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to float32 (a * b is exact in float64)."""
    b = b.double() if isinstance(b, torch.Tensor) else b
    return (a.double() * b + c.double()).float()


def _norm(a: torch.Tensor) -> torch.Tensor:
    """||a|| over the last axis, the squares summed in order by fused
    multiply-adds (jnp.linalg.norm on the CPU)."""
    sq = a[..., 0] * a[..., 0]
    for c in range(1, a.shape[-1]):
        sq = _fma(a[..., c], a[..., c], sq)
    return torch.sqrt(sq)


def _clip_rows(g: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The guide's _finish on every waypoint of g (..., H, 4), or of a
    position-only term (..., H, 2) whose velocity channels are 0: the clip
    by ||g + 1e-6|| over four channels, then 0 at the first and last
    waypoint (the kernel's `clip_rows`)."""
    a = g + 1e-6
    if g.shape[-1] == 2:
        a = torch.cat([a, torch.full_like(a, _EPS)], dim=-1)
    norm = _norm(a)
    g = g * (torch.clamp(norm, 0.0, max_norm) / norm)[..., None]
    g[..., 0, :] = 0.0
    g[..., -1, :] = 0.0
    return g


def _gp_grad_rows(u: torch.Tensor, dt: float, pp: float, pv: float, vv: float) -> torch.Tensor:
    """d/du of the GP prior's sum_t e_t^T Q e_t, e_t = u_{t+1} - Phi u_t,
    at the inner waypoints (0 at the first and last): 2 Q e_{h-1} - Phi^T
    2 Q e_h, channel by channel as the kernel computes it (Q e with JAX's
    fused multiply-add)."""
    s, t = u[..., :-1, :], u[..., 1:, :]
    ep = t[..., :2] - (s[..., :2] + dt * s[..., 2:])
    ev = t[..., 2:] - s[..., 2:]
    gep = 2.0 * _fma(ev, pv, pp * ep)
    gev = 2.0 * _fma(ev, vv, pv * ep)
    g = torch.zeros_like(u)
    g[..., 1:-1, :2] = gep[..., :-1, :] - gep[..., 1:, :]
    g[..., 1:-1, 2:] = gev[..., :-1, :] - (dt * gep[..., 1:, :] + gev[..., 1:, :])
    return g


def _relu_grad(z: torch.Tensor) -> torch.Tensor:
    """d/dz of max(z, 0): 1, 0.5 at z == 0 (torch.maximum's), 0."""
    return torch.where(z > 0, 1.0, torch.where(z == 0, 0.5, 0.0))


def _ball_grad(diff: torch.Tensor, radius: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """d/dq of relu(radius - ||q - c||) * m from diff = q - c (..., 2):
    diff * (-(relu'(radius - d) * m) / d), 0 where d == 0 (torch's norm
    gradient there; JAX's is NaN)."""
    d = _norm(diff)
    s = -(_relu_grad(radius - d) * m) / d
    return torch.where((d > 0)[..., None], diff * s[..., None], 0.0)


def _grouped(t: torch.Tensor, dims: int) -> torch.Tensor:
    """A per-group input with a leading group axis, 1 where it is shared."""
    return t if t.dim() > dims else t[None]


def _constraint_step(q: torch.Tensor, cset: ConstraintSet, max_norm: float) -> torch.Tensor:
    """Every constraint's clipped, weighted gradient, summed over k in
    order; q (G, B, H, 2), the set shared or one a group."""
    cq, ct = _grouped(cset.q, 3), _grouped(cset.t_range, 3)            # (Gc, K, P, 2)
    cr, cpm = _grouped(cset.radius, 2), _grouped(cset.point_mask, 2)  # (Gc, K, P)
    cw, ca = _grouped(cset.weight, 1), _grouped(cset.active, 1)       # (Gc, K)
    K, P, H = cq.shape[1], cq.shape[2], q.shape[-2]
    h_idx = torch.arange(H, dtype=q.dtype, device=q.device)
    qk = q[:, None]                                                   # (G, 1, B, H, 2)
    acc = torch.zeros((q.shape[0], K, *q.shape[1:]), dtype=q.dtype, device=q.device)
    for p in range(P):
        in_range = ((h_idx >= ct[:, :, p, 0, None]) & (h_idx < ct[:, :, p, 1, None])).to(q.dtype)
        m = (in_range * cpm[:, :, p, None]) * ca[:, :, None]          # (Gc, K, H)
        acc = acc + _ball_grad(qk - cq[:, :, None, None, p, :], cr[:, :, p, None, None],
                               m[:, :, None, :])
    weighted = cw[:, :, None, None, None] * _clip_rows(acc, max_norm)
    out = torch.zeros_like(q)
    for k in range(K):
        out = out + weighted[:, k]
    return out


def _soft_path_step(q: torch.Tensor, spc: SoftPathConstraints, max_norm: float) -> torch.Tensor:
    """The soft paths' clipped, weighted gradient: the balls of waypoint h
    summed over r in order; q (G, B, H, 2), the paths shared or one a
    group."""
    pts, msk = _grouped(spc.points, 3), _grouped(spc.mask, 2)         # (Gs, R, H, 2), (Gs, R, H)
    radius = spc.radius.reshape(-1, 1, 1)
    acc = torch.zeros_like(q)
    for r in range(pts.shape[1]):
        acc = acc + _ball_grad(q - pts[:, r, None], radius, msk[:, r, None])
    return spc.weight.reshape(-1, 1, 1, 1) * _clip_rows(acc, max_norm)


def _add_positions(total: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return torch.cat([total[..., :2] + g, total[..., 2:]], dim=-1)


def guide_loop_plain(x: torch.Tensor, gd: GuideData, hard, cfg: GuideConfig,
                     n_steps: int) -> torch.Tensor:
    """The guide-loop kernel's plain version: n_steps iterations of
    x <- hard.apply(x + guide_gradient(x, gd, cfg)) with each term's
    analytic gradient, in the kernel's float32 operations and order (the
    collision terms are `collision_guide_plain`, the collision kernel's
    plain version). x (B, H, 4) or G groups' (G, B, H, 4) as the kernel
    takes it (`mmd_torch/ops/guide_loop.py`)."""
    if n_steps == 0 or x.numel() == 0:
        return x
    dt, pp, pv, vv = gp_constants(cfg.dt)
    cset = gd.constraints if gd.constraints.n_active > 0 else None
    for _ in range(n_steps):
        u = gd.normalizer.unnormalize(x)
        total = collision_guide_plain(u, gd.scene, cfg)
        total = total + cfg.weight_smoothness * _clip_rows(_gp_grad_rows(u, dt, pp, pv, vv),
                                                           cfg.max_grad_norm)
        q = u[..., :2] if u.dim() == 4 else u[None, ..., :2]
        if cset is not None:
            total = _add_positions(total, _constraint_step(q, cset, cfg.max_grad_norm)
                                   .reshape(total.shape[:-1] + (2,)))
        if gd.soft_paths is not None:
            total = _add_positions(total, _soft_path_step(q, gd.soft_paths, cfg.max_grad_norm)
                                   .reshape(total.shape[:-1] + (2,)))
        x = hard.apply(x - total)
    return x


def guide_iterations(x: torch.Tensor, gd: GuideData, hard, cfg: GuideConfig,
                     n_steps: int) -> torch.Tensor:
    """The guide loop one `guide_gradient` call and `hard.apply` at a time:
    the loop of a config the guide-loop kernel does not compute."""
    for _ in range(n_steps):
        x = hard.apply(x + guide_gradient(x, gd, cfg))
    return x


def guide_loop(x: torch.Tensor, gd: GuideData, hard, cfg: GuideConfig,
               n_steps: int) -> torch.Tensor:
    """A guided diffusion step's guide loop: n_steps iterations of
    x <- hard.apply(x + guide_gradient(x, gd, cfg)) (JAX's fori_loop,
    mmd_tpu/models/diffusion.py:105-110). A CUDA tensor goes to the
    guide-loop kernel (one launch), a CPU tensor to `guide_loop_plain`; a
    config the kernel does not compute runs the iterations one
    `guide_gradient` at a time on either."""
    if not cfg.guide_loop_applies:
        return guide_iterations(x, gd, hard, cfg, n_steps)
    if x.is_cuda:
        return guide_loop_cuda(x, gd, hard, cfg, n_steps)
    if x.device.type == "cpu":
        return guide_loop_plain(x, gd, hard, cfg, n_steps)
    raise ValueError(f"guide_loop: unsupported device {x.device}")
