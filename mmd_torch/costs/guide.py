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
  intended 1.5x interpolation never reaches its costs (guides.py:202)
- the result is the negative weighted gradient sum (guides.py:224-226)
"""
from __future__ import annotations

import dataclasses
from typing import Optional

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
from mmd_torch.datasets.normalization import LimitsNormalizer
from mmd_torch.envs.envs import SceneData
from mmd_torch.tasks.task import boundary_signed_distances, scene_object_sdf


@dataclasses.dataclass(frozen=True)
class GuideConfig:
    q_dim: int = 2
    dt: float = default_params.trajectory_duration / default_params.horizon  # mpd.py:142
    robot_radius: float = default_params.robot_planar_disk_radius
    obstacle_cutoff_margin: float = 0.01   # tasks.py:29
    weight_collision: float = default_params.weight_grad_cost_collision
    weight_smoothness: float = default_params.weight_grad_cost_smoothness
    max_grad_norm: float = 1.0

    @property
    def collision_margin(self) -> float:
        # link margin (1.1 r, robot_planar_disk.py:68) + cutoff margin
        return 1.1 * self.robot_radius + self.obstacle_cutoff_margin


@dataclasses.dataclass(frozen=True)
class GuideData:
    """Per-plan guide inputs."""

    scene: SceneData
    normalizer: LimitsNormalizer
    constraints: ConstraintSet
    soft_paths: Optional[SoftPathConstraints] = None


def _collision_points(u: torch.Tensor, cfg: GuideConfig) -> torch.Tensor:
    return u[..., 1:, : cfg.q_dim]  # skip waypoint 0 (FieldFactor range [1, None])


def collision_cost_objects(u: torch.Tensor, scene: SceneData, cfg: GuideConfig) -> torch.Tensor:
    """(B, H, D) unnormalized -> (B,): relu(margin - sdf) summed over H."""
    sd = scene_object_sdf(scene, _collision_points(u, cfg))
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


def guide_gradient(x_norm: torch.Tensor, gd: GuideData, cfg: GuideConfig) -> torch.Tensor:
    """One guide evaluation. x_norm (B, H, D) -> the step to add to it
    (x <- x + guide(x), sample_functions.py:100-107)."""
    with torch.enable_grad():
        u = gd.normalizer.unnormalize(x_norm.detach())
        g_obj = _grad(lambda v: collision_cost_objects(v, gd.scene, cfg), u)
        g_bound = _grad(lambda v: collision_cost_boundaries(v, gd.scene, cfg), u)
        g_gp = _grad(lambda v: gp_trajectory_cost(v, cfg.dt), u)

        total = cfg.weight_collision * _finish(g_obj, cfg.max_grad_norm)
        total = total + cfg.weight_collision * _finish(g_bound, cfg.max_grad_norm)
        total = total + cfg.weight_smoothness * _finish(g_gp, cfg.max_grad_norm)

        cset = gd.constraints
        if cset.n_active > 0:
            # Constraint k acts on row k of a K-fold copy, so one backward
            # pass gives every constraint its own gradient to clip.
            K = cset.max_constraints
            uk = u.detach().expand(K, *u.shape).clone().requires_grad_(True)
            (g,) = torch.autograd.grad(
                constraint_costs(uk[..., : cfg.q_dim], cset).sum(), uk)
            g_cons = cset.weight[:, None, None, None] * _finish(g, cfg.max_grad_norm)
            total = total + g_cons.sum(dim=0)

        if gd.soft_paths is not None:
            g_sp = _grad(lambda v: soft_path_cost(v[..., : cfg.q_dim], gd.soft_paths), u)
            total = total + gd.soft_paths.weight * _finish(g_sp, cfg.max_grad_norm)
    return -total
