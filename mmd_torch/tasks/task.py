"""Collision queries and free/collision classification of trajectories.

Twin of `mmd_tpu/tasks/task.py` (reference: torch_robotics/tasks/tasks.py).
- a waypoint is in collision iff the grid SDF < margin, or a signed distance
  to a wall of the 1.08-scaled workspace box < margin (tasks.py:50-86,
  distance_fields.py:318-326)
- classification interpolates trajectories x5 via-points and uses
  margin = robot radius (tasks.py:236-254)
- a free trajectory also stays inside the joint limits at every waypoint of
  the non-interpolated trajectory (tasks.py:263-285)
"""
from __future__ import annotations

from typing import Tuple

import torch

from mmd_torch.envs.envs import SceneData
from mmd_torch.envs.grid_sdf import grid_sdf_pair
from mmd_torch.utils.interp import interpolate_traj_via_points

WS_BOUNDARY_SCALE = 1.08  # reference: tasks.py:83-85


def boundary_signed_distances(scene: SceneData, q: torch.Tensor) -> torch.Tensor:
    """Signed distances to the 4 walls: (..., 2) -> (..., 4)
    (distance_fields.py:354-368)."""
    lo = scene.ws_min * WS_BOUNDARY_SCALE
    hi = scene.ws_max * WS_BOUNDARY_SCALE
    return torch.cat([q - lo, hi - q], dim=-1)


def scene_object_sdf(scene: SceneData, q: torch.Tensor) -> torch.Tensor:
    """Min over the object grid and the extra-objects grid (env_base.py:76-89),
    both read in one lookup. `torch.minimum` splits the gradient 0.5/0.5 on
    a tie, as `jnp.minimum` does."""
    a, b = grid_sdf_pair(scene.grid, scene.extra_grid, q)
    return torch.minimum(a, b)


def waypoint_in_collision(scene: SceneData, q: torch.Tensor, margin: float) -> torch.Tensor:
    """q: (..., 2) -> (...,) bool, occupancy-style check at one margin."""
    obj_coll = scene_object_sdf(scene, q) < margin
    bound_coll = torch.any(boundary_signed_distances(scene, q) < margin, dim=-1)
    return obj_coll | bound_coll


def classify_trajs(scene: SceneData, trajs: torch.Tensor, radius: float,
                   q_min: torch.Tensor, q_max: torch.Tensor,
                   num_interpolation: int = 5) -> Tuple[torch.Tensor, torch.Tensor]:
    """trajs (B, H, D) -> (free_mask (B,) bool, waypoint_collisions
    (B, H_interp) bool) (tasks.get_trajs_collision_and_free, tasks.py:236-311)."""
    q = trajs[..., :2]
    q_interp = interpolate_traj_via_points(q, num_interpolation)
    wp_coll = waypoint_in_collision(scene, q_interp, radius)
    coll_free = ~torch.any(wp_coll, dim=-1)
    in_limits = torch.all((q >= q_min) & (q <= q_max), dim=-1).all(dim=-1)
    return coll_free & in_limits, wp_coll
