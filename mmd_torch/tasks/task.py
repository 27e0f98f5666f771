"""Collision queries and free/collision classification of trajectories.

Twin of `mmd_tpu/tasks/task.py` (reference: torch_robotics/tasks/tasks.py).
- a waypoint is in collision iff the grid SDF < margin, or a signed distance
  to a wall of the 1.08-scaled workspace box < margin (tasks.py:50-86,
  distance_fields.py:318-326)
- classification interpolates trajectories x5 via-points and uses
  margin = robot radius (tasks.py:236-254)
- a free trajectory also stays inside the joint limits at every waypoint of
  the non-interpolated trajectory (tasks.py:263-285)
- free configurations are drawn by rejection: a batch of uniform
  candidates on the device, filtered there, survivors picked on the host
  (tasks.py:105-131)
- the soft collision cost of a waypoint sums the objects' hinge and the
  walls' largest hinge at the link margin + 0.01 (tasks.py:230-234)
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from mmd_torch.costs.constraints import relu
from mmd_torch.envs.envs import WS_BOUNDARY_SCALE, Env2D, SceneData, make_env
from mmd_torch.envs.grid_sdf import grid_sdf_pair
from mmd_torch.robots.disk import DiskRobot
from mmd_torch.utils.interp import interpolate_traj_via_points


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


def compute_collision_cost_sdf(scene: SceneData, q: torch.Tensor, margin: float) -> torch.Tensor:
    """Soft collision cost a waypoint, q (..., 2) -> (...,): relu(margin -
    sdf) of the objects plus the walls' largest relu(margin - sd)
    (distance_fields.py:115-129; the task-level query of tasks.py:230-234
    sums the two fields, the guide keeps them apart)."""
    obj = relu(margin - scene_object_sdf(scene, q))
    bound = relu(margin - boundary_signed_distances(scene, q)).amax(dim=-1)
    return obj + bound


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


def draw_candidates(generator: torch.Generator, n: int, q_min: torch.Tensor,
                    q_max: torch.Tensor) -> torch.Tensor:
    """n configurations uniform in [q_min, q_max], (n, 2), on the
    generator's device."""
    u = torch.rand((n, q_min.shape[-1]), generator=generator, device=q_min.device)
    return q_min + u * (q_max - q_min)


def _sample_coll_free(scene: SceneData, generator: torch.Generator, radius: float,
                      q_min: torch.Tensor, q_max: torch.Tensor,
                      n_candidates: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """One batch of rejection sampling (task.py:96-111): (candidates
    (n_candidates, 2), free_mask (n_candidates,)), both on the device."""
    qs = draw_candidates(generator, n_candidates, q_min, q_max)
    return qs, ~waypoint_in_collision(scene, qs, radius)


def _mean(mask: torch.Tensor) -> float:
    """The share of True in `mask` as `jnp.mean` computes it in float32: the
    (exact) count times the float32 reciprocal of the size, so that 9475 of
    9475 gives 0.99999994 as in the JAX package."""
    return float(np.float32(mask.sum().item()) * np.float32(1.0 / mask.numel()))


class PlanningTask:
    """An environment and a robot, with the collision query the team
    planners ask (tasks.py:22-331)."""

    def __init__(self, env: Env2D, robot: Optional[DiskRobot] = None):
        self.env = env
        self.scene = env.scene
        self.device = env.scene.ws_min.device
        self.robot = robot or DiskRobot.make(device=self.device)
        # The reference classifies at the robot's radius (tasks.py:249-254).
        self.margin = self.robot.radius

    def compute_collision(self, x: torch.Tensor) -> torch.Tensor:
        """States (..., D) -> (...,) bool: the position in collision with the
        map or its walls, at the robot's radius."""
        return waypoint_in_collision(self.scene, self.robot.get_position(x), self.margin)

    def compute_collision_cost(self, x: torch.Tensor) -> torch.Tensor:
        """States (..., D) -> (...,) soft collision cost at the robot's link
        margin plus the obstacle cutoff margin, 0.01 (tasks.py:29)."""
        return compute_collision_cost_sdf(self.scene, self.robot.get_position(x),
                                          self.robot.collision_link_margin + 0.01)

    def get_trajs_collision_and_free(self, trajs: torch.Tensor, num_interpolation: int = 5
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(free_mask (B,), waypoint_collisions (B, H_interp)), classified at
        the robot's radius on the x5 interpolated trajectories."""
        return classify_trajs(self.scene, trajs, self.robot.radius, self.robot.q_min,
                              self.robot.q_max, num_interpolation)

    # Statistics over a batch of sampled trajectories (tasks.py:313-331);
    # each classifies anew and reads its number to the host, as JAX's do.
    def compute_fraction_free_trajs(self, trajs: torch.Tensor) -> float:
        free, _ = self.get_trajs_collision_and_free(trajs)
        return _mean(free)

    def compute_collision_intensity_trajs(self, trajs: torch.Tensor) -> float:
        _, wp = self.get_trajs_collision_and_free(trajs)
        return _mean(wp)

    def compute_success_free_trajs(self, trajs: torch.Tensor) -> int:
        free, _ = self.get_trajs_collision_and_free(trajs)
        return int(free.any())

    def random_coll_free_q(self, generator: torch.Generator, n_samples: int = 1,
                           max_tries: int = 8) -> np.ndarray:
        """n_samples collision-free configurations from `generator` (on the
        task's device), as a host array: (2,) for one, else (n, 2)
        (task.py:138-160). Each try draws 1024 * max(1, ceil(2n / 1024))
        candidates, filters them on the device and reads them and their
        mask to the host in one copy."""
        n_candidates = 1024 * max(1, -(-2 * n_samples // 1024))
        out = []
        for _ in range(max_tries):
            qs, free = _sample_coll_free(self.scene, generator, self.robot.radius,
                                         self.robot.q_min, self.robot.q_max, n_candidates)
            host = torch.cat([qs, free[:, None].to(qs.dtype)], dim=-1).cpu().numpy()
            out.extend(host[host[:, -1] > 0, :-1][: n_samples - len(out)])
            if len(out) >= n_samples:
                break
        if len(out) < n_samples:
            raise RuntimeError("random_coll_free_q: could not find free configurations")
        arr = np.stack(out).astype(np.float32)
        return arr[0] if n_samples == 1 else arr


def make_task(env_name: str, device="cuda") -> PlanningTask:
    return PlanningTask(make_env(env_name, device))
