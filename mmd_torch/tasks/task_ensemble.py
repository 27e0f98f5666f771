"""Tiled planning task: global-frame queries over a chain of local tasks.

Twin of `mmd_tpu/tasks/task_ensemble.py` (reference: torch_robotics/tasks/
tasks_ensemble.py). The tiles' scenes are stacked once (`SceneStack`), which
the guide reads as one table. A global collision query asks every tile
(its scene at the point shifted into its frame) and keeps the first tile
that contains the point; a point outside every tile is in collision
(tasks_ensemble.py:237-270).

As in JAX, the planner classifies samples per tile in local frames
(mpd_ensemble.py `_finalize_ensemble`); the reference's ensemble
classification is a stub that returns all free (tasks_ensemble.py:271-277).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from mmd_torch.envs.envs import SceneData, SceneStack
from mmd_torch.robots.disk import DiskRobot
from mmd_torch.tasks.task import PlanningTask, waypoint_in_collision


def stack_scenes(scenes: Sequence[SceneData]) -> SceneStack:
    return SceneStack(tuple(scenes))


def _global_collision(stacked: SceneStack, transforms: torch.Tensor,
                      q_global: torch.Tensor, margin: float) -> torch.Tensor:
    """q_global (..., 2) -> (...,) bool: the first tile that contains the
    point decides (infer_task_id_from_q, tasks_ensemble.py:345); outside
    every tile, in collision (tasks_ensemble.py:247-256)."""
    inside, coll = [], []
    for scene, t in zip(stacked.scenes, transforms):
        q_local = q_global - t
        inside.append(torch.all(torch.abs(q_local) <= 1.0, dim=-1))
        coll.append(waypoint_in_collision(scene, q_local, margin))
    inside, coll = torch.stack(inside), torch.stack(coll)
    first = torch.argmax(inside.to(torch.int32), dim=0)      # the first maximum
    chosen = torch.take_along_dim(coll, first[None], dim=0)[0]
    return torch.where(inside.any(dim=0), chosen, torch.ones_like(chosen))


class TaskEnsemble:
    """A chain of per-tile PlanningTasks in one global frame: what the team
    planners ask of a multi-tile agent's task (JAX's helpers for frames and
    bounds have no caller and are not ported)."""

    def __init__(self, tasks: List[PlanningTask], transforms,
                 robot: Optional[DiskRobot] = None):
        self.tasks = list(tasks)
        self.transforms = np.asarray(transforms, np.float32)   # (T, 2)
        self.robot = robot or self.tasks[0].robot
        self.stacked_scenes = stack_scenes([t.scene for t in self.tasks])
        self.device = self.tasks[0].device
        self._transforms_dev = torch.as_tensor(self.transforms, device=self.device)

    @property
    def n_tiles(self) -> int:
        return len(self.tasks)

    def compute_collision(self, x: torch.Tensor, margin: Optional[float] = None
                          ) -> torch.Tensor:
        """Global states (..., >= 2) -> (...,) bool, at the robot's radius
        unless `margin` is given."""
        m = margin if margin is not None else self.robot.radius
        return _global_collision(self.stacked_scenes, self._transforms_dev, x[..., :2], m)

