"""Planar disk robot: its radius, joint limits and robot-robot collisions.

Twin of `mmd_tpu/robots/disk.py` (reference: torch_robotics/robots/
robot_planar_disk.py). State layout [x, y, vx, vy].
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from mmd_torch.config import params as default_params


@dataclasses.dataclass(frozen=True)
class DiskRobot:
    radius: float
    q_min: torch.Tensor  # (2,)
    q_max: torch.Tensor  # (2,)

    @staticmethod
    def make(radius: float = default_params.robot_planar_disk_radius,
             q_limits=((-1.0, -1.0), (1.0, 1.0)), device="cuda") -> "DiskRobot":
        lim = torch.as_tensor(q_limits, dtype=torch.float32, device=device)
        return DiskRobot(radius=radius, q_min=lim[0], q_max=lim[1])

    @property
    def q_dim(self) -> int:
        return 2

    @property
    def collision_link_margin(self) -> float:
        return 1.1 * self.radius  # robot_planar_disk.py:68

    @property
    def rr_margin(self) -> float:
        return 2.1 * self.radius  # robot_planar_disk.py:186

    def get_position(self, x: torch.Tensor) -> torch.Tensor:
        return x[..., : self.q_dim]

    def within_limits(self, q: torch.Tensor) -> torch.Tensor:
        """(..., q_dim) -> (...) bool: every coordinate inside the limits."""
        return torch.all((q >= self.q_min) & (q <= self.q_max), dim=-1)


def distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """||a - b|| over the last axis as sqrt of the sum of squares, the
    arithmetic of `jnp.linalg.norm`, so that a test `distance < margin`
    decides a tie as JAX does."""
    d = a - b
    return torch.sqrt((d * d).sum(dim=-1))


def check_rr_collisions(points: torch.Tensor, margin: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """points (..., n, q_dim) -> (collisions (..., n, n) bool with a False
    diagonal, midpoints (..., n, n, q_dim) of colliding pairs, NaN where
    there is no collision) (robot_planar_disk.py:173-203)."""
    a = points[..., :, None, :]
    b = points[..., None, :, :]
    n = points.shape[-2]
    eye = torch.eye(n, dtype=torch.bool, device=points.device)
    coll = (distance(a, b) < margin) & ~eye
    mid = 0.5 * (a + b)
    mid = torch.where(coll[..., None], mid, torch.full_like(mid, float("nan")))
    return coll, mid
