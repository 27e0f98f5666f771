"""Planar disk robot: its radius and joint limits.

Twin of `DiskRobot` in `mmd_tpu/robots/disk.py` (reference:
torch_robotics/robots/robot_planar_disk.py). State layout [x, y, vx, vy].
"""
from __future__ import annotations

import dataclasses

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

