"""Trajectory dataset metadata and the planner's hard conditions.

Twin of the inference part of `mmd_tpu/datasets/trajectories.py`
(reference: mmd/datasets/trajectories.py:23-249): the model id, the shapes
and duration of a dataset, its normalizer and `get_hard_conditions`.
`metadata.yaml` is read with the port's flat YAML reader; of
`trajs-free.npz` only the array header is read, for the shape.
"""
from __future__ import annotations

import os
import zipfile
from typing import Optional, Tuple

import numpy as np
import torch

from mmd_torch.datasets.normalization import LimitsNormalizer
from mmd_torch.envs.envs import make_env
from mmd_torch.io.flat_yaml import load_flat_yaml
from mmd_torch.models.diffusion import HardConds
from mmd_torch.robots.disk import DiskRobot


def model_id(env_name: str, robot_name: str = "RobotPlanarDisk") -> str:
    """Checkpoint/dataset directory name, e.g. 'EnvEmpty2D-RobotPlanarDisk'
    (reference: inference_multi_agent.py:388, mpd.py:116)."""
    return f"{env_name}-{robot_name}"


def npz_array_shape(path: str, name: str = "trajs") -> Tuple[int, ...]:
    """Shape of one array of an .npz, from its .npy header alone."""
    with zipfile.ZipFile(path) as zf, zf.open(f"{name}.npy") as f:
        version = np.lib.format.read_magic(f)
        if version == (1, 0):
            shape, _, _ = np.lib.format.read_array_header_1_0(f)
        elif version == (2, 0):
            shape, _, _ = np.lib.format.read_array_header_2_0(f)
        else:
            raise ValueError(f"{path}: unsupported .npy version {version}")
    return tuple(shape)


class TrajectoryDataset:
    """What planning needs of one (env, robot) dataset."""

    def __init__(self, env_name: str, n_support_points: int, state_dim: int,
                 normalizer: LimitsNormalizer, duration: float = 5.0,
                 robot: Optional[DiskRobot] = None, device="cuda"):
        self.env_name = env_name
        self.n_support_points = n_support_points
        self.state_dim = state_dim
        # Physical duration in seconds: 5.0 over H=64 in the reference
        # (mmd_params.py:34, dt = 5/64).
        self.duration = float(duration)
        self.normalizer = normalizer
        self.device = torch.device(device)
        self.robot = robot or DiskRobot.make(device=device)
        self.env = make_env(env_name, device)

    @staticmethod
    def load(root: str, mid: str, normalizer: LimitsNormalizer,
             device="cuda") -> "TrajectoryDataset":
        d = os.path.join(root, mid)
        meta = load_flat_yaml(os.path.join(d, "metadata.yaml"))
        _, H, D = npz_array_shape(os.path.join(d, "trajs-free.npz"))
        return TrajectoryDataset(meta["env_id"], H, D, normalizer,
                                 duration=meta.get("duration", 5.0), device=device)

    def get_hard_conditions(self, start_pos: torch.Tensor,
                            goal_pos: torch.Tensor) -> HardConds:
        """{0: [start_pos, 0 vel], H-1: [goal_pos, 0 vel]}, normalized
        (reference: trajectories.py:216-239)."""
        q_dim = start_pos.shape[-1]
        zeros = torch.zeros(q_dim, dtype=torch.float32, device=start_pos.device)
        start = torch.cat([start_pos, zeros])
        goal = torch.cat([goal_pos, zeros])
        start = self.normalizer.normalize(start)
        goal = self.normalizer.normalize(goal)
        H = self.n_support_points
        kw = dict(dtype=torch.float32, device=start_pos.device)
        mask = torch.zeros((H, 1), **kw)
        mask[0] = 1.0
        mask[H - 1] = 1.0
        values = torch.zeros((H, self.state_dim), **kw)
        values[0] = start
        values[H - 1] = goal
        return HardConds(mask=mask, values=values)
