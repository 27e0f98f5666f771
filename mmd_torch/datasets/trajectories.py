"""Trajectory datasets: metadata, trajectories, batches, hard conditions.

Twin of `mmd_tpu/datasets/trajectories.py` (reference:
mmd/datasets/trajectories.py:23-249). A planner's dataset
(`TrajectoryDataset.load`) holds the model id, the shapes and duration, the
checkpoint's normalizer and `get_hard_conditions`; of `trajs-free.npz` only
the array header is read, for the shape. A training dataset
(`TrajectoryDataset.load_trajectories`, `from_trajs`) also holds the
trajectories and their normalized copy on the device, with a normalizer fit
on them, and draws batches with `sample_batch`. `metadata.yaml` is read and
written with the port's flat YAML reader and writer.
"""
from __future__ import annotations

import os
import zipfile
from typing import Optional, Tuple

import numpy as np
import torch

from mmd_torch.datasets.normalization import LimitsNormalizer, make_normalizer
from mmd_torch.envs.envs import make_env
from mmd_torch.io.flat_yaml import load_flat_yaml, save_flat_yaml
from mmd_torch.models.diffusion import HardConds
from mmd_torch.robots.disk import DiskRobot
from mmd_torch.tasks.task import PlanningTask
from mmd_torch.utils.profiling import span
from mmd_torch.utils.transfer import to_device


def model_id(env_name: str, robot_name: str = "RobotPlanarDisk") -> str:
    """Checkpoint/dataset directory name, e.g. 'EnvEmpty2D-RobotPlanarDisk'
    (reference: inference_multi_agent.py:388, mpd.py:116)."""
    return f"{env_name}-{robot_name}"


def env_name_from_model_id(mid: str) -> str:
    """'EnvEmpty2D-RobotPlanarDisk' -> 'EnvEmpty2D'."""
    return mid.split("-")[0]


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


def endpoint_mask(horizon: int, device) -> torch.Tensor:
    """(H, 1): 1 at the first and last waypoints, 0 elsewhere, built on the
    host and copied without a wait."""
    mask = np.zeros((horizon, 1), np.float32)
    mask[[0, horizon - 1]] = 1.0
    return to_device(mask, device)


class TrajectoryDataset:
    """One (env, robot) dataset: what planning needs, and for training the
    trajectories (N, H, D) with their normalized copy, on the device."""

    def __init__(self, env_name: str, n_support_points: int, state_dim: int,
                 normalizer, duration: float = 5.0,
                 robot: Optional[DiskRobot] = None, device="cuda",
                 trajs: Optional[torch.Tensor] = None):
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
        self.trajs = trajs
        self.trajs_normalized = None if trajs is None else normalizer.normalize(trajs)
        self.n_trajs = None if trajs is None else trajs.shape[0]
        # Training's hard-condition mask, made here so that drawing a batch
        # copies nothing from the host.
        self.train_mask = None if trajs is None else endpoint_mask(n_support_points, device)
        self._task: Optional[PlanningTask] = None

    @staticmethod
    def load(root: str, mid: str, normalizer: LimitsNormalizer,
             device="cuda") -> "TrajectoryDataset":
        """A planner's dataset: the checkpoint's normalizer, no trajectories."""
        with span("dataset.load"):
            d = os.path.join(root, mid)
            meta = load_flat_yaml(os.path.join(d, "metadata.yaml"))
            _, H, D = npz_array_shape(os.path.join(d, "trajs-free.npz"))
            return TrajectoryDataset(meta["env_id"], H, D, normalizer,
                                     duration=meta.get("duration", 5.0), device=device)

    @staticmethod
    def from_trajs(trajs: np.ndarray, env_name: str, robot: Optional[DiskRobot] = None,
                   duration: float = 5.0, normalizer: str = "SafeLimitsNormalizer",
                   device="cuda") -> "TrajectoryDataset":
        """A training dataset of trajs (N, H, D), its normalizer (one of
        the reference's four names) fit on them; the default is the safe
        variant, as in the JAX package."""
        if np.ndim(trajs) != 3:
            raise ValueError(f"trajectories must be (N, H, D), got {np.shape(trajs)}")
        t = to_device(np.asarray(trajs, np.float32), device)
        _, H, D = t.shape
        return TrajectoryDataset(env_name, H, D, make_normalizer(normalizer, t),
                                 duration=duration, robot=robot, device=device, trajs=t)

    @staticmethod
    def load_trajectories(root: str, mid: str, normalizer: str = "SafeLimitsNormalizer",
                          device="cuda") -> "TrajectoryDataset":
        """A training dataset read from `root/mid` (the JAX package's
        `TrajectoryDataset.load`)."""
        d = os.path.join(root, mid)
        meta = load_flat_yaml(os.path.join(d, "metadata.yaml"))
        with np.load(os.path.join(d, "trajs-free.npz")) as z:
            trajs = z["trajs"]
        return TrajectoryDataset.from_trajs(trajs, meta["env_id"],
                                            duration=meta.get("duration", 5.0),
                                            normalizer=normalizer, device=device)

    def save(self, root: str, mid: Optional[str] = None):
        """`trajs-free.npz` and `metadata.yaml` under root/mid, as the JAX
        package writes them."""
        d = os.path.join(root, mid or model_id(self.env_name))
        os.makedirs(d, exist_ok=True)
        np.savez_compressed(os.path.join(d, "trajs-free.npz"), trajs=self.trajs.cpu().numpy())
        save_flat_yaml(os.path.join(d, "metadata.yaml"), {
            "env_id": self.env_name, "robot_id": "RobotPlanarDisk",
            "num_trajectories": int(self.n_trajs), "horizon": int(self.n_support_points),
            "duration": float(self.duration), "state_dim": int(self.state_dim)})

    @property
    def task(self) -> PlanningTask:
        if self._task is None:
            self._task = PlanningTask(self.env, self.robot)
        return self._task

    def sample_batch(self, generator: torch.Generator, batch_size: int,
                     start_idx: int = 0) -> Tuple[torch.Tensor, HardConds]:
        """A random batch of normalized trajectories, indices drawn from
        [start_idx, N) on the generator's device (the held-out validation
        prefix excluded), and hard conditions pinning each one's own start
        and goal (trajectories.py:153-168, 216-239). Waits on nothing."""
        idx = torch.randint(start_idx, self.n_trajs, (batch_size,), generator=generator,
                            device=self.device)
        batch = self.trajs_normalized.index_select(0, idx)
        return batch, HardConds(mask=self.train_mask, values=batch)

    def normalize_trajectories(self, x: torch.Tensor) -> torch.Tensor:
        return self.normalizer.normalize(x)

    def unnormalize_trajectories(self, x: torch.Tensor) -> torch.Tensor:
        return self.normalizer.unnormalize(x)

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
