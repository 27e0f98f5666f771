"""Linear trajectory data for the empty maps, made on the device.

Twin of `mmd_tpu/datagen/synthetic.py` (reference: scripts/generate_data/
generate_trajectories.py:559-705): straight start->goal motion at a fixed
speed, waiting at the goal for the remaining steps (EnvEmpty2D) or spread
over the whole horizon (EnvEmptyNoWait2D); velocities are per-step
position differences (reference :630-632). Starts and goals come from the
task's rejection sampler; the whole dataset is one batch.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from mmd_torch.datasets.trajectories import TrajectoryDataset
from mmd_torch.tasks.task import PlanningTask, make_task
from mmd_torch.utils.transfer import to_device


def _linear_batch(starts: torch.Tensor, goals: torch.Tensor, horizon: int,
                  v_mag: torch.Tensor) -> torch.Tensor:
    """starts, goals (N, 2), v_mag (N,) -> (N, H, 4) trajectories."""
    dist = torch.linalg.vector_norm(goals - starts, dim=-1)
    n_move = torch.floor(dist / v_mag).to(torch.int32)  # reference :621-623
    n_move = torch.clamp(n_move, 2, horizon)
    i = torch.arange(horizon, dtype=torch.float32, device=starts.device)[None, :]
    alpha = torch.clamp(i / (n_move[:, None].to(torch.float32) - 1.0), 0.0, 1.0)
    pos = starts[:, None, :] + alpha[..., None] * (goals - starts)[:, None, :]
    vel = torch.cat([pos[:, 1:] - pos[:, :-1], torch.zeros_like(pos[:, :1])], dim=1)
    return torch.cat([pos, vel], dim=-1)


def sample_start_goal_pairs(task: PlanningTask, generator: torch.Generator, n: int,
                            threshold: float = 1.0,
                            max_tries: int = 64) -> Tuple[np.ndarray, np.ndarray]:
    """n collision-free (start, goal) pairs at least `threshold` apart
    (reference: generate_trajectories.py:593-601), on the host."""
    starts, goals = [], []
    for _ in range(max_tries):
        qs = task.random_coll_free_q(generator, n_samples=2 * n)
        s, g = qs[:n], qs[n:]
        ok = np.linalg.norm(s - g, axis=-1) > threshold
        starts.extend(s[ok])
        goals.extend(g[ok])
        if len(starts) >= n:
            break
    if len(starts) < n:
        raise RuntimeError("could not sample enough start/goal pairs")
    return np.stack(starts[:n]), np.stack(goals[:n])


def generate_linear_dataset(env_name: str, n_contexts: int = 500, horizon: int = 64,
                            is_wait_at_goal: Optional[bool] = None, seed: int = 0,
                            threshold: float = 1.0, device="cuda") -> TrajectoryDataset:
    """A dataset of the free linear trajectories of n_contexts sampled
    pairs, on `device`. is_wait_at_goal: True -> 0.05 a step and a dwell at
    the goal (EnvEmpty2D's data); False -> the speed that spans the horizon
    (EnvEmptyNoWait2D's). The default follows the map's name."""
    if is_wait_at_goal is None:
        is_wait_at_goal = "NoWait" not in env_name
    task = make_task(env_name, device)
    generator = torch.Generator(device=task.device).manual_seed(seed)
    starts, goals = sample_start_goal_pairs(task, generator, n_contexts, threshold)
    starts, goals = to_device(starts, task.device), to_device(goals, task.device)
    dist = torch.linalg.vector_norm(goals - starts, dim=-1)
    if is_wait_at_goal:
        v_mag = torch.full((n_contexts,), 0.05, device=task.device)  # reference :614
    else:
        v_mag = dist / horizon                                         # reference :617
    trajs = _linear_batch(starts, goals, horizon, v_mag)
    free, _ = task.get_trajs_collision_and_free(trajs)
    trajs_free = trajs[free].cpu().numpy()
    if len(trajs_free) == 0:
        raise RuntimeError("no free linear trajectories: wrong map for this generator?")
    return TrajectoryDataset.from_trajs(trajs_free, env_name, device=device)
