"""Multi-agent helpers: validity gates, path padding, start/goal layouts.

Twin of `mmd_tpu/common/multi_agent_utils.py` (reference:
mmd/common/multi_agent_utils.py:28-225). The gates run once per team
instance, on the task's device.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from mmd_torch.envs.grid_sdf import grid_sdf_pair
from mmd_torch.robots.disk import DiskRobot, check_rr_collisions


def _on(task, arrays) -> torch.Tensor:
    return torch.as_tensor(np.stack([np.asarray(a, np.float32) for a in arrays]),
                           device=task.device)


def is_multi_agent_state_valid(robot: DiskRobot, task, state_pos_l: List) -> bool:
    """No two robots and no robot and the map collide (reference:
    multi_agent_utils.py:32-50)."""
    pos = _on(task, state_pos_l)
    coll, _ = check_rr_collisions(pos, robot.rr_margin)
    if bool(coll.any()):
        return False
    return not bool(task.compute_collision(pos).any())


def is_multi_agent_start_goal_states_valid(robot: DiskRobot, task, start_l: List,
                                           goal_l: List,
                                           is_enforce_min_dist: bool = True,
                                           min_dist: float = 0.15) -> bool:
    """reference: multi_agent_utils.py:53-94."""
    starts = np.stack([np.asarray(s) for s in start_l])
    goals = np.stack([np.asarray(g) for g in goal_l])
    if is_enforce_min_dist:
        for arr in (starts, goals):
            d = np.linalg.norm(arr[:, None] - arr[None, :], axis=-1)
            np.fill_diagonal(d, np.inf)
            if (d < min_dist).any():
                return False
    return all(is_multi_agent_state_valid(robot, task, arr) for arr in (starts, goals))


def compute_collision_intensity(trajs_l: List, robot: DiskRobot, task) -> float:
    """Fraction of time steps with any robot-robot or world collision
    (reference: multi_agent_utils.py:97-117)."""
    per_t = _on(task, [np.asarray(t)[:, :2] for t in trajs_l]).transpose(0, 1)  # (T, n, 2)
    rr, _ = check_rr_collisions(per_t, robot.rr_margin)
    world = task.compute_collision(per_t).any(dim=-1)
    return float((rr.any(dim=(-1, -2)) | world).float().mean())


def global_pad_paths(path_l: List[np.ndarray], start_time_l: List[int]) -> List[np.ndarray]:
    """Each path led by its first state for its start time and trailed by its
    last state out to the longest (reference: multi_agent_utils.py:120-143)."""
    if len(path_l) == 0:
        return path_l
    path_l = [np.asarray(p) for p in path_l]
    max_t = max(len(p) + start_time_l[i] for i, p in enumerate(path_l))
    out = []
    for i, p in enumerate(path_l):
        tail = max_t - len(p) - start_time_l[i]
        if tail > 0:
            p = np.concatenate([p, np.repeat(p[-1:], tail, axis=0)])
        if start_time_l[i] > 0:
            p = np.concatenate([np.repeat(p[:1], start_time_l[i], axis=0), p])
        out.append(p)
    return out


def get_start_goal_pos_circle(num_agents: int, radius: float = 0.8
                              ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Antipodal points on a circle: agent i starts at angle 2 pi i / n and
    goes to the opposite point (reference: multi_agent_utils.py:146-155)."""
    starts, goals = [], []
    for i in range(num_agents):
        a = 2 * np.pi * i / num_agents
        starts.append(np.array([radius * np.cos(a), radius * np.sin(a)], np.float32))
        goals.append(np.array([radius * np.cos(a + np.pi), radius * np.sin(a + np.pi)],
                              np.float32))
    return starts, goals


def get_start_goal_pos_boundary(num_agents: int, dist: float = 0.87
                                ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Starts on the circle of radius 0.8 pushed out to the box of
    half-width `dist` along their larger axis, each goal the start mirrored
    across the other axis (reference: multi_agent_utils.py:157-174)."""
    starts = []
    for i in range(num_agents):
        a = 2 * np.pi * i / num_agents
        s = np.array([0.8 * np.cos(a), 0.8 * np.sin(a)], np.float32)
        if abs(s[0]) > abs(s[1]):
            s[0] = np.sign(s[0]) * dist
        else:
            s[1] = np.sign(s[1]) * dist
        starts.append(s)
    goals = [np.array([s[0] if abs(s[0]) < abs(s[1]) else -s[0],
                       s[1] if abs(s[1]) < abs(s[0]) else -s[1]], np.float32)
             for s in starts]
    return starts, goals


def get_start_goal_pos_random_in_env(num_agents: int, task,
                                     rng: Optional[np.random.Generator] = None,
                                     margin: float = 0.15,
                                     obstacle_margin: float = 0.16,
                                     max_tries: int = 10000
                                     ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Rejection-sampled starts and goals, each set mutually farther apart
    than `margin` and farther than `obstacle_margin` from the map's objects
    by its object grid (reference: multi_agent_utils.py:183-225). Each set
    draws max_tries candidates at once and clears them in one lookup."""
    rng = rng or np.random.default_rng(0)
    grid = task.scene.grid

    def sample_set() -> List[np.ndarray]:
        cand = rng.random((max_tries, 2)).astype(np.float32) * 1.9 - 0.95
        sdf, _ = grid_sdf_pair(grid, grid, torch.as_tensor(cand, device=task.device))
        clear = sdf.cpu().numpy() > obstacle_margin
        pts: List[np.ndarray] = []
        for q in cand[clear]:
            if pts and np.min(np.linalg.norm(np.stack(pts) - q, axis=-1)) <= margin:
                continue
            pts.append(q)
            if len(pts) == num_agents:
                return pts
        raise RuntimeError("could not sample valid multi-agent states")

    return sample_set(), sample_set()
