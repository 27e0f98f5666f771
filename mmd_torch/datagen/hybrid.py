"""Hybrid planner: sample-based segments, a spline resample, a GPMP2 polish.

Twin of `mmd_tpu/datagen/hybrid.py` (reference: mp_baselines/planners/
hybrid_planner.py:36-129):
- each pre-optimization planner runs once per trajectory and the segment
  paths are concatenated (a straight line where a segment fails,
  hybrid_planner.py:47-57)
- a clamped cubic spline resamples each path to H points, with the
  average velocity on the interior points (smoothen_trajectory,
  torch_robotics trajectory/utils.py:8-38)
- GPMP2 polishes all trajectories at once on the device.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch
from scipy import interpolate

from mmd_torch.datagen.gpmp2 import GPMP2Config, gpmp2_optimize
from mmd_torch.envs.envs import SceneData
from mmd_torch.utils.transfer import to_device


def smoothen_trajectory(traj_pos: np.ndarray, n_support_points: int,
                        dt: float) -> np.ndarray:
    """(K, 2) waypoints -> (H, 4) [pos, vel] states: a cubic spline with
    clamped ends, and the path's first segment over the whole duration as
    the interior velocity (trajectory/utils.py:8-38)."""
    traj_pos = np.asarray(traj_pos, np.float64)
    if traj_pos.shape[0] < 4:
        # Too short for a clamped cubic: densify linearly first (the
        # reference retries with a jittered extra point).
        t = np.linspace(0, 1, 4)
        traj_pos = np.stack([
            np.interp(t, np.linspace(0, 1, traj_pos.shape[0]), traj_pos[:, d])
            for d in range(traj_pos.shape[1])], axis=-1)
    x = np.linspace(0, 1, traj_pos.shape[0])
    spline = interpolate.make_interp_spline(x, traj_pos, k=3, bc_type="clamped")
    pos = spline(np.linspace(0, 1, n_support_points))
    vel = np.zeros_like(pos)
    avg_vel = (traj_pos[1] - traj_pos[0]) / (n_support_points * dt)
    vel[1:-1] = avg_vel
    return np.concatenate([pos, vel], axis=-1).astype(np.float32)


def initial_trajectories(segment_planner_factories: Sequence, n_trajectories: int,
                         cfg: GPMP2Config) -> np.ndarray:
    """(n_trajectories, H, 4) spline-resampled paths of the segment
    planners, each factory called once a trajectory in order
    (MultiSampleBasedPlanner, multi_sample_based_planner.py:22-42)."""
    init = []
    for _ in range(n_trajectories):
        segs = []
        for factory in segment_planner_factories:
            planner = factory()
            path = planner.optimize()
            if path is None:
                path = np.linspace(np.asarray(planner.start_state_pos, np.float32),
                                   np.asarray(planner.goal_state_pos, np.float32), 10)
            segs.append(np.asarray(path, np.float32))
        init.append(smoothen_trajectory(np.concatenate(segs, axis=0),
                                        cfg.n_support_points, cfg.dt))
    return np.stack(init)


def endpoint_state(pos: np.ndarray, device) -> torch.Tensor:
    """[pos, zero velocity] on the device."""
    return to_device(np.concatenate([np.asarray(pos)[:2], np.zeros(2)]).astype(np.float32),
                     device)


def hybrid_plan(scene: SceneData, segment_planner_factories: Sequence, n_trajectories: int,
                start_state_pos: np.ndarray, goal_state_pos: np.ndarray,
                gpmp_cfg: GPMP2Config, timing: Optional[dict] = None) -> torch.Tensor:
    """(n_trajectories, H, 4) optimized trajectories on the scene's device.

    segment_planner_factories: callables () -> a planner with .optimize()
    -> (K, 2) path or None, each run once a trajectory and segment. With
    `timing`, the host seconds of the segments and splines go to its
    "segments_s"."""
    device = scene.ws_min.device
    t0 = time.perf_counter()
    init = initial_trajectories(segment_planner_factories, n_trajectories, gpmp_cfg)
    if timing is not None:
        timing["segments_s"] = time.perf_counter() - t0
    init = to_device(init, device)
    return gpmp2_optimize(scene, endpoint_state(start_state_pos, device),
                          endpoint_state(goal_state_pos, device), init, gpmp_cfg)
