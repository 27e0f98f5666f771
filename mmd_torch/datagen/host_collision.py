"""Host-side (numpy) collision checking for sample-based data generation.

Twin of `mmd_tpu/datagen/host_collision.py`. RRT's per-extend queries are
latency-bound, so a numpy box SDF beats sending each probe to the card
(the reference runs data generation on CPU workers,
launch_generate_trajectories.py). The SDF is the max-coordinate box SDF of
`mmd_torch/envs/primitives.py` (reference primitives.py:223).
"""
from __future__ import annotations

import numpy as np

from mmd_torch.envs.envs import WS_BOUNDARY_SCALE, Env2D


class HostCollisionChecker:
    def __init__(self, env: Env2D, robot_radius: float = 0.05,
                 obstacle_cutoff_margin: float = 0.03):
        self.centers = env.box_field.centers.cpu().numpy()      # (n, 2)
        self.half_sizes = env.box_field.half_sizes.cpu().numpy()
        self.lo = env.limits[0] * WS_BOUNDARY_SCALE
        self.hi = env.limits[1] * WS_BOUNDARY_SCALE
        self.q_min = env.limits[0]
        self.q_max = env.limits[1]
        # The validity margin of task.compute_collision's default: the link
        # margin (1.1 r) and the obstacle cutoff (tasks.py:50-58).
        self.margin = 1.1 * robot_radius + obstacle_cutoff_margin

    def sdf(self, q: np.ndarray) -> np.ndarray:
        """q: (..., 2) -> (...,) min over boxes (max-coordinate box SDF)."""
        if self.centers.shape[0] == 0:
            return np.full(q.shape[:-1], 1e6, np.float32)
        d = np.abs(q[..., None, :] - self.centers) - self.half_sizes
        return d.max(axis=-1).min(axis=-1)

    def in_collision(self, q: np.ndarray, margin: float = None) -> np.ndarray:
        """q: (..., 2) -> (...,) bool (objects, scaled-workspace walls,
        configuration limits)."""
        m = self.margin if margin is None else margin
        obj = self.sdf(q) < m
        bound = np.any((q - self.lo < m) | (self.hi - q < m), axis=-1)
        out = np.any((q < self.q_min) | (q > self.q_max), axis=-1)
        return obj | bound | out

    def segment_free(self, a: np.ndarray, b: np.ndarray, step: float = 0.01) -> bool:
        n = max(2, int(np.ceil(np.linalg.norm(b - a) / step)) + 1)
        t = np.linspace(0.0, 1.0, n)[:, None]
        pts = a[None] * (1 - t) + b[None] * t
        return not bool(self.in_collision(pts).any())

    def sample_free(self, rng: np.random.Generator, n: int) -> np.ndarray:
        out = []
        while len(out) < n:
            q = rng.uniform(self.q_min, self.q_max, size=(max(n, 256), 2)).astype(np.float32)
            q = q[~self.in_collision(q)]
            out.extend(q[: n - len(out)])
        return np.stack(out)
