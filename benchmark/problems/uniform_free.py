"""Start and goal generator `uniform_free`: each problem's start and goal
drawn uniformly in the workspace and kept where the map's exact SDF (the
min over its boxes of the box SDF) and the distance to the workspace's
edge are at least the robot's radius plus the traffic's `free_margin`, as
`eval_model`'s tasks are drawn (a collision-free start and goal, no
distance asked between them)."""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def box_sdf_np(q: np.ndarray, boxes, sizes) -> np.ndarray:
    if len(boxes) == 0:
        return np.full(q.shape[:-1], np.inf)
    c = np.asarray(boxes, np.float64)
    h = np.asarray(sizes, np.float64) / 2.0
    d = np.abs(q[..., None, :] - c) - h
    return d.max(axis=-1).min(axis=-1)


def free_points(rng: np.random.Generator, n: int, cfg: Dict, free_margin: float) -> np.ndarray:
    """(n, 2) free positions drawn by rejection."""
    (lo, hi) = np.asarray(cfg["workspace"], np.float64)
    need = cfg["robot_radius"] + free_margin
    out = np.zeros((0, 2))
    while out.shape[0] < n:
        q = rng.uniform(lo, hi, size=(4 * n, 2))
        ok = box_sdf_np(q, cfg["boxes"], cfg["box_sizes"]) >= need
        ok &= np.all((q - lo >= need) & (hi - q >= need), axis=-1)
        out = np.concatenate([out, q[ok]])
    return out[:n].astype(np.float32)


def draw(rng: np.random.Generator, n: int, cfg: Dict,
         traffic: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """(starts, goals) of n problems, each (n, 2) float32."""
    pts = free_points(rng, 2 * n, cfg, traffic["free_margin"]).reshape(n, 2, 2)
    return pts[:, 0], pts[:, 1]
