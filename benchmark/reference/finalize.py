"""A finished sampler call's finalize (MPD's `_finalize_plan`): classify,
score, choose and smooth the final samples.

- Classification: each trajectory's positions densified with 5 via-points
  a segment; a point is in collision where the grid's SDF or a wall is
  closer than the robot's radius; a trajectory is free where no point is
  in collision and every support point lies inside the joint limits.
- Scores: path length (summed segment lengths of the positions) plus
  smoothness (summed norms of the velocity steps); +inf where not free.
- The best trajectory: the first of the least score.
- Smoothing: a Savitzky-Golay filter (window 10, order 2, mode 'interp')
  along the horizon, as an (H, H) matrix.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from benchmark.reference.scene import Scene


@functools.lru_cache(maxsize=4)
def savgol(n: int, window: int = 10, order: int = 2) -> np.ndarray:
    from scipy.signal import savgol_filter

    eye = np.eye(n, dtype=np.float64)
    return np.stack([savgol_filter(eye[:, i], window, order, mode="interp")
                     for i in range(n)], axis=1).astype(np.float32)


def densify(q: torch.Tensor, k: int = 5) -> torch.Tensor:
    H = q.shape[-2]
    alphas = torch.arange(k + 1, dtype=q.dtype, device=q.device) / (k + 1)
    seg = q[..., :-1, None, :] * (1 - alphas)[:, None] + q[..., 1:, None, :] * alphas[:, None]
    flat = seg.reshape(*q.shape[:-2], (H - 1) * (k + 1), q.shape[-1])
    return torch.cat([flat, q[..., -1:, :]], dim=-2)


def finalize(u: torch.Tensor, scene: Scene, radius: float, q_min=(-1.0, -1.0),
             q_max=(1.0, 1.0)) -> dict:
    """u (..., B, H, 4) unnormalized final samples -> free (..., B),
    cost (..., B), best (...), smoothed (..., B, H, 4)."""
    q = u[..., :2]
    coll = scene.in_collision(densify(q), radius).any(dim=-1)
    lo = torch.as_tensor(q_min, dtype=u.dtype, device=u.device)
    hi = torch.as_tensor(q_max, dtype=u.dtype, device=u.device)
    inside = torch.all((q >= lo) & (q <= hi), dim=-1).all(dim=-1)
    free = ~coll & inside
    length = torch.linalg.vector_norm(torch.diff(q, dim=-2), dim=-1).sum(-1)
    smooth = torch.linalg.vector_norm(torch.diff(u[..., 2:4], dim=-2), dim=-1).sum(-1)
    cost = torch.where(free, length + smooth, torch.full_like(length, float("inf")))
    S = torch.as_tensor(savgol(u.shape[-2]), device=u.device)
    return {"free": free, "cost": cost, "best": torch.argmin(cost, dim=-1),
            "smoothed": torch.einsum("ij,...bjd->...bid", S, u)}
