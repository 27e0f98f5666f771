"""Trajectory metrics over (B, H, D) batches.

Twin of `mmd_tpu/utils/metrics.py` (reference:
torch_robotics/trajectory/metrics.py:7-65). Positions are [..., :q_dim],
velocities [..., q_dim:2q_dim].
"""
from __future__ import annotations

import torch


def _step_norms(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.diff(x, dim=-2), dim=-1)


def compute_path_length(trajs: torch.Tensor, q_dim: int = 2) -> torch.Tensor:
    """Sum of segment lengths (metrics.py:7-16). (B, H, D) -> (B,)."""
    return _step_norms(trajs[..., :q_dim]).sum(-1)


def compute_smoothness(trajs: torch.Tensor, q_dim: int = 2) -> torch.Tensor:
    """Sum of ||dvel|| over the horizon (metrics.py:31-40). (B, H, D) -> (B,)."""
    return _step_norms(trajs[..., q_dim: 2 * q_dim]).sum(-1)


def compute_average_acceleration(trajs: torch.Tensor, q_dim: int = 2) -> torch.Tensor:
    """Mean ||dvel|| over the horizon (metrics.py:42-65). (B, H, D) -> (B,)."""
    return _step_norms(trajs[..., q_dim: 2 * q_dim]).mean(-1)


def compute_variance_waypoints(trajs: torch.Tensor, q_dim: int = 2) -> torch.Tensor:
    """Sum over waypoints of the variance of the pairwise inter-sample
    distances (metrics.py:18-29). (B, H, D) -> scalar. As the reference,
    the variance runs over the whole flattened (B, B) upper triangle, its
    zeroed diagonal and lower part included."""
    per_t = trajs[..., :q_dim].transpose(0, 1)  # (H, B, q)
    d = torch.linalg.vector_norm(per_t[:, :, None, :] - per_t[:, None, :, :], dim=-1)
    B = trajs.shape[0]
    upper = torch.ones((B, B), dtype=torch.bool, device=trajs.device).triu(1)
    tri = torch.where(upper[None], d, torch.zeros((), dtype=d.dtype, device=d.device))
    return torch.var(tri.reshape(d.shape[0], -1), dim=-1, correction=1).sum()
