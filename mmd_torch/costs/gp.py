"""Constant-velocity GP prior cost.

Twin of `gp_trajectory_cost` in `mmd_tpu/costs/gp.py` (reference:
mp_baselines/planners/costs/factors/gp_factor.py:4-65,
cost_functions.py:505-543). State s_t = [pos, vel]; transition
Phi = [[I, dt I], [0, I]]; error e_t = s_{t+1} - Phi s_t;
cost = sum_t e_t^T Q_inv e_t with
Q_inv = [[12/dt^3 C, -6/dt^2 C], [-6/dt^2 C, 4/dt C]], C = I / sigma^2.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=16)
def gp_matrices(q_dim: int, dt: float, sigma: float = 1.0):
    """Returns (Phi (2q, 2q), Q_inv (2q, 2q)) as read-only numpy constants."""
    I = np.eye(q_dim, dtype=np.float32)
    Z = np.zeros((q_dim, q_dim), np.float32)
    phi = np.block([[I, dt * I], [Z, I]])
    C = I / sigma**2
    q_inv = np.block([
        [12.0 * dt**-3 * C, -6.0 * dt**-2 * C],
        [-6.0 * dt**-2 * C, 4.0 * dt**-1 * C],
    ]).astype(np.float32)
    for m in (phi, q_inv):
        m.setflags(write=False)
    return phi, q_inv


@functools.lru_cache(maxsize=16)
def _device_matrices(q_dim: int, dt: float, sigma: float, dtype, device):
    # Cached on the device: a fresh host-to-device copy in every guide
    # iteration would make the host wait for the card each time.
    return tuple(torch.as_tensor(np.array(m), dtype=dtype, device=device)
                 for m in gp_matrices(q_dim, dt, sigma))


def gp_error(trajs: torch.Tensor, dt: float) -> torch.Tensor:
    """e_t = s_{t+1} - Phi s_t. (..., H, 2q) -> (..., H-1, 2q)."""
    phi, _ = _device_matrices(trajs.shape[-1] // 2, dt, 1.0, trajs.dtype, trajs.device)
    return trajs[..., 1:, :] - trajs[..., :-1, :] @ phi.T


def gp_trajectory_cost(trajs: torch.Tensor, dt: float, sigma: float = 1.0) -> torch.Tensor:
    """Per-trajectory GP smoothness cost. (..., H, 2q) -> (...,)
    (CostGPTrajectory.eval, cost_functions.py:531-543)."""
    _, q_inv = _device_matrices(trajs.shape[-1] // 2, dt, sigma, trajs.dtype,
                                trajs.device)
    e = gp_error(trajs, dt)
    return torch.einsum("...ti,ij,...tj->...", e, q_inv, e)
