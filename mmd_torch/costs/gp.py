"""Constant-velocity GP prior: its cost and its samples.

Twin of `mmd_tpu/costs/gp.py` (reference:
mp_baselines/planners/costs/factors/gp_factor.py:4-65,
cost_functions.py:505-543, mp_priors_multi.py:15-262). State
s_t = [pos, vel]; transition Phi = [[I, dt I], [0, I]]; error
e_t = s_{t+1} - Phi s_t; cost = sum_t e_t^T Q_inv e_t with
Q_inv = [[12/dt^3 C, -6/dt^2 C], [-6/dt^2 C, 4/dt C]], C = I / sigma^2.

`sample_gp_prior` draws from the goal-directed GP N(const-vel mean,
K_inv^-1) through the float32 Cholesky of the precision K_inv, on the
device of the start state. K_inv holds 1/sigma_start^2 = 1e6 beside O(1)
entries, so the float32 factor carries a rounding error far above float32's
epsilon; tests/test_torch_gp_prior.py measures it against float64.
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


# ----------------------------------------------------- GP trajectory prior
def const_vel_trajectory(start_state: torch.Tensor, goal_state: torch.Tensor,
                         horizon: int, dt: float,
                         zero_endpoint_vel: bool = True) -> torch.Tensor:
    """Constant-velocity mean trajectory (H, 2q) from start to goal
    (reference: mp_priors_multi.py:131-151), on start_state's device."""
    from mmd_torch.envs.grid_sdf import linspace_f32

    q = start_state.shape[-1] // 2
    alpha = torch.from_numpy(linspace_f32(0.0, 1.0, horizon)).to(start_state.device)[:, None]
    pos = (1 - alpha) * start_state[:q][None] + alpha * goal_state[:q][None]
    mean_vel = (goal_state[:q] - start_state[:q]) / ((horizon - 1) * dt)
    vel = mean_vel[None].repeat(horizon, 1)
    if zero_endpoint_vel:
        vel[0].zero_()  # not `= 0.0`, which waits for the card
        vel[-1].zero_()
    return torch.cat([pos, vel], -1)


@functools.lru_cache(maxsize=8)
def gp_prior_precision(horizon: int, q_dim: int, dt: float,
                       sigma_start: float = 1e-3, sigma_gp: float = 2e-1,
                       sigma_goal: float = 1e-3) -> np.ndarray:
    """Full-trajectory precision K_inv = A^T Q_inv A of the goal-directed
    constant-velocity GP (reference: mp_priors_multi.py:215-262), built in
    float64 and returned as a read-only float32 (M, M) numpy constant,
    M = 2 q_dim horizon, as the JAX package builds it."""
    D = 2 * q_dim
    M = D * horizon
    phi, q_inv = gp_matrices(q_dim, dt, sigma_gp)
    A = np.eye(M, dtype=np.float64)
    for t in range(horizon - 1):
        A[D * (t + 1):D * (t + 2), D * t:D * (t + 1)] = -phi
    goal_row = np.zeros((D, M))
    goal_row[:, -D:] = np.eye(D)
    A = np.concatenate([A, goal_row], 0)
    blocks = ([np.eye(D) / sigma_start**2]
              + [q_inv.astype(np.float64)] * (horizon - 1)
              + [np.eye(D) / sigma_goal**2])
    Q_inv = np.zeros((M + D, M + D))
    off = 0
    for b in blocks:
        Q_inv[off:off + D, off:off + D] = b
        off += D
    out = (A.T @ Q_inv @ A).astype(np.float32)
    out.setflags(write=False)
    return out


def sample_gp_prior(source, start_state: torch.Tensor, goal_state: torch.Tensor,
                    horizon: int, dt: float, n_samples: int, sigma_start: float = 1e-3,
                    sigma_gp: float = 2e-1, sigma_goal: float = 1e-3,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(n_samples, H, 2q) draws from the goal-directed GP prior (reference:
    mp_priors_multi.py:104-110): x = mean + L^-T z with L = chol(K_inv).
    `source` is a torch.Generator on start_state's device, from which z
    (n_samples, M) standard normals are drawn, or z itself. `dtype`
    float64 factors the float32 precision in float64 (a reference)."""
    device = start_state.device
    q_dim = start_state.shape[-1] // 2
    mean = const_vel_trajectory(start_state.to(dtype), goal_state.to(dtype), horizon, dt)
    k_inv = torch.from_numpy(np.array(gp_prior_precision(
        horizon, q_dim, dt, sigma_start, sigma_gp, sigma_goal))).to(device, dtype)
    if isinstance(source, torch.Generator):
        z = torch.randn((n_samples, k_inv.shape[0]), generator=source, device=device,
                        dtype=dtype)
    else:
        z = torch.as_tensor(source, device=device).to(dtype)
    L = torch.linalg.cholesky(k_inv)
    dev = torch.linalg.solve_triangular(L.T, z.T, upper=True).T
    return mean[None] + dev.reshape(n_samples, horizon, 2 * q_dim)
