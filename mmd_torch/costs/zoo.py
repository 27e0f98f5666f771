"""The cost zoo: costs off MMD's main path, as plain torch functions.

Twin of `mmd_tpu/costs/zoo.py` (reference: deps/motion_planning_baselines/
mp_baselines/planners/costs/cost_functions.py:332-745): CostMaxVelocity
(:332), CostVelocityAndDirectionAlignment (:358), CostSmoothnessCHOMP
(:559), CostJointLimits (:581), CostGoalPrior (:678). The reference reaches
them through the env planner-param hooks (env_base.py:266-276); here they
are the guide's optional terms (`mmd_torch/costs/guide.py`).

Trajectories are (..., H, D) with D = [pos(q), vel(q)]; every function
returns a cost per trajectory (...,) unless noted. The CHOMP precision is a
cached numpy constant, as `costs/gp.py` caches its matrices.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from mmd_torch.costs.constraints import relu
from mmd_torch.utils.transfer import to_device


def finite_difference_vector(x: torch.Tensor, dt: float = 1.0,
                             method: str = "central") -> torch.Tensor:
    """Finite differences along the horizon with zero borders
    (reference: torch_robotics/trajectory/utils.py:89-100)."""
    d = torch.zeros_like(x)
    if method == "forward":
        d[..., :-1, :] = torch.diff(x, dim=-2) / dt
    elif method == "backward":
        d[..., 1:, :] = torch.diff(x, dim=-2) / dt
    elif method == "central":
        d[..., 1:-1, :] = (x[..., 2:, :] - x[..., :-2, :]) / (2.0 * dt)
    else:
        raise NotImplementedError(method)
    return d


def cost_max_velocity(trajs: torch.Tensor, dt: float, max_vel: float,
                      q_dim: int = 2) -> torch.Tensor:
    """Squared deviation of the central-difference velocity from `max_vel`,
    summed over the position dims: (..., H, D) -> (..., H) (reference
    CostMaxVelocity.eval, cost_functions.py:345-352, zero border rows
    included)."""
    vel = finite_difference_vector(trajs[..., :q_dim], dt=dt, method="central")
    return ((vel - max_vel) ** 2).sum(dim=-1)


def _unit(v: torch.Tensor, eps: float) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + eps)


def cost_velocity_direction_alignment(trajs: torch.Tensor, dt: float,
                                      q_dim: int = 2,
                                      eps: float = 1e-8) -> torch.Tensor:
    """Sum over the horizon of dot(the state's unit velocity, the unit
    central-difference velocity of the positions): (..., H, D) -> (...,).
    The reference class (cost_functions.py:358-374) calls robot methods
    that its released deps lack; this is its documented intent, as JAX
    implements it."""
    direction = _unit(trajs[..., q_dim:2 * q_dim], eps)
    v = _unit(finite_difference_vector(trajs[..., :q_dim], dt=dt, method="central"), eps)
    return (direction * v).sum(dim=(-2, -1))


@functools.lru_cache(maxsize=16)
def chomp_precision(horizon: int, dt: float) -> np.ndarray:
    """CHOMP's precision R = K^T K, K the backward finite-difference
    operator with its boundary rows (reference: chomp.py:82-101
    _get_R_mat). (H, H) float32, read-only."""
    K = np.eye(horizon) - np.diag(np.ones(horizon - 1), -1)
    K = np.concatenate([K, np.zeros((1, horizon))], axis=0)
    K[-1, -1] = -1.0
    K = K / dt**2
    out = (K.T @ K).astype(np.float32)
    out.setflags(write=False)  # cached and shared
    return out


@functools.lru_cache(maxsize=16)
def _device_precision(horizon: int, dt: float, dtype, device) -> torch.Tensor:
    return to_device(np.array(chomp_precision(horizon, dt)), device, dtype)


def cost_smoothness_chomp(trajs: torch.Tensor, dt: float) -> torch.Tensor:
    """CHOMP smoothness x_d^T R x_d summed over the state dims:
    (..., H, D) -> (...,) (reference CostSmoothnessCHOMP.eval,
    cost_functions.py:559-578)."""
    R = _device_precision(trajs.shape[-2], dt, trajs.dtype, trajs.device)
    return torch.einsum("...td,ts,...sd->...", trajs, R, trajs)


def cost_joint_limits(trajs: torch.Tensor, q_min: torch.Tensor, q_max: torch.Tensor,
                      eps: float = float(np.deg2rad(3)),
                      q_dim: int = 2) -> torch.Tensor:
    """Squared penetration past the eps-shrunk box [q_min + eps, q_max - eps]:
    (..., H, D) -> (...,) (reference CostJointLimits.eval,
    cost_functions.py:581-610, reduced per trajectory as JAX does)."""
    pos = trajs[..., :q_dim]
    lower = relu(q_min + eps - pos)
    upper = relu(pos - (q_max - eps))
    return (lower**2 + upper**2).sum(dim=(-2, -1))


def cost_goal_prior(trajs: torch.Tensor, goal_state: torch.Tensor,
                    sigma: float = 1.0) -> torch.Tensor:
    """Gaussian prior on the final state, err^T err / sigma^2 with
    err = goal - x_{H-1}: (..., H, D) -> (...,) (reference CostGoalPrior.eval,
    cost_functions.py:713-728)."""
    err = goal_state - trajs[..., -1, :]
    return (err * err).sum(dim=-1) / sigma**2
