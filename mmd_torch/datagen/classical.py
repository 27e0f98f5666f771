"""Classical trajectory-optimization baselines, batched over particles.

Twin of `mmd_tpu/datagen/classical.py` (reference: deps/
motion_planning_baselines/mp_baselines/planners/{chomp,stomp,mppi,
stoch_gpmp}.py, which the reference exposes through its env param hooks).
None lies on MMD's main path; they complete the baseline inventory. JAX's
`lax.scan` over iterations is a Python loop here that reads nothing back
to the host, and its `vmap`s over particles and candidates are batch
dimensions.

All work on (P, H, 4) [pos, vel] trajectories against a scene's grid SDF
(one lookup of both grids a cost evaluation: the lookup kernel on the
card) and its walls, with the endpoints pinned to the start and goal
states (MPPI rolls out from the start instead). The sampling optimizers
draw one standard normal tensor an iteration, from `generator`, or take
them all as `draws` (opt_iters, K, P, H, D), so that a test can hand them
JAX's.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from mmd_torch.costs.constraints import relu
from mmd_torch.costs.gp import gp_trajectory_cost
from mmd_torch.envs.envs import SceneData
from mmd_torch.tasks.task import boundary_signed_distances, scene_object_sdf
from mmd_torch.utils.transfer import to_device


def _obstacle_cost(scene: SceneData, pos: torch.Tensor, margin: float) -> torch.Tensor:
    """(..., H, 2) -> (...,): the hinge relu(margin - sd) summed over the
    horizon, sd the least of both grids and the four walls. `amin` and
    `torch.minimum` split a tie's gradient evenly, as JAX's do."""
    sd_b = boundary_signed_distances(scene, pos).amin(dim=-1)
    sd = torch.minimum(scene_object_sdf(scene, pos), sd_b)
    return relu(margin - sd).sum(dim=-1)


def _pin_endpoints(trajs: torch.Tensor, start_state: torch.Tensor,
                   goal_state: torch.Tensor) -> torch.Tensor:
    out = trajs.clone()
    out[..., 0, :] = start_state
    out[..., -1, :] = goal_state
    return out


def _standard_normal(i: int, shape, like: torch.Tensor, generator: Optional[torch.Generator],
                     draws: Optional[torch.Tensor]) -> torch.Tensor:
    """Iteration i's standard normals of `shape`: draws[i], or drawn from
    `generator` on like's device."""
    if draws is not None:
        if tuple(draws.shape[1:]) != tuple(shape):
            raise ValueError(f"draws are {tuple(draws.shape)}, an iteration needs {shape}")
        return draws[i]
    if generator is None:
        raise ValueError("a sampling optimizer needs a generator or its draws")
    return torch.randn(shape, generator=generator, dtype=like.dtype, device=like.device)


def _weighted_update(costs: torch.Tensor, noise: torch.Tensor, temperature: float) -> torch.Tensor:
    """sum_k softmax_k(-costs / temperature) noise_k: (K, P), (K, P, ...)
    -> (P, ...)."""
    w = torch.softmax(-costs / temperature, dim=0)
    return torch.einsum("kp,kp...->p...", w, noise)


# ------------------------------------------------------------------- CHOMP
@dataclasses.dataclass(frozen=True)
class CHOMPConfig:
    """reference hook values: env_conveyor_2d.py:123-140."""

    opt_iters: int = 100
    step_size: float = 0.05
    grad_clip: float = 0.05
    weight_prior_cost: float = 1e-4
    dt: float = 5.0 / 64.0
    collision_margin: float = 1.1 * 0.05 + 0.03


@torch.no_grad()
def chomp_optimize(scene: SceneData, start_state: torch.Tensor, goal_state: torch.Tensor,
                   init_trajs: torch.Tensor, cfg: CHOMPConfig) -> torch.Tensor:
    """Covariant gradient descent: the obstacle and GP-smoothness gradients
    by autograd (the lookup's floor-cell gradient), clipped elementwise,
    one step an iteration, endpoints pinned (reference: chomp.py)."""

    def cost(trajs):
        c_obs = _obstacle_cost(scene, trajs[..., :2], cfg.collision_margin)
        c_smooth = cfg.weight_prior_cost * gp_trajectory_cost(trajs, cfg.dt)
        return (c_obs + c_smooth).sum()

    trajs = _pin_endpoints(init_trajs.detach(), start_state, goal_state)
    for _ in range(cfg.opt_iters):
        with torch.enable_grad():
            v = trajs.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(cost(v), v)
        g = torch.clamp(g, -cfg.grad_clip, cfg.grad_clip)
        trajs = _pin_endpoints(trajs - cfg.step_size * g, start_state, goal_state)
    return trajs


# ------------------------------------------------------------------- STOMP
@dataclasses.dataclass(frozen=True)
class STOMPConfig:
    opt_iters: int = 100
    n_noisy: int = 16
    noise_std: float = 0.05
    temperature: float = 1.0
    dt: float = 5.0 / 64.0
    weight_smoothness: float = 1e-2
    collision_margin: float = 1.1 * 0.05 + 0.03


@torch.no_grad()
def stomp_optimize(scene: SceneData, start_state: torch.Tensor, goal_state: torch.Tensor,
                   init_trajs: torch.Tensor, cfg: STOMPConfig,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stochastic trajectory optimization: K noisy copies of each particle,
    weighted by softmax(-cost / temperature), move its mean (reference:
    stomp.py)."""
    trajs = _pin_endpoints(init_trajs, start_state, goal_state)
    for i in range(cfg.opt_iters):
        noise = _standard_normal(i, (cfg.n_noisy, *trajs.shape), trajs, generator,
                                 draws) * cfg.noise_std
        noise[..., 0, :] = 0.0
        noise[..., -1, :] = 0.0
        cands = trajs + noise                                    # (K, P, H, D)
        costs = (_obstacle_cost(scene, cands[..., :2], cfg.collision_margin)
                 + cfg.weight_smoothness * gp_trajectory_cost(cands, cfg.dt))
        trajs = _pin_endpoints(trajs + _weighted_update(costs, noise, cfg.temperature),
                               start_state, goal_state)
    return trajs


# -------------------------------------------------------------------- MPPI
@dataclasses.dataclass(frozen=True)
class MPPIConfig:
    opt_iters: int = 50
    n_rollouts: int = 32
    noise_std: float = 0.1
    temperature: float = 1.0
    dt: float = 5.0 / 64.0
    collision_margin: float = 1.1 * 0.05 + 0.03


def _rollout(start_pos: torch.Tensor, vels: torch.Tensor, dt: float) -> torch.Tensor:
    """Point dynamics from the start: (..., H, q) velocities -> (..., H, q)
    positions, the first the start."""
    pos = start_pos + torch.cumsum(vels, dim=-2) * dt
    first = start_pos.expand(*vels.shape[:-2], 1, vels.shape[-1])
    return torch.cat([first, pos[..., :-1, :]], dim=-2)


@torch.no_grad()
def mppi_optimize(scene: SceneData, start_state: torch.Tensor, goal_state: torch.Tensor,
                  init_trajs: torch.Tensor, cfg: MPPIConfig,
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Model-predictive path integral over velocity controls: K noisy
    control sequences a particle, rolled out through point dynamics and
    weighted by softmax(-cost / temperature) (reference: mppi.py +
    dynamics/point.py). `draws` are (opt_iters, K, P, H, q)."""
    q_dim = init_trajs.shape[-1] // 2
    start_pos, goal_pos = start_state[:q_dim], goal_state[:q_dim]
    vels = init_trajs[..., q_dim:]
    for i in range(cfg.opt_iters):
        noise = _standard_normal(i, (cfg.n_rollouts, *vels.shape), vels, generator,
                                 draws) * cfg.noise_std
        pos = _rollout(start_pos, vels + noise, cfg.dt)         # (K, P, H, q)
        costs = (_obstacle_cost(scene, pos, cfg.collision_margin)
                 + 10.0 * ((pos[..., -1, :] - goal_pos) ** 2).sum(dim=-1))
        vels = vels + _weighted_update(costs, noise, cfg.temperature)
    return torch.cat([_rollout(start_pos, vels, cfg.dt), vels], dim=-1)


# --------------------------------------------------------------- StochGPMP
@dataclasses.dataclass(frozen=True)
class StochGPMPConfig:
    opt_iters: int = 100
    n_samples_per_particle: int = 8
    temperature: float = 1.0
    sigma_gp_sample: float = 0.02
    step_size: float = 0.5
    dt: float = 5.0 / 64.0
    weight_smoothness: float = 1e-2
    collision_margin: float = 1.1 * 0.05 + 0.03


@functools.lru_cache(maxsize=4)
def smoothing_kernel() -> np.ndarray:
    """The 9-tap Gaussian (sigma 2 taps) that smooths the perturbations,
    normalized in float32."""
    k = np.exp(-0.5 * (np.arange(-4, 5) / 2.0) ** 2).astype(np.float32)
    out = k / k.sum(dtype=np.float32)
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=4)
def _conv_weight(dtype, device) -> torch.Tensor:
    """The kernel as conv1d's (1, 1, 9) weight, flipped: conv1d
    cross-correlates. Copied once a device, without a host wait."""
    return to_device(smoothing_kernel()[::-1].copy(), device, dtype).view(1, 1, -1)


def smooth_noise(noise: torch.Tensor) -> torch.Tensor:
    """`jnp.convolve(column, kernel, mode="same")` of every column of
    (..., H, D) along H: the flipped kernel (it is symmetric, but the flip
    keeps the meaning), padded 4 each side as "same" pads a 9-tap kernel."""
    *lead, H, D = noise.shape
    w = _conv_weight(noise.dtype, noise.device)
    cols = noise.movedim(-1, -2).reshape(-1, 1, H)
    out = F.conv1d(cols, w, padding=w.shape[-1] // 2)
    return out.reshape(*lead, D, H).movedim(-2, -1)


@torch.no_grad()
def stoch_gpmp_optimize(scene: SceneData, start_state: torch.Tensor, goal_state: torch.Tensor,
                        init_trajs: torch.Tensor, cfg: StochGPMPConfig,
                        generator: Optional[torch.Generator] = None,
                        draws: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stochastic GPMP: smoothed (GP-correlated) perturbations of each
    particle, weighted by cost, move it by step_size (reference:
    stoch_gpmp.py; smoothed white noise stands in for exact GP sampling,
    as in JAX)."""
    trajs = _pin_endpoints(init_trajs, start_state, goal_state)
    for i in range(cfg.opt_iters):
        noise = _standard_normal(i, (cfg.n_samples_per_particle, *trajs.shape), trajs,
                                 generator, draws) * cfg.sigma_gp_sample
        noise = smooth_noise(noise)
        noise[..., 0, :] = 0.0
        noise[..., -1, :] = 0.0
        cands = trajs + noise
        costs = (_obstacle_cost(scene, cands[..., :2], cfg.collision_margin)
                 + cfg.weight_smoothness * gp_trajectory_cost(cands, cfg.dt))
        trajs = trajs + cfg.step_size * _weighted_update(costs, noise, cfg.temperature)
        trajs = _pin_endpoints(trajs, start_state, goal_state)
    return trajs
