"""GPMP2: damped Gauss-Newton trajectory optimization, batched over particles.

Twin of `mmd_tpu/datagen/gpmp2.py` (reference: mp_baselines/planners/
gpmp2.py:91-510). The whitened residual of a trajectory theta (H, 2q) has
four factors (build_gpmp2_cost_composite):
- start prior: (s_0 - start) / sigma_start                (UnaryFactor)
- goal prior:  (s_{H-1} - goal) / sigma_goal
- GP prior:    (s_{t+1} - Phi s_t) L, L = chol(Q_inv(sigma_gp))
- collision:   relu(margin - sd(pos_t)) / sigma_coll for t in [1, H), sd the
               least of the scene's two grids and the four walls
               (FieldFactor, cost_functions.py:166)

JAX takes the Jacobian with `jax.jacrev` through its lookup's custom VJP.
Here J is assembled: the start, goal and GP rows are constant, and each
collision row has two nonzero entries, the derivative of its relu at the
waypoint, built from one lookup of both grids a iteration (the CUDA kernel
on the card). The derivatives follow JAX's rules at ties: `minimum` and
`maximum` give each tied side half, `min` over the walls splits evenly
among tied walls, and relu(x) at x = 0 has slope 0.5.

An articulated robot passes `coll_fn` (JAX's static argument of the same
name, `mmd_tpu/datagen/gpmp2.py:49-58`): it maps the interior states
(P, H-1, D) to the signed clearances (P, H-1, S) of its collision spheres
and their derivatives in the positions (P, H-1, S, q_dim). The collision
rows are then the (H-1) x S relu(-clearance) / sigma_coll, in JAX's order
(t major), each with its q_dim derivatives at waypoint t + 1.
`mmd_torch.robots.kinematics.arm_clearances_and_jacobian` is one. Without
it the factor is the disk's, as above. With it the iteration builds the
damped J^T J and J^T r from J's structure (`_damped_normal_equations`)
instead of the dense product: the same sums in another order.

Each iteration solves (J^T J + delta diag(J^T J) + 1e-9 I) d = -J^T r by a
Cholesky factor in float32, as JAX does, and steps theta += step_size d
(reference _step / get_torch_solve, gpmp2.py:310-493). Where a factor fails
JAX's `cho_factor` gives NaN; so does this one (no exception, no retry),
and the NaN stays in that particle, which the classification then drops.
Nothing in the loop reads the card, so it runs without a host sync.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from mmd_torch.costs.gp import gp_matrices
from mmd_torch.envs.envs import SceneData
from mmd_torch.ops.sdf_kernel import grid_lookup
from mmd_torch.tasks.task import boundary_signed_distances
from mmd_torch.utils.transfer import to_device


@dataclasses.dataclass(frozen=True)
class GPMP2Config:
    n_support_points: int = 64
    dt: float = 5.0 / 64.0
    # Defaults from the env hooks (env_conveyor_2d.py:94-116).
    sigma_start: float = 1e-5
    sigma_gp: float = 1e-2
    sigma_goal: float = 1e-5
    sigma_coll: float = 1e-5
    step_size: float = 0.1
    delta: float = 1e-2          # LM damping (solver_params['delta'])
    opt_iters: int = 500
    collision_margin: float = 1.1 * 0.05 + 0.03  # link margin + cutoff


def _f32(x: float) -> np.float32:
    return np.float32(x)


@functools.lru_cache(maxsize=16)
def _constants(H: int, D: int, cfg: GPMP2Config):
    """(Phi, L, the start, goal and GP rows of J (8 + (H-1) D, H D)) in
    float32, the rows as JAX's reverse mode computes them: 1 / sigma on
    the endpoints; L[i, j] on s_{t+1, i} and -(L[:, j] . Phi[:, k]) on
    s_{t, k}."""
    phi, q_inv = gp_matrices(D // 2, cfg.dt, cfg.sigma_gp)
    L = np.linalg.cholesky(q_inv).astype(np.float32)
    phi = np.array(phi, np.float32)
    rows = np.zeros((2 * D + (H - 1) * D, H * D), np.float32)
    rows[np.arange(D), np.arange(D)] = _f32(1.0) / _f32(cfg.sigma_start)
    rows[D + np.arange(D), (H - 1) * D + np.arange(D)] = _f32(1.0) / _f32(cfg.sigma_goal)
    back = -(L.T @ phi)  # row j: the cotangent L[:, j] through theta[:-1] @ phi.T
    for t in range(H - 1):
        r0 = 2 * D + t * D
        rows[r0:r0 + D, (t + 1) * D:(t + 2) * D] = L.T
        rows[r0:r0 + D, t * D:(t + 1) * D] = back
    return phi, L, rows


@functools.lru_cache(maxsize=16)
def _device_constants(H: int, D: int, cfg: GPMP2Config, device: torch.device):
    """`_constants` on the device, copied once."""
    return tuple(to_device(a, device) for a in _constants(H, D, cfg))


def _tie_weights(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """d min(a, b) / d a and / d b as JAX's `minimum` gives them: 1 to the
    smaller, 0.5 to each at a tie."""
    m = torch.minimum(a, b)
    wa = torch.where(a == m, torch.where(b == m, 0.5, 1.0), 0.0)
    wb = torch.where(b == m, torch.where(a == m, 0.5, 1.0), 0.0)
    return wa, wb


def _relu_rows(clearance: torch.Tensor, cfg: GPMP2Config) -> Tuple[torch.Tensor, torch.Tensor]:
    """relu(-clearance) / sigma_coll and its derivative in the clearance:
    -1 / sigma (JAX's 1 / sigma in float32) where the relu is active, half
    that at 0."""
    r = torch.clamp(-clearance, min=0.0) / cfg.sigma_coll
    inv_sigma = float(_f32(1.0) / _f32(cfg.sigma_coll))
    slope = torch.where(clearance < 0, 1.0, torch.where(clearance == 0, 0.5, 0.0))
    return r, -inv_sigma * slope


def _collision(theta: torch.Tensor, scene: SceneData, cfg: GPMP2Config
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The collision residuals (P, H-1) and their derivatives with respect
    to the waypoints' positions (P, H-1, q_dim), from one lookup."""
    q_dim = theta.shape[-1] // 2
    pos = theta[:, 1:, :q_dim]
    tables = ((scene.grid.values, scene.grid.grads),
              (scene.extra_grid.values, scene.extra_grid.grads))
    vals, cell_grads = grid_lookup(pos, tables, scene.grid.lower, scene.grid.upper)
    sd_obj = torch.minimum(vals[0], vals[1])
    walls = boundary_signed_distances(scene, pos)                  # (P, H-1, 4)
    sd_walls = walls.min(dim=-1).values
    clearance = torch.minimum(sd_obj, sd_walls) - cfg.collision_margin
    r, ct = _relu_rows(clearance, cfg)
    w_obj, w_walls = _tie_weights(sd_obj, sd_walls)
    w_a, w_b = _tie_weights(vals[0], vals[1])
    ct_obj = ct * w_obj
    grad = ((ct_obj * w_a)[..., None] * cell_grads[0]
            + (ct_obj * w_b)[..., None] * cell_grads[1])
    # min over the walls: each tied wall gets ct / count; walls 0-1 are
    # q - lo (+1 on their axis), walls 2-3 are hi - q (-1).
    hit = (walls == sd_walls[..., None]).to(theta.dtype)
    share = (ct * w_walls / hit.sum(-1))[..., None] * hit
    return r, grad + (share[..., :q_dim] - share[..., q_dim:])


def _collision_rows(theta: torch.Tensor, cfg: GPMP2Config, coll_fn
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A `coll_fn`'s collision residuals (P, H-1, S) and each one's
    derivatives in the positions of its waypoint t + 1 (P, H-1, S, q_dim)."""
    clearance, d_clear = coll_fn(theta[:, 1:])
    r, ct = _relu_rows(clearance, cfg)
    return r, ct[..., None] * d_clear


@functools.lru_cache(maxsize=16)
def _device_damped_gram(H: int, D: int, cfg: GPMP2Config, device: torch.device) -> torch.Tensor:
    """C^T C + delta diag(C^T C) + 1e-9 I of the start, goal and GP rows C
    of J, once on the device."""
    const = _device_constants(H, D, cfg, device)[2]
    gram = const.mT @ const
    eye = torch.eye(H * D, dtype=gram.dtype, device=device)
    return gram + cfg.delta * torch.diag_embed(torch.diagonal(gram)) + 1e-9 * eye


def _damped_normal_equations(theta: torch.Tensor, start_state: torch.Tensor,
                             goal_state: torch.Tensor, cfg: GPMP2Config, coll_fn
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(J^T J + delta diag(J^T J) + 1e-9 I (P, N, N), J^T r (P, N, 1)) with
    a `coll_fn`'s collision factor, from J's structure rather than a dense
    product: the C rows' part is constant, and collision row (t, s) touches
    only waypoint t + 1's positions, so its part of J^T J is a
    (q_dim, q_dim) block on that waypoint's diagonal (an arm's (H-1) S rows
    would make the dense J^T J ~10x the rest of the iteration)."""
    P, H, D = theta.shape
    phi, L, const = _device_constants(H, D, cfg, theta.device)
    r_fixed = torch.cat([(theta[:, 0] - start_state) / cfg.sigma_start,
                         (theta[:, -1] - goal_state) / cfg.sigma_goal,
                         ((theta[:, 1:] - theta[:, :-1] @ phi.T) @ L).reshape(P, -1)], dim=-1)
    r_coll, grad = _collision_rows(theta, cfg, coll_fn)     # (P, H-1, S), (P, H-1, S, q)
    q_dim = grad.shape[-1]
    blocks = torch.einsum("ptsi,ptsj->pijt", grad, grad)    # (P, q, q, H-1)
    damped = _device_damped_gram(H, D, cfg, theta.device).expand(P, -1, -1).clone()
    # The diagonal blocks: [p, i, j, t] is damped[p, t D + i, t D + j].
    damped.view(P, H, D, H, D).diagonal(dim1=1, dim2=3)[:, :q_dim, :q_dim, 1:] += blocks
    damped.diagonal(dim1=-2, dim2=-1).unflatten(-1, (H, D))[:, 1:, :q_dim] += \
        cfg.delta * blocks.diagonal(dim1=1, dim2=2)
    g = const.mT @ r_fixed[..., None]
    g.view(P, H, D)[:, 1:, :q_dim] += torch.einsum("pts,ptsi->pti", r_coll, grad)
    return damped, g


def residuals_and_jacobian(theta: torch.Tensor, scene: SceneData, start_state: torch.Tensor,
                           goal_state: torch.Tensor, cfg: GPMP2Config
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(r (P, R), J (P, R, H D)) of a batch of trajectories theta (P, H, D),
    J equal to `jax.jacrev` of JAX's residual, its tie rules included."""
    P, H, D = theta.shape
    q_dim = D // 2
    phi, L, const = _device_constants(H, D, cfg, theta.device)
    r_start = (theta[:, 0] - start_state) / cfg.sigma_start
    r_goal = (theta[:, -1] - goal_state) / cfg.sigma_goal
    r_gp = (theta[:, 1:] - theta[:, :-1] @ phi.T) @ L              # (P, H-1, D)
    r_coll, coll_grad = _collision(theta, scene, cfg)
    r = torch.cat([r_start, r_goal, r_gp.reshape(P, -1), r_coll], dim=-1)

    # Collision row t holds its two derivatives at columns (t+1) D + d.
    rows = torch.zeros((P, H - 1, H, D), dtype=theta.dtype, device=theta.device)
    rows.diagonal(offset=1, dim1=1, dim2=2)[:, :q_dim] = coll_grad.mT
    J = torch.cat([const.expand(P, -1, -1), rows.reshape(P, H - 1, H * D)], dim=1)
    return r, J


def gauss_newton_step(theta: torch.Tensor, scene: SceneData, start_state: torch.Tensor,
                      goal_state: torch.Tensor, cfg: GPMP2Config, coll_fn=None) -> torch.Tensor:
    """One damped Gauss-Newton iteration of every particle (gpmp2.py:103-111)."""
    P, H, D = theta.shape
    if coll_fn is None:
        r, J = residuals_and_jacobian(theta, scene, start_state, goal_state, cfg)
        Jt = J.mT
        JtJ = Jt @ J
        g = Jt @ r[..., None]
        eye = torch.eye(H * D, dtype=theta.dtype, device=theta.device)
        damped = JtJ + cfg.delta * torch.diag_embed(torch.diagonal(JtJ, dim1=-2, dim2=-1)) \
            + 1e-9 * eye
    else:
        damped, g = _damped_normal_equations(theta, start_state, goal_state, cfg, coll_fn)
    factor, info = torch.linalg.cholesky_ex(damped)
    # JAX's cho_factor gives NaN where the factorization fails.
    factor = torch.where((info == 0)[:, None, None], factor, torch.nan)
    d_theta = -torch.cholesky_solve(g, factor)
    return theta + cfg.step_size * d_theta.reshape(P, H, D)


@torch.no_grad()
def gpmp2_optimize(scene: SceneData, start_state: torch.Tensor, goal_state: torch.Tensor,
                   init_trajs: torch.Tensor, cfg: GPMP2Config, coll_fn=None) -> torch.Tensor:
    """init_trajs (P, H, D) -> optimized (P, H, D), cfg.opt_iters damped
    Gauss-Newton iterations on the trajectories' device (gpmp2.py:89-118),
    with the collision factor of `coll_fn` if given. A particle whose
    factor fails comes back NaN."""
    theta = init_trajs
    for _ in range(cfg.opt_iters):
        theta = gauss_newton_step(theta, scene, start_state, goal_state, cfg, coll_fn)
    return theta
