"""The guided DDPM sampler's arithmetic: schedule, normalizer, one reverse
step and the guide's iterations (Carvalho et al., Motion Planning
Diffusion; the MMD planner's settings).

- Schedule: the exponential betas beta_start * exp(a x), x = linspace(0, n,
  n), a = log(beta_end / beta_start) / n, in float32 and clipped to at most
  1 - 1e-6 (the last beta would be 1), and the DDPM coefficients from them.
- Normalizer: [min, max] -> [-1, 1] per state dimension; unnormalizing
  clips to [-1, 1] first.
- A step at index i (n-1 ... 0, then -1 noise-free at t = 0): x0 from the
  model's epsilon, clamped to [-1, 1], the posterior mean, then in the
  guided steps (i < t_start_guide) the guide's iterations, then for i > 0
  the noise scaled by 0.5 * exp(0.5 log var), then the hard conditions
  (start and goal waypoints with zero velocity).
- A guide iteration: x <- hard(x - total), total the gradients of the
  collision costs (objects on the grid, walls) and the GP smoothness prior
  w.r.t. the unnormalized trajectory, each clipped per waypoint to norm 1
  by ||g + 1e-6|| and zeroed at the first and last waypoint, weighted
  2e-2 and 8e-2. The collision costs skip waypoint 0 and use the margin
  1.1 r + 0.01. The GP prior's error is e_t = s_{t+1} - Phi s_t with
  Phi = [[I, dt I], [0, I]], its cost e^T Q e with Q = [[12/dt^3, -6/dt^2],
  [-6/dt^2, 4/dt]] (sigma 1). Its gradient and the clip's norms are summed
  with each product rounded once in a fused multiply-add (`fma`), which is
  how the reference CPU arithmetic of the planner rounds them.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from benchmark.reference.scene import Scene


def schedule(n_steps: int, beta_start: float = 1e-4, beta_end: float = 1.0,
             device="cpu") -> Dict[str, torch.Tensor]:
    x = np.linspace(0.0, n_steps, n_steps, dtype=np.float32)
    a = np.float32(np.log(beta_end / beta_start) / n_steps)
    betas = np.clip(np.float32(beta_start) * np.exp(a * x), 0.0, 1.0 - 1e-6).astype(np.float32)
    alphas = 1.0 - betas
    ac = np.cumprod(alphas)
    ac_prev = np.concatenate([[1.0], ac[:-1]]).astype(np.float32)
    post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
    coefs = dict(
        sqrt_recip_ac=np.sqrt(1.0 / ac),
        sqrt_recipm1_ac=np.sqrt(1.0 / ac - 1.0),
        log_var=np.log(np.maximum(post_var, 1e-20)),
        coef1=betas * np.sqrt(ac_prev) / (1.0 - ac),
        coef2=(1.0 - ac_prev) * np.sqrt(alphas) / (1.0 - ac),
    )
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in coefs.items()}


class Normalizer:
    def __init__(self, mins: Sequence[float], maxs: Sequence[float], device):
        self.mins = torch.as_tensor(mins, dtype=torch.float32, device=device)
        self.maxs = torch.as_tensor(maxs, dtype=torch.float32, device=device)
        self.span = torch.clamp(self.maxs - self.mins, min=1e-12)

    def normalize(self, x):
        return 2.0 * (x - self.mins) / self.span - 1.0

    def unnormalize(self, x):
        return 0.5 * (torch.clamp(x, -1.0, 1.0) + 1.0) * self.span + self.mins


def hard_values(norm: Normalizer, starts: torch.Tensor, goals: torch.Tensor,
                horizon: int) -> torch.Tensor:
    """(N, 2) starts and goals -> (N, H, 4) normalized conditioned values:
    waypoint 0 the start, H-1 the goal, both at zero velocity."""
    zeros = torch.zeros_like(starts)
    s = norm.normalize(torch.cat([starts, zeros], dim=-1))
    g = norm.normalize(torch.cat([goals, zeros], dim=-1))
    values = torch.zeros((starts.shape[0], horizon, 4), dtype=torch.float32,
                         device=starts.device)
    values[:, 0] = s
    values[:, horizon - 1] = g
    return values


def hard_mask(horizon: int, device) -> torch.Tensor:
    mask = torch.zeros((horizon, 1), dtype=torch.float32, device=device)
    mask[0] = 1.0
    mask[horizon - 1] = 1.0
    return mask


def apply_hard(x, mask, values):
    return x * (1.0 - mask) + values * mask


# ------------------------------------------------------------- the guide
def fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to float32 (the product is exact in float64)."""
    b = b.double() if isinstance(b, torch.Tensor) else b
    return (a.double() * b + c.double()).float()


def _norm_fma(a: torch.Tensor) -> torch.Tensor:
    sq = a[..., 0] * a[..., 0]
    for c in range(1, a.shape[-1]):
        sq = fma(a[..., c], a[..., c], sq)
    return torch.sqrt(sq)


def _zero_ends(g):
    g[..., 0, :] = 0.0
    g[..., -1, :] = 0.0
    return g


def clip_rows(g: torch.Tensor, max_norm: float) -> torch.Tensor:
    norm = _norm_fma(g + 1e-6)
    return _zero_ends(g * (torch.clamp(norm, 0.0, max_norm) / norm)[..., None])


def clip_rows_plain(g: torch.Tensor, max_norm: float) -> torch.Tensor:
    norm = torch.linalg.vector_norm(g + 1e-6, dim=-1, keepdim=True)
    return _zero_ends(g * (torch.clamp(norm, 0.0, max_norm) / norm))


def gp_constants(dt: float):
    return tuple(float(np.float32(v)) for v in (dt, 12.0 * dt ** -3, -6.0 * dt ** -2,
                                                4.0 * dt ** -1))


def gp_grad(u: torch.Tensor, dt: float) -> torch.Tensor:
    """d/du of sum_t e_t^T Q e_t at the inner waypoints, 0 at the ends."""
    dt, pp, pv, vv = gp_constants(dt)
    s, t = u[..., :-1, :], u[..., 1:, :]
    ep = t[..., :2] - (s[..., :2] + dt * s[..., 2:])
    ev = t[..., 2:] - s[..., 2:]
    gep = 2.0 * fma(ev, pv, pp * ep)
    gev = 2.0 * fma(ev, vv, pv * ep)
    g = torch.zeros_like(u)
    g[..., 1:-1, :2] = gep[..., :-1, :] - gep[..., 1:, :]
    g[..., 1:-1, 2:] = gev[..., :-1, :] - (dt * gep[..., 1:, :] + gev[..., 1:, :])
    return g


class _Lookup(torch.autograd.Function):
    """The grid's value at each point's floor cell; its gradient the cell's."""

    @staticmethod
    def forward(ctx, q, scene):
        v, g = scene.lookup(q.detach())
        ctx.save_for_backward(g)
        return v

    @staticmethod
    def backward(ctx, gv):
        (g,) = ctx.saved_tensors
        return gv[..., None] * g, None


def _relu(x):
    return torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _grad(cost, u):
    with torch.enable_grad():
        v = u.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(cost(v).sum(), v)
    return g


def collision_step(u: torch.Tensor, scene: Scene, margin: float, weight: float,
                   max_norm: float) -> torch.Tensor:
    def objects(v):
        return _relu(margin - _Lookup.apply(v[..., 1:, :2], scene)).sum(dim=-1)

    def walls(v):
        return _relu(margin - scene.wall_distances(v[..., 1:, :2])).amax(dim=-1).sum(dim=-1)

    out = weight * clip_rows_plain(_grad(objects, u), max_norm)
    return out + weight * clip_rows_plain(_grad(walls, u), max_norm)


def guide_loop(x, norm: Normalizer, scene: Scene, mask, values, g: Dict,
               n_iters: int, cells: Optional[list] = None) -> torch.Tensor:
    """n_iters guide iterations on normalized x (..., H, 4). With `cells`,
    the flat floor-cell keys that each iteration's inner waypoints read are
    appended to it."""
    for _ in range(n_iters):
        u = norm.unnormalize(x)
        if cells is not None:
            i, j = scene.cells(u[..., 1:-1, :2])
            cells.append((i * scene.shape[1] + j).flatten())
        total = collision_step(u, scene, g["margin"], g["w_collision"], g["max_norm"])
        total = total + g["w_smooth"] * clip_rows(gp_grad(u, g["dt"]), g["max_norm"])
        x = apply_hard(x - total, mask, values)
    return x


def posterior_mean(sch: Dict, x: torch.Tensor, eps: torch.Tensor, t: int) -> torch.Tensor:
    """x0 from epsilon (clamped), then the posterior mean; x and eps the
    model's (rows, H, D)."""
    tb = torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)

    def c(name):
        return sch[name][tb].reshape(-1, 1, 1)

    x0 = torch.clamp(c("sqrt_recip_ac") * x - c("sqrt_recipm1_ac") * eps, -1.0, 1.0)
    return c("coef1") * x0 + c("coef2") * x


def add_noise(sch: Dict, x: torch.Tensor, noise: torch.Tensor, i: int,
              extra: float = 0.5) -> torch.Tensor:
    if i <= 0:
        return x
    std = torch.exp(0.5 * sch["log_var"][i].reshape((1,) * x.dim()))
    return x + std * noise * extra
