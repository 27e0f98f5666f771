"""Guided DDPM sampling.

Twin of `mmd_tpu/models/diffusion.py` (reference: mmd/models/
diffusion_models/diffusion_model_base.py:48-461, sample_functions.py:41-107)
for fresh plans. Semantics:
- step indices run i = n_steps-1 ... -n_no_noise; i < 0 runs the model at
  t=0 and adds no noise (sample_functions.py:53-57, 76-78)
- x0 is predicted from epsilon and clamped to [-1, 1]
  (diffusion_model_base.py:148-160)
- guidance (n_guide_steps of x += guide(x), re-applying the hard
  conditions) only while i < t_start_guide (sample_functions.py:63-72)
- extra noise std multiplier 0.5 (mpd.py:303)
- the chain stacks the initial noise and every step's output:
  (n_steps + n_no_noise + 1, B, H, D) (diffusion_model_base.py:321-351)

Noise is injectable: `SamplerNoise` holds the initial x_T and one normal
draw per step; without it, draws come from the caller's `torch.Generator`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from mmd_torch.config import DiffusionConfig
from mmd_torch.costs.guide import GuideConfig, GuideData, guide_gradient
from mmd_torch.models.schedules import DiffusionSchedule


@dataclasses.dataclass(frozen=True)
class HardConds:
    """x <- x * (1 - mask) + values * mask for conditioned waypoints."""

    mask: torch.Tensor    # (H, 1) in {0., 1.}
    values: torch.Tensor  # (H, D) or (B, H, D)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return x * (1.0 - self.mask) + self.values * self.mask


def make_start_goal_hard_conds(start_state: torch.Tensor, goal_state: torch.Tensor,
                               horizon: int) -> HardConds:
    """{0: start, H-1: goal} (reference: trajectories.py:216-239)."""
    D = start_state.shape[-1]
    kw = dict(dtype=start_state.dtype, device=start_state.device)
    mask = torch.zeros((horizon, 1), **kw)
    mask[0] = 1.0
    mask[horizon - 1] = 1.0
    values = torch.zeros(start_state.shape[:-1] + (horizon, D), **kw)
    values[..., 0, :] = start_state
    values[..., horizon - 1, :] = goal_state
    return HardConds(mask=mask, values=values)


@dataclasses.dataclass(frozen=True)
class SamplerNoise:
    """The normal draws of one fresh sampling loop."""

    x_T: torch.Tensor   # (B, H, D) initial noise
    steps: torch.Tensor  # (n_steps + n_no_noise, B, H, D), one per step

    @staticmethod
    def draw(cfg: DiffusionConfig, generator: torch.Generator, device) -> "SamplerNoise":
        shape = (cfg.n_samples, cfg.horizon, cfg.state_dim)
        n = len(cfg.step_indices())
        kw = dict(generator=generator, device=device, dtype=torch.float32)
        return SamplerNoise(x_T=torch.randn(shape, **kw),
                            steps=torch.randn((n, *shape), **kw))


def _coef(v: torch.Tensor, t: int, ndim: int) -> torch.Tensor:
    return v[t].reshape((1,) * ndim)


def q_sample(schedule: DiffusionSchedule, x_start: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Forward-noise x_start to step t (diffusion_model_base.py:425-433)."""
    shape = (-1,) + (1,) * (x_start.dim() - 1)
    return (schedule.sqrt_alphas_cumprod[t].reshape(shape) * x_start
            + schedule.sqrt_one_minus_alphas_cumprod[t].reshape(shape) * noise)


def predict_start_from_noise(schedule: DiffusionSchedule, x_t: torch.Tensor,
                             t: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """diffusion_model_base.py:132-143 (predict_epsilon=True)."""
    shape = (-1,) + (1,) * (x_t.dim() - 1)
    return (schedule.sqrt_recip_alphas_cumprod[t].reshape(shape) * x_t
            - schedule.sqrt_recipm1_alphas_cumprod[t].reshape(shape) * eps)


def q_posterior_mean(schedule: DiffusionSchedule, x_start: torch.Tensor,
                     x_t: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """diffusion_model_base.py:145-152."""
    shape = (-1,) + (1,) * (x_t.dim() - 1)
    return (schedule.posterior_mean_coef1[t].reshape(shape) * x_start
            + schedule.posterior_mean_coef2[t].reshape(shape) * x_t)


def _ddpm_step(model: nn.Module, schedule: DiffusionSchedule, x: torch.Tensor,
               i: int, noise: torch.Tensor, hard: HardConds,
               gd: Optional[GuideData], cfg: DiffusionConfig,
               guide_cfg: Optional[GuideConfig], guided: bool) -> torch.Tensor:
    """One reverse step at index i with this step's normal draw `noise`."""
    t = max(i, 0)
    tb = torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)
    eps = model(x, tb)
    x0 = predict_start_from_noise(schedule, x, tb, eps)
    x0 = torch.clamp(x0, -1.0, 1.0)
    x = q_posterior_mean(schedule, x0, x, tb)

    if guided and gd is not None:
        for _ in range(cfg.n_guide_steps):
            x = hard.apply(x + guide_gradient(x, gd, guide_cfg))

    if i > 0:  # no noise at and after t = 0
        std = torch.exp(0.5 * _coef(schedule.posterior_log_variance_clipped, t, x.dim()))
        x = x + std * noise * cfg.noise_std_extra
    return hard.apply(x)


@torch.no_grad()
def guided_p_sample_loop(
    model: nn.Module,
    schedule: DiffusionSchedule,
    hard: HardConds,
    cfg: DiffusionConfig,
    noise: SamplerNoise,
    gd: Optional[GuideData] = None,
    guide_cfg: Optional[GuideConfig] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full reverse process from x_T. Returns (x_final, chain (S+1, B, H, D))."""
    steps = cfg.step_indices()
    if noise.steps.shape[0] != len(steps):
        raise ValueError(f"need {len(steps)} step draws, got {noise.steps.shape[0]}")
    x = hard.apply(noise.x_T)
    chain = [x]
    for n, i in enumerate(steps):
        guided = gd is not None and i < cfg.t_start_guide
        x = _ddpm_step(model, schedule, x, i, noise.steps[n], hard, gd, cfg,
                       guide_cfg, guided)
        chain.append(x)
    return x, torch.stack(chain)


def run_inference(model: nn.Module, schedule: DiffusionSchedule, hard: HardConds,
                  gd: GuideData, noise: SamplerNoise, cfg: DiffusionConfig,
                  guide_cfg: GuideConfig) -> torch.Tensor:
    """Guided sampling of a fresh batch; returns the normalized chain
    (n_steps + n_no_noise + 1, B, H, D) (diffusion_model_base.py:321-351)."""
    _, chain = guided_p_sample_loop(model, schedule, hard, cfg, noise,
                                    gd=gd, guide_cfg=guide_cfg)
    return chain
