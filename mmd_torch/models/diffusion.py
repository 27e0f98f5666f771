"""Guided DDPM and DDIM sampling.

Twin of `mmd_tpu/models/diffusion.py` (reference: mmd/models/
diffusion_models/diffusion_model_base.py:48-461, sample_functions.py:41-107)
for fresh plans and XCBS's warm-started local inference. Semantics:
- step indices run i = n_steps-1 ... -n_no_noise; i < 0 runs the model at
  t=0 and adds no noise (sample_functions.py:53-57, 76-78)
- x0 is predicted from epsilon and clamped to [-1, 1]
  (diffusion_model_base.py:148-160)
- guidance (n_guide_steps of x += guide(x), re-applying the hard
  conditions) only while i < t_start_guide (sample_functions.py:63-72):
  `guide_loop`, one launch of the guide-loop kernel a guided step on the
  card, as JAX runs its iterations as one fori_loop
- extra noise std multiplier 0.5 (mpd.py:303)
- the chain stacks the initial noise and every step's output:
  (n_steps + n_no_noise + 1, B, H, D) (diffusion_model_base.py:321-351)

- a warm-started loop (`run_local_inference`) q-samples a seed batch at
  t = n_noising_steps and runs n_denoising_steps + n_no_noise steps from it
  (diffusion_model_base.py:353-421)
- with cfg.sampler 'ddim' a fresh full loop runs `ddim_sample_loop`
  (diffusion_model_base.py:214-291) instead; warm-started loops stay DDPM

Noise is injectable: `SamplerNoise` holds the loop's first draw (x_T of a
fresh loop, the q-sample noise of a warm-started one) and one normal draw
per step (none for DDIM, whose eta is 0); without it, draws come from the
caller's `torch.Generator`.

A DDPM loop runs N problems of one model and one scene at once, as JAX's
vmapped team and child programs run them (mmd_tpu/parallel/team.py:45,
336; mmd_tpu/planners/multi_agent/fused.py:99-196): x is then (N, B, H,
D), the UNet sees (N * B, H, D), the hard conditions' values are
(N, 1, H, D) under one mask, the `SamplerNoise` is N problems' draws
stacked (`SamplerNoise.stack`) and the `GuideData` leads with N
(`mmd_torch/costs/guide.py`). Problem n's rows see only problem n's
conditions, draws and constraints, so its result does not depend on the
others. DDIM keeps its single-problem loop.

`diffusion_loss` is the training loss (diffusion_model_base.py:435-456),
its t and noise arguments, drawn by `draw_loss_noise`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from mmd_torch.config import DiffusionConfig
from mmd_torch.costs.guide import GuideConfig, GuideData, guide_loop
from mmd_torch.models.schedules import DiffusionSchedule
from mmd_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class HardConds:
    """x <- x * (1 - mask) + values * mask for conditioned waypoints."""

    mask: torch.Tensor    # (H, 1) in {0., 1.}
    values: torch.Tensor  # (H, D) or (B, H, D); N problems' (N, 1, H, D)

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
    """The normal draws of one sampling loop."""

    x_T: torch.Tensor   # (B, H, D) x_T, or a warm start's q-sample noise
    steps: torch.Tensor  # (n_steps + n_no_noise, B, H, D), one per step
    # A multi-tile loop's draws have a tile axis after the step's:
    # x_T (T, B, H, D), steps (n, T, B, H, D); so do N problems' (`stack`).

    @staticmethod
    def stack(noise_l) -> "SamplerNoise":
        """N loops' draws as one batched loop's: x_T (N, B, H, D), steps
        (n, N, B, H, D)."""
        return SamplerNoise(x_T=torch.stack([z.x_T for z in noise_l]),
                            steps=torch.stack([z.steps for z in noise_l], dim=1))

    @staticmethod
    def draw(cfg: DiffusionConfig, generator: torch.Generator, device,
             n_steps: Optional[int] = None, n_tiles: Optional[int] = None) -> "SamplerNoise":
        """The draws of a loop of n_steps noisy steps (all of them by
        default; a local replan's n_denoising_steps), for n_tiles tiles if
        given. A fresh DDIM loop draws x_T alone; a multi-tile loop is
        DDPM whatever the sampler, as in the JAX package."""
        shape = ((n_tiles,) if n_tiles else ()) + (cfg.n_samples, cfg.horizon, cfg.state_dim)
        n = 0 if cfg.is_ddim(n_steps) and not n_tiles else len(cfg.step_indices(n_steps))
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
    return _guide_and_noise(schedule, _denoised_mean(model, schedule, x, i), i, noise, hard,
                            gd, cfg, guide_cfg, guided)


def _denoised_mean(model: nn.Module, schedule: DiffusionSchedule, x: torch.Tensor,
                   i: int) -> torch.Tensor:
    """A step's first half: the posterior mean from the model's epsilon. N
    problems' x (N, B, H, D) runs as one (N * B, H, D) batch."""
    xf = x.reshape(-1, *x.shape[-2:])
    tb = torch.full((xf.shape[0],), max(i, 0), dtype=torch.int64, device=x.device)
    with span("unet"):
        eps = model(xf, tb)
    x0 = torch.clamp(predict_start_from_noise(schedule, xf, tb, eps), -1.0, 1.0)
    return q_posterior_mean(schedule, x0, xf, tb).reshape(x.shape)


def _guide_and_noise(schedule: DiffusionSchedule, x: torch.Tensor, i: int,
                     noise: torch.Tensor, hard: HardConds, gd: Optional[GuideData],
                     cfg: DiffusionConfig, guide_cfg: Optional[GuideConfig],
                     guided: bool) -> torch.Tensor:
    """A step's second half, from the posterior mean x: the guide
    iterations, then the step's noise."""
    t = max(i, 0)
    if guided and gd is not None:
        x = guide_loop(x, gd, hard, guide_cfg, cfg.n_guide_steps)

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
    n_diffusion_steps: Optional[int] = None,
    warm_start: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reverse process over n_diffusion_steps noisy steps (all of them
    by default) and the noise-free ones, from noise.x_T or, if given, from
    `warm_start` (diffusion.py:129-158). Returns (x_final, chain (S+1, B,
    H, D)); for N problems (module docstring) x_final (N, B, H, D) and the
    chain (S+1, N, B, H, D). A fresh full loop of a DDIM config runs
    `ddim_sample_loop` instead (diffusion.py:139-147)."""
    if warm_start is None and cfg.is_ddim(n_diffusion_steps):
        if noise.x_T.dim() > 3:
            raise ValueError("DDIM samples one problem a loop")
        return ddim_sample_loop(model, schedule, hard, cfg, noise, gd=gd, guide_cfg=guide_cfg)
    steps = cfg.step_indices(n_diffusion_steps)
    if noise.steps.shape[0] != len(steps):
        raise ValueError(f"need {len(steps)} step draws, got {noise.steps.shape[0]}")
    x = hard.apply(noise.x_T if warm_start is None else warm_start)
    chain = [x]
    for n, i in enumerate(steps):
        guided = gd is not None and i < cfg.t_start_guide
        x = _ddpm_step(model, schedule, x, i, noise.steps[n], hard, gd, cfg,
                       guide_cfg, guided)
        chain.append(x)
    return x, torch.stack(chain)


@torch.no_grad()
def ddim_sample_loop(
    model: nn.Module,
    schedule: DiffusionSchedule,
    hard: HardConds,
    cfg: DiffusionConfig,
    noise: SamplerNoise,
    gd: Optional[GuideData] = None,
    guide_cfg: Optional[GuideConfig] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """DDIM with eta = 0 over `cfg.ddim_time_pairs()`, from noise.x_T
    (diffusion.py:222-279). Returns (x_final, chain (n_pairs + 1, B, H, D)).

    The update is x_{t'} = sqrt(ac_{t'}) x0 + sqrt(1 - ac_{t'}) eps, the
    model's epsilon unchanged (diffusion_model_base.py:119-120). The
    reference's quirks are kept: x0 is not clamped; guidance runs when
    t_next < t_start_guide; the final (0, -1) pair returns x0 under the
    hard conditions, with no guidance (:251-256, 270-271). One UNet
    forward a pair.
    """
    if noise.steps.shape[0] != 0:
        raise ValueError(f"a DDIM loop draws x_T alone, got {noise.steps.shape[0]} step draws")
    x = hard.apply(noise.x_T)
    chain = [x]
    for t, t_next in cfg.ddim_time_pairs():
        x = ddim_step(model, schedule, x, t, t_next, hard, gd, cfg, guide_cfg)
        chain.append(x)
        if t_next < 0:
            break
    return x, torch.stack(chain)


def ddim_step(model: nn.Module, schedule: DiffusionSchedule, x: torch.Tensor, t: int,
              t_next: int, hard: HardConds, gd: Optional[GuideData], cfg: DiffusionConfig,
              guide_cfg: Optional[GuideConfig]) -> torch.Tensor:
    """One DDIM substep from t to t_next (diffusion.py:259-277)."""
    tb = torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)
    with span("unet"):
        eps = model(x, tb)
    x0 = predict_start_from_noise(schedule, x, tb, eps)
    if t_next < 0:
        return hard.apply(x0)
    ac_next = schedule.alphas_cumprod[t_next]
    x = torch.sqrt(ac_next) * x0 + torch.sqrt(1.0 - ac_next) * eps
    if gd is not None and t_next < cfg.t_start_guide:
        x = guide_loop(x, gd, hard, guide_cfg, cfg.n_guide_steps)
    return hard.apply(x)


def run_inference(model: nn.Module, schedule: DiffusionSchedule, hard: HardConds,
                  gd: GuideData, noise: SamplerNoise, cfg: DiffusionConfig,
                  guide_cfg: GuideConfig) -> torch.Tensor:
    """Guided sampling of a fresh batch; returns the normalized chain
    (n_steps + n_no_noise + 1, B, H, D) (diffusion_model_base.py:321-351)."""
    _, chain = guided_p_sample_loop(model, schedule, hard, cfg, noise,
                                    gd=gd, guide_cfg=guide_cfg)
    return chain


def run_local_inference(model: nn.Module, schedule: DiffusionSchedule, hard: HardConds,
                        gd: GuideData, seed_trajs: torch.Tensor, noise: SamplerNoise,
                        cfg: DiffusionConfig, guide_cfg: GuideConfig,
                        n_noising_steps: int = 3,
                        n_denoising_steps: int = 3) -> torch.Tensor:
    """XCBS experience reuse: q-sample the normalized seed batch at
    t = n_noising_steps with noise.x_T, then denoise n_denoising_steps (and
    the noise-free steps) under the current constraints; returns the
    normalized chain (n_denoising_steps + n_no_noise + 1, B, H, D)
    (diffusion.py:202-219), or N problems' (..., N, B, H, D) from seeds
    (N, B, H, D)."""
    flat = seed_trajs.reshape(-1, *seed_trajs.shape[-2:])
    t = torch.full((flat.shape[0],), n_noising_steps, dtype=torch.int64,
                   device=seed_trajs.device)
    warm = q_sample(schedule, flat, t, noise.x_T.reshape(flat.shape)).reshape(seed_trajs.shape)
    _, chain = guided_p_sample_loop(model, schedule, hard, cfg, noise, gd=gd,
                                    guide_cfg=guide_cfg,
                                    n_diffusion_steps=n_denoising_steps, warm_start=warm)
    return chain


# ---------------------------------------------------------------- training
def draw_loss_noise(generator: torch.Generator, x_start: torch.Tensor,
                    n_diffusion_steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A loss's draws on the generator's device: t (B,) uniform in
    [0, n_diffusion_steps), and the noise, normal like x_start."""
    t = torch.randint(0, n_diffusion_steps, (x_start.shape[0],), generator=generator,
                      device=x_start.device)
    noise = torch.randn(x_start.shape, generator=generator, device=x_start.device,
                        dtype=x_start.dtype)
    return t, noise


def diffusion_loss(model, schedule: DiffusionSchedule, x_start: torch.Tensor,
                   hard: HardConds, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Epsilon-prediction MSE with the hard conditions applied to the noisy
    input AND to the model's output, so the conditioned rows carry no
    gradient (`mmd_tpu/models/diffusion.py:282-296`, p_losses in
    diffusion_model_base.py:435-456)."""
    x_noisy = hard.apply(q_sample(schedule, x_start, t, noise))
    eps_hat = hard.apply(model(x_noisy, t))
    return torch.mean((eps_hat - noise) ** 2)
