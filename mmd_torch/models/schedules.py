"""Beta schedules and the derived diffusion coefficients.

Twin of `mmd_tpu/models/schedules.py` (reference:
mmd/models/diffusion_models/diffusion_model_base.py:69-105, helpers.py:16-49).
Coefficients are computed in numpy float32 as there, then held as tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def exponential_beta_schedule(n_steps: int, beta_start: float = 1e-4,
                              beta_end: float = 1.0) -> np.ndarray:
    """reference: helpers.py:43-49 (x = linspace(0, n, n)).

    With beta_end=1.0 the last beta is exactly 1 in float64 (alpha = 0, a
    division by zero downstream); the torch reference dodges it only by
    float32 rounding (~0.9999998). As the JAX package does (ARCHITECTURE.md,
    "Documented behavioral divergences"), compute in float32 and clip betas
    to at most 1 - 1e-6, so the derived coefficients stay finite.
    """
    x = np.linspace(0.0, n_steps, n_steps, dtype=np.float32)
    a = np.float32(np.log(beta_end / beta_start) / n_steps)
    betas = np.float32(beta_start) * np.exp(a * x)
    return np.clip(betas, 0.0, 1.0 - 1e-6).astype(np.float32)


def cosine_beta_schedule(n_steps: int, s: float = 0.008,
                         a_min: float = 0.0, a_max: float = 0.999) -> np.ndarray:
    """reference: helpers.py:29-40."""
    steps = n_steps + 1
    x = np.linspace(0, steps, steps)
    ac = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
    ac = ac / ac[0]
    betas = 1 - (ac[1:] / ac[:-1])
    return np.clip(betas, a_min, a_max).astype(np.float32)


def linear_beta_schedule(n_steps: int, beta_start: float = 1e-4,
                         beta_end: float = 0.02) -> np.ndarray:
    """reference: helpers.py:16-17."""
    return np.linspace(beta_start, beta_end, n_steps, dtype=np.float32)


SCHEDULES = {
    "exponential": exponential_beta_schedule,
    "cosine": cosine_beta_schedule,
    "linear": linear_beta_schedule,
}


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor

    @property
    def n_steps(self) -> int:
        return self.betas.shape[0]


def make_schedule(variance_schedule: str, n_steps: int, device="cuda") -> DiffusionSchedule:
    betas = SCHEDULES[variance_schedule](n_steps)
    alphas = 1.0 - betas
    ac = np.cumprod(alphas)
    ac_prev = np.concatenate([[1.0], ac[:-1]]).astype(np.float32)
    post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
    coefs = dict(
        betas=betas,
        alphas_cumprod=ac,
        alphas_cumprod_prev=ac_prev,
        sqrt_alphas_cumprod=np.sqrt(ac),
        sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - ac),
        sqrt_recip_alphas_cumprod=np.sqrt(1.0 / ac),
        sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / ac - 1.0),
        posterior_variance=post_var,
        posterior_log_variance_clipped=np.log(np.maximum(post_var, 1e-20)),
        posterior_mean_coef1=betas * np.sqrt(ac_prev) / (1.0 - ac),
        posterior_mean_coef2=(1.0 - ac_prev) * np.sqrt(alphas) / (1.0 - ac),
    )
    return DiffusionSchedule(**{
        k: torch.as_tensor(np.asarray(v, np.float32), device=device)
        for k, v in coefs.items()})
