"""The loss wrapper with the reference's dict interface.

Twin of `mmd_tpu/train/losses.py` (reference:
mmd/losses/gaussian_diffusion_loss.py:15-28): `loss_fn` takes the
normalized trajectories and hard conditions from the batch dict and returns
a named loss dict.
"""
from __future__ import annotations

from typing import Dict

import torch

from mmd_torch.models.diffusion import HardConds, diffusion_loss, draw_loss_noise
from mmd_torch.models.schedules import DiffusionSchedule


class GaussianDiffusionLoss:
    """reference: gaussian_diffusion_loss.py:15."""

    @staticmethod
    def loss_fn(model, schedule: DiffusionSchedule, input_dict: Dict,
                generator: torch.Generator, n_diffusion_steps: int) -> Dict[str, torch.Tensor]:
        trajs = input_dict["traj_normalized"]
        hard: HardConds = input_dict["hard_conds"]
        t, noise = draw_loss_noise(generator, trajs, n_diffusion_steps)
        return {"diffusion_loss": diffusion_loss(model, schedule, trajs, hard, t, noise)}
