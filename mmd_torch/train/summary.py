"""Training-time sampling summaries.

Twin of `mmd_tpu/train/summary.py:24-70` (reference:
mmd/summaries/summary_trajectory_generation.py:19-100): sample a small
batch of trajectories for a random dataset start and goal, with no guide,
and report fraction-free, collision intensity and success. The JAX
package's dataset-vs-diffusion figure needs matplotlib and waits for the
port of `viz/`.
"""
from __future__ import annotations

import torch

from mmd_torch.config import DiffusionConfig
from mmd_torch.datasets.trajectories import TrajectoryDataset
from mmd_torch.models.diffusion import SamplerNoise, guided_p_sample_loop
from mmd_torch.models.schedules import DiffusionSchedule


def summary_trajectory_generation(model, schedule: DiffusionSchedule,
                                  dataset: TrajectoryDataset, generator: torch.Generator,
                                  n_samples: int = 25, step: int = 0) -> dict:
    """Sample n_samples trajectories for the start and goal of a random
    dataset trajectory, drawn from `generator`, and score them with the
    dataset's task."""
    idx = int(torch.randint(0, dataset.n_trajs, (1,), generator=generator,
                            device=generator.device))
    ref_traj = dataset.trajs[idx]
    hard = dataset.get_hard_conditions(ref_traj[0, :2], ref_traj[-1, :2])
    cfg = DiffusionConfig(horizon=dataset.n_support_points, state_dim=dataset.state_dim,
                          n_samples=n_samples, n_diffusion_steps=schedule.n_steps)
    noise = SamplerNoise.draw(cfg, generator, dataset.device)
    _, chain = guided_p_sample_loop(model, schedule, hard, cfg, noise, gd=None)
    trajs = dataset.unnormalize_trajectories(chain[-1])
    task = dataset.task
    return {
        "step": step,
        "fraction_free": task.compute_fraction_free_trajs(trajs),
        "collision_intensity": task.compute_collision_intensity_trajs(trajs),
        "success": task.compute_success_free_trajs(trajs),
    }
