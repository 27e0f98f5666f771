"""Training-time sampling summaries.

Twin of `mmd_tpu/train/summary.py:24-70` (reference:
mmd/summaries/summary_trajectory_generation.py:19-100): sample a small
batch of trajectories for a random dataset start and goal, with no guide,
report fraction-free, collision intensity and success, and, given a
`save_dir`, save the dataset-vs-diffusion figure there. Without matplotlib
(as on the card's machine) the figure is skipped with one line on stderr
and the statistics are unchanged.
"""
from __future__ import annotations

import os
import sys
from typing import Optional

import torch

from mmd_torch.config import DiffusionConfig
from mmd_torch.datasets.trajectories import TrajectoryDataset
from mmd_torch.models.diffusion import SamplerNoise, guided_p_sample_loop
from mmd_torch.models.schedules import DiffusionSchedule


def summary_trajectory_generation(model, schedule: DiffusionSchedule,
                                  dataset: TrajectoryDataset, generator: torch.Generator,
                                  n_samples: int = 25, step: int = 0,
                                  save_dir: Optional[str] = None) -> dict:
    """Sample n_samples trajectories for the start and goal of a random
    dataset trajectory, drawn from `generator`, score them with the
    dataset's task, and save the figure into `save_dir` if given."""
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
    stats = {
        "step": step,
        "fraction_free": task.compute_fraction_free_trajs(trajs),
        "collision_intensity": task.compute_collision_intensity_trajs(trajs),
        "success": task.compute_success_free_trajs(trajs),
    }
    if save_dir is not None:
        save_summary_figure(dataset, trajs, n_samples, save_dir, step)
    return stats


def save_summary_figure(dataset: TrajectoryDataset, trajs: torch.Tensor, n_samples: int,
                        save_dir: str, step: int) -> Optional[str]:
    """The dataset's first n_samples trajectories beside the sampled ones,
    over the map (JAX summary.py:52-70); None, with one line on stderr,
    where matplotlib is not installed."""
    from mmd_torch.viz.visualizer import PlanningVisualizer, pyplot

    try:
        plt = pyplot()
    except ImportError as e:
        print(f"summary_trajectory_generation: figure skipped: {e}", file=sys.stderr)
        return None
    os.makedirs(save_dir, exist_ok=True)
    fig, axs = plt.subplots(1, 2, figsize=(10, 5))
    viz = PlanningVisualizer(task=dataset.task)
    for ax, (title, data) in zip(axs, [
            ("dataset", dataset.trajs[:n_samples].cpu().numpy()),
            ("diffusion", trajs.cpu().numpy())]):
        ax.set_aspect("equal")
        viz.render_env(ax)
        for tr in data:
            ax.plot(tr[:, 0], tr[:, 1], alpha=0.4, lw=0.8)
        ax.set_title(title)
    path = os.path.join(save_dir, f"summary_step_{step:07d}.png")
    fig.savefig(path, dpi=80)
    plt.close(fig)
    return path
