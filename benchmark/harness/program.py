"""The system under test, `mmd_torch`, as the cells build it: the
checkpoint and dataset loaded through the program's own readers, and
planners given the configuration file's settings explicitly, so that the
program runs as the configuration states."""
from __future__ import annotations

from typing import Dict

import torch

from benchmark.harness.common import program_paths


def load(cfg: Dict, device: str):
    """(model, schedule, dataset) of the configuration on `device`; on a
    card the kernels are loaded (built first where they are missing).
    Raises where the program's float32 matmuls and convolutions would not
    run in the configuration's `tf32` setting."""
    from mmd_torch.datasets.normalization import LimitsNormalizer
    from mmd_torch.datasets.trajectories import TrajectoryDataset
    from mmd_torch.train.checkpoint import load_checkpoint

    if device.startswith("cuda"):
        from mmd_torch.ops.build import load_kernels
        load_kernels()
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    if flags != (cfg["tf32"], cfg["tf32"]):
        raise RuntimeError(f"the program runs with TF32 (matmul, cuDNN) {flags}; "
                           f"the configuration states tf32 {cfg['tf32']}")
    paths = program_paths(cfg)
    model, schedule, info = load_checkpoint(paths["model_dir"], device=device)
    normalizer = LimitsNormalizer.from_limits(info["normalizer_mins"], info["normalizer_maxs"],
                                              device=device)
    dataset = TrajectoryDataset.load(paths["trajectories"], cfg["model_id"], normalizer,
                                     device=device)
    return model, schedule, dataset


def planner(cfg: Dict, loaded, start, goal, seed: int, bf16: bool = False):
    """An MPD planner for one start and goal under the configuration's
    sampler and guide settings, seeded `seed`; with `bf16` the UNet's
    bfloat16 forward (the program's own lower-precision path)."""
    from mmd_torch.config import DiffusionConfig
    from mmd_torch.costs.guide import GuideConfig
    from mmd_torch.planners.single_agent.mpd import MPD

    model, schedule, dataset = loaded
    dc = DiffusionConfig(horizon=cfg["horizon"], state_dim=cfg["state_dim"],
                         n_samples=cfg["n_samples"], n_diffusion_steps=cfg["n_diffusion_steps"],
                         n_diffusion_steps_without_noise=cfg["n_diffusion_steps_without_noise"],
                         n_guide_steps=cfg["n_guide_steps"], t_start_guide=cfg["t_start_guide"],
                         noise_std_extra=cfg["noise_std_extra"])
    gc = GuideConfig(dt=cfg["trajectory_duration"] / cfg["horizon"],
                     robot_radius=cfg["robot_radius"], weight_collision=cfg["weight_collision"],
                     weight_smoothness=cfg["weight_smoothness"],
                     max_grad_norm=cfg["max_grad_norm"])
    return MPD(model, schedule, dataset, start, goal, cfg=dc, guide_cfg=gc, seed=seed, bf16=bf16)
