"""Central parameter hub: planner defaults and the sampler configuration.

Twin of `mmd_tpu/config.py`: the same values as plain frozen dataclasses
(reference: mmd/config/mmd_params.py:28-64).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class MMDParams:
    """Global defaults of the planners (reference:
    mmd/config/mmd_params.py:28-64)."""

    robot_planar_disk_radius: float = 0.05
    horizon: int = 64              # waypoints per trajectory
    start_guide_steps_fraction: float = 0.5
    n_guide_steps: int = 20        # guide iterations per diffusion step
    n_local_inference_noising_steps: int = 3    # XCBS replans (mmd_params.py:33-34)
    n_local_inference_denoising_steps: int = 3
    weight_grad_cost_collision: float = 2e-2
    weight_grad_cost_smoothness: float = 8e-2
    weight_grad_cost_constraints: float = 2e-1
    weight_grad_cost_soft_constraints: float = 2e-2
    trajectory_duration: float = 5.0
    seed: int = 18
    runtime_limit: float = 60.0    # seconds a team plan may take
    # 'least_collisions' or 'least_cost' (mmd_params.py:53, cbs.py:436-462)
    low_level_choose_path_from_batch_strategy: str = "least_collisions"

    @property
    def vertex_constraint_radius(self) -> float:
        # reference: mmd/config/mmd_params.py:52
        return self.robot_planar_disk_radius * 2.4


params = MMDParams()


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    """Static configuration of one guided diffusion sampler.

    Mirrors the knobs threaded through GaussianDiffusionModel + MPD
    (reference: mmd/models/diffusion_models/diffusion_model_base.py:48-105,
    mmd/planners/single_agent/mpd.py:267-304). The model predicts epsilon
    and the DDPM loop clamps x0 to [-1, 1], as in every checkpoint's
    config. With sampler 'ddim' a fresh full-denoise loop runs the DDIM
    fast mode (diffusion_model_base.py:214-291) over `ddim_time_pairs`;
    warm-started loops (XCBS local inference) stay DDPM.
    """

    horizon: int = 64
    state_dim: int = 4             # [x, y, vx, vy]
    n_samples: int = 64
    n_diffusion_steps: int = 25
    n_diffusion_steps_without_noise: int = 1
    n_guide_steps: int = 20
    t_start_guide: int = 13        # ceil(0.5 * 25)
    noise_std_extra: float = 0.5   # constant extra noise-std schedule (mpd.py:303)
    sampler: str = "ddpm"          # or 'ddim'
    # DDIM substeps; 0 = the reference's n_diffusion_steps // 5.
    ddim_substeps: int = 0

    def __post_init__(self):
        if self.sampler not in ("ddpm", "ddim"):
            raise ValueError(f"sampler must be 'ddpm' or 'ddim', got {self.sampler!r}")
        # Past n_diffusion_steps the linspace of the time pairs repeats
        # integer times, and below 0 it has no meaning.
        if not 0 <= self.ddim_substeps <= self.n_diffusion_steps:
            raise ValueError(f"ddim_substeps must lie in [0, {self.n_diffusion_steps}], "
                             f"got {self.ddim_substeps}")

    def ddim_time_pairs(self) -> List[Tuple[int, int]]:
        """DDIM's (t, t_next) pairs, [(T-1, ...), ..., (0, -1)], over
        ddim_substeps (default n_diffusion_steps // 5) substeps, as the JAX
        package builds them (diffusion.py:246-250)."""
        n = self.n_diffusion_steps
        sub = self.ddim_substeps or max(1, n // 5)
        times = [-1] + [int(v) for v in np.linspace(0, n - 1, sub + 1).astype(int)]
        times = times[::-1]
        return list(zip(times[:-1], times[1:]))

    def is_ddim(self, n_steps: Optional[int] = None) -> bool:
        """Whether a loop of n_steps noisy steps (a fresh full loop when
        None) runs DDIM."""
        return self.sampler == "ddim" and n_steps is None

    def n_unet_forwards(self, n_steps: Optional[int] = None) -> int:
        """UNet forwards of a loop of n_steps noisy steps (a fresh full
        loop when None): one per DDIM pair, or one per DDPM step."""
        if self.is_ddim(n_steps):
            return len(self.ddim_time_pairs())
        return len(self.step_indices(n_steps))

    def step_indices(self, n_steps: Optional[int] = None) -> List[int]:
        """Reverse-process step indices n-1 ... -n_no_noise of a loop of
        n_steps noisy steps (the full n_diffusion_steps by default, fewer
        in a warm-started loop); a negative index runs the model at t=0 and
        adds no noise (sample_functions.py:53-57)."""
        n = self.n_diffusion_steps if n_steps is None else n_steps
        return list(range(n - 1, -self.n_diffusion_steps_without_noise - 1, -1))

    def n_guided_steps(self, n_steps: Optional[int] = None) -> int:
        """Steps that run guidance: DDPM steps with index < t_start_guide,
        the noise-free steps included; DDIM pairs with t_next in
        [0, t_start_guide) (the final (0, -1) pair is not guided)."""
        if self.is_ddim(n_steps):
            return sum(1 for _, t in self.ddim_time_pairs() if 0 <= t < self.t_start_guide)
        return sum(1 for i in self.step_indices(n_steps) if i < self.t_start_guide)
