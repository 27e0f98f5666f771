"""Central parameter hub: planner defaults and the sampler configuration.

Twin of `mmd_tpu/config.py`: the same values as plain frozen dataclasses
(reference: mmd/config/mmd_params.py:28-64).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional


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
    """Static configuration of one guided DDPM sampler.

    Mirrors the knobs threaded through GaussianDiffusionModel + MPD
    (reference: mmd/models/diffusion_models/diffusion_model_base.py:48-105,
    mmd/planners/single_agent/mpd.py:267-304). The model predicts epsilon
    and x0 is always clamped to [-1, 1], as in every checkpoint's config.
    DDIM sampling is not ported yet; every loop here is DDPM, fresh or
    warm-started (XCBS local inference).
    """

    horizon: int = 64
    state_dim: int = 4             # [x, y, vx, vy]
    n_samples: int = 64
    n_diffusion_steps: int = 25
    n_diffusion_steps_without_noise: int = 1
    n_guide_steps: int = 20
    t_start_guide: int = 13        # ceil(0.5 * 25)
    noise_std_extra: float = 0.5   # constant extra noise-std schedule (mpd.py:303)

    def step_indices(self, n_steps: Optional[int] = None) -> List[int]:
        """Reverse-process step indices n-1 ... -n_no_noise of a loop of
        n_steps noisy steps (the full n_diffusion_steps by default, fewer
        in a warm-started loop); a negative index runs the model at t=0 and
        adds no noise (sample_functions.py:53-57)."""
        n = self.n_diffusion_steps if n_steps is None else n_steps
        return list(range(n - 1, -self.n_diffusion_steps_without_noise - 1, -1))

    def n_guided_steps(self, n_steps: Optional[int] = None) -> int:
        """Steps that run guidance: those with index < t_start_guide,
        the noise-free steps included."""
        return sum(1 for i in self.step_indices(n_steps) if i < self.t_start_guide)
