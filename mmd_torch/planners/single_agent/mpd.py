"""MPD: the guided-diffusion single-agent motion planner, fresh plans.

Twin of `mmd_tpu/planners/single_agent/mpd.py` (reference:
mmd/planners/single_agent/mpd.py:58-617). A plan call runs the guided
DDPM loop, then `_finalize_plan`: unnormalize, classify free/collision,
score (path length + smoothness), select the best free trajectory and
savgol-smooth (mpd.py:354-405). The warm-started local path (experience
reuse) is not ported yet.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional

import numpy as np
import torch

from mmd_torch.config import DiffusionConfig, params as default_params
from mmd_torch.costs.constraints import (
    ConstraintSet,
    empty_constraint_set,
    pack_constraint_set,
)
from mmd_torch.costs.guide import GuideConfig, GuideData
from mmd_torch.datasets.normalization import LimitsNormalizer
from mmd_torch.datasets.trajectories import TrajectoryDataset, model_id
from mmd_torch.models.diffusion import SamplerNoise, guided_p_sample_loop
from mmd_torch.planners.single_agent.common import PlannerOutput
from mmd_torch.tasks.task import classify_trajs
from mmd_torch.train.checkpoint import load_checkpoint
from mmd_torch.utils.interp import savgol_matrix
from mmd_torch.utils.metrics import (
    compute_path_length,
    compute_smoothness,
    compute_variance_waypoints,
)

@dataclasses.dataclass(frozen=True)
class PlanResult:
    trajs_iters: torch.Tensor       # (S+1, B, H, D) unnormalized chain
    trajs_final: torch.Tensor       # (B, H, D) savgol-smoothed final
    free_mask: torch.Tensor         # (B,) bool
    wp_collisions: torch.Tensor     # (B, H_interp) bool
    cost_path_length: torch.Tensor  # (B,)
    cost_smoothness: torch.Tensor   # (B,)
    cost_all: torch.Tensor          # (B,) path + smoothness, +inf where not free
    idx_best: torch.Tensor          # () argmin of cost_all
    variance_waypoints: torch.Tensor  # ()


@torch.no_grad()
def _finalize_plan(chain_norm: torch.Tensor, normalizer, scene, radius: float,
                   q_min, q_max, savgol: torch.Tensor) -> PlanResult:
    trajs_iters = normalizer.unnormalize(chain_norm)
    trajs_final = trajs_iters[-1]
    free_mask, wp_coll = classify_trajs(scene, trajs_final, radius, q_min, q_max)
    c_len = compute_path_length(trajs_final)
    c_smooth = compute_smoothness(trajs_final)
    cost_all = torch.where(free_mask, c_len + c_smooth,
                           torch.full_like(c_len, float("inf")))
    return PlanResult(
        trajs_iters=trajs_iters,
        trajs_final=torch.einsum("ij,bjd->bid", savgol, trajs_final),
        free_mask=free_mask,
        wp_collisions=wp_coll,
        cost_path_length=c_len,
        cost_smoothness=c_smooth,
        cost_all=cost_all,
        idx_best=torch.argmin(cost_all),
        variance_waypoints=compute_variance_waypoints(trajs_final),
    )


class MPD:
    """Single-agent guided-diffusion planner bound to one (env, model) and
    one start/goal pair (mpd.py:116-304). Runs on the dataset's device."""

    def __init__(self, model, schedule, dataset: TrajectoryDataset,
                 start_state_pos, goal_state_pos,
                 cfg: Optional[DiffusionConfig] = None,
                 guide_cfg: Optional[GuideConfig] = None,
                 seed: int = default_params.seed):
        self.model = model
        self.schedule = schedule
        self.dataset = dataset
        self.device = dataset.device
        self.robot = dataset.robot
        self.scene = dataset.env.scene
        H = dataset.n_support_points
        self.cfg = cfg or DiffusionConfig(
            horizon=H,
            state_dim=dataset.state_dim,
            n_diffusion_steps=schedule.n_steps,
            t_start_guide=int(np.ceil(default_params.start_guide_steps_fraction
                                      * schedule.n_steps)),
            n_guide_steps=default_params.n_guide_steps,
        )
        self.guide_cfg = guide_cfg or GuideConfig(dt=dataset.duration / H,
                                                  robot_radius=self.robot.radius)
        kw = dict(dtype=torch.float32, device=self.device)
        self.start_state_pos = torch.as_tensor(np.asarray(start_state_pos), **kw)
        self.goal_state_pos = torch.as_tensor(np.asarray(goal_state_pos), **kw)
        self.hard_conds = dataset.get_hard_conditions(self.start_state_pos,
                                                      self.goal_state_pos)
        self._savgol = torch.as_tensor(np.array(savgol_matrix(H)), **kw)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        self.n_support_points = H

    def _pack(self, constraints_l: Optional[List]) -> ConstraintSet:
        """The constraints at their exact size; PyTorch needs no static
        shapes, so unlike the JAX planner nothing is padded to a bucket."""
        if not constraints_l:
            return empty_constraint_set(1, 1, device=self.device)
        P = max(len(c.q_l) for c in constraints_l)
        return pack_constraint_set(constraints_l, len(constraints_l), P,
                                   device=self.device)

    def _plan_fresh(self, gd: GuideData, noise: SamplerNoise) -> PlanResult:
        _, chain = guided_p_sample_loop(self.model, self.schedule, self.hard_conds,
                                        self.cfg, noise, gd=gd,
                                        guide_cfg=self.guide_cfg)
        return _finalize_plan(chain, gd.normalizer, self.scene, self.robot.radius,
                              self.robot.q_min, self.robot.q_max, self._savgol)

    def draw_noise(self) -> SamplerNoise:
        return SamplerNoise.draw(self.cfg, self._generator, self.device)

    def __call__(self, start_state_pos=None, goal_state_pos=None,
                 constraints_l: Optional[List] = None,
                 noise: Optional[SamplerNoise] = None) -> PlannerOutput:
        """Plan once. `noise` replaces the planner's own draws (for replay)."""
        for given, bound in ((start_state_pos, self.start_state_pos),
                             (goal_state_pos, self.goal_state_pos)):
            if given is not None and not np.allclose(np.asarray(given),
                                                     bound.cpu().numpy()):
                raise ValueError("start/goal differ from the ones bound at "
                                 "construction (mpd.py:318-321)")
        t0 = time.perf_counter()
        gd = GuideData(scene=self.scene, normalizer=self.dataset.normalizer,
                       constraints=self._pack(constraints_l))
        res = self._plan_fresh(gd, noise if noise is not None else self.draw_noise())
        free = res.free_mask.cpu().numpy()  # waits for the plan to finish
        t_total = time.perf_counter() - t0
        return self._to_output(res, free, constraints_l, t_total)

    @staticmethod
    def _to_output(res: PlanResult, free: np.ndarray, constraints_l,
                   t_total: float) -> PlannerOutput:
        free_idxs = np.nonzero(free)[0]
        coll_idxs = np.nonzero(~free)[0]
        out = PlannerOutput()
        out.trajs_iters = res.trajs_iters
        out.trajs_final = res.trajs_final
        out.trajs_final_free_idxs = free_idxs
        out.trajs_final_coll_idxs = coll_idxs
        out.trajs_final_free = res.trajs_final[free_idxs] if len(free_idxs) else None
        out.trajs_final_coll = res.trajs_final[coll_idxs] if len(coll_idxs) else None
        out.success_free_trajs = int(len(free_idxs) > 0)
        out.fraction_free_trajs = float(free.mean())
        out.collision_intensity_trajs = float(res.wp_collisions.float().mean())
        if len(free_idxs):
            out.idx_best_traj = int(res.idx_best)
            out.traj_final_free_best = res.trajs_final[out.idx_best_traj]
            out.cost_best_free_traj = float(res.cost_all[out.idx_best_traj])
        out.cost_smoothness = res.cost_smoothness
        out.cost_path_length = res.cost_path_length
        out.cost_all = res.cost_all
        out.variance_waypoint_trajs_final_free = float(res.variance_waypoints)
        out.t_total = t_total
        out.constraints_l = constraints_l
        return out


def load_planner(models_root: str, trajectories_root: str, env_name: str,
                 start_state_pos, goal_state_pos, device="cuda") -> MPD:
    """An MPD for `env_name` from the repository's checkpoint and dataset
    metadata, with the checkpoint's training normalizer (as bench.py:54-66
    builds its planners)."""
    mid = model_id(env_name)
    model, schedule, info = load_checkpoint(os.path.join(models_root, mid), device=device)
    normalizer = LimitsNormalizer.from_limits(info["normalizer_mins"],
                                              info["normalizer_maxs"], device=device)
    dataset = TrajectoryDataset.load(trajectories_root, mid, normalizer, device=device)
    return MPD(model, schedule, dataset, start_state_pos, goal_state_pos)
