"""MPD: the guided-diffusion single-agent motion planner.

Twin of `mmd_tpu/planners/single_agent/mpd.py` (reference:
mmd/planners/single_agent/mpd.py:58-617). A plan call runs the guided
loop, fresh (DDPM, or DDIM with `sampler="ddim"`) or, given an
experience, warm-started from that batch (XCBS local inference, always
DDPM), then `_finalize_plan`: unnormalize, classify
free/collision, score (path length + smoothness), select the best free
trajectory and savgol-smooth (mpd.py:354-405). With `bf16` the UNet's
forward alone runs in bfloat16; guide, posterior, finalize and selection
stay float32.

`plan_fresh_batch` and `plan_local_batch` plan N problems of the
planner's program (one model, scene and config; each problem its own hard
conditions, draws, constraints and, locally, seed batch) as one sampler
call, as JAX vmaps `_plan_fresh` and `_plan_local`: the finalize then
classifies all N * B trajectories in one lookup launch and every
`PlanResult` field leads with N. A single plan is the same code without
the leading axis.

In an open recording (`utils.profiling.recording`) a sampler call, from
its entry to its finalize, is one `sampler.call` span, and the
constructor is a `planner.init` span.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from mmd_torch.common.experiences import PathBatchExperience
from mmd_torch.config import DiffusionConfig, params as default_params
from mmd_torch.costs.constraints import (
    ConstraintSet,
    SoftPathConstraints,
    empty_constraint_set,
    pack_constraint_set,
    split_soft_path_constraints,
)
from mmd_torch.costs.guide import GuideConfig, GuideData
from mmd_torch.datasets.normalization import LimitsNormalizer
from mmd_torch.datasets.trajectories import TrajectoryDataset, model_id
from mmd_torch.models.diffusion import (
    HardConds,
    SamplerNoise,
    guided_p_sample_loop,
    run_local_inference,
)
from mmd_torch.models.temporal_unet import bf16_model
from mmd_torch.planners.single_agent.common import PlannerOutput
from mmd_torch.tasks.task import PlanningTask, classify_trajs
from mmd_torch.train.checkpoint import load_checkpoint
from mmd_torch.utils.interp import savgol_matrix
from mmd_torch.utils.metrics import (
    compute_path_length,
    compute_smoothness,
    compute_variance_waypoints,
)
from mmd_torch.utils.profiling import SAMPLER_CALL, span

@dataclasses.dataclass(frozen=True)
class PlanResult:
    # Shapes of one plan; N problems' fields lead with N (JAX's vmapped
    # PlanResult), trajs_iters (N, S+1, B, H, D).
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
    """The chain (S+1, B, H, D), or N problems' (S+1, N, B, H, D), as a
    PlanResult: all N * B trajectories classified in one lookup, scored and
    smoothed together; the best index per problem."""
    trajs_iters = normalizer.unnormalize(chain_norm)
    trajs_final = trajs_iters[-1]
    free_mask, wp_coll = classify_trajs(scene, trajs_final, radius, q_min, q_max)
    c_len = compute_path_length(trajs_final)
    c_smooth = compute_smoothness(trajs_final)
    cost_all = torch.where(free_mask, c_len + c_smooth,
                           torch.full_like(c_len, float("inf")))
    return PlanResult(
        trajs_iters=trajs_iters.movedim(0, -4),
        trajs_final=torch.einsum("ij,...bjd->...bid", savgol, trajs_final),
        free_mask=free_mask,
        wp_collisions=wp_coll,
        cost_path_length=c_len,
        cost_smoothness=c_smooth,
        cost_all=cost_all,
        idx_best=torch.argmin(cost_all, dim=-1),
        variance_waypoints=compute_variance_waypoints(trajs_final),
    )


class MPD:
    """Single-agent guided-diffusion planner bound to one (env, model) and
    one start/goal pair (mpd.py:116-304). Runs on the dataset's device."""

    def __init__(self, model, schedule, dataset: TrajectoryDataset,
                 start_state_pos, goal_state_pos,
                 cfg: Optional[DiffusionConfig] = None,
                 guide_cfg: Optional[GuideConfig] = None,
                 seed: int = default_params.seed, bf16: bool = False,
                 sampler: str = "ddpm", ddim_substeps: int = 0):
        with span("planner.init"):
            # bf16: the UNet's bfloat16 twin, shared by every planner of the
            # model (mpd.py:71, 170).
            self.model = bf16_model(model) if bf16 else model
            self.schedule = schedule
            self.dataset = dataset
            self.device = dataset.device
            self.robot = dataset.robot
            self.task = PlanningTask(dataset.env, dataset.robot)
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
            if sampler != self.cfg.sampler or ddim_substeps:
                # DDIM runs fresh full loops only (mpd.py:185-190); the config
                # checks ddim_substeps.
                self.cfg = dataclasses.replace(self.cfg, sampler=sampler,
                                               ddim_substeps=int(ddim_substeps))
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

    def _pack(self, constraints_l: Optional[List]
              ) -> Tuple[ConstraintSet, Optional[SoftPathConstraints]]:
        """(the generic ConstraintSet, the split-out per-waypoint group or
        None), as the JAX planner packs them (mpd.py:209-221): the one large
        per-waypoint group of ECBS and PP costs (B, R, T) as
        SoftPathConstraints instead of (B, P, H) on the generic path. Sizes
        are exact; PyTorch needs no static shapes, so nothing is padded to
        a bucket."""
        rest, spc = split_soft_path_constraints(constraints_l or [],
                                                self.n_support_points,
                                                device=self.device)
        if not rest:
            return empty_constraint_set(1, 1, device=self.device), spc
        P = max(len(c.q_l) for c in rest)
        return pack_constraint_set(rest, len(rest), P, device=self.device), spc

    def _run(self, constraints_l: Optional[List] = None,
             experience: Optional[PathBatchExperience] = None,
             noise: Optional[SamplerNoise] = None) -> PlanResult:
        """One plan on the device (mpd.py:228-242): fresh, or local from
        the experience's batch; draws from the planner's own generator
        unless `noise` is given. Nothing is read to the host."""
        cset, spc = self._pack(constraints_l)
        gd = GuideData(scene=self.scene, normalizer=self.dataset.normalizer,
                       constraints=cset, soft_paths=spc)
        if experience is None:
            return self._plan_fresh(gd, noise if noise is not None else self.draw_noise(),
                                    self.hard_conds)
        seed_norm = self.dataset.normalizer.normalize(experience.path_b)
        return self._plan_local(gd, seed_norm,
                                noise if noise is not None else self.draw_noise(local=True),
                                self.hard_conds)

    def _plan_fresh(self, gd: GuideData, noise: SamplerNoise,
                    hard: HardConds) -> PlanResult:
        """The planner's program (model, configs, scene, finalize) under the
        hard conditions `hard`: its own, or a team member's."""
        with span(SAMPLER_CALL):
            _, chain = guided_p_sample_loop(self.model, self.schedule, hard,
                                            self.cfg, noise, gd=gd,
                                            guide_cfg=self.guide_cfg)
            return _finalize_plan(chain, gd.normalizer, self.scene, self.robot.radius,
                                  self.robot.q_min, self.robot.q_max, self._savgol)

    def _plan_local(self, gd: GuideData, seed_norm: torch.Tensor, noise: SamplerNoise,
                    hard: HardConds) -> PlanResult:
        """The local replan (mpd.py:134-149): the normalized seed batch
        q-sampled at n_local_inference_noising_steps, then that many steps
        and the noise-free ones denoised under `gd`."""
        with span(SAMPLER_CALL):
            chain = run_local_inference(
                self.model, self.schedule, hard, gd, seed_norm, noise, self.cfg, self.guide_cfg,
                n_noising_steps=default_params.n_local_inference_noising_steps,
                n_denoising_steps=default_params.n_local_inference_denoising_steps)
            return _finalize_plan(chain, gd.normalizer, self.scene, self.robot.radius,
                                  self.robot.q_min, self.robot.q_max, self._savgol)

    def plan_fresh_batch(self, gd: GuideData, noise_l: Sequence[SamplerNoise],
                         hard_values: torch.Tensor) -> PlanResult:
        """N fresh problems as one sampler call (JAX's vmap of `_plan_fresh`):
        problem n under the hard-condition values hard_values[n] (H, D), the
        draws noise_l[n] and `gd`'s n-th constraints (`gd` leads with N, or
        holds none). Every field of the result leads with N."""
        with span(SAMPLER_CALL):
            return self._plan_fresh(gd, SamplerNoise.stack(noise_l),
                                    self._hard_batch(hard_values))

    def plan_local_batch(self, gd: GuideData, seeds_norm: torch.Tensor,
                         noise_l: Sequence[SamplerNoise],
                         hard_values: torch.Tensor) -> PlanResult:
        """N local replans as one sampler call (JAX's vmap of `_plan_local`),
        problem n warm-started from the normalized batch seeds_norm[n]
        (N, B, H, D); otherwise as `plan_fresh_batch`."""
        with span(SAMPLER_CALL):
            return self._plan_local(gd, seeds_norm, SamplerNoise.stack(noise_l),
                                    self._hard_batch(hard_values))

    def _hard_batch(self, hard_values: torch.Tensor) -> HardConds:
        """(N, H, D) start/goal values as N problems' conditions under the
        planner's mask."""
        return HardConds(mask=self.hard_conds.mask, values=hard_values[:, None])

    def draw_noise(self, local: bool = False) -> SamplerNoise:
        """One loop's draws from the planner's generator: a fresh loop's,
        or with `local` a local replan's."""
        return SamplerNoise.draw(self.cfg, self._generator, self.device,
                                 default_params.n_local_inference_denoising_steps
                                 if local else None)

    def __call__(self, start_state_pos=None, goal_state_pos=None,
                 constraints_l: Optional[List] = None,
                 experience: Optional[PathBatchExperience] = None,
                 noise: Optional[SamplerNoise] = None) -> PlannerOutput:
        """Plan once, locally from `experience` if given. `noise` replaces
        the planner's own draws (for replay)."""
        for given, bound in ((start_state_pos, self.start_state_pos),
                             (goal_state_pos, self.goal_state_pos)):
            if given is not None and not np.allclose(np.asarray(given),
                                                     bound.cpu().numpy()):
                raise ValueError("start/goal differ from the ones bound at "
                                 "construction (mpd.py:318-321)")
        t0 = time.perf_counter()
        res = self._run(constraints_l, experience, noise)
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


def load_planners(models_root: str, trajectories_root: str, env_name: str,
                  starts: Sequence, goals: Sequence, seeds: Optional[Sequence[int]] = None,
                  device="cuda", bf16: bool = False, sampler: str = "ddpm") -> List[MPD]:
    """One MPD per (start, goal) for `env_name`, all sharing one model,
    schedule and dataset loaded from the repository's checkpoint and dataset
    metadata, with the checkpoint's training normalizer (as bench.py:54-66
    builds its planners; planner i is seeded seeds[i], by default i), the
    UNet in bfloat16 if `bf16`, sampling with `sampler`."""
    mid = model_id(env_name)
    model, schedule, info = load_checkpoint(os.path.join(models_root, mid), device=device)
    normalizer = LimitsNormalizer.from_limits(info["normalizer_mins"],
                                              info["normalizer_maxs"], device=device)
    dataset = TrajectoryDataset.load(trajectories_root, mid, normalizer, device=device)
    seeds = range(len(starts)) if seeds is None else seeds
    return [MPD(model, schedule, dataset, s, g, seed=seed, bf16=bf16, sampler=sampler)
            for s, g, seed in zip(starts, goals, seeds)]


def load_planner(models_root: str, trajectories_root: str, env_name: str,
                 start_state_pos, goal_state_pos, device="cuda") -> MPD:
    """An MPD for one start and goal, seeded as MPD's default."""
    return load_planners(models_root, trajectories_root, env_name, [start_state_pos],
                         [goal_state_pos], [default_params.seed], device)[0]
