"""MPDEnsemble: the multi-tile guided-diffusion planner for long horizons.

Twin of `mmd_tpu/planners/single_agent/mpd_ensemble.py` (reference:
mmd/planners/single_agent/mpd_ensemble.py:65-723). An agent's skeleton is
a chain of tiles, each a local [-1, 1]^2 map with its own diffusion model.
The tiles' batches denoise in one batched forward over the stacked
parameters, the seams are cross-conditioned every step, and the global
(B, T*H, D) trajectories are assembled, classified, scored and smoothed.

Frames and times, as in the reference:
- the start is pinned in tile 0 at t = 0, the goal in the last tile at
  t = H-1, both in local normalized coordinates (mpd_ensemble.py:286-296)
- constraints arrive in the global frame and time; each point goes to tile
  t_start // H, with its time shifted by -tile * H and its position by
  -transform (split_cost_constraints_to_tasks, mpd_ensemble.py:431-518);
  per tile, the hard points form one constraint and the soft points
  another; one large per-waypoint group (ECBS) is split out over the global
  horizon and routed per tile in the cheap (R, H) form
- a sample is free iff it is free in every tile, each classified in its
  own frame (tasks_ensemble.py:77-84, combine_trajs :162-225)

`_run` has `MPD._run`'s contract (constraints in the global frame, an
optional experience of global (B, T*H, D) paths, optional injected draws),
so the team planners take an ensemble agent as they take an MPD one.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from mmd_torch.common.constraints import MultiPointConstraint
from mmd_torch.common.experiences import PathBatchExperience
from mmd_torch.config import DiffusionConfig, params as default_params
from mmd_torch.costs.constraints import (
    ConstraintSet,
    SoftPathConstraints,
    pack_constraint_sets,
    split_soft_path_constraints,
)
from mmd_torch.costs.guide import GuideConfig, GuideData
from mmd_torch.datasets.normalization import LimitsNormalizer
from mmd_torch.datasets.trajectories import TrajectoryDataset
from mmd_torch.envs.envs import SceneStack
from mmd_torch.models.diffusion import HardConds, SamplerNoise, q_sample
from mmd_torch.models.ensemble import CrossConds, ensemble_p_sample_loop, stack_params
from mmd_torch.models.temporal_unet import bf16_model
from mmd_torch.planners.single_agent.common import PlannerOutput
from mmd_torch.planners.single_agent.mpd import MPD, PlanResult
from mmd_torch.tasks.task import PlanningTask, classify_trajs
from mmd_torch.tasks.task_ensemble import TaskEnsemble
from mmd_torch.utils.interp import savgol_matrix
from mmd_torch.utils.metrics import (
    compute_path_length,
    compute_smoothness,
    compute_variance_waypoints,
)
from mmd_torch.utils.transfer import to_device

# Padded sizes of a routed constraint stack, as JAX's (mpd.py:57-65): every
# tile's set is padded to one (K, P). An unused slot adds exactly zero.
K_BUCKETS = (4, 16, 64, 128, 256)
P_BUCKETS = (1, 64, 512, 2048, 4096)


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} exceeds the largest bucket {buckets[-1]}")


def _split_global_path_constraint(constraints_l, global_horizon: int):
    """The one large per-waypoint constraint (ECBS-style) split out of the
    list over the global horizon: (the rest, (points (R, T*H, 2), mask
    (R, T*H), radius, weight) as numpy and floats, or None)."""
    rest, spc = split_soft_path_constraints(constraints_l, global_horizon, device="cpu")
    if spc is None:
        return rest, None
    return rest, (spc.points.numpy(), spc.mask.numpy(), float(spc.radius), float(spc.weight))


@torch.no_grad()
def _finalize_ensemble(chain: torch.Tensor, normalizer: LimitsNormalizer,
                       transforms: torch.Tensor, scenes: SceneStack, radius: float,
                       q_min, q_max, savgol: torch.Tensor) -> PlanResult:
    """chain (S+1, T, B, H, D), normalized per tile -> the global PlanResult
    (mpd_ensemble.py:70-105): per tile unnormalized and translated, tile
    after tile along the horizon; free iff free in every tile, each tile
    classified in its own frame (one lookup a tile); scored by length and
    smoothness; savgol-smoothed over T*H."""
    S1, T, B, H, D = chain.shape
    local = normalizer.unnormalize(chain)                  # (S+1, T, B, H, D)
    shift = torch.zeros((T, 1, 1, D), dtype=chain.dtype, device=chain.device)
    shift[:, 0, 0, :2] = transforms
    trajs_iters = (local + shift).permute(0, 2, 1, 3, 4).reshape(S1, B, T * H, D)
    trajs_final = trajs_iters[-1]
    per_tile = [classify_trajs(scene, local[-1, m], radius, q_min, q_max)
                for m, scene in enumerate(scenes.scenes)]
    free_mask = torch.stack([f for f, _ in per_tile]).all(dim=0)
    wp_coll = torch.cat([w for _, w in per_tile], dim=-1)       # (B, T * H_interp)
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


class MPDEnsemble:
    """A multi-tile planner bound to a skeleton of (model, dataset) tiles,
    their world translations and one global start and goal. Runs on the
    datasets' device."""

    def __init__(self, models: Sequence, schedule, datasets: Sequence[TrajectoryDataset],
                 transforms, start_state_pos, goal_state_pos,
                 cfg: Optional[DiffusionConfig] = None,
                 guide_cfg: Optional[GuideConfig] = None,
                 seed: int = default_params.seed, bf16: bool = False):
        if not len(models) == len(datasets) == len(transforms):
            raise ValueError("one model, dataset and transform per tile")
        self.n_tiles = T = len(models)
        # Every tile shares the architecture; with bf16 each tile's
        # bfloat16 twin (shared with the model's other planners) is stacked.
        self.model = stack_params([bf16_model(m) if bf16 else m for m in models])
        self.schedule = schedule
        self.datasets = list(datasets)
        self.device = datasets[0].device
        self.robot = datasets[0].robot
        self.transforms = np.asarray(transforms, np.float32)
        self._transforms = torch.as_tensor(self.transforms, device=self.device)
        self.task = TaskEnsemble([PlanningTask(d.env, d.robot) for d in datasets],
                                 self.transforms, self.robot)
        self.scene = self.task.stacked_scenes
        H = self.n_support_points = datasets[0].n_support_points
        D = datasets[0].state_dim
        self.cfg = cfg or DiffusionConfig(
            horizon=H, state_dim=D, n_diffusion_steps=schedule.n_steps,
            t_start_guide=int(np.ceil(default_params.start_guide_steps_fraction
                                      * schedule.n_steps)),
            n_guide_steps=default_params.n_guide_steps)
        self.guide_cfg = guide_cfg or GuideConfig(dt=datasets[0].duration / H,
                                                  robot_radius=self.robot.radius)

        self.start_state_pos = np.asarray(start_state_pos, np.float32)
        self.goal_state_pos = np.asarray(goal_state_pos, np.float32)
        # The start in tile 0 at t = 0, the goal in the last tile at H-1,
        # in local frames, normalized (mpd_ensemble.py:286-296).
        kw = dict(dtype=torch.float32, device=self.device)
        pad = np.zeros(D - 2, np.float32)
        sv = datasets[0].normalizer.normalize(torch.as_tensor(
            np.concatenate([self.start_state_pos - self.transforms[0], pad]), **kw))
        gv = datasets[-1].normalizer.normalize(torch.as_tensor(
            np.concatenate([self.goal_state_pos - self.transforms[-1], pad]), **kw))
        mask = torch.zeros((T, 1, H, 1), **kw)
        mask[0, 0, 0] = 1.0
        mask[-1, 0, H - 1] = 1.0
        values = torch.zeros((T, 1, H, D), **kw)
        values[0, 0, 0] = sv
        values[-1, 0, H - 1] = gv
        self.hard_conds = HardConds(mask=mask, values=values)

        self.cc = CrossConds.from_transforms(self.transforms, D, self.device)
        self.normalizer = LimitsNormalizer.stack([d.normalizer for d in datasets])
        self._savgol = torch.as_tensor(np.array(savgol_matrix(T * H)), **kw)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)

    # ------------------------------------------------------------ pieces
    def draw_noise(self, local: bool = False) -> SamplerNoise:
        """One loop's draws for every tile, from the planner's generator:
        a fresh loop's, or with `local` a local replan's."""
        return SamplerNoise.draw(self.cfg, self._generator, self.device,
                                 default_params.n_local_inference_denoising_steps
                                 if local else None, n_tiles=self.n_tiles)

    def _route_constraints(self, constraints_l: Optional[List[MultiPointConstraint]]
                           ) -> Tuple[ConstraintSet, Optional[SoftPathConstraints]]:
        """Global constraints -> (the per-tile sets (T, K, P, ...), the
        per-tile soft paths (T, R, H, ...) or None)
        (split_cost_constraints_to_tasks, mpd_ensemble.py:431-518)."""
        T, H = self.n_tiles, self.n_support_points
        rest, global_spc = _split_global_path_constraint(constraints_l or [], T * H)

        per_tile_hard: List[list] = [[] for _ in range(T)]
        per_tile_soft: List[list] = [[] for _ in range(T)]
        for c in rest:
            for q, (t0, t1), r in zip(c.q_l, c.t_range_l, c.radius_l):
                tid = min(max(int(t0) // H, 0), T - 1)
                entry = (np.asarray(q, np.float32)[:2] - self.transforms[tid],
                         (t0 - tid * H, t1 - tid * H), float(r))
                (per_tile_soft if c.is_soft else per_tile_hard)[tid].append(entry)

        per_tile: List[list] = []
        max_pts = 1
        for tid in range(T):
            lst = []
            for group, is_soft in ((per_tile_hard[tid], False), (per_tile_soft[tid], True)):
                if group:
                    qs, ranges, radii = zip(*group)
                    lst.append(MultiPointConstraint(q_l=list(qs), t_range_l=list(ranges),
                                                    radius_l=list(radii), is_soft=is_soft))
                    max_pts = max(max_pts, len(qs))
            per_tile.append(lst)
        K = _bucket(max(1, max(len(lst) for lst in per_tile)), K_BUCKETS)
        P = _bucket(max_pts, P_BUCKETS)
        csets = pack_constraint_sets(per_tile, K, P, device=self.device)

        spc = None
        if global_spc is not None:
            points_g, mask_g, radius, weight = global_spc        # (R, T*H, 2), (R, T*H)
            R = points_g.shape[0]
            pts = points_g.reshape(R, T, H, 2).transpose(1, 0, 2, 3).copy()
            pts -= self.transforms[:, None, None, :]
            msk = np.ascontiguousarray(mask_g.reshape(R, T, H).transpose(1, 0, 2))
            kw = dict(dtype=torch.float32, device=self.device)
            spc = SoftPathConstraints(points=to_device(pts, self.device),
                                      mask=to_device(msk, self.device),
                                      radius=torch.full((T,), radius, **kw),
                                      weight=torch.full((T,), weight, **kw))
        return csets, spc

    def _guide_data(self, csets: ConstraintSet,
                    spc: Optional[SoftPathConstraints] = None) -> GuideData:
        return GuideData(scene=self.scene, normalizer=self.normalizer,
                         constraints=csets, soft_paths=spc)

    def local_seeds(self, paths: torch.Tensor) -> torch.Tensor:
        """Global (B, T*H, D) paths -> per-tile local normalized seeds
        (T, B, H, D): split along the horizon, shifted into each tile's
        frame, normalized by its tile's normalizer."""
        B, _, D = paths.shape
        tiles = paths.reshape(B, self.n_tiles, self.n_support_points, D).permute(1, 0, 2, 3)
        tiles = tiles.clone()
        tiles[..., :2] -= self._transforms[:, None, None, :]
        return self.normalizer.normalize(tiles)

    def _finalize(self, chain: torch.Tensor) -> PlanResult:
        return _finalize_ensemble(chain, self.normalizer, self._transforms, self.scene,
                                  self.robot.radius, self.robot.q_min, self.robot.q_max,
                                  self._savgol)

    def _plan_fresh(self, gds: GuideData, noise: SamplerNoise) -> PlanResult:
        """The fresh ensemble plan under `gds` (mpd_ensemble.py:108-117)."""
        _, chain = ensemble_p_sample_loop(self.model, self.schedule, self.hard_conds,
                                          self.cc, self.cfg, noise, gds=gds,
                                          guide_cfg=self.guide_cfg)
        return self._finalize(chain)

    def _plan_local(self, gds: GuideData, seed_local_norm: torch.Tensor,
                    noise: SamplerNoise) -> PlanResult:
        """The local replan (mpd_ensemble.py:120-139): the seeds (T, B, H, D)
        q-sampled at n_local_inference_noising_steps with noise.x_T, then
        that many steps and the noise-free ones denoised under `gds`."""
        T, B = seed_local_norm.shape[:2]
        t = torch.full((T * B,), default_params.n_local_inference_noising_steps,
                       dtype=torch.int64, device=seed_local_norm.device)
        warm = q_sample(self.schedule, seed_local_norm.flatten(0, 1), t,
                        noise.x_T.flatten(0, 1)).view_as(seed_local_norm)
        _, chain = ensemble_p_sample_loop(
            self.model, self.schedule, self.hard_conds, self.cc, self.cfg, noise, gds=gds,
            guide_cfg=self.guide_cfg,
            n_diffusion_steps=default_params.n_local_inference_denoising_steps,
            warm_start=warm)
        return self._finalize(chain)

    def _run(self, constraints_l: Optional[List] = None,
             experience: Optional[PathBatchExperience] = None,
             noise: Optional[SamplerNoise] = None) -> PlanResult:
        """One plan on the device: fresh, or local from the experience's
        global batch; draws from the planner's generator unless `noise` is
        given. Nothing is read to the host."""
        gds = self._guide_data(*self._route_constraints(constraints_l))
        if experience is None:
            return self._plan_fresh(gds, noise if noise is not None else self.draw_noise())
        return self._plan_local(gds, self.local_seeds(experience.path_b),
                                noise if noise is not None else self.draw_noise(local=True))

    def __call__(self, start_state_pos=None, goal_state_pos=None,
                 constraints_l: Optional[List] = None,
                 experience: Optional[PathBatchExperience] = None,
                 noise: Optional[SamplerNoise] = None) -> PlannerOutput:
        """Plan once, locally from `experience` if given; `noise` replaces
        the planner's own draws (for replay)."""
        for given, bound in ((start_state_pos, self.start_state_pos),
                             (goal_state_pos, self.goal_state_pos)):
            if given is not None and not np.allclose(np.asarray(given), bound):
                raise ValueError("start/goal differ from the ones bound at "
                                 "construction (mpd_ensemble.py:348-350)")
        t0 = time.perf_counter()
        res = self._run(constraints_l, experience, noise)
        free = res.free_mask.cpu().numpy()  # waits for the plan to finish
        return MPD._to_output(res, free, constraints_l, time.perf_counter() - t0)
