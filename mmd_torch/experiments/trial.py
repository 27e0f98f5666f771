"""A multi-agent trial's planners: per-agent planners from (model ids, tile
skeletons), the team planner, and the post-hoc solution audit.

Twin of the planner-building part of `mmd_tpu/experiments/trial.py`
(reference: scripts/inference/inference_multi_agent.py:81-296): a
single-tile agent gets an `MPD` in its tile's frame, a longer skeleton an
`MPDEnsemble` in the global frame; agent i starts `stagger_dt * i` steps
late; the reference task spans every tile of the grid. Saving results,
the metrics and rendering are not ported.
"""
from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mmd_torch.config import DiffusionConfig, params as default_params
from mmd_torch.datasets.normalization import LimitsNormalizer
from mmd_torch.datagen.synthetic import generate_linear_dataset
from mmd_torch.datasets.trajectories import TrajectoryDataset, env_name_from_model_id
from mmd_torch.planners.multi_agent.cbs import CBS
from mmd_torch.planners.multi_agent.conflict_detection import team_conflict_summary
from mmd_torch.planners.multi_agent.prioritized_planning import PrioritizedPlanning
from mmd_torch.planners.single_agent.mpd import MPD
from mmd_torch.planners.single_agent.mpd_ensemble import MPDEnsemble
from mmd_torch.tasks.task import PlanningTask
from mmd_torch.tasks.task_ensemble import TaskEnsemble
from mmd_torch.train.checkpoint import load_checkpoint

ROOT = Path(__file__).resolve().parents[2]
TILE_WIDTH = 2.0   # reference: inference_multi_agent.py:146-149
TILE_HEIGHT = 2.0


def tile_transform(coord: Sequence[int]) -> np.ndarray:
    """Skeleton coord [row, col] -> world translation (col * W, -row * H)."""
    r, c = coord
    return np.array([c * TILE_WIDTH, -r * TILE_HEIGHT], np.float32)


class ModelRegistry:
    """(model, schedule, dataset) per model id, loaded once, the dataset
    with the checkpoint's training normalizer (the reference reloads
    args.yaml for it, mpd.py:120). A model whose dataset is missing gets
    256 contexts of linear data (`generate_linear_dataset`, seed 7), as the
    JAX registry falls back (trial.py:66-70)."""

    def __init__(self, trained_models_dir=ROOT / "data_trained_models",
                 trajectories_dir=ROOT / "data_trajectories", device="cuda"):
        self.trained_models_dir = str(trained_models_dir)
        self.trajectories_dir = str(trajectories_dir)
        self.device = device
        self._cache: Dict[str, Tuple] = {}

    def get(self, mid: str):
        if mid not in self._cache:
            model, schedule, info = load_checkpoint(
                os.path.join(self.trained_models_dir, mid), device=self.device)
            normalizer = LimitsNormalizer.from_limits(
                info["normalizer_mins"], info["normalizer_maxs"], device=self.device)
            try:
                dataset = TrajectoryDataset.load(self.trajectories_dir, mid, normalizer,
                                                 device=self.device)
            except FileNotFoundError:
                env_name = env_name_from_model_id(mid)
                print(f"ModelRegistry: no dataset for {mid} under {self.trajectories_dir}; "
                      f"generating 256 contexts of linear data for {env_name}")
                dataset = generate_linear_dataset(env_name, n_contexts=256, seed=7,
                                                  device=self.device)
                dataset.normalizer = normalizer
                dataset.trajs_normalized = normalizer.normalize(dataset.trajs)
            self._cache[mid] = (model, schedule, dataset)
        return self._cache[mid]


def build_agent_planner(registry: ModelRegistry, model_ids: List[str],
                        transforms: np.ndarray, start_global, goal_global,
                        seed: int = 0, cfg: Optional[DiffusionConfig] = None,
                        bf16: bool = False):
    """A one-tile skeleton -> an MPD in the tile's frame; a longer one -> an
    MPDEnsemble in the global frame."""
    if len(model_ids) == 1:
        model, schedule, dataset = registry.get(model_ids[0])
        return MPD(model, schedule, dataset, np.asarray(start_global) - transforms[0],
                   np.asarray(goal_global) - transforms[0], cfg=cfg, seed=seed, bf16=bf16)
    tiles = [registry.get(mid) for mid in model_ids]
    return MPDEnsemble([m for m, _, _ in tiles], tiles[-1][1], [d for _, _, d in tiles],
                       transforms, np.asarray(start_global), np.asarray(goal_global),
                       cfg=cfg, seed=seed, bf16=bf16)


def make_team_planner(planner_class: str, low_level_planner_l, start_l, goal_l, **kwargs):
    """reference: inference_multi_agent.py:112-113, 240-254."""
    if planner_class == "PP":
        return PrioritizedPlanning(low_level_planner_l, start_l, goal_l, **kwargs)
    is_ecbs, is_xcbs = {"CBS": (False, False), "ECBS": (True, False),
                        "XCBS": (False, True), "XECBS": (True, True)}[planner_class]
    return CBS(low_level_planner_l, start_l, goal_l, is_ecbs=is_ecbs, is_xcbs=is_xcbs,
               **kwargs)


def audit_solution_collisions(paths_l: List[np.ndarray], robot_radius: float) -> int:
    """Unordered (pair, t) contacts closer than 2 * radius among padded
    paths (reference: inference_multi_agent.py:286-296)."""
    pos = torch.from_numpy(np.stack([np.asarray(p, np.float32)[:, :2] for p in paths_l]))
    count, *_ = team_conflict_summary(pos, 2.0 * robot_radius)
    return int(count) // 2  # ordered -> unordered pairs


@dataclasses.dataclass
class TrialTeam:
    """A trial's team planner and what it was built from."""

    team: object                  # CBS or PrioritizedPlanning
    planners: list
    start_l: List[np.ndarray]     # global frame
    goal_l: List[np.ndarray]
    start_time_l: List[int]
    model_ids_l: List[List[str]]
    transforms_l: List[np.ndarray]


def build_multi_agent_trial(planner_class: str, start_l_local, goal_l_local,
                            global_model_ids: List[List[str]],
                            skeletons: List[List[List[int]]],
                            registry: ModelRegistry, stagger_dt: int = 0,
                            trial_number: int = 0,
                            diffusion_cfg: Optional[DiffusionConfig] = None,
                            bf16: bool = False) -> TrialTeam:
    """The planner construction of run_multi_agent_trial (JAX trial.py:156-213;
    reference: inference_multi_agent.py:163-254): global starts and goals
    (the problem's are in the frame of the agent's first and last tile),
    agent i's planner over its skeleton seeded seed + i + 1009 * trial,
    start times stagger_dt * i, the reference task over the whole grid."""
    n = len(start_l_local)
    start_l = [np.asarray(start_l_local[i], np.float32) + tile_transform(skeletons[i][0])
               for i in range(n)]
    goal_l = [np.asarray(goal_l_local[i], np.float32) + tile_transform(skeletons[i][-1])
              for i in range(n)]
    model_ids_l, transforms_l, planners = [], [], []
    for i in range(n):
        mids = [global_model_ids[r][c] for r, c in skeletons[i]]
        transforms = np.stack([tile_transform(rc) for rc in skeletons[i]])
        model_ids_l.append(mids)
        transforms_l.append(transforms)
        # A seed per agent and trial: on a deterministic problem fixed
        # seeds would make every trial the same.
        planners.append(build_agent_planner(
            registry, mids, transforms, start_l[i], goal_l[i],
            seed=default_params.seed + i + 1009 * trial_number, cfg=diffusion_cfg, bf16=bf16))

    coords = [[r, c] for r in range(len(global_model_ids))
              for c in range(len(global_model_ids[0]))]
    ref_tasks = [PlanningTask(registry.get(global_model_ids[r][c])[2].env) for r, c in coords]
    reference_task = (ref_tasks[0] if len(coords) == 1 else
                      TaskEnsemble(ref_tasks, np.stack([tile_transform(rc) for rc in coords])))
    start_time_l = [stagger_dt * i for i in range(n)]
    team = make_team_planner(planner_class, planners, start_l, goal_l,
                             start_time_l=start_time_l, reference_robot=planners[0].robot,
                             reference_task=reference_task)
    return TrialTeam(team=team, planners=planners, start_l=start_l, goal_l=goal_l,
                     start_time_l=start_time_l, model_ids_l=model_ids_l,
                     transforms_l=transforms_l)
