"""A multi-agent trial: per-agent planners from (model ids, tile
skeletons), the team planner, the timed team plan, the post-hoc solution
audit, the metrics and the saved result.

Twin of `mmd_tpu/experiments/trial.py` (reference:
scripts/inference/inference_multi_agent.py:81-366): a single-tile agent
gets an `MPD` in its tile's frame, a longer skeleton an `MPDEnsemble` in
the global frame; agent i starts `stagger_dt * i` steps late; the
reference task spans every tile of the grid. A saved successful trial
gets its frame, mmd_single_trial.png, and with `render_animation` its GIF
(`viz.visualizer`, on the host, with matplotlib). Where matplotlib is not
installed the frame is skipped with one line on stderr, and
`render_animation` raises ImportError before the trial plans.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mmd_torch.config import DiffusionConfig, params as default_params
from mmd_torch.datasets.normalization import LimitsNormalizer
from mmd_torch.datagen.synthetic import generate_linear_dataset
from mmd_torch.datasets.trajectories import TrajectoryDataset, env_name_from_model_id
from mmd_torch.envs.envs import make_env
from mmd_torch.experiments.experiments import (
    RESULTS_ROOT,
    MultiAgentPlanningSingleTrialConfig,
    MultiAgentPlanningSingleTrialResult,
    check_results_root,
    get_result_dir_from_trial_config,
)
from mmd_torch.experiments.status import TrialSuccessStatus
from mmd_torch.planners.multi_agent.cbs import CBS
from mmd_torch.planners.multi_agent.conflict_detection import team_conflict_summary
from mmd_torch.planners.multi_agent.prioritized_planning import PrioritizedPlanning
from mmd_torch.planners.single_agent.mpd import MPD
from mmd_torch.planners.single_agent.mpd_ensemble import MPDEnsemble
from mmd_torch.tasks.task import PlanningTask
from mmd_torch.tasks.task_ensemble import TaskEnsemble
from mmd_torch.train.checkpoint import load_checkpoint
from mmd_torch.utils.metrics import compute_average_acceleration, compute_path_length
from mmd_torch.utils.profiling import compile_time_monitor

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
                            bf16: bool = False,
                            search_kw: Optional[dict] = None) -> TrialTeam:
    """The planner construction of run_multi_agent_trial (JAX trial.py:156-213;
    reference: inference_multi_agent.py:163-254): global starts and goals
    (the problem's are in the frame of the agent's first and last tile),
    agent i's planner over its skeleton seeded seed + i + 1009 * trial,
    start times stagger_dt * i, the reference task over the whole grid;
    search_kw goes to a CBS team (`search_kwargs`)."""
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
                             reference_task=reference_task, **(search_kw or {}))
    return TrialTeam(team=team, planners=planners, start_l=start_l, goal_l=goal_l,
                     start_time_l=start_time_l, model_ids_l=model_ids_l,
                     transforms_l=transforms_l)


@dataclasses.dataclass
class SolutionScore:
    """What a team's solution scores: its status after the audit, the
    contacts the audit added, and the success-only metrics (0.0 else)."""

    status: TrialSuccessStatus
    n_audit: int = 0
    data_adherence: float = 0.0
    path_length_per_agent: float = 0.0
    mean_path_acceleration_per_agent: float = 0.0


def score_solution(paths_l: List[np.ndarray], status: TrialSuccessStatus,
                   start_time_l: List[int], model_ids_l: List[List[str]],
                   transforms_l: List[np.ndarray], horizons: List[int],
                   robot_radius: float = default_params.robot_planar_disk_radius
                   ) -> SolutionScore:
    """The scoring of run_multi_agent_trial, in JAX's order (trial.py:237-275;
    reference: inference_multi_agent.py:286-330): a SUCCESS whose padded
    paths bring two robots closer than 2 * radius becomes
    FAIL_COLLISION_AGENTS with the contacts added; a SUCCESS that stands
    gets agent i's data adherence, the mean over its skeleton's tiles of
    its map's score of the tile's H = horizons[i] steps from its start
    time, in the tile's frame, averaged over agents, and the mean path
    length and acceleration over agents."""
    score = SolutionScore(status=status)
    if len(paths_l) > 0 and status == TrialSuccessStatus.SUCCESS:
        score.n_audit = audit_solution_collisions(paths_l, robot_radius)
        if score.n_audit > 0:
            score.status = TrialSuccessStatus.FAIL_COLLISION_AGENTS
    if score.status != TrialSuccessStatus.SUCCESS:
        return score
    adh_total = 0.0
    for i, mids in enumerate(model_ids_l):
        H, path, agent_adh = horizons[i], np.asarray(paths_l[i]), 0.0
        for step, mid in enumerate(mids):
            seg = path[start_time_l[i] + step * H: start_time_l[i] + (step + 1) * H, :2]
            env = make_env(env_name_from_model_id(mid), device="cpu")
            agent_adh += env.compute_traj_data_adherence(seg - transforms_l[i][step])
        adh_total += agent_adh / len(mids)
    score.data_adherence = adh_total / len(model_ids_l)
    trajs = [torch.from_numpy(np.asarray(p, np.float32))[None] for p in paths_l]
    score.path_length_per_agent = float(np.mean(
        [float(compute_path_length(t)[0]) for t in trajs]))
    score.mean_path_acceleration_per_agent = float(np.mean(
        [float(compute_average_acceleration(t)[0]) for t in trajs]))
    return score


SHARDING_NOT_PORTED = ("sharding a team over devices is not ported (ROADMAP.md Queue 1, "
                       "\"sharding\": parallel/sharding.py)")


def refuse_unported(cfg: MultiAgentPlanningSingleTrialConfig, mesh=None) -> None:
    """Raise ValueError for a knob of the JAX trial that the port lacks
    (a mesh), naming the ROADMAP.md item that ports it, rather than ignore
    it; and ImportError for `render_animation` on a machine without
    matplotlib, before anything is planned."""
    if mesh is not None:
        raise ValueError(f"mesh: {SHARDING_NOT_PORTED}")
    if cfg.render_animation:
        from mmd_torch.viz.visualizer import pyplot

        pyplot()


def save_renders(cfg: MultiAgentPlanningSingleTrialConfig, trial: "TrialTeam",
                 paths_l: List[np.ndarray], results_dir: str) -> None:
    """A successful trial's frame, and its GIF with `render_animation`
    (JAX trial.py:277-290): the team's paths over every tile of the grid.
    Without matplotlib the frame is skipped with one line on stderr."""
    from mmd_torch.viz.visualizer import PlanningVisualizer, pyplot

    try:
        pyplot()
    except ImportError as e:
        if cfg.render_animation:
            raise
        print(f"run_multi_agent_trial: mmd_single_trial.png skipped: {e}", file=sys.stderr)
        return
    coords = [[r, c] for r in range(len(cfg.global_model_ids))
              for c in range(len(cfg.global_model_ids[0]))]
    envs = [make_env(env_name_from_model_id(cfg.global_model_ids[r][c]), device="cpu")
            for r, c in coords]
    transforms = np.stack([tile_transform(rc) for rc in coords])
    viz = PlanningVisualizer(robot_radius=trial.planners[0].robot.radius)
    viz.save_frame(paths_l, trial.start_l, trial.goal_l,
                   output_fpath=os.path.join(results_dir, "mmd_single_trial.png"),
                   envs=envs, env_transforms=transforms)
    if cfg.render_animation:
        viz.animate_multi_robot_trajectories(
            trajs_l=paths_l, start_state_l=trial.start_l, goal_state_l=trial.goal_l,
            video_filepath=os.path.join(results_dir, "mmd_single_trial.gif"),
            envs=envs, env_transforms=transforms)


def search_kwargs(cfg: MultiAgentPlanningSingleTrialConfig) -> dict:
    """The CBS knobs of the trial's config, for a CBS team only (JAX
    trial.py:201-209); `CBS` owns their defaults."""
    if cfg.multi_agent_planner_class == "PP":
        return {}
    return {"frontier_width": cfg.frontier_width, "repair_period": cfg.repair_period,
            "greedy_iters": cfg.greedy_iters}


def run_multi_agent_trial(cfg: MultiAgentPlanningSingleTrialConfig,
                          registry: Optional[ModelRegistry] = None,
                          results_root: str = RESULTS_ROOT, save: bool = True,
                          diffusion_cfg: Optional[DiffusionConfig] = None,
                          mesh=None) -> MultiAgentPlanningSingleTrialResult:
    """One trial (JAX trial.py:145-290; reference: inference_multi_agent.py:
    81-366): build the planners on the registry's device (a new registry
    of the repository's checkpoints on the card by default), time
    `team.plan(runtime_limit)` on the host clock up to a synchronize of the
    card, score the solution (`score_solution`) and save the result under
    `results_root`, with a successful trial's renders (`save_renders`). On
    the card the kernels are built before the clock starts;
    `jit_compile_time` holds the seconds spent building kernels inside the
    plan (`utils.profiling.compile_time_monitor`), 0.0 once they are built.
    Unported knobs and, when saving, the committed `results/` tree raise
    (`refuse_unported`, `check_results_root`)."""
    refuse_unported(cfg, mesh)
    if save:
        check_results_root(results_root)
    registry = registry or ModelRegistry()
    trial = build_multi_agent_trial(
        cfg.multi_agent_planner_class, cfg.start_state_pos_l, cfg.goal_state_pos_l,
        cfg.global_model_ids, cfg.agent_skeleton_l, registry,
        stagger_dt=cfg.stagger_start_time_dt, trial_number=cfg.trial_number,
        diffusion_cfg=diffusion_cfg, bf16=cfg.bf16, search_kw=search_kwargs(cfg))
    device = torch.device(registry.device)
    if device.type == "cuda":
        from mmd_torch.ops.build import load_kernels

        load_kernels()  # built once a process, before the clock starts
    t0 = time.perf_counter()
    with compile_time_monitor() as compile_acc:
        paths_l, num_ct_expansions, status, n_coll = trial.team.plan(
            runtime_limit=cfg.runtime_limit)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    planning_time = time.perf_counter() - t0

    score = score_solution(paths_l, status, trial.start_time_l, trial.model_ids_l,
                           trial.transforms_l, [p.n_support_points for p in trial.planners])
    result = MultiAgentPlanningSingleTrialResult(
        trial_config=cfg,
        agent_path_l=[np.asarray(p) for p in paths_l],
        num_ct_expansions=num_ct_expansions,
        success_status=score.status,
        num_collisions_in_solution=n_coll + score.n_audit,
        data_adherence=score.data_adherence,
        planning_time=planning_time,
        jit_compile_time=float(compile_acc["compile_s"]),
        path_length_per_agent=score.path_length_per_agent,
        mean_path_acceleration_per_agent=score.mean_path_acceleration_per_agent,
        start_state_pos_l=[s.tolist() for s in trial.start_l],
        goal_state_pos_l=[g.tolist() for g in trial.goal_l],
        global_model_ids=cfg.global_model_ids,
        agent_skeleton_l=cfg.agent_skeleton_l,
        team_timing=dict(trial.team.timing),
    )
    if save:
        results_dir = get_result_dir_from_trial_config(
            cfg, cfg.time_str or time.strftime("%y-%m-%d--%H-%M-%S"), cfg.trial_number,
            root=results_root)
        result.save(results_dir)
        if result.success_status == TrialSuccessStatus.SUCCESS and len(paths_l):
            save_renders(cfg, trial, result.agent_path_l, results_dir)
    return result
