"""Experiment configs, per-trial results, and the results-directory layout.

Twin of `mmd_tpu/experiments/experiments.py` (reference:
mmd/common/experiments/experiments.py:47-274), with its field names and
defaults. A trial's result pickles to results.pkl beside a results.txt
whose text is the JAX package's for the same numbers, under
<root>/<time_str>/instance_name___X/num_agents___N/planner___P/
single_agent_planner___S/<trial>/. An experiment's trials pair across
planners: trial t of every planner plans the problem drawn from the seed
`crc32(f"{instance}:{num_agents}") + t`, the JAX package's seed, so the
port's trial t is also JAX's trial t. Results go under `build/results` of
the repository by default; the committed `results/` tree, and a sweep
whose results.pkl another package wrote, are refused
(`check_results_root`).
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import zlib
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from mmd_torch.config import params as default_params
from mmd_torch.experiments.status import TrialSuccessStatus

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RESULTS_ROOT = os.path.join(ROOT, "build", "results")
FOREIGN_PACKAGES = ("mmd_tpu", "jax", "jaxlib", "flax")


@dataclasses.dataclass
class MultiAgentPlanningSingleTrialConfig:
    """reference: experiments.py:122-166. `frontier_width`, `repair_period`
    and `greedy_iters` reach a CBS team's search; `render_animation` adds
    a successful trial's GIF beside its frame (it needs matplotlib)."""

    time_str: Optional[str] = None
    trial_number: int = 0
    runtime_limit: float = 10.0
    num_agents: int = 1
    stagger_start_time_dt: int = 0
    multi_agent_planner_class: str = "XECBS"
    single_agent_planner_class: str = "MPD"
    instance_name: Optional[str] = None
    render_animation: bool = False
    start_state_pos_l: Optional[List[np.ndarray]] = None
    goal_state_pos_l: Optional[List[np.ndarray]] = None
    global_model_ids: Optional[List[List[str]]] = None
    agent_skeleton_l: Optional[List[List[List[int]]]] = None
    frontier_width: int = 1
    bf16: bool = False
    repair_period: int = 0
    greedy_iters: int = 0


@dataclasses.dataclass
class MultiAgentPlanningExperimentConfig:
    """reference: experiments.py:47-120."""

    time_str: Optional[str] = None
    instance_name: Optional[str] = None
    num_agents_l: List[int] = dataclasses.field(default_factory=list)
    stagger_start_time_dt: int = 0
    multi_agent_planner_class_l: List[str] = dataclasses.field(default_factory=list)
    single_agent_planner_class: str = "MPD"
    runtime_limit: float = default_params.runtime_limit
    num_trials_per_combination: int = 1
    render_animation: bool = False
    frontier_width: int = 1
    bf16: bool = False
    repair_period: int = 0
    greedy_iters: int = 0

    def get_single_trial_configs_from_experiment_config(self):
        """One config per (agents, planner, trial); trial t of every planner
        gets the same problem (reference :68-97), drawn from a seed fixed by
        (instance, agents, t), so a resumed sweep draws it again."""
        from mmd_torch.experiments.problems import get_planning_problem

        configs = []
        for num_agents in self.num_agents_l:
            base = zlib.crc32(f"{self.instance_name}:{num_agents}".encode())
            problems = [get_planning_problem(self.instance_name, num_agents, seed=base + t)
                        for t in range(self.num_trials_per_combination)]
            for planner_cls in self.multi_agent_planner_class_l:
                for trial_number in range(self.num_trials_per_combination):
                    c = MultiAgentPlanningSingleTrialConfig(
                        time_str=self.time_str,
                        trial_number=trial_number,
                        num_agents=num_agents,
                        stagger_start_time_dt=self.stagger_start_time_dt,
                        multi_agent_planner_class=planner_cls,
                        single_agent_planner_class=self.single_agent_planner_class,
                        instance_name=self.instance_name,
                        runtime_limit=self.runtime_limit,
                        render_animation=self.render_animation,
                        frontier_width=self.frontier_width,
                        bf16=self.bf16,
                        repair_period=self.repair_period,
                        greedy_iters=self.greedy_iters,
                    )
                    (c.start_state_pos_l, c.goal_state_pos_l,
                     c.global_model_ids, c.agent_skeleton_l) = problems[trial_number]
                    configs.append(c)
        return configs

    def save(self, root: str = RESULTS_ROOT):
        d = get_result_dir_from_time_str(self.time_str, root)
        Path(d).mkdir(parents=True, exist_ok=True)
        with open(os.path.join(d, "experiment_config.pkl"), "wb") as f:
            pickle.dump(self, f)


@dataclasses.dataclass
class MultiAgentPlanningSingleTrialResult:
    """reference: experiments.py:179-239. `jit_compile_time` is kept so that
    the results and their aggregates have JAX's layout; the port compiles
    no XLA program, so it is always 0.0. `team_timing`, the port's own
    field, holds the team planner's `timing` after its plan: the plan's
    host seconds, its waits on the device, its plans fresh and local and
    their UNet forwards; results.txt leaves it out, as JAX's has no such
    line."""

    trial_config: Optional[MultiAgentPlanningSingleTrialConfig] = None
    agent_path_l: List[np.ndarray] = dataclasses.field(default_factory=list)
    num_ct_expansions: int = 0
    success_status: TrialSuccessStatus = TrialSuccessStatus.UNKNOWN
    num_collisions_in_solution: int = 0
    data_adherence: float = 0.0
    planning_time: float = 0.0
    jit_compile_time: float = 0.0
    path_length_per_agent: float = 0.0
    mean_path_acceleration_per_agent: float = 0.0
    start_state_pos_l: List[np.ndarray] = dataclasses.field(default_factory=list)
    goal_state_pos_l: List[np.ndarray] = dataclasses.field(default_factory=list)
    global_model_ids: List[List[str]] = dataclasses.field(default_factory=list)
    agent_skeleton_l: List[List[List[int]]] = dataclasses.field(default_factory=list)
    team_timing: Dict = dataclasses.field(default_factory=dict)

    def save(self, results_dir: str):
        Path(results_dir).mkdir(parents=True, exist_ok=True)
        with open(os.path.join(results_dir, "results.pkl"), "wb") as f:
            pickle.dump(self, f)
        with open(os.path.join(results_dir, "results.txt"), "w") as f:
            f.write(str(self))

    def __str__(self):
        tc = self.trial_config
        return (f"Trial Config Summary:\n"
                f"  Method: {tc.multi_agent_planner_class if tc else '?'}\n"
                f"  Num Agents: {tc.num_agents if tc else '?'}\n"
                f"  Instance: {tc.instance_name if tc else '?'}\n"
                f"Trial Results:\n"
                f"  success_status: {self.success_status}\n"
                f"  num_collisions_in_solution: {self.num_collisions_in_solution}\n"
                f"  data_adherence: {self.data_adherence}\n"
                f"  planning_time: {self.planning_time}\n"
                f"  jit_compile_time: {self.jit_compile_time}\n"
                f"  path_length_per_agent: {self.path_length_per_agent}\n"
                f"  mean_path_acceleration_per_agent: {self.mean_path_acceleration_per_agent}\n"
                f"  num_ct_expansions: {self.num_ct_expansions}\n")


def get_result_dir_from_time_str(time_str: str, root: str = RESULTS_ROOT) -> str:
    return os.path.abspath(os.path.join(root, f"{time_str}"))


def get_result_dir_from_trial_config(trial_config: MultiAgentPlanningSingleTrialConfig,
                                     time_str: Optional[str] = None,
                                     trial_number: int = 0,
                                     root: str = RESULTS_ROOT) -> str:
    """reference: experiments.py:258-274."""
    if time_str is None:
        raise ValueError("Time string must be provided.")
    return os.path.abspath(os.path.join(
        get_result_dir_from_time_str(time_str, root),
        f"instance_name___{trial_config.instance_name}",
        f"num_agents___{trial_config.num_agents}",
        f"planner___{trial_config.multi_agent_planner_class}",
        f"single_agent_planner___{trial_config.single_agent_planner_class}",
        str(trial_number)))


class _ForeignClass(ValueError):
    pass


class _PortUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in FOREIGN_PACKAGES:
            raise _ForeignClass(f"it pickles {module}.{name}, a class of another package")
        return super().find_class(module, name)


def load_trial_result(path: str) -> MultiAgentPlanningSingleTrialResult:
    """A results.pkl that the port wrote. One that names a class of the JAX
    package raises ValueError instead of importing that package."""
    with open(path, "rb") as f:
        try:
            return _PortUnpickler(f).load()
        except _ForeignClass as e:
            raise ValueError(f"{path} was not written by the port: {e}") from None


def check_results_root(root: str, time_str: Optional[str] = None) -> None:
    """Raise ValueError if `root` lies in the repository's committed
    `results/` tree, or if `<root>/<time_str>` holds a results.pkl that the
    port did not write: a sweep there would skip those trials as done and
    overwrite their aggregate."""
    rel = os.path.relpath(os.path.abspath(root), ROOT)
    if rel.split(os.sep)[0] == "results":
        raise ValueError(f"refusing to write into {root}: results/ holds the repository's "
                         f"committed sweeps (the port's default is {RESULTS_ROOT})")
    if time_str is None:
        return
    for dirpath, _, files in os.walk(get_result_dir_from_time_str(time_str, root)):
        if "results.pkl" in files:
            load_trial_result(os.path.join(dirpath, "results.pkl"))
