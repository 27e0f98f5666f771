"""Reading an experiment's results tree back and aggregating it.

Twin of `mmd_tpu/experiments/experiment_utils.py` (reference:
mmd/common/experiments/experiment_utils.py:45-196): the per-trial results
of each (agents, planner) cell, and the analyzed dict with the JAX
package's keys and normalizations: rates and `avg_collisions_all_trials`
over all trials, the other averages over successful trials only. The
dict holds plain dicts, ints and floats, so `scripts/results_to_markdown.py`
renders the port's `analyzed_results__<instance>.pkl` as it renders JAX's.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict

from mmd_torch.experiments.experiments import (
    RESULTS_ROOT,
    MultiAgentPlanningExperimentConfig,
    MultiAgentPlanningSingleTrialConfig,
    get_result_dir_from_time_str,
    get_result_dir_from_trial_config,
    load_trial_result,
)
from mmd_torch.experiments.status import TrialSuccessStatus


def read_aggregated_trial_results_for_experiment(
        cfg: MultiAgentPlanningExperimentConfig, root: str = RESULTS_ROOT) -> Dict:
    """{num_agents: {planner_class: [trial results]}}, the trials that
    saved a results.pkl (reference :45-81)."""
    out = {}
    for num_agents in cfg.num_agents_l:
        out[num_agents] = {}
        for planner_cls in cfg.multi_agent_planner_class_l:
            out[num_agents][planner_cls] = []
            for trial_number in range(cfg.num_trials_per_combination):
                tc = MultiAgentPlanningSingleTrialConfig(
                    instance_name=cfg.instance_name, num_agents=num_agents,
                    multi_agent_planner_class=planner_cls,
                    single_agent_planner_class=cfg.single_agent_planner_class)
                d = get_result_dir_from_trial_config(tc, time_str=cfg.time_str,
                                                     trial_number=trial_number, root=root)
                fpath = os.path.join(d, "results.pkl")
                if os.path.exists(fpath):
                    out[num_agents][planner_cls].append(load_trial_result(fpath))
    return out


def analyze_trials(trials) -> Dict[str, float]:
    """One cell's analyzed dict (reference :84-196)."""
    d = {
        "num_trials": len(trials),
        "success_rate": 0.0,
        "fail_rate_runtime_limit": 0.0,
        "fail_rate_no_solution": 0.0,
        "fail_rate_collision_agents": 0.0,
        "avg_num_collisions_in_solution": 0.0,
        "avg_collisions_all_trials": 0.0,
        "avg_ct_expansions": 0.0,
        "avg_data_adherence": 0.0,
        "avg_planning_time": 0.0,
        "avg_warm_planning_time": 0.0,
        "avg_path_length_per_agent": 0.0,
        "avg_mean_path_acceleration_per_agent": 0.0,
    }
    n_success = sum(1 for t in trials if t.success_status == TrialSuccessStatus.SUCCESS)
    n = len(trials)
    for t in trials:
        d["success_rate"] += bool(t.success_status) / n
        d["fail_rate_runtime_limit"] += (
            t.success_status == TrialSuccessStatus.FAIL_RUNTIME_LIMIT) / n
        d["fail_rate_no_solution"] += (
            t.success_status == TrialSuccessStatus.FAIL_NO_SOLUTION) / n
        d["fail_rate_collision_agents"] += (
            t.success_status == TrialSuccessStatus.FAIL_COLLISION_AGENTS) / n
        # Residual collisions over all trials, the failed ones included.
        d["avg_collisions_all_trials"] += t.num_collisions_in_solution / n
        if t.success_status == TrialSuccessStatus.SUCCESS:
            d["avg_num_collisions_in_solution"] += t.num_collisions_in_solution / n_success
            d["avg_ct_expansions"] += t.num_ct_expansions / n_success
            d["avg_data_adherence"] += t.data_adherence / n_success
            d["avg_planning_time"] += t.planning_time / n_success
            d["avg_warm_planning_time"] += max(
                0.0, t.planning_time - t.jit_compile_time) / n_success
            d["avg_path_length_per_agent"] += t.path_length_per_agent / n_success
            d["avg_mean_path_acceleration_per_agent"] += \
                t.mean_path_acceleration_per_agent / n_success
    return d


def combine_and_save_results_for_experiment(
        cfg: MultiAgentPlanningExperimentConfig, root: str = RESULTS_ROOT) -> Dict:
    """The analyzed dict {num_agents: {planner_class: metrics}}, saved as
    analyzed_results__<instance>.pkl and .txt in the experiment's
    directory (reference :84-196)."""
    agg = read_aggregated_trial_results_for_experiment(cfg, root)
    analyzed = {num_agents: {planner_cls: analyze_trials(agg[num_agents][planner_cls])
                             for planner_cls in cfg.multi_agent_planner_class_l}
                for num_agents in cfg.num_agents_l}
    out_dir = get_result_dir_from_time_str(cfg.time_str, root)
    os.makedirs(out_dir, exist_ok=True)
    # One aggregate a instance, so that sweeps sharing a time_str keep theirs.
    stem = (f"analyzed_results__{cfg.instance_name}" if cfg.instance_name
            else "analyzed_results")
    with open(os.path.join(out_dir, f"{stem}.pkl"), "wb") as f:
        pickle.dump(analyzed, f)
    with open(os.path.join(out_dir, f"{stem}.txt"), "w") as f:
        for num_agents, per_planner in analyzed.items():
            for planner_cls, metrics in per_planner.items():
                f.write(f"num_agents={num_agents} planner={planner_cls}: {metrics}\n")
    return analyzed

