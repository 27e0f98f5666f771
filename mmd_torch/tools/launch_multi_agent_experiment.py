"""A sweep of agents x planners x trials on one instance, with its aggregate.

    python -m mmd_torch.tools.launch_multi_agent_experiment \\
        --instance EnvEmptyNoWait2DRobotPlanarDiskCircle --num_agents 2 6 --planners XECBS PP

The twin of `scripts/launch_multi_agent_experiment.py` (reference:
launch_multi_agent_experiment.py:31-58), with its flags and defaults. The
trials run one after another on the card (`--device cpu` for the CPU) and
save under `<results_root>/<time_str>/`; a trial whose results.pkl exists
is skipped, so `--time_str` of an interrupted sweep resumes it. A trial
that raises is appended to `<results_root>/error_<time_str>.txt` (JAX's
line, then the traceback) and the sweep goes on; the command then exits 1. `--frontier_width`,
`--repair_period` and `--greedy_iters` reach every CBS team's search
(`CBS`, JAX trial.py:201-209), not PP's.
`--results_root` and `--device` are the port's own flags; `--results_root`
defaults to `build/results` of the repository and may not name its
committed `results/` tree, nor hold a `<time_str>` whose results.pkl
another package wrote.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
import traceback
from typing import Dict, List, Optional, Tuple

from mmd_torch.experiments.experiment_utils import combine_and_save_results_for_experiment
from mmd_torch.experiments.experiments import (
    RESULTS_ROOT,
    MultiAgentPlanningExperimentConfig,
    check_results_root,
    get_result_dir_from_trial_config,
)
from mmd_torch.experiments.trial import ModelRegistry, check_renders, run_multi_agent_trial

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_multi_agent_experiment(cfg: MultiAgentPlanningExperimentConfig,
                               results_root: str = RESULTS_ROOT, registry=None,
                               diffusion_cfg=None) -> Tuple[Dict, int]:
    """Run the experiment's trials in order and aggregate them
    (reference: launch_multi_agent_experiment.py:31-58): (the analyzed
    dict, the number of trials that raised in this call). Trials whose
    results.pkl exists are skipped; a trial that raises is written to
    error_<time_str>.txt and the sweep goes on. `diffusion_cfg` (the
    sampler's schedule, the default's when None) is passed to every
    trial. A render without matplotlib (`check_renders`) and a results
    root that `check_results_root` refuses raise before any trial."""
    check_renders(cfg)
    check_results_root(results_root, cfg.time_str)
    registry = registry or ModelRegistry()  # one for all trials: each model loads once
    cfg.save(results_root)
    n_failed = 0
    for trial_cfg in cfg.get_single_trial_configs_from_experiment_config():
        done_marker = os.path.join(
            get_result_dir_from_trial_config(trial_cfg, cfg.time_str, trial_cfg.trial_number,
                                             root=results_root), "results.pkl")
        if os.path.exists(done_marker):
            continue
        try:
            result = run_multi_agent_trial(trial_cfg, registry=registry,
                                           results_root=results_root,
                                           diffusion_cfg=diffusion_cfg)
            print(f"[{trial_cfg.multi_agent_planner_class} n={trial_cfg.num_agents} "
                  f"trial={trial_cfg.trial_number}] {result.success_status} in "
                  f"{result.planning_time:.1f}s", flush=True)
        except Exception as e:  # noqa: BLE001 - the sweep goes on past a failed trial
            n_failed += 1
            with open(os.path.join(results_root, f"error_{cfg.time_str}.txt"), "a") as f:
                f.write(f"{trial_cfg}: {e!r}\n{traceback.format_exc()}")
            print(f"trial failed: {e!r}", flush=True)
    return combine_and_save_results_for_experiment(cfg, results_root), n_failed


def add_registry_args(ap: argparse.ArgumentParser) -> None:
    """--models_dir and --data_dir (the JAX scripts'), --results_root and
    --device (the port's)."""
    ap.add_argument("--models_dir", default=os.path.join(ROOT, "data_trained_models"),
                    help="alternate checkpoint root (e.g. the H=128 long-horizon models "
                         "in data_trained_models_h128)")
    ap.add_argument("--data_dir", default=os.path.join(ROOT, "data_trajectories"))
    ap.add_argument("--results_root", default=RESULTS_ROOT,
                    help="where sweeps are saved; not the committed results/ tree")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def run_sweeps(cfgs: List[MultiAgentPlanningExperimentConfig], args) -> int:
    """Run each experiment on one registry and print its cells; 1 if any
    trial raised, else 0."""
    registry = ModelRegistry(args.models_dir, args.data_dir, device=args.device)
    n_failed = 0
    for cfg in cfgs:
        analyzed, failed = run_multi_agent_experiment(cfg, args.results_root, registry)
        n_failed += failed
        for n, per_planner in analyzed.items():
            for planner, metrics in per_planner.items():
                print(f"{cfg.instance_name} n={n} {planner}: "
                      f"success={metrics['success_rate']:.2f} "
                      f"time={metrics['avg_planning_time']:.1f}s")
    if n_failed:
        print(f"{n_failed} trials raised; see {args.results_root}/error_*.txt", file=sys.stderr)
    return 1 if n_failed else 0


def default_time_str(time_str: Optional[str]) -> str:
    return time_str or time.strftime("%y-%m-%d--%H-%M-%S")


def parser() -> argparse.ArgumentParser:
    """The command's flags: the JAX script's, with its defaults, and the port's own."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--instance", default="EnvEmptyNoWait2DRobotPlanarDiskCircle")
    ap.add_argument("--num_agents", type=int, nargs="+", default=[3, 6, 9])
    ap.add_argument("--planners", nargs="+", default=["XECBS", "ECBS", "PP", "CBS", "XCBS"])
    ap.add_argument("--trials", type=int, default=10)
    ap.add_argument("--runtime_limit", type=float, default=180.0)
    ap.add_argument("--stagger_dt", type=int, default=0)
    ap.add_argument("--frontier_width", type=int, default=1,
                    help="CBS: the greedy chains of this many top open nodes a round "
                         "(a power of two; 1 = the reference's expansion order)")
    ap.add_argument("--bf16", action="store_true",
                    help="bfloat16 UNet inference (guide, posterior and selection stay f32)")
    ap.add_argument("--repair_period", type=int, default=0,
                    help="CBS: a Jacobi repair round on the popped node every N expansions "
                         "(0 = off)")
    ap.add_argument("--greedy_iters", type=int, default=0,
                    help="CBS: steps of a speculative greedy chain (0 = CBS.GREEDY_ITERS)")
    ap.add_argument("--time_str", default=None,
                    help="reuse <results_root>/<time_str> to resume (done trials skip)")
    add_registry_args(ap)
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    cfg = MultiAgentPlanningExperimentConfig(
        time_str=default_time_str(args.time_str),
        instance_name=args.instance,
        num_agents_l=args.num_agents,
        multi_agent_planner_class_l=args.planners,
        num_trials_per_combination=args.trials,
        runtime_limit=args.runtime_limit,
        stagger_start_time_dt=args.stagger_dt,
        frontier_width=args.frontier_width,
        bf16=args.bf16,
        repair_period=args.repair_period,
        greedy_iters=args.greedy_iters,
    )
    return run_sweeps([cfg], args)


if __name__ == "__main__":
    sys.exit(main())
