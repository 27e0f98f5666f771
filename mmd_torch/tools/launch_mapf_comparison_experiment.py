"""The MAPF planner comparison: agents x planners x maps x trials.

    python -m mmd_torch.tools.launch_mapf_comparison_experiment

The twin of `scripts/launch_mapf_comparison_experiment.py` (reference
scale: agents {3, 6, 9, 12, 15, 20} x planners {XECBS, ECBS, PP, CBS,
XCBS} x 3 maps x 10 trials), with its flags and defaults, on the card
unless `--device cpu`. Exits 1 when a trial raised.
"""
from __future__ import annotations

import argparse
import sys

from mmd_torch.experiments.experiments import MultiAgentPlanningExperimentConfig
from mmd_torch.tools.launch_multi_agent_experiment import (
    add_registry_args,
    default_time_str,
    run_sweeps,
)


def parser() -> argparse.ArgumentParser:
    """The command's flags: the JAX script's, with its defaults, and the port's own."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--instances", nargs="+", default=[
        "EnvConveyor2DRobotPlanarDiskRandom",
        "EnvHighways2DRobotPlanarDiskRandom",
        "EnvDropRegion2DRobotPlanarDiskRandom",
    ])
    ap.add_argument("--num_agents", type=int, nargs="+", default=[3, 6, 9, 12, 15, 20])
    ap.add_argument("--planners", nargs="+", default=["XECBS", "ECBS", "PP", "CBS", "XCBS"])
    ap.add_argument("--trials", type=int, default=10)
    ap.add_argument("--runtime_limit", type=float, default=180.0)
    ap.add_argument("--time_str", default=None,
                    help="reuse <results_root>/<time_str> to resume an interrupted sweep "
                         "(done trials are skipped)")
    add_registry_args(ap)
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    time_str = default_time_str(args.time_str)
    cfgs = [MultiAgentPlanningExperimentConfig(
        time_str=time_str,
        instance_name=instance,
        num_agents_l=args.num_agents,
        multi_agent_planner_class_l=args.planners,
        num_trials_per_combination=args.trials,
        runtime_limit=args.runtime_limit,
    ) for instance in args.instances]
    return run_sweeps(cfgs, args)


if __name__ == "__main__":
    sys.exit(main())
