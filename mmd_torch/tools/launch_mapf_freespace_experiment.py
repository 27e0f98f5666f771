"""The free-space MAPF scaling sweep: 2-30 agents on the empty map.

    python -m mmd_torch.tools.launch_mapf_freespace_experiment --num_agents 2 6 10

The twin of `scripts/launch_mapf_freespace_experiment.py` (reference: 2-30
agents, runtime 240 s), with its flags and defaults, on the card unless
`--device cpu`. Exits 1 when a trial raised.
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
    ap.add_argument("--instance", default="EnvEmptyNoWait2DRobotPlanarDiskCircle")
    ap.add_argument("--num_agents", type=int, nargs="+", default=list(range(2, 31, 2)))
    ap.add_argument("--planners", nargs="+", default=["XECBS", "PP"])
    ap.add_argument("--trials", type=int, default=10)
    ap.add_argument("--runtime_limit", type=float, default=240.0)
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
    )
    return run_sweeps([cfg], args)


if __name__ == "__main__":
    sys.exit(main())
