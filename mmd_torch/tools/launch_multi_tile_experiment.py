"""Multi-tile (2x2 / 3x3 grid) sweeps with staggered start times.

    python -m mmd_torch.tools.launch_multi_tile_experiment \\
        --instances EnvTestTwoByTwoRobotPlanarDiskRandom --num_agents 2 4 6 --trials 10

The twin of `scripts/launch_multi_tile_experiment.py` (reference: 2x2 and
3x3 tile grids, stagger dt 10, runtime 240 s): `MPDEnsemble` agents over
3-tile skeletons, with its flags and defaults, on the card unless
`--device cpu`. `--frontier_width` reaches every CBS team's search.
Exits 1 when a trial raised.
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
        "EnvTestTwoByTwoRobotPlanarDiskRandom",
        "EnvTestThreeByThreeRobotPlanarDiskRandom",
    ])
    ap.add_argument("--num_agents", type=int, nargs="+", default=[2, 4, 6])
    ap.add_argument("--planners", nargs="+", default=["XECBS", "PP"])
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--runtime_limit", type=float, default=240.0)
    ap.add_argument("--stagger_dt", type=int, default=10)
    ap.add_argument("--frontier_width", type=int, default=1,
                    help="CBS: the greedy chains of this many top open nodes a round "
                         "(a power of two; 1 = the reference's expansion order)")
    ap.add_argument("--bf16", action="store_true",
                    help="bfloat16 UNet inference for every tile model")
    ap.add_argument("--time_str", default=None,
                    help="reuse <results_root>/<time_str> to resume (done trials skip)")
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
        stagger_start_time_dt=args.stagger_dt,
        single_agent_planner_class="MPDEnsemble",
        frontier_width=args.frontier_width,
        bf16=args.bf16,
    ) for instance in args.instances]
    return run_sweeps(cfgs, args)


if __name__ == "__main__":
    sys.exit(main())
