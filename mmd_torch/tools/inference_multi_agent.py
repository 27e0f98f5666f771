"""One multi-agent planning trial from the command line.

    python -m mmd_torch.tools.inference_multi_agent \\
        --instance EnvEmptyNoWait2DRobotPlanarDiskCircle --num_agents 6 --planner XECBS

The twin of `scripts/inference_multi_agent.py` (reference:
scripts/inference/inference_multi_agent.py): pick an instance, an agent
count and a planner, run one trial on the card (`--device cpu` for the
CPU), save its results.txt and results.pkl under
`<results_root>/<time>/` (`build/results` by default) and print them;
a successful trial writes mmd_single_trial.png there too, and with
`--render_animation` mmd_single_trial.gif (these need matplotlib: without
it the frame is skipped and `--render_animation` raises ImportError).
`--mesh_agents` other than 0 raises `ValueError`: sharding a team is not
ported (ROADMAP.md Queue 1, "sharding"). `--results_root`, `--device`,
`--models_dir` and `--data_dir` are the port's own flags.
"""
from __future__ import annotations

import argparse
import sys
import time

from mmd_torch.experiments.experiments import MultiAgentPlanningSingleTrialConfig
from mmd_torch.experiments.problems import get_planning_problem
from mmd_torch.experiments.trial import SHARDING_NOT_PORTED, ModelRegistry, run_multi_agent_trial
from mmd_torch.tools.launch_multi_agent_experiment import add_registry_args


def parser() -> argparse.ArgumentParser:
    """The command's flags: the JAX script's, with its defaults, and the port's own."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--instance", default="EnvEmptyNoWait2DRobotPlanarDiskCircle")
    ap.add_argument("--num_agents", type=int, default=6)
    ap.add_argument("--planner", default="XECBS", choices=["CBS", "ECBS", "XCBS", "XECBS", "PP"])
    ap.add_argument("--runtime_limit", type=float, default=180.0)
    ap.add_argument("--stagger_dt", type=int, default=0)
    ap.add_argument("--render_animation", action="store_true",
                    help="write a successful trial's GIF (needs matplotlib)")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--mesh_agents", type=int, default=0,
                    help="not ported: any value but 0 raises")
    add_registry_args(ap)
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.mesh_agents:
        raise ValueError(f"--mesh_agents {args.mesh_agents}: {SHARDING_NOT_PORTED}")
    cfg = MultiAgentPlanningSingleTrialConfig(
        time_str=time.strftime("%y-%m-%d--%H-%M-%S"),
        num_agents=args.num_agents,
        multi_agent_planner_class=args.planner,
        runtime_limit=args.runtime_limit,
        stagger_start_time_dt=args.stagger_dt,
        instance_name=args.instance,
        render_animation=args.render_animation,
    )
    (cfg.start_state_pos_l, cfg.goal_state_pos_l,
     cfg.global_model_ids, cfg.agent_skeleton_l) = get_planning_problem(
        args.instance, args.num_agents, seed=args.seed)
    registry = ModelRegistry(args.models_dir, args.data_dir, device=args.device)
    result = run_multi_agent_trial(cfg, registry=registry, results_root=args.results_root)
    print(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
