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
`--mesh_agents n` (n > 0; it must divide `--num_agents`) runs the trial
SPMD on n spawned ranks over an 'agent' mesh (`parallel.sharding`):
with NCCL on the card, one GPU a rank, or with `--device cpu` on gloo;
rank 0 alone writes the results and prints them. A card with fewer GPUs
than ranks raises, naming the backend and the GPU count. `--results_root`,
`--device`, `--models_dir` and `--data_dir` are the port's own flags.
"""
from __future__ import annotations

import argparse
import sys
import time

from mmd_torch.experiments.experiments import MultiAgentPlanningSingleTrialConfig
from mmd_torch.experiments.problems import get_planning_problem
import torch

from mmd_torch.experiments.trial import ModelRegistry, run_multi_agent_trial
from mmd_torch.parallel.sharding import make_mesh, spawn
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
                    help="shard a CBS-family team over an 'agent' mesh of this many ranks "
                         "(0 = one process); the size must divide --num_agents")
    add_registry_args(ap)
    return ap


def trial_rank(rank: int, device: torch.device, cfg, n_ranks: int, models_dir: str,
               data_dir: str, results_root: str):
    """One rank of a sharded trial: the trial on an 'agent' mesh of all
    n_ranks ranks; rank 0 saves it and returns its result."""
    mesh = make_mesh([n_ranks], axis_names=("agent",))
    registry = ModelRegistry(models_dir, data_dir, device=str(device))
    result = run_multi_agent_trial(cfg, registry=registry, results_root=results_root,
                                   save=rank == 0, mesh=mesh)
    return result if rank == 0 else None


def main(argv=None) -> int:
    args = parser().parse_args(argv)
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
    if args.mesh_agents:
        backend = "gloo" if torch.device(args.device).type == "cpu" else "nccl"
        result = spawn(trial_rank, args.mesh_agents, backend, args.device, cfg,
                       args.mesh_agents, args.models_dir, args.data_dir, args.results_root)[0]
    else:
        registry = ModelRegistry(args.models_dir, args.data_dir, device=args.device)
        result = run_multi_agent_trial(cfg, registry=registry, results_root=args.results_root)
    print(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
