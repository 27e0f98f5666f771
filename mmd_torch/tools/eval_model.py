"""Sampling quality of a trained checkpoint over random tasks, on the card.

    python -m mmd_torch.tools.eval_model --env EnvConveyor2D --n_tasks 50

The twin of `scripts/eval_model.py`: the same flags and the same row. For
each of n_tasks tasks, a collision-free start and goal are drawn by the
task's rejection sampler from one generator seeded `--seed`, and an MPD
planner seeded `seed * 1000 + i` plans once. The row holds the mean
fraction of free samples, the success rate (a free sample exists), the
map's data adherence of the best free trajectory and the mean plan
seconds without the first task's (its warm-up). `--n_samples` sets the
batch (the JAX script parses it and keeps 64). `--out_yaml` writes the
row list, with any earlier row of the same model replaced, to that path
alone, as `yaml.safe_dump` writes it. `--render_dir` writes each task's
free trajectories (task_<i>.png) and, for the first task, the SDF and its
gradient field (env_sdf.png, env_grad_sdf.png; the fields through the
lookup, the kernel on the card), the joint-space panels (joint_space.png)
and the denoising chain (opt_iters.gif), as scripts/eval_model.py:78-100
does; it needs matplotlib, and raises ImportError before planning without
it. Runs on the card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from mmd_torch.planners.single_agent.mpd import MPD

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def model_name(mid: str, bf16: bool, sampler: str, ddim_substeps: int,
               tag: Optional[str] = None) -> str:
    """The row's model name: `mid+tag`, or `mid` with '+bf16' and
    '+ddim[substeps]' as they apply (eval_model.py:103-117)."""
    if tag:
        return mid + "+" + tag
    suffix = (["bf16"] if bf16 else []) + (
        [sampler + (str(ddim_substeps) if ddim_substeps else "")] if sampler != "ddpm" else [])
    return mid + "+" + "+".join(suffix) if suffix else mid


def evaluate(env: str, n_tasks: int = 50, n_samples: int = 64, seed: int = 0,
             models_dir: str = os.path.join(ROOT, "data_trained_models"),
             data_dir: str = os.path.join(ROOT, "data_trajectories"), bf16: bool = False,
             sampler: str = "ddpm", ddim_substeps: int = 0, tag: Optional[str] = None,
             variant: Optional[str] = None, device="cuda", registry=None,
             run_plan: Callable[[int, MPD], object] = lambda i, planner: planner(),
             render_dir: Optional[str] = None) -> Dict:
    """The evaluation row of `env`'s checkpoint (eval_model.py:53-123).
    `run_plan(i, planner)` plans task i (by default `planner()`); a caller
    may wrap it to count or replay. With `render_dir`, the renders of the
    module docstring go there."""
    from mmd_torch.datasets.trajectories import model_id
    from mmd_torch.experiments.trial import ModelRegistry

    registry = registry or ModelRegistry(models_dir, data_dir, device=device)
    mid = model_id(env)
    model, schedule, dataset = registry.get(mid)
    task = dataset.task
    generator = torch.Generator(device=task.device).manual_seed(seed)
    stats: Dict[str, List[float]] = {"fraction_free": [], "success": [], "adherence": [],
                                     "plan_time": []}
    for i in range(n_tasks):
        start, goal = task.random_coll_free_q(generator, n_samples=2)
        planner = MPD(model, schedule, dataset, start, goal, seed=seed * 1000 + i, bf16=bf16,
                      sampler=sampler, ddim_substeps=ddim_substeps)
        if n_samples != planner.cfg.n_samples:
            planner.cfg = dataclasses.replace(planner.cfg, n_samples=n_samples)
        out = run_plan(i, planner)
        stats["fraction_free"].append(out.fraction_free_trajs)
        stats["success"].append(out.success_free_trajs)
        stats["plan_time"].append(out.t_total)
        if out.traj_final_free_best is not None:
            best = out.traj_final_free_best.cpu().numpy()
            stats["adherence"].append(task.env.compute_traj_data_adherence(best[:, :2]))
        if render_dir and out.trajs_final_free is not None:
            render_task(render_dir, i, task, planner, out, start, goal)
    row = {
        "model": model_name(mid, bf16, sampler, ddim_substeps, tag), "n_tasks": n_tasks,
        "fraction_free": float(np.mean(stats["fraction_free"])),
        "success_rate": float(np.mean(stats["success"])),
        "adherence": float(np.mean(stats["adherence"])) if stats["adherence"] else None,
        "plan_time": float(np.mean(stats["plan_time"][1:] or stats["plan_time"])),
    }
    if variant:
        row["variant"] = variant
    return row


def merge_row(path: str, row: Dict):
    """`row` into the row list at `path` (created if missing), in place of
    any earlier row of its model (eval_model.py:131-138)."""
    from mmd_torch.io.flat_yaml import load_rows, save_rows

    rows = load_rows(path) if os.path.exists(path) else []
    save_rows(path, [r for r in rows if r.get("model") != row["model"]] + [row])


def render_task(render_dir: str, i: int, task, planner: MPD, out, start, goal) -> None:
    """Task i's renders (eval_model.py:78-100): its free trajectories, and
    for task 0 the SDF, its gradient field, the joint-space panels and the
    denoising chain."""
    from mmd_torch.viz.visualizer import PlanningVisualizer, pyplot

    plt = pyplot()
    os.makedirs(render_dir, exist_ok=True)
    viz = PlanningVisualizer(task=task)
    fig, _ = viz.render_robot_trajectories(trajs=out.trajs_final_free, start_state=start,
                                           goal_state=goal)
    fig.savefig(os.path.join(render_dir, f"task_{i}.png"), dpi=90)
    plt.close(fig)
    if i != 0:
        return
    for name, render in (("env_sdf.png", viz.render_env_sdf),
                         ("env_grad_sdf.png", viz.render_env_grad_sdf)):
        fig, _ = render()
        fig.savefig(os.path.join(render_dir, name), dpi=120)
        plt.close(fig)
    free_mask = np.zeros(len(out.trajs_final), bool)
    free_mask[np.asarray(out.trajs_final_free_idxs)] = True
    viz.plot_joint_space_trajectories(
        out.trajs_final, free_mask=free_mask, pos_start=start, pos_goal=goal,
        q_min=planner.robot.q_min, q_max=planner.robot.q_max,
        output_fpath=os.path.join(render_dir, "joint_space.png"))
    viz.animate_opt_iters(out.trajs_iters, idx_best=out.idx_best_traj, start_state=start,
                          goal_state=goal,
                          video_filepath=os.path.join(render_dir, "opt_iters.gif"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--env", required=True)
    ap.add_argument("--n_tasks", type=int, default=50)
    ap.add_argument("--n_samples", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--render_dir", default=None)
    ap.add_argument("--out_yaml", default=None,
                    help="merge the row into this yaml file's row list")
    ap.add_argument("--models_dir", default=os.path.join(ROOT, "data_trained_models"))
    ap.add_argument("--data_dir", default=os.path.join(ROOT, "data_trajectories"))
    ap.add_argument("--bf16", action="store_true", help="the UNet's forward in bfloat16")
    ap.add_argument("--sampler", default="ddpm", choices=["ddpm", "ddim"],
                    help="'ddim' = n_steps//5-substep fast mode "
                         "(reference diffusion_model_base.py:214-291)")
    ap.add_argument("--ddim_substeps", type=int, default=0,
                    help="the DDIM substep count (0 = n_steps//5)")
    ap.add_argument("--tag", default=None, help="the row's model-name suffix (e.g. 'vd+bf16')")
    ap.add_argument("--variant", default=None, help="a provenance note stored in the row")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.render_dir:
        from mmd_torch.viz.visualizer import pyplot

        pyplot()  # ImportError without matplotlib, before any plan
    row = evaluate(args.env, args.n_tasks, args.n_samples, args.seed, args.models_dir,
                   args.data_dir, args.bf16, args.sampler, args.ddim_substeps, args.tag,
                   args.variant, args.device, render_dir=args.render_dir)
    print(f"model {row['model']} over {args.n_tasks} tasks:")
    print(f"  fraction_free: {row['fraction_free']:.3f}")
    print(f"  success_rate:  {row['success_rate']:.3f}")
    if row["adherence"] is not None:
        print(f"  adherence:     {row['adherence']:.3f}")
    print(f"  plan_time:     {row['plan_time']:.3f}s")
    if args.out_yaml:
        merge_row(args.out_yaml, row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
