"""Render the contents of a `data_trajectories/<model-id>/` dataset.

    python -m mmd_torch.tools.visualize_trajectories --env EnvConveyor2D \\
        [--data_dir data_trajectories] [--n 128] [--out build/dataset_renders/<mid>]

The twin of `scripts/visualize_trajectories.py` (reference:
scripts/generate_data/visualize_trajectories.py:24-86): print the
dataset's metadata, overlay a sample of its trajectories on the map
(trajectories.png), plot them in joint space (joint_space.png) and animate
a few (robot-traj.gif). `metadata.yaml` is read with the port's own reader
(`mmd_torch.io.flat_yaml`). The renders need matplotlib (ImportError
without it); they are drawn on the host. `--out` defaults to
`build/dataset_renders/<mid>`.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from mmd_torch.tools.generate_data import ROOT


def main(argv=None) -> int:
    from mmd_torch.datasets.trajectories import TrajectoryDataset, model_id
    from mmd_torch.io.flat_yaml import dumps, load_flat_yaml
    from mmd_torch.viz.visualizer import PlanningVisualizer, pyplot

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--env", required=True, help="e.g. EnvConveyor2D")
    ap.add_argument("--data_dir", default=os.path.join(ROOT, "data_trajectories"))
    ap.add_argument("--n", type=int, default=128, help="number of trajectories to overlay")
    ap.add_argument("--n_animate", type=int, default=8,
                    help="trajectories in the animation GIF (0 to skip)")
    ap.add_argument("--out", default=None,
                    help="output dir (default: build/dataset_renders/<mid>)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    plt = pyplot()
    mid = model_id(args.env)
    meta = load_flat_yaml(os.path.join(args.data_dir, mid, "metadata.yaml"))
    print("-------------- METADATA --------------")
    print(dumps(meta), end="")
    print("--------------------------------------")

    ds = TrajectoryDataset.load_trajectories(args.data_dir, mid, device="cpu")
    out = args.out or os.path.join(ROOT, "build", "dataset_renders", mid)
    os.makedirs(out, exist_ok=True)

    rng = np.random.default_rng(args.seed)
    trajs = ds.trajs.numpy()
    idx = rng.choice(len(trajs), size=min(args.n, len(trajs)), replace=False)
    sample = trajs[idx]

    viz = PlanningVisualizer(task=ds.task)
    # Workspace overlay (reference render_robot_trajectories call, :70-75).
    fig, ax = viz.render_robot_trajectories(trajs=sample, show_robot_in_image=False)
    ax.set_title(f"{mid}: {len(sample)}/{len(trajs)} free trajectories")
    fig.savefig(os.path.join(out, "trajectories.png"), dpi=150)
    plt.close(fig)
    # Joint-space panels (reference plot_joint_space_state_trajectories, :63-68).
    viz.plot_joint_space_trajectories(
        sample, q_min=ds.robot.q_min[:2], q_max=ds.robot.q_max[:2],
        output_fpath=os.path.join(out, "joint_space.png"))
    # An animated subset (reference animate_robot_trajectories, :78-86).
    if args.n_animate > 0:
        anim_trajs = sample[:args.n_animate]
        viz.animate_multi_robot_trajectories(
            trajs_l=list(anim_trajs),
            start_state_l=[t[0, :2] for t in anim_trajs],
            goal_state_l=[t[-1, :2] for t in anim_trajs],
            video_filepath=os.path.join(out, "robot-traj.gif"),
            anim_time=float(meta.get("duration", 5.0)))
    print(f"wrote renders to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
