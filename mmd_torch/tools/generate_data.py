"""Generate a map's training dataset with the PyTorch port.

    python -m mmd_torch.tools.generate_data --env EnvConveyor2D --contexts 20

The twin of `scripts/generate_data.py`, with the same flags but `--cpu`:
the port runs on the card unless `--device cpu` is given. An empty map
(a name with "Empty") gets linear trajectories (`generate_linear_dataset`);
an obstacle map gets RRT + GPMP2 contexts (`generate_dataset`, the native
RRT where g++ builds it). The dataset is saved as `trajs-free.npz` and
`metadata.yaml` under `--out/<env>-RobotPlanarDisk`, which both packages'
loaders read. `--out` defaults to `build/data_trajectories` and may not
name one of the repository's `data_trajectories*` directories, which hold
its committed datasets.
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def committed_data_dir(out: str) -> bool:
    """True if `out` lies in one of the repository's `data_trajectories*`
    directories."""
    rel = os.path.relpath(os.path.abspath(out), ROOT)
    return rel.split(os.sep)[0].startswith("data_trajectories")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--env", required=True)
    ap.add_argument("--contexts", type=int, default=100)
    ap.add_argument("--trajs_per_context", type=int, default=20)
    ap.add_argument("--gpmp_iters", type=int, default=300)
    ap.add_argument("--horizon", type=int, default=64)
    ap.add_argument("--duration", type=float, default=None,
                    help="trajectory duration in s; default keeps the reference "
                         "dt = 5/64 (horizon * 5 / 64)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "data_trajectories"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if committed_data_dir(args.out):
        sys.exit(f"refusing to write into {args.out}: data_trajectories* directories hold "
                 "the repository's committed datasets")

    from mmd_torch.datagen.generate import generate_dataset
    from mmd_torch.datagen.native_rrt import native_available
    from mmd_torch.datagen.synthetic import generate_linear_dataset

    duration = args.duration if args.duration else args.horizon * 5.0 / 64.0
    if "Empty" in args.env:
        ds = generate_linear_dataset(args.env, n_contexts=args.contexts, horizon=args.horizon,
                                     seed=args.seed, device=args.device)
        how = "linear"
    else:
        ds = generate_dataset(args.env, n_contexts=args.contexts,
                              n_trajectories_per_context=args.trajs_per_context,
                              horizon=args.horizon, duration=duration,
                              gpmp_opt_iters=args.gpmp_iters, seed=args.seed,
                              device=args.device)
        how = f"{'native' if native_available() else 'python'} RRT + GPMP2"
    ds.save(args.out)
    print(f"saved {ds.n_trajs} trajectories for {args.env} to {args.out} ({how})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
