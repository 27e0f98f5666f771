"""Train the flagship EnvEmptyNoWait2D diffusion model with the port.

    python -m mmd_torch.tools.train_flagship [--steps 20000] [--contexts 2000]

The twin of `scripts/train_flagship.py`, with its recipe (reference:
launch_train_01.py): UNet 32 x (1, 2, 4), 25 exponential diffusion steps,
batch 128, lr 3e-4, EMA 0.995, on the linear trajectories of `--contexts`
contexts (`generate_linear_dataset`, seed 7). The dataset is saved under
`--data_out` and the checkpoint under `--out/<env>-RobotPlanarDisk`,
readable by both packages. They default to `build/data_trajectories` and
`build/trained_models`, and may not name the repository's committed
`data_trajectories*` or `data_trained_models*` directories. Runs on the
card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import os
import sys

from mmd_torch.tools.generate_data import ROOT, committed_data_dir
from mmd_torch.train.train_diffusion import committed_models_dir


def main(argv=None) -> int:
    from mmd_torch.datagen.synthetic import generate_linear_dataset
    from mmd_torch.datasets.trajectories import model_id
    from mmd_torch.train.trainer import TrainConfig, train

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--env", default="EnvEmptyNoWait2D")
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--contexts", type=int, default=2000)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "trained_models"))
    ap.add_argument("--data_out", default=os.path.join(ROOT, "build", "data_trajectories"))
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--log_every", type=int, default=1000)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if committed_models_dir(args.out) or committed_data_dir(args.data_out):
        sys.exit(f"refusing to write into {args.out} or {args.data_out}: they hold the "
                 "repository's committed models and datasets")

    ds = generate_linear_dataset(args.env, n_contexts=args.contexts, seed=7, device=args.device)
    print(f"dataset: {ds.n_trajs} trajectories for {args.env}")
    ds.save(args.data_out)
    cfg = TrainConfig(batch_size=128, n_diffusion_steps=25, lr=args.lr)
    model_dir = os.path.join(args.out, model_id(args.env))
    train(ds, cfg, num_train_steps=args.steps, unet_dim=32, dim_mults=(1, 2, 4),
          model_dir=model_dir, log_every=args.log_every, steps_til_checkpoint=None)
    print(f"saved checkpoint to {model_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
