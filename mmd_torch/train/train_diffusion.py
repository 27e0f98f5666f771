"""Train a diffusion model for one environment on the card (CLI).

    python -m mmd_torch.train.train_diffusion --env EnvEmptyNoWait2D --out build/trained_models

Twin of `scripts/train_diffusion.py` (reference: scripts/train_diffusion/
train.py, launch_train_01.py): UNet dim 32 x (1, 2, 4), 25 exponential
steps, batch 128, lr 3e-4, EMA 0.995, validation every 5000 steps. It
reads `--data_dir/<env>-RobotPlanarDisk` and writes the checkpoint to
`--out/<env>-RobotPlanarDisk`. `--out` defaults to `build/trained_models`
and may not name a `data_trained_models*` directory, which hold the
repository's committed checkpoints. It runs on `cuda` unless
`--device cpu` is given.
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def committed_models_dir(out: str) -> bool:
    """True if `out` lies in a `data_trained_models*` directory."""
    parts = os.path.abspath(out).split(os.sep)
    return any(p.startswith("data_trained_models") for p in parts)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--env", required=True)
    ap.add_argument("--steps", type=int, default=50000)
    ap.add_argument("--batch_size", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--n_diffusion_steps", type=int, default=25)
    ap.add_argument("--unet_dim", type=int, default=32)
    ap.add_argument("--data_dir", default=os.path.join(ROOT, "data_trajectories"))
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "trained_models"))
    ap.add_argument("--validate_every", type=int, default=5000)
    ap.add_argument("--summary_every", type=int, default=0)
    ap.add_argument("--checkpoint_every", type=int, default=0)
    ap.add_argument("--bf16", action="store_true", help="bfloat16-compute train step")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if committed_models_dir(args.out):
        sys.exit(f"refusing to write into {args.out}: data_trained_models* directories hold "
                 "the repository's committed checkpoints")

    from mmd_torch.datasets.trajectories import TrajectoryDataset, model_id
    from mmd_torch.train.trainer import TrainConfig, train

    mid = model_id(args.env)
    ds = TrajectoryDataset.load_trajectories(args.data_dir, mid, device=args.device)
    print(f"dataset {mid}: {ds.n_trajs} trajectories on {args.device}")
    cfg = TrainConfig(batch_size=args.batch_size, lr=args.lr,
                      n_diffusion_steps=args.n_diffusion_steps, bf16=args.bf16)
    train(ds, cfg, num_train_steps=args.steps, unet_dim=args.unet_dim,
          model_dir=os.path.join(args.out, mid), log_every=1000,
          validate_every=args.validate_every or None,
          summary_every=args.summary_every or None,
          steps_til_checkpoint=args.checkpoint_every or None)
    print(f"saved to {os.path.join(args.out, mid)}")


if __name__ == "__main__":
    main()
