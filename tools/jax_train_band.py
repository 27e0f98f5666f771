"""The JAX package's own training losses on the port's chip-run recipe.

    JAX_PLATFORMS=cpu python tools/jax_train_band.py --seeds 0 1 2

Trains `mmd_tpu.train.trainer.train` from scratch on
`data_trajectories/EnvEmptyNoWait2D-RobotPlanarDisk` with the reference
recipe (UNet 32 x (1, 2, 4), 25 exponential steps, batch 128, Adam 3e-4,
clip 1.0, EMA 0.995) for 2000 steps, logging every 1000 and validating
every 1000 (so 500 trajectories are held out), once per seed. It writes
no checkpoint. It prints one JSON line per seed with the logged losses at
steps 1000 and 2000 and the validation losses. `chip_smoke.py`'s train
phase holds the port's step-2000 loss to the band these losses set.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--env", default="EnvEmptyNoWait2D")
    ap.add_argument("--steps", type=int, default=2000)
    args = ap.parse_args()

    from mmd_tpu.datasets.trajectories import TrajectoryDataset, model_id
    from mmd_tpu.train.trainer import TrainConfig, train

    ds = TrajectoryDataset.load(os.path.join(ROOT, "data_trajectories"), model_id(args.env))
    for seed in args.seeds:
        log = []
        t0 = time.perf_counter()
        _, _, _, losses = train(ds, TrainConfig(), num_train_steps=args.steps, seed=seed,
                                log_every=1000, validate_every=1000, log_fn=log.append)
        print(json.dumps({"seed": seed, "env": args.env, "losses": losses,
                          "log": log, "wall_s": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
