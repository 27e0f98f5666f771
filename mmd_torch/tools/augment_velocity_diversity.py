"""Velocity-diversity augmentation: time-reparameterized trajectory variants.

    python -m mmd_torch.tools.augment_velocity_diversity --env EnvConveyor2D \\
        --data_dir data_trajectories --out_dir build/data_trajectories_vd --variants 3

The twin of `scripts/augment_velocity_diversity.py`, which built the
`data_trajectories_vd` data the vd checkpoints were trained on: each
trajectory gets up to `--variants` copies that hold still at the start
("wait-then-sprint") or at the goal ("sprint-then-park") and compress the
motion into the remaining steps. A variant with total hold w is sped up by
(H-1)/(H-1-w), and its hold is capped per trajectory so that the peak
speed stays within `--speed_cap`. Every map is static, so a monotone
time-warp of a free path stays free. Velocities are central differences at
dt = duration / (H-1) with rest endpoints, as the stored datasets hold
them. The work is numpy on the host, with the JAX script's arithmetic and
draws (`default_rng(--seed)`); the result is saved as `trajs-free.npz` and
`metadata.yaml` under `--out_dir/<env>-RobotPlanarDisk`, which both
packages read. `--out_dir` defaults to `build/data_trajectories_vd` and may
not name one of the repository's committed `data_trajectories*`
directories.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from mmd_torch.tools.generate_data import ROOT, committed_data_dir


def central_diff_velocities(pos: np.ndarray, dt: float) -> np.ndarray:
    """(..., H, q) positions -> central-difference velocities, rest endpoints."""
    vel = np.zeros_like(pos)
    vel[..., 1:-1, :] = (pos[..., 2:, :] - pos[..., :-2, :]) / (2.0 * dt)
    return vel


def time_reparam(pos: np.ndarray, w_start: int, w_goal: int) -> np.ndarray:
    """Hold at the start for w_start steps and at the goal for w_goal
    steps, the original motion linearly time-compressed into the rest."""
    H = pos.shape[0]
    t = np.arange(H, dtype=np.float64)
    u = (t - w_start) * (H - 1) / (H - 1 - w_start - w_goal)
    u = np.clip(u, 0.0, H - 1)
    i0 = np.floor(u).astype(np.int64)
    i1 = np.minimum(i0 + 1, H - 1)
    a = (u - i0)[:, None]
    return (1.0 - a) * pos[i0] + a * pos[i1]


def augment(trajs: np.ndarray, duration: float, variants: int, speed_cap: float,
            holds: tuple, seed: int) -> np.ndarray:
    """The originals and up to `variants` reparameterized copies of each."""
    N, H, D = trajs.shape
    q = D // 2
    dt = duration / (H - 1)
    pos = trajs[..., :q].astype(np.float64)
    peak = np.max(np.linalg.norm(central_diff_velocities(pos, dt), axis=-1), axis=1)  # (N,)
    rng = np.random.default_rng(seed)
    out = [trajs]
    n_skipped = 0
    for v in range(variants):
        w = rng.choice(holds, size=N)
        # Cap each trajectory's hold so that its compressed peak speed stays
        # within speed_cap.
        w_max = np.floor((H - 1) * np.maximum(0.0, 1.0 - peak / speed_cap)).astype(np.int64)
        w_eff = np.minimum(w, w_max)
        n_skipped += int(np.sum(w_eff == 0))
        # The hold all at the start, all at the goal, or split at random:
        # one mode a variant pass.
        frac = {0: 1.0, 1: 0.0}.get(v % 3, rng.uniform(size=N))
        ws = np.round(w_eff * frac).astype(np.int64)
        wg = w_eff - ws
        new_pos = np.stack([time_reparam(pos[i], int(ws[i]), int(wg[i])) for i in range(N)])
        out.append(np.concatenate([new_pos, central_diff_velocities(new_pos, dt)],
                                  axis=-1).astype(trajs.dtype))
    aug = np.concatenate(out, axis=0)
    print(f"augmented {N} -> {aug.shape[0]} trajs "
          f"({n_skipped} variant slots fell back to w=0: no speed headroom)")
    return aug


def main(argv=None) -> int:
    from mmd_torch.datasets.trajectories import TrajectoryDataset, model_id

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--env", required=True)
    ap.add_argument("--data_dir", default=os.path.join(ROOT, "data_trajectories"))
    ap.add_argument("--out_dir", default=os.path.join(ROOT, "build", "data_trajectories_vd"))
    ap.add_argument("--variants", type=int, default=3)
    ap.add_argument("--speed_cap", type=float, default=2.8,
                    help="max allowed peak speed after compression "
                         "(dataset peak is ~2.7 on Conveyor)")
    ap.add_argument("--holds", type=int, nargs="+", default=[8, 16, 24],
                    help="total hold-step choices per variant")
    ap.add_argument("--duration", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if committed_data_dir(args.out_dir):
        sys.exit(f"refusing to write into {args.out_dir}: data_trajectories* directories hold "
                 "the repository's committed datasets")
    mid = model_id(args.env)
    ds = TrajectoryDataset.load_trajectories(args.data_dir, mid, device="cpu")
    aug = augment(ds.trajs.numpy(), args.duration, args.variants, args.speed_cap,
                  tuple(args.holds), args.seed)
    TrajectoryDataset.from_trajs(aug, args.env, device="cpu").save(args.out_dir, mid)
    print(f"saved to {os.path.join(args.out_dir, mid)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
