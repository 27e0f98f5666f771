"""Trajectory helpers of mmd/common/trajectory_utils.py, on the host.

Twin of `mmd_tpu/common/trajectory_utils.py`, numpy as there:
- `densify_trajs`: linear densify (:54-70)
- `are_points_closer_than_margin` (:73-92)
The savgol smoothing (:31-52) is `mmd_torch.utils.interp.savgol_matrix`.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def densify_trajs(trajs: Sequence, n_points_interp: int = 2) -> List[np.ndarray]:
    """Each (H, D) path with n_points_interp - 1 points inserted into each
    segment, as numpy arrays."""
    out = []
    for traj in trajs:
        t = np.asarray(traj)
        if n_points_interp <= 1 or t.shape[0] < 2:
            out.append(t.copy())
            continue
        alphas = np.linspace(0.0, 1.0, n_points_interp, endpoint=False)[:, None]
        segs = [(1 - alphas) * a + alphas * b for a, b in zip(t[:-1], t[1:])]
        segs.append(t[-1:])
        out.append(np.concatenate(segs, axis=0))
    return out


def are_points_closer_than_margin(points: np.ndarray, margin: float) -> bool:
    """True if any two of the points (n, d) are closer than margin."""
    p = np.asarray(points)
    d = np.linalg.norm(p[:, None] - p[None, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    return bool((d < margin).any())
