"""Inputs that reach every branch of the collision guide.

The port's tests and `chip_smoke.py` hold the collision-guide kernel
against its plain version (and the plain version against the JAX package)
on these: waypoints on cell edges, inside objects and their margin, inside
the walls' margin, in corners where two walls tie, exactly at a wall's
hinge, and a scene whose two grids are equal (a tie at every cell) with a
band of cells exactly at the margin.
"""
from __future__ import annotations

import numpy as np
import torch

from mmd_torch.envs.envs import SceneData
from mmd_torch.envs.grid_sdf import GridSDF

# GuideConfig(obstacle_cutoff_margin=HINGE_CUTOFF) has a margin of exactly
# 0.0625 in float32 (1.1 * 0.05 + 0.0075). With it a waypoint can sit
# exactly at a wall's hinge: the default 0.065 is no multiple of the
# float32 spacing near the walls, so no waypoint reaches relu(0) there.
HINGE_CUTOFF = 0.0075


def waypoints(shape, scene: SceneData, margin: float, seed: int) -> np.ndarray:
    """Unnormalized float32 trajectories of `shape` (..., H, 4).

    Inner waypoints (1 <= h <= H-2; the guide zeroes the others) get, in a
    shuffled order: the walls' hinges and corners, points exactly on cell
    edges, points within 1.5 margins of a wall, points where two walls tie,
    points in cells closer to an object than the margin, and the rest
    uniform over a box a little larger than the walls'.
    """
    rng = np.random.default_rng(seed)
    t = scene.guide_table
    lo, span = np.asarray(t.lower, np.float32), np.asarray(t.span, np.float32)
    n_cells = np.asarray(t.cells.shape[:2], np.float32)
    w_lo = np.asarray(t.wall_lo, np.float32)
    w_hi = np.asarray(t.wall_hi, np.float32)
    m = np.float32(margin)

    u = rng.uniform(-2.0, 2.0, shape).astype(np.float32)
    u[..., :2] = rng.uniform(w_lo - 0.04, w_hi + 0.04, (*shape[:-1], 2))
    rows = np.arange(u.size // 4).reshape(shape[:-1])[..., 1:-1].ravel()
    rows = rng.permutation(rows)
    q = u.reshape(-1, 4)[:, :2]  # a view: writes land in u

    # The hinges (margin - sd == 0 when the margin is HINGE_CUTOFF's) and
    # the corners, where two or four walls tie.
    at_lo, at_hi = w_lo + m, w_hi - m
    fixed = np.array([[at_hi[0], 0.1], [at_lo[0], -0.3], [0.2, at_hi[1]],
                      [-0.5, at_lo[1]], [at_hi[0], at_hi[1]], [at_lo[0], at_hi[1]],
                      [at_lo[0], at_lo[1]], [at_hi[0], at_lo[1]]], np.float32)
    n = len(rows)
    parts = np.split(rows, [len(fixed), n // 4, 3 * n // 8, n // 2, 5 * n // 8])
    q[parts[0]] = fixed[: len(parts[0])]
    # Cell edges: lo + k / n * span, as the grid's index arithmetic sees them.
    k = rng.integers(0, int(n_cells[0]) + 1, (len(parts[1]), 2)).astype(np.float32)
    q[parts[1]] = lo + k / n_cells * span
    # Within 1.5 margins of a wall, the other axis free.
    band = rng.uniform(0.0, 1.5, len(parts[2])).astype(np.float32) * m
    axis = rng.integers(0, 2, len(parts[2]))
    high = rng.integers(0, 2, len(parts[2])).astype(bool)
    idx = np.arange(len(parts[2]))
    pts = rng.uniform(-0.9, 0.9, (len(parts[2]), 2)).astype(np.float32)
    pts[idx, axis] = np.where(high, w_hi[axis] - band, w_lo[axis] + band)
    q[parts[2]] = pts
    # Corners: the same depth into two walls, so their penalties tie.
    d = rng.uniform(0.0, 1.0, len(parts[3])).astype(np.float32) * m
    sx = rng.integers(0, 2, len(parts[3])).astype(bool)
    sy = rng.integers(0, 2, len(parts[3])).astype(bool)
    q[parts[3]] = np.stack([np.where(sx, w_hi[0] - d, w_lo[0] + d),
                            np.where(sy, w_hi[1] - d, w_lo[1] + d)], -1)
    # In cells whose value is below the margin: inside objects or near them.
    values = torch.minimum(scene.grid.values, scene.extra_grid.values).cpu().numpy()
    near = np.argwhere(values < m).astype(np.float32)
    if len(near):
        pick = near[rng.integers(0, len(near), len(parts[4]))]
        frac = rng.uniform(0.0, 1.0, pick.shape).astype(np.float32)
        q[parts[4]] = lo + (pick + frac) / n_cells * span
    return u


def tied_scene(scene: SceneData, margin: float) -> SceneData:
    """`scene`'s object grid as both of its grids, so that every cell ties
    (the gradient splits 0.5/0.5), with the cells of rows 190-209 set to
    the margin in float32 (relu at exactly 0: gradient 0.5)."""
    g = scene.grid
    values = g.values.clone()
    values[190:210] = float(np.float32(margin))
    grid = GridSDF(lower=g.lower, upper=g.upper, values=values, grads=g.grads)
    return SceneData(grid=grid, extra_grid=grid, ws_min=scene.ws_min,
                     ws_max=scene.ws_max)
