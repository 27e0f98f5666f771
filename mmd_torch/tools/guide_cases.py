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


# ------------------------------------------------------------ guide loops
# The guide-loop kernel's cases (`chip_smoke.py`'s guide-loop phase and
# tests/test_torch_cuda.py, on the card; the CPU tests build the same kinds
# on JAX's grids): the two maps, the edge waypoints above, constraints,
# soft paths, N problems, stacked tiles and three horizons. Each is
# (x (..., B, H, 4) normalized, GuideData, HardConds, GuideConfig), made
# with numpy from a seed.
LOOP_CASES = ("conveyor", "nowait", "edges", "hinge", "tied", "constraints", "inactive_set",
              "soft_paths", "root", "local", "problems", "tiles", "H2", "H128")
TILE_ENVS = ("EnvConveyor2D", "EnvHighways2D", "EnvEmptyNoWait2D")


def checkpoint_limits(env_name: str):
    """The normalizer limits (mins, maxs) of a map's committed checkpoint."""
    from mmd_torch.io.flat_yaml import load_flat_yaml
    from mmd_torch.ops.build import REPO_ROOT

    info = load_flat_yaml(str(REPO_ROOT / "data_trained_models" / f"{env_name}-RobotPlanarDisk"
                              / "args.yaml"))
    return (np.asarray(info["normalizer_mins"], np.float32),
            np.asarray(info["normalizer_maxs"], np.float32))


def loop_trajectories(rng, B: int, H: int) -> np.ndarray:
    """Normalized wavy paths across the map with noise; one waypoint beyond
    [-1, 1], so that unnormalize clips."""
    s = np.linspace(-1.0, 1.0, H, dtype=np.float32)
    x = np.zeros((B, H, 4), np.float32)
    for b in range(B):
        a = rng.uniform(0, np.pi)
        x[b, :, 0] = np.cos(a) * s + 0.2 * np.sin(3 * s + b)
        x[b, :, 1] = np.sin(a) * s + 0.2 * np.cos(2 * s - b)
    x[..., 2:] = rng.uniform(-1.0, 1.0, (B, H, 2))
    x += rng.normal(0, 0.05, x.shape).astype(np.float32)
    if H > 5:
        x[0, H // 2] = [1.3, -1.2, 1.5, -1.5]
    return x


def loop_constraints(rng, H: int, k: int = 2, p: int = 2) -> list:
    """k constraints of up to p points: the first two as the CPU tests'
    (one range ending at H), the rest random balls on random ranges."""
    from mmd_torch.common.constraints import MultiPointConstraint

    cons = [MultiPointConstraint(q_l=[np.array([0.0, 0.1]), np.array([0.3, -0.2])][:p],
                                 t_range_l=[(H // 6, H // 2), (H // 3, H)][:p],
                                 radius_l=[0.3, 0.2][:p]),
            MultiPointConstraint(q_l=[np.array([-0.4, 0.0])], t_range_l=[(0, H)],
                                 radius_l=[0.5], is_soft=True)][:k]
    for _ in range(k - len(cons)):
        n = int(rng.integers(1, p + 1))
        t0 = rng.integers(0, H - 1, n)
        cons.append(MultiPointConstraint(
            q_l=list(rng.uniform(-0.8, 0.8, (n, 2)).astype(np.float32)),
            t_range_l=[(int(a), int(rng.integers(a + 1, H + 1))) for a in t0],
            radius_l=list(rng.uniform(0.05, 0.4, n).astype(np.float32))))
    return cons


def loop_soft_paths(rng, R: int, H: int, lead=()):
    """R rows of ball centres near the map's middle, a third masked,
    waypoint 0 masked."""
    pts = rng.uniform(-0.7, 0.7, (*lead, R, H, 2)).astype(np.float32)
    mask = (rng.uniform(size=(*lead, R, H)) < 0.67).astype(np.float32)
    mask[..., 0] = 0.0
    return pts, mask


def loop_hard_values(rng, H: int, lead) -> np.ndarray:
    """Start and goal values at waypoints 0 and H - 1, the rest 0."""
    v = np.zeros((*lead, H, 4), np.float32)
    v[..., 0, :2] = rng.uniform(-0.9, 0.9, (*lead, 2))
    v[..., -1, :2] = rng.uniform(-0.9, 0.9, (*lead, 2))
    return v


def loop_case(name: str, device, B: int = 64, seed: int = 0):
    """The guide-loop case `name` (LOOP_CASES) on `device` with B rows."""
    from mmd_torch.costs import constraints as cons_mod
    from mmd_torch.costs.guide import GuideConfig, GuideData
    from mmd_torch.datasets.normalization import LimitsNormalizer
    from mmd_torch.envs.envs import SceneStack, make_env
    from mmd_torch.models.diffusion import HardConds

    rng = np.random.default_rng(seed + LOOP_CASES.index(name))
    H = {"H2": 2, "H128": 128}.get(name, 64)
    cfg = GuideConfig(**({"dt": 5.0 / H} if H != 64 else {}),
                      **({"obstacle_cutoff_margin": HINGE_CUTOFF} if name == "hinge" else {}))

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=device)

    mask = np.zeros((H, 1), np.float32)
    mask[0] = mask[-1] = 1.0
    if name in ("problems", "tiles"):
        G = 10 if name == "problems" else len(TILE_ENVS)
        envs = ("EnvConveyor2D",) * G if name == "problems" else TILE_ENVS
        x = np.stack([loop_trajectories(rng, B, H) for _ in range(G)])
        per = [loop_constraints(rng, H, k=int(rng.integers(0, 4))) for _ in range(G)]
        per[0] = []  # a group whose rows are all inactive
        R = 9
        pts, smask = loop_soft_paths(rng, R, H, (G,))
        values = loop_hard_values(rng, H, (G, 1))
        if name == "problems":
            scene = make_env(envs[0], device).scene
            norm = LimitsNormalizer.from_limits(*checkpoint_limits(envs[0]), device)
            hard = HardConds(mask=t(mask), values=t(values))
            radius = t(np.float32(0.3)).expand(G)  # expanded, as the children's
            weight = t(rng.uniform(0.02, 0.2, G))
        else:
            scene = SceneStack(tuple(make_env(e, device).scene for e in envs))
            norm = LimitsNormalizer.stack([LimitsNormalizer.from_limits(*checkpoint_limits(e), device)
                                           for e in envs])
            tmask = np.zeros((G, 1, H, 1), np.float32)
            tmask[0, 0, 0] = tmask[-1, 0, H - 1] = 1.0
            hard = HardConds(mask=t(tmask), values=t(values))
            radius, weight = t(np.full(G, 0.3, np.float32)), t(np.full(G, 0.02, np.float32))
        gd = GuideData(scene=scene, normalizer=norm,
                       constraints=cons_mod.pack_constraint_sets(per, device=device),
                       soft_paths=cons_mod.SoftPathConstraints(points=t(pts), mask=t(smask),
                                                               radius=radius, weight=weight))
        return t(x), gd, hard, cfg

    env = "EnvEmptyNoWait2D" if name == "nowait" else "EnvConveyor2D"
    scene = make_env(env, device).scene
    if name == "tied":
        scene = tied_scene(scene, cfg.collision_margin)
    if name in ("edges", "hinge", "tied"):
        # The edge waypoints as x itself: with limits [-1, 1] on the
        # positions, unnormalize gives a cell edge back exactly.
        mins = np.array([-1.0, -1.0, -2.0, -2.0], np.float32)
        maxs = -mins
        x = waypoints((B, H, 4), scene, cfg.collision_margin, seed)
        x[..., 2:] *= 0.5
    else:
        mins, maxs = checkpoint_limits(env)
        x = loop_trajectories(rng, B, H)
    k, p = {"constraints": (2, 2), "soft_paths": (2, 2), "local": (8, 2),
            "H128": (2, 2)}.get(name, (0, 0))
    cons = loop_constraints(rng, H, k, p)
    K, P = (3, 2) if k in (0, 2) else (k, p)  # K = 3: an inactive row
    cset = (cons_mod.pack_constraint_set(cons, K, P, device=device) if cons
            else cons_mod.empty_constraint_set(K, P, device=device))
    R = {"soft_paths": 3, "root": 9, "H2": 3, "H128": 3}.get(name, 0)
    spc = None
    if R:
        pts, smask = loop_soft_paths(rng, R, H)
        spc = cons_mod.SoftPathConstraints(points=t(pts), mask=t(smask),
                                           radius=t(np.float32(0.3)), weight=t(np.float32(0.02)))
    gd = GuideData(scene=scene, normalizer=LimitsNormalizer.from_limits(mins, maxs, device),
                   constraints=cset, soft_paths=spc)
    hard = HardConds(mask=t(mask), values=t(loop_hard_values(rng, H, (B,))))
    return t(x), gd, hard, cfg
