"""The five 2D planning environments.

Twin of `mmd_tpu/envs/envs.py`: the box geometry of each map, its SDF
grids and the workspace bounds (all workspaces are [-1, 1]^2), and the
host-side hooks of data generation and evaluation: each map's skills
(`get_skill_pos_seq_l`), its data-adherence score
(`compute_traj_data_adherence`) and its start/goal gate
(`is_start_goal_valid_for_data_gen`), in numpy. Every env has a `GridSDF`
for its objects and one for its extra objects (empty in every released
map); an empty map's grid is a constant BIG with zero gradient. Grids are
built on the host and moved to `device`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from mmd_torch.envs.grid_sdf import GridSDF, build_grid_sdf
from mmd_torch.envs.primitives import BIG, BoxField, union_sdf
from mmd_torch.ops.collision_guide import GuideTable

SDF_CELL_SIZE = 0.005  # 400 x 400 cells over [-1, 1]^2, as every checkpoint saw
WS_BOUNDARY_SCALE = 1.08  # the walls' box, scaled workspace (reference: tasks.py:83-85)


@dataclasses.dataclass(frozen=True)
class SceneData:
    """What the guide and the classifier read of a map."""

    grid: GridSDF
    extra_grid: GridSDF
    ws_min: torch.Tensor  # (2,) workspace bounds for the boundary field
    ws_max: torch.Tensor
    # The collision-guide kernel's packed grids and constants, built once
    # per scene, on the grids' device.
    guide_table: GuideTable = dataclasses.field(init=False, repr=False,
                                                compare=False)

    def __post_init__(self):
        # The walls' box as boundary_signed_distances computes it: a float32
        # product, the same on the CPU as on the card.
        lo = (self.ws_min.cpu() * WS_BOUNDARY_SCALE).tolist()
        hi = (self.ws_max.cpu() * WS_BOUNDARY_SCALE).tolist()
        object.__setattr__(self, "guide_table",
                           GuideTable.build(self.grid, self.extra_grid, lo, hi))


@dataclasses.dataclass(frozen=True)
class SceneStack:
    """The scenes of a multi-tile plan's T tiles, read together: tile m's
    rows of a (T, B, H, D) batch read scene m. The collision-guide kernel
    reads them as one stacked table, built once per stack."""

    scenes: Tuple[SceneData, ...]
    guide_table: GuideTable = dataclasses.field(init=False, repr=False,
                                                compare=False)

    def __post_init__(self):
        object.__setattr__(self, "guide_table",
                           GuideTable.stack([s.guide_table for s in self.scenes]))

    @property
    def n_tiles(self) -> int:
        return len(self.scenes)


class Env2D:
    name = "Env2D"
    _BOXES: Optional[np.ndarray] = None
    _SIZES: Optional[np.ndarray] = None

    def __init__(self, device="cuda"):
        self.limits = np.array([[-1.0, -1.0], [1.0, 1.0]], np.float32)
        self.box_field = _box_field(self._BOXES, self._SIZES)
        # Extra objects (reference obj_extra_list): empty in every released env.
        self.extra_box_field = _box_field(None, None)
        self.grid = self._build_grid(self.box_field).to(device)
        self.extra_grid = self._build_grid(self.extra_box_field).to(device)
        self.scene = SceneData(
            grid=self.grid, extra_grid=self.extra_grid,
            ws_min=torch.as_tensor(self.limits[0], device=device),
            ws_max=torch.as_tensor(self.limits[1], device=device))

    def _build_grid(self, field: BoxField) -> GridSDF:
        lo, hi = self.limits[0], self.limits[1]
        if field.centers.shape[0] == 0:
            n = tuple(int(np.ceil((hi[d] - lo[d]) / SDF_CELL_SIZE))
                      for d in range(2))
            return GridSDF(lower=tuple(map(float, lo)), upper=tuple(map(float, hi)),
                           values=torch.full(n, BIG, dtype=torch.float32),
                           grads=torch.zeros((*n, 2), dtype=torch.float32))
        return build_grid_sdf(lambda p: union_sdf([field], p), lo, hi, SDF_CELL_SIZE)

    def compute_sdf_exact(self, x: torch.Tensor) -> torch.Tensor:
        """The analytic SDF of the map's objects, the primitives its grid is
        built from: x (..., 2) -> (...,), on x's device."""
        f = self.box_field
        return union_sdf([BoxField(centers=f.centers.to(x.device),
                                   half_sizes=f.half_sizes.to(x.device))], x)

    def get_skill_pos_seq_l(self, start_pos=None, goal_pos=None,
                            rng: Optional[np.random.Generator] = None
                            ) -> Optional[List[np.ndarray]]:
        """The map's skill waypoint sequences for data generation, if any."""
        return None

    def compute_traj_data_adherence(self, path: np.ndarray) -> float:
        """The map's behavioral adherence score of a (H, >=2) path."""
        return float("-inf")

    def is_start_goal_valid_for_data_gen(self, start_pos, goal_pos) -> bool:
        return True


def _box_field(boxes, sizes) -> BoxField:
    if boxes is None or len(boxes) == 0:
        return BoxField(centers=torch.zeros((0, 2)), half_sizes=torch.zeros((0, 2)))
    return BoxField(centers=torch.as_tensor(boxes, dtype=torch.float32),
                    half_sizes=torch.as_tensor(sizes, dtype=torch.float32) / 2.0)


class EnvEmpty2D(Env2D):
    """reference: env_empty_2d.py (no obstacles)."""

    name = "EnvEmpty2D"

    def compute_traj_data_adherence(self, path: np.ndarray,
                                    fraction_of_length: float = 0.1) -> float:
        # The share of waypoints within fraction_of_length x length of the
        # straight start->goal line (reference: env_empty_2d.py:132-146).
        p = np.asarray(path)[:, :2]
        start, goal = p[0], p[-1]
        length = np.linalg.norm(goal - start)
        if length < 1e-9:
            return 1.0
        d = goal - start
        rel = p - start
        deviation = np.abs(d[0] * rel[:, 1] - d[1] * rel[:, 0]) / length
        return float((deviation < fraction_of_length * length).mean())


class EnvEmptyNoWait2D(EnvEmpty2D):
    """reference: env_empty_nowait_2d.py:15 (same geometry, own model id)."""

    name = "EnvEmptyNoWait2D"


class EnvConveyor2D(Env2D):
    """reference: env_conveyor_2d.py:47-67."""

    name = "EnvConveyor2D"
    _BOXES = np.array([[0.0, 0.0], [0.0, 0.35], [0.0, -0.35]], np.float32)
    _SIZES = np.array([[0.8, 0.1], [1.0, 0.1], [1.0, 0.1]], np.float32)

    def get_skill_pos_seq_l(self, start_pos=None, goal_pos=None, rng=None):
        # The two corridor traversals, 30 lerped waypoints each: bottom
        # left->right at y=-0.2, top right->left at y=+0.2
        # (reference: env_conveyor_2d.py:143-159).
        def lerp_seq(a, b, n=30):
            alphas = np.linspace(0.0, 1.0, n, dtype=np.float32)[:, None]
            return (1 - alphas) * np.asarray(a, np.float32) + alphas * np.asarray(b, np.float32)

        return [lerp_seq([-0.6, -0.2], [0.6, -0.2]), lerp_seq([0.6, 0.2], [-0.6, 0.2])]

    def compute_traj_data_adherence(self, path: np.ndarray) -> float:
        # 1.0 iff the path passes a corridor's enter, middle and exit gates
        # in order (reference: env_conveyor_2d.py:161-185).
        p = np.asarray(path)[:, :2]
        gates = {
            "top": np.array([[0.6, 0.2], [0.0, 0.2], [-0.6, 0.2]], np.float32),
            "bottom": np.array([[-0.6, -0.2], [0.0, -0.2], [0.6, -0.2]], np.float32),
        }
        for g in gates.values():
            t_hit = np.full(3, -1.0)
            for t in range(p.shape[0]):
                nxt = int(np.argmin(t_hit))
                if np.linalg.norm(p[t] - g[nxt]) < 0.2:
                    t_hit[nxt] = t
            if np.all(t_hit != -1):
                return 1.0
        return 0.0


class EnvHighways2D(Env2D):
    """reference: env_highways_2d.py:46-77."""

    name = "EnvHighways2D"
    _BOXES = np.array([
        [0.0, 0.0], [0.0, 0.875], [0.0, -0.875], [0.875, 0.0], [-0.875, 0.0],
        [0.875, 0.875], [0.875, -0.875], [-0.875, 0.875], [-0.875, -0.875],
    ], np.float32)
    _SIZES = np.array([
        [0.5, 0.5], [0.5, 0.25], [0.5, 0.25], [0.25, 0.5], [0.25, 0.5],
        [0.25, 0.25], [0.25, 0.25], [0.25, 0.25], [0.25, 0.25],
    ], np.float32)

    def get_skill_pos_seq_l(self, start_pos=None, goal_pos=None, rng=None):
        # The counterclockwise route of quadrant midpoints from the one
        # nearest the start to the one nearest the goal, densified x10 with
        # its ends trimmed, and one copy noised from `rng`
        # (reference: env_highways_2d.py:199-254).
        rng = rng or np.random.default_rng(0)
        wps = np.array([[-0.5, -0.5], [0.5, -0.5], [0.5, 0.5], [-0.5, 0.5]], np.float32)
        i0 = int(np.argmin(np.linalg.norm(wps - np.asarray(start_pos)[:2], axis=-1)))
        i1 = int(np.argmin(np.linalg.norm(wps - np.asarray(goal_pos)[:2], axis=-1)))
        seq = [wps[i0]]
        i = i0
        if i0 == i1:
            i = (i + 1) % 4
            seq.append(wps[i])
        while i != i1:
            i = (i + 1) % 4
            seq.append(wps[i])
        seq = np.stack(seq)
        dense = _densify(seq, 10)[4:-4]
        if dense.shape[0] == 0:
            dense = _densify(seq, 10)
        noised = dense + rng.normal(size=dense.shape).astype(np.float32) * 0.01
        return [dense, noised]

    def compute_traj_data_adherence(self, path: np.ndarray) -> float:
        # 1.0 iff the summed cross product of consecutive normalized
        # positions (not deltas, as the reference) is positive: the ring
        # is driven counterclockwise (reference: env_highways_2d.py:255-275).
        p = np.asarray(path)[:, :2]
        norms = np.linalg.norm(p, axis=1, keepdims=True)
        norms = np.where(norms < 1e-12, 1.0, norms)
        v = p / norms
        cross = v[:-1, 0] * v[1:, 1] - v[:-1, 1] * v[1:, 0]
        return 1.0 if float(np.sum(cross)) > 0 else 0.0

    def is_start_goal_valid_for_data_gen(self, start_pos, goal_pos) -> bool:
        # Start and goal in the four open corner squares
        # (reference: env_highways_2d.py:168-197).
        def in_corner(q):
            return abs(abs(q[0]) - 0.5) < 0.25 and abs(abs(q[1]) - 0.5) < 0.25

        return in_corner(np.asarray(start_pos)) and in_corner(np.asarray(goal_pos))


class EnvDropRegion2D(Env2D):
    """reference: env_drop_region_2d.py:62-95."""

    name = "EnvDropRegion2D"
    _BOXES = np.array([[0.4, 0.4], [-0.4, 0.4], [0.4, -0.4], [-0.4, -0.4]], np.float32)
    _SIZES = np.array([[0.4, 0.4]] * 4, np.float32)
    DROP_REGION_CENTERS = np.array([
        [0.4, 0.75], [0.4, 0.05], [0.4, -0.05], [0.4, -0.75],
        [-0.4, 0.75], [-0.4, 0.05], [-0.4, -0.05], [-0.4, -0.75],
        [0.75, 0.4], [0.05, 0.4], [-0.05, 0.4], [-0.75, 0.4],
        [0.75, -0.4], [0.05, -0.4], [-0.05, -0.4], [-0.75, -0.4],
    ], np.float32)

    def get_skill_pos_seq_l(self, start_pos=None, goal_pos=None, rng=None):
        # A 35-step dwell at each drop-region centre
        # (reference: env_drop_region_2d.py:173-181).
        return [np.tile(c[None], (35, 1)) for c in self.DROP_REGION_CENTERS]

    def compute_traj_data_adherence(self, path: np.ndarray,
                                    drop_region_radius: float = 0.15,
                                    ratio_traj_steps_in_region: float = 0.25) -> float:
        # 1.0 iff the path dwells in one drop region for 25% of its steps in
        # a row (reference: env_drop_region_2d.py:183-197).
        p = np.asarray(path)[:, :2]
        n_req = int(p.shape[0] * ratio_traj_steps_in_region)
        if n_req <= 0:
            return 0.0
        for c in self.DROP_REGION_CENTERS:
            inside = np.linalg.norm(p - c, axis=-1) < drop_region_radius
            run = 0
            for flag in inside:
                run = run + 1 if flag else 0
                if run >= n_req:
                    return 1.0
        return 0.0


def _densify(seq: np.ndarray, n_points_interp: int) -> np.ndarray:
    """A (K, 2) waypoint sequence with n points a segment, linearly
    (reference: mmd/common/trajectory_utils.py:54-70)."""
    out = []
    for a, b in zip(seq[:-1], seq[1:]):
        alphas = np.linspace(0.0, 1.0, n_points_interp, endpoint=False, dtype=np.float32)[:, None]
        out.append((1 - alphas) * a + alphas * b)
    out.append(seq[-1:])
    return np.concatenate(out, axis=0)


ENV_REGISTRY = {cls.name: cls for cls in (
    EnvEmpty2D, EnvEmptyNoWait2D, EnvConveyor2D, EnvHighways2D, EnvDropRegion2D)}


@functools.lru_cache(maxsize=16)
def _make_env(name: str, device: str) -> Env2D:
    return ENV_REGISTRY[name](device=device)


def make_env(name: str, device="cuda") -> Env2D:
    """Construct (and cache) an environment by class name on `device`."""
    return _make_env(name, str(torch.device(device)))
