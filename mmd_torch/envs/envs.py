"""The five 2D planning environments.

Twin of `mmd_tpu/envs/envs.py` for what planning reads: the box geometry of
each map, its SDF grids and the workspace bounds (all workspaces are
[-1, 1]^2). Every env has a `GridSDF` for its objects and one for its extra
objects (empty in every released map); an empty map's grid is a constant
BIG with zero gradient. Grids are built on the host and moved to `device`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

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


def _box_field(boxes, sizes) -> BoxField:
    if boxes is None or len(boxes) == 0:
        return BoxField(centers=torch.zeros((0, 2)), half_sizes=torch.zeros((0, 2)))
    return BoxField(centers=torch.as_tensor(boxes, dtype=torch.float32),
                    half_sizes=torch.as_tensor(sizes, dtype=torch.float32) / 2.0)


class EnvEmpty2D(Env2D):
    """reference: env_empty_2d.py (no obstacles)."""

    name = "EnvEmpty2D"


class EnvEmptyNoWait2D(EnvEmpty2D):
    """reference: env_empty_nowait_2d.py:15 (same geometry, own model id)."""

    name = "EnvEmptyNoWait2D"


class EnvConveyor2D(Env2D):
    """reference: env_conveyor_2d.py:47-67."""

    name = "EnvConveyor2D"
    _BOXES = np.array([[0.0, 0.0], [0.0, 0.35], [0.0, -0.35]], np.float32)
    _SIZES = np.array([[0.8, 0.1], [1.0, 0.1], [1.0, 0.1]], np.float32)


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


class EnvDropRegion2D(Env2D):
    """reference: env_drop_region_2d.py:62-95."""

    name = "EnvDropRegion2D"
    _BOXES = np.array([[0.4, 0.4], [-0.4, 0.4], [0.4, -0.4], [-0.4, -0.4]], np.float32)
    _SIZES = np.array([[0.4, 0.4]] * 4, np.float32)


ENV_REGISTRY = {cls.name: cls for cls in (
    EnvEmpty2D, EnvEmptyNoWait2D, EnvConveyor2D, EnvHighways2D, EnvDropRegion2D)}


@functools.lru_cache(maxsize=16)
def _make_env(name: str, device: str) -> Env2D:
    return ENV_REGISTRY[name](device=device)


def make_env(name: str, device="cuda") -> Env2D:
    """Construct (and cache) an environment by class name on `device`."""
    return _make_env(name, str(torch.device(device)))
