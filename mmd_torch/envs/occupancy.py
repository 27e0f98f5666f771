"""Binary occupancy grid of a map.

Twin of `mmd_tpu/envs/occupancy.py` (reference: deps/torch_robotics/
torch_robotics/environments/occupancy_map.py:62-172): a cell grid stamped
from the env's primitives, and point lookups by floor indexing. In the
reference it backs only the occupancy-map task mode and the RRT
pre-sample path (tasks.py:40-42), both off by default.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mmd_torch.envs.envs import Env2D


@dataclasses.dataclass(frozen=True)
class OccupancyMap:
    lower: torch.Tensor   # (2,)
    upper: torch.Tensor   # (2,)
    grid: torch.Tensor    # (N0, N1) bool, True = occupied

    def get_collisions(self, x: torch.Tensor) -> torch.Tensor:
        """x (..., 2) -> (...,) bool: the floor cell is occupied, or the
        point lies outside the grid (occupancy_map.py:100-130)."""
        n0, n1 = self.grid.shape
        rel = (x - self.lower) / (self.upper - self.lower)
        i = torch.floor(rel[..., 0] * n0).to(torch.int64)
        j = torch.floor(rel[..., 1] * n1).to(torch.int64)
        oob = (i < 0) | (i >= n0) | (j < 0) | (j >= n1)
        return self.grid[i.clamp(0, n0 - 1), j.clamp(0, n1 - 1)] | oob


def build_occupancy_map(env: Env2D, cell_size: float = 0.01,
                        margin: float = 0.0) -> OccupancyMap:
    """Stamp the env's primitives into a binary grid, on the host, then on
    the env's device (env_base.py:101; primitives' add_to_occupancy_map
    :121, :233): a cell is occupied where the exact SDF at its grid point
    is below `margin`."""
    lo, hi = env.limits[0], env.limits[1]
    n = [int(np.ceil((hi[d] - lo[d]) / cell_size)) for d in range(2)]
    xs = np.linspace(lo[0], hi[0], n[0], dtype=np.float32)
    ys = np.linspace(lo[1], hi[1], n[1], dtype=np.float32)
    pts = np.stack(np.meshgrid(xs, ys, indexing="ij"), axis=-1).reshape(-1, 2)
    sdf = env.compute_sdf_exact(torch.from_numpy(pts)).numpy()
    device = env.scene.ws_min.device
    return OccupancyMap(lower=torch.as_tensor(lo, device=device),
                        upper=torch.as_tensor(hi, device=device),
                        grid=torch.as_tensor((sdf < margin).reshape(n), device=device))
