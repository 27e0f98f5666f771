"""A map's collision geometry: its SDF grid and the floor-cell lookup.

A map is a union of axis-aligned boxes in the workspace [-1, 1]^2. Its SDF
is the min over boxes of max_d(|x - c|_d - h_d). The planner reads it from
a grid of 0.005 cells (400 x 400): each point reads its floor cell's value
and, for the guide's gradient, the cell's gradient, which is the SDF's
gradient at the cell's corner (autograd of the formula above; ties split
evenly, as max and min reductions split them). The grid points lie on a
float32 linspace of the workspace, the grid size ceil(span / cell) in
float64. The walls are the workspace box scaled by 1.08: a point's signed
distances to them are (q - lo, hi - q).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

CELL = 0.005
WALL_SCALE = 1.08
BIG = 1e6  # the SDF of a map without boxes


def _linspace_f32(lo: float, hi: float, n: int) -> np.ndarray:
    lo32, hi32 = np.float32(lo), np.float32(hi)
    s = np.arange(n - 1, dtype=np.float32) / np.float32(n - 1)
    return np.concatenate([lo32 * (np.float32(1) - s) + hi32 * s, [hi32]]).astype(np.float32)


def box_sdf(x: torch.Tensor, centers: torch.Tensor, half: torch.Tensor) -> torch.Tensor:
    d = torch.abs(x[..., None, :] - centers) - half
    return d.amax(dim=-1).amin(dim=-1)


class Scene:
    """A map's grid (values (n0, n1), gradients (n0, n1, 2)) on `device`,
    and its walls."""

    def __init__(self, boxes: Sequence[Sequence[float]], sizes: Sequence[Sequence[float]],
                 device, lower=(-1.0, -1.0), upper=(1.0, 1.0)):
        lo64, hi64 = np.asarray(lower, np.float64), np.asarray(upper, np.float64)
        n = [int(np.ceil((hi64[d] - lo64[d]) / CELL)) for d in range(2)]
        if len(boxes) == 0:
            values = torch.full(n, BIG, dtype=torch.float32)
            grads = torch.zeros((*n, 2), dtype=torch.float32)
        else:
            axes = [torch.from_numpy(_linspace_f32(lo64[d], hi64[d], n[d])) for d in range(2)]
            pts = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1).reshape(-1, 2)
            pts.requires_grad_(True)
            centers = torch.as_tensor(np.asarray(boxes, np.float32))
            half = torch.as_tensor(np.asarray(sizes, np.float32)) / 2.0
            with torch.enable_grad():
                v = box_sdf(pts, centers, half)
                (g,) = torch.autograd.grad(v.sum(), pts)
            values, grads = v.detach().reshape(n), g.reshape(*n, 2)
        self.shape = tuple(n)
        self.values = values.to(device)
        self.grads = grads.to(device)
        self.lower = torch.as_tensor(np.asarray(lower, np.float32), device=device)
        self.span = torch.as_tensor(np.asarray(upper, np.float32)
                                    - np.asarray(lower, np.float32), device=device)
        self.n = torch.tensor([float(s) for s in n], device=device)
        ws_lo = torch.as_tensor(np.asarray(lower, np.float32), device=device)
        ws_hi = torch.as_tensor(np.asarray(upper, np.float32), device=device)
        self.wall_lo = ws_lo * WALL_SCALE
        self.wall_hi = ws_hi * WALL_SCALE

    def cells(self, q: torch.Tensor):
        """(i, j) floor-cell indices of points q (..., 2), clamped to the
        grid; a NaN coordinate reads cell 0."""
        f = torch.nan_to_num(torch.floor((q - self.lower) / self.span * self.n), nan=0.0)
        f = torch.minimum(torch.clamp(f, min=0.0), self.n - 1.0).to(torch.int64)
        return f[..., 0], f[..., 1]

    def lookup(self, q: torch.Tensor):
        """(values (...), cell gradients (..., 2)) at points q (..., 2)."""
        i, j = self.cells(q)
        return self.values[i, j], self.grads[i, j]

    def wall_distances(self, q: torch.Tensor) -> torch.Tensor:
        """Signed distances to the four walls: (..., 2) -> (..., 4)."""
        return torch.cat([q - self.wall_lo, self.wall_hi - q], dim=-1)

    def in_collision(self, q: torch.Tensor, margin: float) -> torch.Tensor:
        """(..., 2) -> (...) bool: the grid's SDF or a wall closer than margin."""
        return (self.lookup(q)[0] < margin) | torch.any(self.wall_distances(q) < margin, dim=-1)
