"""Precomputed SDF grid with a surrogate-gradient lookup.

Twin of `mmd_tpu/envs/grid_sdf.py` (reference: torch_robotics
environments/grid_map_sdf.py). A `GridSDF` holds a value grid and a gradient
grid. A query reads the floor cell of each point: forward gives the cell's
value, backward gives `g[..., None] * cell_grad` (grid_sdf.py:52-73), as a
`torch.autograd.Function`. A scene's two grids (objects and extra objects)
are always read together. The lookup itself is `mmd_torch.ops.sdf_kernel`:
the CUDA kernel on the card, the plain torch version on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch

from mmd_torch.ops.sdf_kernel import grid_lookup


@dataclasses.dataclass(frozen=True)
class GridSDF:
    lower: Tuple[float, ...]  # host floats, so a query needs no device read
    upper: Tuple[float, ...]
    values: torch.Tensor      # (N0, N1)
    grads: torch.Tensor       # (N0, N1, dim)

    @property
    def shape(self):
        return tuple(self.values.shape)

    def to(self, device) -> "GridSDF":
        return dataclasses.replace(self, values=self.values.to(device),
                                   grads=self.grads.to(device))


class _GridLookup(torch.autograd.Function):
    """x (..., 2) -> values (2, ...) on two grids that share shape and box."""

    @staticmethod
    def forward(ctx, x, a, b):
        tables = ((a.values, a.grads), (b.values, b.grads))
        vals, cell_grads = grid_lookup(x.detach(), tables, a.lower, a.upper)
        ctx.save_for_backward(cell_grads)
        return vals

    @staticmethod
    def backward(ctx, g):
        (cell_grads,) = ctx.saved_tensors
        # No gradient w.r.t. the grids: they are static geometry.
        return (g[..., None] * cell_grads).sum(0), None, None


def grid_sdf_pair(a: GridSDF, b: GridSDF, x: torch.Tensor):
    """Both grids at points x (..., dim) -> two (...,) tensors, in one kernel
    launch on the card."""
    if a.shape != b.shape or a.lower != b.lower or a.upper != b.upper:
        raise ValueError("grid_sdf_pair needs grids of one shape and box")
    vals = _GridLookup.apply(x, a, b)
    return vals[0], vals[1]


def linspace_f32(lo: float, hi: float, n: int) -> np.ndarray:
    """`jnp.linspace(lo, hi, n, dtype=float32)`'s arithmetic, in numpy:
    lo * (1 - s) + hi * s with s = iota / (n - 1), endpoint set exactly."""
    lo32, hi32 = np.float32(lo), np.float32(hi)
    step = np.arange(n - 1, dtype=np.float32) / np.float32(n - 1)
    out = lo32 * (np.float32(1) - step) + hi32 * step
    return np.concatenate([out, [hi32]]).astype(np.float32)


def build_grid_sdf(sdf_fn: Callable[[torch.Tensor], torch.Tensor], lower,
                   upper, cell_size: float = 0.005) -> GridSDF:
    """Precompute value + gradient grids of `sdf_fn` on the host (CPU).

    Mirrors `build_grid_sdf` (mmd_tpu/envs/grid_sdf.py:76-102): grid sizes
    ceil(span / cell) computed in float64, grid points on a float32
    linspace, gradients by autograd of the analytic SDF.
    """
    lower64 = np.asarray(lower, np.float64)
    upper64 = np.asarray(upper, np.float64)
    n = [int(np.ceil((upper64[d] - lower64[d]) / cell_size))
         for d in range(lower64.shape[0])]
    axes = [torch.from_numpy(linspace_f32(lower64[d], upper64[d], n[d]))
            for d in range(len(n))]
    mesh = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    pts = mesh.reshape(-1, len(n)).requires_grad_(True)
    vals = sdf_fn(pts)
    (grads,) = torch.autograd.grad(vals.sum(), pts)
    return GridSDF(
        lower=tuple(float(np.float32(v)) for v in lower64),
        upper=tuple(float(np.float32(v)) for v in upper64),
        values=vals.detach().reshape(*n).contiguous(),
        grads=grads.reshape(*n, len(n)).contiguous(),
    )
