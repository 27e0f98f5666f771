"""Trajectory interpolation and Savitzky-Golay smoothing.

Twin of `mmd_tpu/utils/interp.py`:
- `interpolate_points` ~ F.interpolate(linear, align_corners=True)
  (reference: torch_robotics/fields/distance_fields.py:66-73)
- `interpolate_traj_via_points` ~ per-segment linear densify
  (reference: torch_robotics/trajectory/utils.py:73-87)
- `savgol_matrix` ~ scipy.signal.savgol_filter(window, order, mode='interp')
  as one (H, H) matrix (reference: mmd/common/trajectory_utils.py:31-52)
- `finite_difference_vector` ~ torch_robotics/trajectory/utils.py:89-100
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def interpolate_points(x: torch.Tensor, num_points: int) -> torch.Tensor:
    """Linear resample along axis -2, align_corners=True: (..., H, D) ->
    (..., num_points, D)."""
    H = x.shape[-2]
    if num_points == H:
        return x
    src = torch.linspace(0.0, H - 1.0, num_points, dtype=x.dtype, device=x.device)
    lo = torch.clamp(torch.floor(src).to(torch.int64), 0, H - 2)
    frac = (src - lo.to(x.dtype))[:, None]
    return x[..., lo, :] * (1.0 - frac) + x[..., lo + 1, :] * frac


def interpolate_traj_via_points(x: torch.Tensor, num_interpolation: int) -> torch.Tensor:
    """Insert `num_interpolation` points per segment: (..., H, D) ->
    (..., (H-1)*(num_interpolation+1) + 1, D)."""
    if num_interpolation <= 0:
        return x
    H = x.shape[-2]
    a = x[..., :-1, None, :]
    b = x[..., 1:, None, :]
    # np.linspace(0, 1, k+1, endpoint=False) in float32: alpha_i = i / (k+1).
    alphas = torch.arange(num_interpolation + 1, dtype=x.dtype,
                          device=x.device) / (num_interpolation + 1)
    seg = a * (1 - alphas)[:, None] + b * alphas[:, None]
    flat = seg.reshape(*x.shape[:-2], (H - 1) * (num_interpolation + 1), x.shape[-1])
    return torch.cat([flat, x[..., -1:, :]], dim=-2)


@functools.lru_cache(maxsize=32)
def savgol_matrix(n: int, window: int = 10, order: int = 2) -> np.ndarray:
    """The (n, n) Savitzky-Golay smoothing matrix S: S @ y equals
    scipy.signal.savgol_filter(y, window, order, mode='interp') along axis 0.
    The filter is linear, so column i is the filter of the i-th unit vector.
    """
    from scipy.signal import savgol_filter

    eye = np.eye(n, dtype=np.float64)
    cols = [savgol_filter(eye[:, i], window, order, mode="interp") for i in range(n)]
    out = np.stack(cols, axis=1).astype(np.float32)
    out.setflags(write=False)  # cached and shared: read-only
    return out


def finite_difference_vector(x: torch.Tensor, dt: float = 1.0,
                             method: str = "central") -> torch.Tensor:
    """Finite differences along the horizon (..., H, D), one-sided at the
    borders (reference: torch_robotics/trajectory/utils.py:89-100; the cost
    zoo's own version, `mmd_torch/costs/zoo.py`, zeroes the borders)."""
    if method == "central":
        inner = (x[..., 2:, :] - x[..., :-2, :]) / (2 * dt)
        first = (x[..., 1:2, :] - x[..., 0:1, :]) / dt
        last = (x[..., -1:, :] - x[..., -2:-1, :]) / dt
        return torch.cat([first, inner, last], dim=-2)
    d = (x[..., 1:, :] - x[..., :-1, :]) / dt
    if method == "forward":
        return torch.cat([d, d[..., -1:, :]], dim=-2)
    if method == "backward":
        return torch.cat([d[..., :1, :], d], dim=-2)
    raise ValueError(method)
