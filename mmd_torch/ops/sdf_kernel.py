"""Batched grid-SDF lookup: cell value + precomputed cell gradient.

Twin of `mmd_tpu/ops/sdf_kernel.py`. On a CUDA tensor `grid_lookup` launches
the hand-written kernel of `mmd_torch/csrc/grid_sdf.cu` (built with nvcc at
first use, bound with ctypes); on a CPU tensor it runs `grid_lookup_plain`,
the same arithmetic in plain torch. It never falls back from one to the
other. `grid_lookup.launches` counts kernel launches.

A lookup reads two tables, a scene's object grid and its extra-objects
grid, in one launch. Each table is a `(values (N0, N1), grads (N0, N1, 2))`
pair; both share one shape and one box `[lower, upper]`.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from mmd_torch.ops.build import CSRC_DIR, build_shared_library

SOURCE = CSRC_DIR / "grid_sdf.cu"
# The TPU kernel this one replaces (file:line of its body).
REPLACES = "mmd_tpu/ops/sdf_kernel.py:50"

Table = Tuple[torch.Tensor, torch.Tensor]
Tables = Tuple[Table, Table]
_lib: Optional[ctypes.CDLL] = None


def load_library() -> ctypes.CDLL:
    """Build (first call only) and load the kernel's shared library."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_shared_library(SOURCE, "grid_sdf")))
        fn = lib.grid_sdf_lookup
        p, f, i = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
        fn.argtypes = [p, ctypes.c_longlong, p, p, p, p, i, i, f, f, f, f,
                       p, p, p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def box_span(lower, upper) -> Tuple[float, float]:
    """upper - lower in float32, as the JAX lookup computes it."""
    return tuple(float(s) for s in (np.asarray(upper, np.float32)
                                    - np.asarray(lower, np.float32)))


def cell_index(points: torch.Tensor, shape, lower, upper):
    """floor((x - lo) / span * n) clamped to the grid (grid_map_sdf.py:100-104)."""
    kw = dict(dtype=torch.float32, device=points.device)
    lo = torch.tensor(lower, **kw)
    span = torch.tensor(box_span(lower, upper), **kw)
    n = torch.tensor([float(s) for s in shape], **kw)
    f = torch.floor((points - lo) / span * n)
    f = torch.minimum(torch.clamp(f, min=0.0), n - 1.0)
    idx = f.to(torch.int64)
    return idx[..., 0], idx[..., 1]


def grid_lookup_plain(points: torch.Tensor, tables: Tables, lower,
                      upper) -> Tuple[torch.Tensor, torch.Tensor]:
    """points (..., 2) -> (values (2, ...), grads (2, ..., 2))."""
    (v0, g0), (v1, g1) = tables
    i, j = cell_index(points, v0.shape, lower, upper)
    return torch.stack([v0[i, j], v1[i, j]]), torch.stack([g0[i, j], g1[i, j]])


def _check_cuda_args(points: torch.Tensor, tables: Tables):
    if points.dtype != torch.float32 or points.shape[-1] != 2:
        raise ValueError(f"points must be float32 (..., 2), got {points.dtype} "
                         f"{tuple(points.shape)}")
    shape = tables[0][0].shape
    for v, g in tables:
        if v.dim() != 2 or v.shape != shape or g.shape != (*shape, 2):
            raise ValueError("grids must share one (N0, N1) shape with "
                             "(N0, N1, 2) gradients")
        for t in (v, g):
            if t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError("grids must be contiguous float32")
            if t.device != points.device:
                raise ValueError("grids and points must be on one device")


def grid_lookup_cuda(points: torch.Tensor, tables: Tables, lower,
                     upper) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel: same contract as `grid_lookup_plain`."""
    _check_cuda_args(points, tables)
    (v0, g0), (v1, g1) = tables
    batch = points.shape[:-1]
    pts = points.reshape(-1, 2).contiguous()
    if pts.data_ptr() % 8:  # the kernel reads each point as one float2
        pts = pts.clone()
    n = pts.shape[0]
    out_vals = torch.empty((2, n), dtype=torch.float32, device=points.device)
    out_grads = torch.empty((2, n, 2), dtype=torch.float32, device=points.device)
    if n > 0:
        lib = load_library()
        span = box_span(lower, upper)
        stream = torch.cuda.current_stream(points.device).cuda_stream
        rc = lib.grid_sdf_lookup(
            pts.data_ptr(), n, v0.data_ptr(), g0.data_ptr(), v1.data_ptr(),
            g1.data_ptr(), v0.shape[0], v0.shape[1],
            float(lower[0]), float(lower[1]), span[0], span[1],
            out_vals.data_ptr(), out_grads.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"grid_sdf_lookup launch failed: cudaError {rc}")
        grid_lookup.launches += 1
    return out_vals.reshape(2, *batch), out_grads.reshape(2, *batch, 2)


def grid_lookup(points: torch.Tensor, tables: Tables, lower,
                upper) -> Tuple[torch.Tensor, torch.Tensor]:
    """points (..., 2) -> (values (2, ...), grads (2, ..., 2)).

    CUDA tensors go to the kernel, CPU tensors to the plain version.
    """
    if points.is_cuda:
        return grid_lookup_cuda(points, tables, lower, upper)
    if points.device.type == "cpu":
        return grid_lookup_plain(points, tables, lower, upper)
    raise ValueError(f"grid_lookup: unsupported device {points.device}")


grid_lookup.launches = 0
