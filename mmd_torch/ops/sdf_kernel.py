"""Batched grid-SDF lookup: cell value + precomputed cell gradient.

Twin of `mmd_tpu/ops/sdf_kernel.py`. On a CUDA tensor `grid_lookup` launches
the hand-written kernel of `mmd_torch/csrc/grid_sdf.cu` (built with nvcc at
first use, bound with ctypes); on a CPU tensor it runs `grid_lookup_plain`,
the same arithmetic in plain torch. It never falls back from one to the
other. `grid_lookup.launches` counts kernel launches.

A lookup reads two tables, a scene's object grid and its extra-objects
grid, in one launch. Each table is a `(values (N0, N1), grads (N0, N1, 2))`
pair; both share one shape and one box `[lower, upper]`. Both versions read
the two grids through one packed record per cell (`packed_cells`: v0, g0x,
g0y, v1, g1x, g1y, 0, 0, 32 bytes), built once for the four tensors and
kept while they live; a scene's collision-guide table
(`mmd_torch/ops/collision_guide.py`) is that same tensor.
"""
from __future__ import annotations

import ctypes
import functools
import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from mmd_torch.ops.build import CSRC_DIR, build_shared_libraries

SOURCE = CSRC_DIR / "grid_sdf.cu"
# The TPU kernel this one replaces (file:line of its body).
REPLACES = "mmd_tpu/ops/sdf_kernel.py:50"

RECORD = 8  # float32 per packed cell: v0, g0x, g0y, v1, g1x, g1y, 0, 0

Table = Tuple[torch.Tensor, torch.Tensor]
Tables = Tuple[Table, Table]
_lib: Optional[ctypes.CDLL] = None
# id()s of (v0, g0, v1, g1) -> (weak references to them, their versions,
# the packed cells).
_packed: Dict[tuple, tuple] = {}


def packed_cells(tables: Tables) -> torch.Tensor:
    """Both grids of `tables` as one (N0, N1, RECORD) float32 record per
    cell on their device, built at the first call for these four tensors
    and returned again while they live and are unchanged."""
    (v0, g0), (v1, g1) = tables
    ts = (v0, g0, v1, g1)
    key = tuple(id(t) for t in ts)
    versions = tuple(t._version for t in ts)
    hit = _packed.get(key)
    if hit is not None and all(r() is t for r, t in zip(hit[0], ts)) and hit[1] == versions:
        return hit[2]
    shape = v0.shape
    if (v0.dim() != 2 or v1.shape != shape or g0.shape != (*shape, 2)
            or g1.shape != (*shape, 2)):
        raise ValueError("grids must share one (N0, N1) shape with (N0, N1, 2) gradients")
    cells = torch.cat([v0[..., None], g0, v1[..., None], g1, torch.zeros_like(g0)],
                      dim=-1).to(torch.float32).contiguous()
    refs = tuple(weakref.ref(t, lambda _, k=key: _packed.pop(k, None)) for t in ts)
    _packed[key] = (refs, versions, cells)
    return cells


def load_library() -> ctypes.CDLL:
    """Build (first call only) and load the kernel's shared library."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_shared_libraries([SOURCE])[0]))
        p, f, i = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
        lib.grid_sdf_lookup.argtypes = [p, ctypes.c_longlong, p, i, i, f, f, f, f, p, p, p]
        lib.grid_sdf_lookup.restype = ctypes.c_int
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=16)
def box_span(lower: Tuple[float, ...], upper: Tuple[float, ...]) -> Tuple[float, ...]:
    """upper - lower in float32, as the JAX lookup computes it; computed
    once per box (a grid's box is a tuple of host floats)."""
    return tuple(float(s) for s in (np.asarray(upper, np.float32)
                                    - np.asarray(lower, np.float32)))


def cell_index(points: torch.Tensor, shape, lower, upper):
    """floor((x - lo) / span * n) clamped to the grid (grid_map_sdf.py:100-104).
    A NaN coordinate reads cell 0, as in JAX (XLA converts NaN to integer 0)
    and in the kernel (fmaxf(NaN, 0) is 0)."""
    kw = dict(dtype=torch.float32, device=points.device)
    lo = torch.tensor(lower, **kw)
    span = torch.tensor(box_span(lower, upper), **kw)
    n = torch.tensor([float(s) for s in shape], **kw)
    f = torch.nan_to_num(torch.floor((points - lo) / span * n), nan=0.0)
    f = torch.minimum(torch.clamp(f, min=0.0), n - 1.0)
    idx = f.to(torch.int64)
    return idx[..., 0], idx[..., 1]


def grid_lookup_plain(points: torch.Tensor, tables: Tables, lower,
                      upper) -> Tuple[torch.Tensor, torch.Tensor]:
    """points (..., 2) -> (values (2, ...), grads (2, ..., 2)), each point's
    floor-cell record gathered from `packed_cells`."""
    cells = packed_cells(tables)
    i, j = cell_index(points, cells.shape[:2], lower, upper)
    rec = cells[i, j]
    return (torch.stack([rec[..., 0], rec[..., 3]]),
            torch.stack([rec[..., 1:3], rec[..., 4:6]]))


def _check_cuda_args(points: torch.Tensor, tables: Tables):
    if points.dtype != torch.float32 or points.shape[-1] != 2:
        raise ValueError(f"points must be float32 (..., 2), got {points.dtype} "
                         f"{tuple(points.shape)}")
    for v, g in tables:
        for t in (v, g):
            if t.dtype != torch.float32:
                raise ValueError("grids must be float32")
            if t.device != points.device:
                raise ValueError("grids and points must be on one device")


def grid_lookup_cuda(points: torch.Tensor, tables: Tables, lower,
                     upper) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel: same contract as `grid_lookup_plain`."""
    _check_cuda_args(points, tables)
    cells = packed_cells(tables)
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
            pts.data_ptr(), n, cells.data_ptr(), cells.shape[0], cells.shape[1],
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
