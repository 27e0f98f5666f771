"""The collision-guide kernel's binding: its scene table, build and launch.

`collision_guide(u, scene, cfg)` launches the hand-written kernel of
`mmd_torch/csrc/collision_guide.cu` (built with nvcc at first use, bound
with ctypes) on a CUDA tensor u (..., H, 4) of unnormalized trajectories and
returns

    w * _finish(d/du collision_cost_objects(u))
      + w * _finish(d/du collision_cost_boundaries(u))

with w = cfg.weight_collision (twin of `mmd_tpu/costs/guide.py:106-136,
147-152`). It refuses any other tensor. The plain version, and the choice
between the two by device, are `collision_guide_plain` and
`collision_gradient` in `mmd_torch/costs/guide.py`.
`collision_guide.launches` counts kernel launches.

The kernel reads a scene through its `GuideTable`, built once per scene
(`SceneData.guide_table`): both SDF grids packed into one record of eight
float32 per cell (the grid-SDF lookup's own `packed_cells`, the same
tensor), and the box and wall constants as host floats. A
multi-tile plan's T scenes are one stacked table (`GuideTable.stack`, built
once per `SceneStack`): u is then (T, B, H, 4), tile m's rows read scene m,
and one launch covers all T tiles. Stacked scenes must share the box and
wall constants, which every map does.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from mmd_torch.ops.build import CSRC_DIR, build_shared_libraries
from mmd_torch.ops.sdf_kernel import RECORD, box_span, packed_cells  # noqa: F401 (RECORD)

SOURCE = CSRC_DIR / "collision_guide.cu"
# The TPU kernel whose work on the guide's path this one takes over.
REPLACES = "mmd_tpu/ops/sdf_kernel.py:50"

_lib: Optional[ctypes.CDLL] = None


@dataclasses.dataclass(frozen=True)
class GuideTable:
    """A scene as the kernel reads it."""

    cells: torch.Tensor             # (N0, N1, RECORD), or (T, N0, N1, RECORD)
    #                                 stacked over tiles; float32, contiguous
    lower: Tuple[float, float]      # grid box, host floats
    span: Tuple[float, float]       # upper - lower in float32
    wall_lo: Tuple[float, float]    # the walls' box, as the boundary field
    wall_hi: Tuple[float, float]    # computes it in float32

    @staticmethod
    def build(grid, extra_grid, wall_lo: Sequence[float],
              wall_hi: Sequence[float]) -> "GuideTable":
        """Pack two `GridSDF`s of one shape and box, on their device: the
        lookup's own packed record (`packed_cells`), one tensor for both
        kernels."""
        if (grid.shape != extra_grid.shape or grid.lower != extra_grid.lower
                or grid.upper != extra_grid.upper):
            raise ValueError("the two grids must share one shape and box")
        cells = packed_cells(((grid.values, grid.grads), (extra_grid.values, extra_grid.grads)))
        return GuideTable(cells=cells, lower=tuple(grid.lower),
                          span=box_span(grid.lower, grid.upper),
                          wall_lo=tuple(wall_lo), wall_hi=tuple(wall_hi))

    @property
    def n_tiles(self) -> Optional[int]:
        """T of a stacked table, None for one scene's."""
        return self.cells.shape[0] if self.cells.dim() == 4 else None

    @staticmethod
    def stack(tables: Sequence["GuideTable"]) -> "GuideTable":
        """T single-scene tables as one (T, N0, N1, RECORD) table. Refuses
        tables whose grid shape, grid box or wall box differ: the kernel
        takes those as one set of constants."""
        t0 = tables[0]
        for t in tables[1:]:
            if (t.cells.shape != t0.cells.shape or t.lower != t0.lower
                    or t.span != t0.span or t.wall_lo != t0.wall_lo
                    or t.wall_hi != t0.wall_hi):
                raise ValueError("stacked scenes must share one grid shape, grid "
                                 "box and wall box")
        return dataclasses.replace(t0, cells=torch.stack([t.cells for t in tables]))


def load_library() -> ctypes.CDLL:
    """Build (first call only) and load the kernel's shared library."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_shared_libraries([SOURCE])[0]))
        fn = lib.collision_guide
        p, f, i = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
        ll = ctypes.c_longlong
        fn.argtypes = [p, ll, i, ll, p, i, i, f, f, f, f, f, f, f, f, f, f, f, p, p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_cuda_args(u: torch.Tensor, table: GuideTable):
    if (u.dtype != torch.float32 or u.dim() < 2 or u.shape[-1] != 4
            or u.shape[-2] < 2):
        raise ValueError(f"u must be float32 (..., H >= 2, 4), got {u.dtype} "
                         f"{tuple(u.shape)}")
    if table.n_tiles is not None and (u.dim() < 3 or u.shape[0] != table.n_tiles):
        raise ValueError(f"a table of {table.n_tiles} stacked scenes needs u of "
                         f"(T={table.n_tiles}, ..., H, 4), got {tuple(u.shape)}")
    if not u.is_contiguous() or u.data_ptr() % 16:
        raise ValueError("u must be contiguous and 16-byte aligned: the kernel "
                         "reads each waypoint as one float4")
    if not u.is_cuda:
        raise ValueError(f"u must be a CUDA tensor, got one on {u.device}")
    if table.cells.device != u.device:
        raise ValueError(f"the scene's table is on {table.cells.device}, "
                         f"u on {u.device}")


def collision_guide(u: torch.Tensor, scene, cfg) -> torch.Tensor:
    """u (..., H, 4) unnormalized, on the card -> the guide's collision step
    (..., H, 4), by the CUDA kernel. With a stacked scene (`SceneStack`) u
    is (T, ..., H, 4) and tile m's rows read scene m, in the same one
    launch."""
    table = scene.guide_table
    _check_cuda_args(u, table)
    out = torch.empty_like(u)
    n_rows = u.numel() // 4
    if n_rows > 0:
        lib = load_library()
        stream = torch.cuda.current_stream(u.device).cuda_stream
        n0, n1 = table.cells.shape[-3:-1]
        rc = lib.collision_guide(
            u.data_ptr(), n_rows, u.shape[-2], n_rows // (table.n_tiles or 1),
            table.cells.data_ptr(), n0, n1,
            *table.lower, *table.span, *table.wall_lo, *table.wall_hi,
            cfg.collision_margin, cfg.weight_collision, cfg.max_grad_norm,
            out.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"collision_guide launch failed: cudaError {rc}")
        collision_guide.launches += 1
    return out


collision_guide.launches = 0
