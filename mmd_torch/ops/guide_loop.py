"""The guide-loop kernel's binding: its arguments, build and launch.

`guide_loop_cuda(x, gd, hard, cfg, n_steps)` launches the hand-written
kernel of `mmd_torch/csrc/guide_loop.cu` (built with nvcc at first use,
bound with ctypes) on a CUDA tensor x of normalized trajectories and
returns x after n_steps iterations of

    x <- hard.apply(x + guide_gradient(x, gd, cfg))

in one launch: the guide loop of one guided diffusion step (JAX's
`fori_loop`, `mmd_tpu/models/diffusion.py:105-110`). It refuses any other
tensor, and a config it does not compute (`GuideConfig.guide_loop_applies`).
The plain version and the choice between the two by device are
`guide_loop_plain` and `guide_loop` in `mmd_torch/costs/guide.py`.
`guide_loop_cuda.launches` counts kernel launches.

x is (B, H, 4), or G groups' (G, B, H, 4): N problems on one scene, or a
tile stack's T tiles (`gd.scene` a `SceneStack`). Each per-group input may
be shared or given a group: the normalizer's limits (4,) or (G, 1, 1, 4),
the hard mask and values as they broadcast against x, the constraint set
(K, P, ...) or (G, K, P, ...), the soft paths (R, H, 2) or (G, R, H, 2)
with a radius and weight () or (G,). The wrapper passes each with its
strides, so a broadcast or expanded input is read in place.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from mmd_torch.costs.gp import gp_matrices
from mmd_torch.ops.build import CSRC_DIR, build_shared_libraries

SOURCE = CSRC_DIR / "guide_loop.cu"
# The TPU kernel whose work on the sampler's path this one takes over,
# with the loop around it.
REPLACES = "mmd_tpu/ops/sdf_kernel.py:50"
# Dynamic shared memory a block may take on the H100 (227 KB).
SMEM_LIMIT = 232448
MAX_HORIZON = 1024

_lib: Optional[ctypes.CDLL] = None

_P, _LL, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float


class _Args(ctypes.Structure):
    """`GuideLoopArgs` of guide_loop.cu, field for field."""

    _fields_ = ([(n, _P) for n in ("x", "out", "mins", "maxs", "mask", "values", "cells",
                                   "cq", "ct", "cr", "cpm", "cw", "ca", "sp", "sm", "sr",
                                   "sw")]
                + [(n, _LL) for n in ("norm_gs", "mask_gs", "mask_bs", "mask_hs", "val_gs",
                                      "val_bs", "val_hs", "table_gs", "cset_gs", "sp_gs",
                                      "sp_rs", "sp_hs", "sm_gs", "sm_rs", "sm_hs", "sr_gs",
                                      "sw_gs")]
                + [(n, _I) for n in ("G", "B", "H", "n_steps", "K", "P", "R", "n0", "n1")]
                + [(n, _F) for n in ("lo0", "lo1", "span0", "span1", "wall_lo0", "wall_lo1",
                                     "wall_hi0", "wall_hi1", "margin", "w_collision",
                                     "max_norm", "dt", "q_pp", "q_pv", "q_vv", "w_smooth")])


def load_library() -> ctypes.CDLL:
    """Build (first call only) and load the kernel's shared library."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_shared_libraries([SOURCE])[0]))
        lib.guide_loop.argtypes = [ctypes.POINTER(_Args), _LL, _P]
        lib.guide_loop.restype = ctypes.c_int
        _lib = lib
    return _lib


def staging_bytes(H: int, K: int, P: int, R: int) -> int:
    """A block's dynamic shared memory: the warps' edge slots (two float4
    a warp, two buffers) and the staged constraint set and soft paths."""
    n_warps = (H + 31) // 32
    return 64 * n_warps + 4 * (6 * K * P + 2 * K + 3 * R * H)


def gp_constants(dt: float):
    """Phi's dt and Q's three distinct entries, the float32 values the GP
    prior's cost uses (`mmd_torch/costs/gp.py`)."""
    phi, q_inv = gp_matrices(2, dt)
    return tuple(float(v) for v in (phi[0, 2], q_inv[0, 0], q_inv[0, 2], q_inv[2, 2]))


def _group_stride(t: torch.Tensor, dims: int, G: int, what: str) -> int:
    """0 for a tensor of `dims` dimensions shared by every group, its
    leading stride for one with a leading group axis of G."""
    if t.dim() == dims:
        return 0
    if t.dim() == dims + 1 and t.shape[0] == G:
        return t.stride(0)
    raise ValueError(f"{what} of shape {tuple(t.shape)} is neither shared nor one of "
                     f"{G} groups")


def _check_x(x: torch.Tensor):
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        raise ValueError(f"x must be a float32 tensor, got {getattr(x, 'dtype', type(x))}")
    if x.dim() not in (3, 4) or x.shape[-1] != 4 or not 2 <= x.shape[-2] <= MAX_HORIZON:
        raise ValueError(f"x must be (B, H, 4) or (G, B, H, 4) with 2 <= H <= {MAX_HORIZON}, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned: the kernel reads each "
                         "waypoint as one float4")


def guide_loop_cuda(x: torch.Tensor, gd, hard, cfg, n_steps: int) -> torch.Tensor:
    """x (B, H, 4) or (G, B, H, 4), normalized, on the card -> x after
    n_steps guide iterations under the hard conditions, by the CUDA kernel
    in one launch (none for n_steps == 0)."""
    _check_x(x)
    if not cfg.guide_loop_applies:
        raise ValueError("the guide-loop kernel computes the default collision terms and no "
                         "zoo term; this config takes the per-iteration loop")
    G, B, H = (1, *x.shape[:2]) if x.dim() == 3 else x.shape[:3]
    cs, spc = gd.constraints, gd.soft_paths
    K, P = (cs.max_constraints, cs.max_points) if cs.n_active > 0 else (0, 0)
    R = spc.rows if spc is not None else 0
    smem = staging_bytes(H, K, P, R)
    if smem > SMEM_LIMIT:
        raise ValueError(f"staging (K, P, R, H) = ({K}, {P}, {R}, {H}) takes {smem} B of "
                         f"shared memory, over the {SMEM_LIMIT} B a block may have")
    if not x.is_cuda:
        raise ValueError(f"x must be a CUDA tensor, got one on {x.device}")
    if n_steps == 0 or B == 0:
        return x
    dev = x.device
    keep = []  # every tensor the launch reads, alive until it is enqueued

    def ptr(t: torch.Tensor) -> int:
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"an input of the guide loop is {t.dtype} on {t.device}, not "
                             f"float32 on {dev}")
        keep.append(t)
        return t.data_ptr()

    a = _Args(G=G, B=B, H=H, n_steps=n_steps)
    a.x = ptr(x)
    out = torch.empty_like(x)
    a.out = ptr(out)

    norm = gd.normalizer
    mins, maxs = norm.mins.reshape(-1, 4), norm.maxs.reshape(-1, 4)
    if mins.shape != maxs.shape or mins.shape[0] not in (1, G):
        raise ValueError(f"normalizer limits of shape {tuple(norm.mins.shape)} for {G} groups")
    mins, maxs = mins.contiguous(), maxs.contiguous()
    a.mins, a.maxs = ptr(mins), ptr(maxs)
    a.norm_gs = 0 if mins.shape[0] == 1 else 4

    mask = torch.broadcast_to(hard.mask, (G, B, H, 1))
    a.mask = ptr(mask)
    a.mask_gs, a.mask_bs, a.mask_hs = mask.stride()[:3]
    values = hard.values if hard.values.stride(-1) == 1 else hard.values.contiguous()
    values = torch.broadcast_to(values, (G, B, H, 4))
    a.values = ptr(values)
    a.val_gs, a.val_bs, a.val_hs = values.stride()[:3]

    table = gd.scene.guide_table
    if table.n_tiles is not None and (x.dim() != 4 or table.n_tiles != G):
        raise ValueError(f"a table of {table.n_tiles} stacked scenes needs x of (T, B, H, 4), "
                         f"got {tuple(x.shape)}")
    a.cells = ptr(table.cells)
    a.n0, a.n1 = table.cells.shape[-3:-1]
    a.table_gs = 0 if table.n_tiles is None else a.n0 * a.n1
    a.lo0, a.lo1 = table.lower
    a.span0, a.span1 = table.span
    a.wall_lo0, a.wall_lo1 = table.wall_lo
    a.wall_hi0, a.wall_hi1 = table.wall_hi
    a.margin, a.w_collision = cfg.collision_margin, cfg.weight_collision
    a.max_norm, a.w_smooth = cfg.max_grad_norm, cfg.weight_smoothness
    a.dt, a.q_pp, a.q_pv, a.q_vv = gp_constants(cfg.dt)

    if K > 0:
        if cs.q.shape[-1] != 2:
            raise ValueError(f"constraint centres of {cs.q.shape[-1]} coordinates, not 2")
        a.K, a.P = K, P
        fields = [getattr(cs, n).contiguous() for n in ("q", "t_range", "radius", "point_mask",
                                                         "weight", "active")]
        a.cq, a.ct, a.cr, a.cpm, a.cw, a.ca = (ptr(t) for t in fields)
        a.cset_gs = 0 if _group_stride(cs.q, 3, G, "the constraint set") == 0 else 1

    if R > 0:
        if spc.points.shape[-2:] != (H, 2):
            raise ValueError(f"soft paths of shape {tuple(spc.points.shape)} for H = {H}")
        a.R = R
        pts = spc.points if spc.points.stride(-1) == 1 else spc.points.contiguous()
        a.sp = ptr(pts)
        a.sp_gs = _group_stride(pts, 3, G, "the soft paths")
        a.sp_rs, a.sp_hs = pts.stride()[-3:-1]
        a.sm = ptr(spc.mask)
        a.sm_gs = _group_stride(spc.mask, 2, G, "the soft mask")
        a.sm_rs, a.sm_hs = spc.mask.stride()[-2:]
        a.sr, a.sw = ptr(spc.radius), ptr(spc.weight)
        a.sr_gs = _group_stride(spc.radius, 0, G, "the soft radius")
        a.sw_gs = _group_stride(spc.weight, 0, G, "the soft weight")

    lib = load_library()
    rc = lib.guide_loop(ctypes.byref(a), smem, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"guide_loop launch failed: cudaError {rc}")
    guide_loop_cuda.launches += 1
    return out


guide_loop_cuda.launches = 0
