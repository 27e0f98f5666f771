"""FLOP accounting of the planners' UNet work, for the bench's MFU line.

Twin of the accounting half of `mmd_tpu/utils/baked.py:41-99`
(`loop_unet_evals`; `xla_flops` for one forward). The JAX package counts
UNet forwards in a global (`add_unet_evals`, `reset_flop_counters`)
because its fused device programs hide their loop trip counts from XLA's
cost analysis. The port runs its loops on the host, so a search counts its
own: `CBS.timing["unet_forwards"]` (and PP's), reset by each `plan()`, is
that global's twin. One forward's FLOPs come from
`torch.utils.flop_counter.FlopCounterMode` (the convolutions and matmuls),
as `tools.train_bench` counts a training step.

The rest of `baked.py`, its program cache, and `utils/cache.py`, the
persistent XLA cache, have no counterpart: the port compiles no program.
Its one compiled artifact, the kernel libraries, is cached by
`mmd_torch/ops/build.py` under `build/`.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.flop_counter import FlopCounterMode


def loop_unet_evals(cfg, local: bool, n_denoise: int) -> int:
    """UNet forwards of one sampling loop, with baked.py:56-67's signature:
    the config's own count (`DiffusionConfig.n_unet_forwards`), which a
    search adds to timing["unet_forwards"]."""
    return cfg.n_unet_forwards(n_denoise if local else None)


def unet_forward_flops(model, batch: int, horizon: int, state_dim: int,
                       context_dim: Optional[int] = None) -> int:
    """FLOPs of one forward of `model` on a (batch, horizon, state_dim)
    input on the model's device (and a (batch, context_dim) context where
    given), as FlopCounterMode counts them."""
    device = next(model.parameters()).device
    x = torch.zeros((batch, horizon, state_dim), device=device)
    t = torch.zeros((batch,), dtype=torch.int64, device=device)
    args = (x, t) if context_dim is None else (
        x, t, torch.zeros((batch, context_dim), device=device))
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(*args)
    return int(counter.get_total_flops())


def mfu_pct(unet_evals: float, forward_flops: float, seconds: float,
            peak_flops: Optional[float]) -> Optional[float]:
    """100 * unet_evals * forward_flops / seconds / peak_flops: the model
    FLOPs' share of the peak over `seconds`; None without a peak or time."""
    if not peak_flops or seconds <= 0:
        return None
    return 100.0 * unet_evals * forward_flops / seconds / peak_flops
