"""A denoiser evaluated a fixed number of rows at a time.

A batched sampler call runs N problems' B samples through the UNet as one
(N * B, H, D) batch. Convolutions choose their float32 summation order by
batch size (cuDNN its algorithm on the card, the CPU its blocking), so a
row of that batch need not equal the same row run at B rows. Wrapping the
UNet in `RowChunked(model, B)` runs it B rows at a time, so that a batched
call can be held step by step against its single calls on what the
batching itself does: the hard conditions, the draws, the constraints, the
guide, the noise and the finalize. `chip_smoke.py` and the port's tests use
it; no planner does.
"""
from __future__ import annotations

import torch


class RowChunked(torch.nn.Module):
    """`model` evaluated `rows` rows of its batch at a time."""

    def __init__(self, model: torch.nn.Module, rows: int):
        super().__init__()
        self.model, self.rows = model, rows

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.model(x[i:i + self.rows], t[i:i + self.rows])
                          for i in range(0, x.shape[0], self.rows)])
