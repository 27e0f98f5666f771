"""The TemporalUnet denoiser as plain functions over a flax parameter tree.

x (B, H, D) and the step t (B,) give epsilon (B, H, D). Inside, the
activations are (B, C, H). A residual block is two Conv1d(k=5) ->
GroupNorm(8, eps 1e-6) -> Mish blocks with the time embedding's Dense
added after the first, and a 1x1 convolution on the skip where the
channels change. The levels run down with a stride-2 Conv1d(k=3) between
them, then two middle blocks, then up with the skip connections
concatenated and a stride-2 transposed Conv1d(k=4). The time embedding is
a sinusoidal embedding of width 32, Dense(128), Mish, Dense(32).

Flax stores a convolution's kernel as (k, in, out) and a Dense's as
(in, out). Its transposed convolution (`ConvTranspose`, padding SAME,
`transpose_kernel=False`) is a correlation of the 2x-dilated input, which
is `conv_transpose1d(stride 2, padding 1)` with the kernel flipped in k.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch
from torch.nn import functional as F

GROUPNORM_EPS = 1e-6
GROUPS = 8


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def _t(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=device)


class Unet:
    """The forward of one checkpoint's TemporalUnet in float32."""

    def __init__(self, params: Dict, dim_mults: Sequence[int], device):
        self.p = params
        self.n_levels = len(dim_mults)
        self.device = torch.device(device)
        self._cache: Dict[tuple, torch.Tensor] = {}

    def _leaf(self, path: tuple, layout: str) -> torch.Tensor:
        key = (path, layout)
        if key not in self._cache:
            node = self.p
            for k in path:
                node = node[k]
            a = np.asarray(node, np.float32)
            if layout == "conv":
                a = a.transpose(2, 1, 0)
            elif layout == "conv_t":
                a = a.transpose(1, 2, 0)[:, :, ::-1]
            elif layout == "dense":
                a = a.T
            self._cache[key] = _t(a, self.device)
        return self._cache[key]

    def _dense(self, path, x):
        return F.linear(x, self._leaf(path + ("kernel",), "dense"),
                        self._leaf(path + ("bias",), "same"))

    def _conv(self, path, x, stride=1, padding=0):
        return F.conv1d(x, self._leaf(path + ("kernel",), "conv"),
                        self._leaf(path + ("bias",), "same"), stride, padding)

    def _conv_block(self, path, x):
        h = self._conv(path + ("Conv_0",), x, padding=2)
        h = F.group_norm(h, GROUPS, self._leaf(path + ("GroupNorm_0", "scale"), "same"),
                         self._leaf(path + ("GroupNorm_0", "bias"), "same"), GROUPNORM_EPS)
        return mish(h)

    def _res_block(self, r: int, x, c):
        path = (f"ResidualTemporalBlock_{r}",)
        h = (self._conv_block(path + ("Conv1dBlock_0",), x)
             + self._dense(path + ("Dense_0",), mish(c))[:, :, None])
        h = self._conv_block(path + ("Conv1dBlock_1",), h)
        node = self.p[path[0]]
        return h + (self._conv(path + ("Conv_0",), x) if "Conv_0" in node else x)

    def time_embedding(self, t: torch.Tensor) -> torch.Tensor:
        half = 16
        freq = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                         * (-math.log(10000.0) / (half - 1)))
        ang = t.to(torch.float32)[:, None] * freq[None, :]
        h = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
        h = mish(self._dense(("TimeEncoder_0", "Dense_0"), h))
        return self._dense(("TimeEncoder_0", "Dense_1"), h)

    @torch.no_grad()
    def __call__(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        c = self.time_embedding(t)
        x = x.transpose(1, 2)
        skips, r = [], 0
        for lvl in range(self.n_levels):
            x = self._res_block(r, x, c)
            x = self._res_block(r + 1, x, c)
            r += 2
            skips.append(x)
            if lvl < self.n_levels - 1:
                x = self._conv((f"Downsample1d_{lvl}", "Conv_0"), x, stride=2, padding=1)
        x = self._res_block(r + 1, self._res_block(r, x, c), c)
        r += 2
        for lvl in range(self.n_levels - 1):
            x = torch.cat([x, skips.pop()], dim=1)
            x = self._res_block(r + 1, self._res_block(r, x, c), c)
            r += 2
            path = (f"Upsample1d_{lvl}", "ConvTranspose_0")
            x = F.conv_transpose1d(x, self._leaf(path + ("kernel",), "conv_t"),
                                   self._leaf(path + ("bias",), "same"), stride=2, padding=1)
        x = self._conv_block(("Conv1dBlock_0",), x)
        x = self._conv(("Conv_0",), x)
        return x.transpose(1, 2)
