"""Temporal 1D-conv UNet denoiser, and the converter from flax parameters.

Twin of `TemporalUnet` in `mmd_tpu/models/temporal_unet.py` without
attention or context, which no checkpoint uses (reference:
mmd/models/diffusion_models/temporal_unet.py:23-174, layers.py). The public
forward keeps the JAX layout: x (B, H, D), t (B,) -> (B, H, D). Inside, the
convolutions run in torch's (B, C, H) layout.

`convert_flax_params` maps a flax parameter tree (nested dicts of numpy
arrays, as `mmd_torch.io.msgpack` reads them) onto this module's
state_dict:
- Conv kernels are (k, in, out) in flax and (out, in, k) in torch; Dense
  kernels are (in, out) in flax and (out, in) in torch.
- flax GroupNorm uses eps 1e-6 (torch's default is 1e-5).
- `Upsample1d` is flax `ConvTranspose(k=4, s=2, padding="SAME")` with
  `transpose_kernel=False`: a plain correlation of the 2x-dilated input
  padded by (2, 2). torch's `ConvTranspose1d(k=4, s=2, padding=1)` computes
  the same with the kernel flipped along k, and gives the same 2H outputs.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

GROUPNORM_EPS = 1e-6  # flax nn.GroupNorm default


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


class SinusoidalPosEmb(nn.Module):
    """reference: layers.py:246-258."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t: torch.Tensor) -> torch.Tensor:  # (B,) -> (B, dim)
        half = self.dim // 2
        freq = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                         * (-math.log(10000.0) / (half - 1)))
        ang = t.to(torch.float32)[:, None] * freq[None, :]
        return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class TimeEncoder(nn.Module):
    """Sin(dim) -> Linear(4 dim) -> Mish -> Linear(out) (layers.py:232-243)."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.pos = SinusoidalPosEmb(dim)
        self.dense0 = nn.Linear(dim, dim * 4)
        self.dense1 = nn.Linear(dim * 4, dim_out)

    def forward(self, t):
        return self.dense1(mish(self.dense0(self.pos(t))))


class Conv1dBlock(nn.Module):
    """Conv1d -> GroupNorm -> Mish (layers.py:279-296), on (B, C, H)."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int = 5, n_groups: int = 8):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, kernel_size, padding=kernel_size // 2)
        self.norm = nn.GroupNorm(n_groups, c_out, eps=GROUPNORM_EPS)

    def forward(self, x):
        return mish(self.norm(self.conv(x)))


class ResidualTemporalBlock(nn.Module):
    """Two conv blocks + FiLM time-add + 1x1 residual (layers.py:326-359)."""

    def __init__(self, c_in: int, c_out: int, emb_dim: int, kernel_size: int = 5):
        super().__init__()
        self.block0 = Conv1dBlock(c_in, c_out, kernel_size)
        self.block1 = Conv1dBlock(c_out, c_out, kernel_size)
        self.time = nn.Linear(emb_dim, c_out)
        self.res = nn.Conv1d(c_in, c_out, 1) if c_in != c_out else None

    def forward(self, x, c):  # x (B, C, H), c (B, E)
        h = self.block0(x) + self.time(mish(c))[:, :, None]
        h = self.block1(h)
        return h + (self.res(x) if self.res is not None else x)


class TemporalUnet(nn.Module):
    """Denoiser: x (B, H, D), t (B,) -> epsilon (B, H, D)."""

    def __init__(self, state_dim: int = 4, unet_input_dim: int = 32,
                 dim_mults: Tuple[int, ...] = (1, 2, 4), time_emb_dim: int = 32):
        super().__init__()
        self.state_dim = state_dim
        self.unet_input_dim = unet_input_dim
        self.dim_mults = tuple(dim_mults)
        self.time_mlp = TimeEncoder(32, time_emb_dim)
        dims = [state_dim] + [unet_input_dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        E = time_emb_dim

        self.downs = nn.ModuleList()
        for ind, (d_in, d_out) in enumerate(in_out):
            is_last = ind >= len(in_out) - 1
            self.downs.append(nn.ModuleList([
                ResidualTemporalBlock(d_in, d_out, E),
                ResidualTemporalBlock(d_out, d_out, E),
                nn.Identity() if is_last else nn.Conv1d(d_out, d_out, 3, stride=2, padding=1),
            ]))
        mid = dims[-1]
        self.mid0 = ResidualTemporalBlock(mid, mid, E)
        self.mid1 = ResidualTemporalBlock(mid, mid, E)
        self.ups = nn.ModuleList()
        for d_in, d_out in reversed(in_out[1:]):
            self.ups.append(nn.ModuleList([
                ResidualTemporalBlock(d_out * 2, d_in, E),
                ResidualTemporalBlock(d_in, d_in, E),
                nn.ConvTranspose1d(d_in, d_in, 4, stride=2, padding=1),
            ]))
        self.final_block = Conv1dBlock(unet_input_dim, unet_input_dim)
        self.final_conv = nn.Conv1d(unet_input_dim, state_dim, 1)

    def forward(self, x: torch.Tensor, time: torch.Tensor) -> torch.Tensor:
        c = self.time_mlp(time)
        x = x.transpose(1, 2)  # (B, D, H)
        h_stack = []
        for res0, res1, down in self.downs:
            x = res1(res0(x, c), c)
            h_stack.append(x)
            x = down(x)
        x = self.mid1(self.mid0(x, c), c)
        for res0, res1, up in self.ups:
            x = torch.cat([x, h_stack.pop()], dim=1)
            x = up(res1(res0(x, c), c))
        x = self.final_conv(self.final_block(x))
        return x.transpose(1, 2)


# ------------------------------------------------------------- conversion
def _conv(w: np.ndarray) -> np.ndarray:      # (k, in, out) -> (out, in, k)
    return np.ascontiguousarray(w.transpose(2, 1, 0))


def _conv_t(w: np.ndarray) -> np.ndarray:    # (k, in, out) -> (in, out, k), flipped in k
    return np.ascontiguousarray(w.transpose(1, 2, 0)[:, :, ::-1])


def _dense(w: np.ndarray) -> np.ndarray:     # (in, out) -> (out, in)
    return np.ascontiguousarray(w.T)


def _conv_block(sd: Dict, prefix: str, p: Dict):
    sd[f"{prefix}.conv.weight"] = _conv(p["Conv_0"]["kernel"])
    sd[f"{prefix}.conv.bias"] = p["Conv_0"]["bias"]
    sd[f"{prefix}.norm.weight"] = p["GroupNorm_0"]["scale"]
    sd[f"{prefix}.norm.bias"] = p["GroupNorm_0"]["bias"]


def _res_block(sd: Dict, prefix: str, p: Dict):
    _conv_block(sd, f"{prefix}.block0", p["Conv1dBlock_0"])
    _conv_block(sd, f"{prefix}.block1", p["Conv1dBlock_1"])
    sd[f"{prefix}.time.weight"] = _dense(p["Dense_0"]["kernel"])
    sd[f"{prefix}.time.bias"] = p["Dense_0"]["bias"]
    if "Conv_0" in p:
        sd[f"{prefix}.res.weight"] = _conv(p["Conv_0"]["kernel"])
        sd[f"{prefix}.res.bias"] = p["Conv_0"]["bias"]


def convert_flax_params(tree: Dict, n_levels: int = 3) -> Dict[str, torch.Tensor]:
    """Flax TemporalUnet parameters -> a state_dict of `TemporalUnet`.

    `tree` is the restored msgpack ({"params": {...}} or the inner dict).
    Flax names submodules by creation order: ResidualTemporalBlock_0.. run
    down (two per level), mid (two), then up (two per level above the
    bottom); Downsample1d_i and Upsample1d_i in order.
    """
    p = tree.get("params", tree)
    sd: Dict[str, np.ndarray] = {}
    te = p["TimeEncoder_0"]
    for i in range(2):
        sd[f"time_mlp.dense{i}.weight"] = _dense(te[f"Dense_{i}"]["kernel"])
        sd[f"time_mlp.dense{i}.bias"] = te[f"Dense_{i}"]["bias"]
    r = 0
    for lvl in range(n_levels):
        for k in range(2):
            _res_block(sd, f"downs.{lvl}.{k}", p[f"ResidualTemporalBlock_{r}"])
            r += 1
        if lvl < n_levels - 1:
            conv = p[f"Downsample1d_{lvl}"]["Conv_0"]
            sd[f"downs.{lvl}.2.weight"] = _conv(conv["kernel"])
            sd[f"downs.{lvl}.2.bias"] = conv["bias"]
    for k in range(2):
        _res_block(sd, f"mid{k}", p[f"ResidualTemporalBlock_{r}"])
        r += 1
    for lvl in range(n_levels - 1):
        for k in range(2):
            _res_block(sd, f"ups.{lvl}.{k}", p[f"ResidualTemporalBlock_{r}"])
            r += 1
        conv = p[f"Upsample1d_{lvl}"]["ConvTranspose_0"]
        sd[f"ups.{lvl}.2.weight"] = _conv_t(conv["kernel"])
        sd[f"ups.{lvl}.2.bias"] = conv["bias"]
    _conv_block(sd, "final_block", p["Conv1dBlock_0"])
    sd["final_conv.weight"] = _conv(p["Conv_0"]["kernel"])
    sd["final_conv.bias"] = p["Conv_0"]["bias"]
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}
