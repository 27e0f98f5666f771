"""Generic small denoisers.

Twin of `mmd_tpu/models/generic.py:18-60` (reference:
mmd/models/generic/{mlp_model,no_model}.py, temporal_unet.py:268): simple
alternatives to the TemporalUnet, named in the loaders' model registry.
Each takes x (B, H, D) and t (B,). `convert_generic_params` maps a flax
tree of MLPModel or PointUnet onto their state_dict.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
from torch import nn

from mmd_torch.models.temporal_unet import TimeEncoder, mish


class MLPModel(nn.Module):
    """A plain MLP over the flattened trajectory (mlp_model.py:9)."""

    def __init__(self, state_dim: int = 4, horizon: int = 64,
                 hidden_dims: Sequence[int] = (256, 256), time_emb_dim: int = 32):
        super().__init__()
        self.time_mlp = TimeEncoder(32, time_emb_dim)
        dims = [horizon * state_dim + time_emb_dim, *hidden_dims, horizon * state_dim]
        self.dense = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor, time: torch.Tensor) -> torch.Tensor:
        B, H, D = x.shape
        h = torch.cat([x.reshape(B, H * D), self.time_mlp(time)], dim=-1)
        for layer in self.dense[:-1]:
            h = mish(layer(h))
        return self.dense[-1](h).reshape(B, H, D)


class NoModel(nn.Module):
    """The identity (no_model.py:5)."""

    def forward(self, x: torch.Tensor, time: torch.Tensor) -> torch.Tensor:
        return x


class PointUnet(nn.Module):
    """A per-waypoint MLP (temporal_unet.py:268): no temporal mixing."""

    def __init__(self, state_dim: int = 4, hidden_dim: int = 64, time_emb_dim: int = 32):
        super().__init__()
        self.time_mlp = TimeEncoder(32, time_emb_dim)
        dims = [state_dim + time_emb_dim, hidden_dim, hidden_dim, state_dim]
        self.dense = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor, time: torch.Tensor) -> torch.Tensor:
        t_emb = self.time_mlp(time)[:, None, :].expand(-1, x.shape[1], -1)
        h = torch.cat([x, t_emb], dim=-1)
        for layer in self.dense[:-1]:
            h = mish(layer(h))
        return self.dense[-1](h)


def convert_generic_params(tree: Dict) -> Dict[str, torch.Tensor]:
    """A flax MLPModel or PointUnet tree ({"params": {...}} or the inner
    dict) -> the state_dict of its twin: TimeEncoder_0's Dense_i ->
    time_mlp.dense{i}, Dense_i -> dense.{i}; kernels (in, out) -> (out, in)."""
    p = tree.get("params", tree)
    layers = {f"time_mlp.dense{i}": p["TimeEncoder_0"][f"Dense_{i}"] for i in range(2)}
    n_dense = sum(1 for k in p if k.startswith("Dense_"))
    layers.update({f"dense.{i}": p[f"Dense_{i}"] for i in range(n_dense)})
    sd = {}
    for name, leaf in layers.items():
        sd[f"{name}.weight"] = np.ascontiguousarray(np.asarray(leaf["kernel"]).T)
        sd[f"{name}.bias"] = np.asarray(leaf["bias"])
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}
