"""Dataset normalizer: per-dimension [min, max] <-> [-1, 1].

Twin of `LimitsNormalizer` in `mmd_tpu/datasets/normalization.py:18-57`
(reference: mmd/datasets/normalization.py:145-168).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class LimitsNormalizer:
    mins: torch.Tensor  # (D,)
    maxs: torch.Tensor  # (D,)

    @staticmethod
    def from_limits(mins, maxs, device="cuda") -> "LimitsNormalizer":
        return LimitsNormalizer(
            mins=torch.as_tensor(mins, dtype=torch.float32, device=device),
            maxs=torch.as_tensor(maxs, dtype=torch.float32, device=device))

    @staticmethod
    def stack(normalizers: Sequence["LimitsNormalizer"]) -> "LimitsNormalizer":
        """Per-tile normalizers as one whose limits are (T, 1, 1, D): it
        maps a (T, B, H, D) batch, or a chain (S, T, B, H, D), tile by tile."""
        return LimitsNormalizer(
            mins=torch.stack([n.mins for n in normalizers])[:, None, None, :],
            maxs=torch.stack([n.maxs for n in normalizers])[:, None, None, :])

    @property
    def span(self) -> torch.Tensor:
        return torch.clamp(self.maxs - self.mins, min=1e-12)

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        # [min, max] -> [0, 1] -> [-1, 1]
        return 2.0 * (x - self.mins) / self.span - 1.0

    def unnormalize(self, x: torch.Tensor) -> torch.Tensor:
        # The reference clips to [-1, 1] first (:157-163); for in-range
        # inputs the clip is the identity.
        x = torch.clamp(x, -1.0, 1.0)
        return 0.5 * (x + 1.0) * self.span + self.mins
