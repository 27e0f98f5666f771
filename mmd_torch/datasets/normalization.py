"""Dataset normalizers.

Twin of `mmd_tpu/datasets/normalization.py:18-127` (reference:
mmd/datasets/normalization.py:120-196): `LimitsNormalizer` maps
per-dimension [min, max] to [-1, 1], `GaussianNormalizer` standardizes, and
`make_normalizer` fits one of the reference's four by name.
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
    def from_data(x: torch.Tensor) -> "LimitsNormalizer":
        flat = x.reshape(-1, x.shape[-1])
        return LimitsNormalizer(mins=flat.amin(dim=0), maxs=flat.amax(dim=0))

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

    def unnormalize_unclipped(self, x: torch.Tensor) -> torch.Tensor:
        return 0.5 * (x + 1.0) * self.span + self.mins


@dataclasses.dataclass(frozen=True)
class GaussianNormalizer:
    """Zero mean, unit std per dimension (normalization.py:120-142)."""

    means: torch.Tensor
    stds: torch.Tensor

    @staticmethod
    def from_data(x: torch.Tensor) -> "GaussianNormalizer":
        flat = x.reshape(-1, x.shape[-1])
        return GaussianNormalizer(means=flat.mean(dim=0),
                                  stds=torch.clamp(flat.std(dim=0, correction=0), min=1e-8))

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.means) / self.stds

    def unnormalize(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.stds + self.means


def fixed_limits_normalizer(state_dim: int, low: float = -1.0, high: float = 1.0,
                            device="cuda") -> LimitsNormalizer:
    """Constant [low, high] limits on every dimension, whatever the data
    (normalization.py:188-196)."""
    return LimitsNormalizer(mins=torch.full((state_dim,), low, device=device),
                            maxs=torch.full((state_dim,), high, device=device))


def safe_limits_from_data(x: torch.Tensor, eps: float = 1.0) -> LimitsNormalizer:
    """A LimitsNormalizer that tolerates constant dimensions
    (normalization.py:171-186). As the reference does, each constant
    dimension widens EVERY dimension's limits by eps."""
    flat = x.reshape(-1, x.shape[-1])
    mins, maxs = flat.amin(dim=0), flat.amax(dim=0)
    pad = eps * (mins == maxs).sum()
    return LimitsNormalizer(mins=mins - pad, maxs=maxs + pad)


def make_normalizer(name: str, x: torch.Tensor):
    """One of the reference's four normalizers, fit on x (..., D)
    (trajectories.py:28, normalization.py:120,145,171,188)."""
    if name == "LimitsNormalizer":
        return LimitsNormalizer.from_data(x)
    if name == "GaussianNormalizer":
        return GaussianNormalizer.from_data(x)
    if name == "SafeLimitsNormalizer":
        return safe_limits_from_data(x)
    if name == "FixedLimitsNormalizer":
        return fixed_limits_normalizer(x.shape[-1], device=x.device)
    raise ValueError(f"Unknown normalizer {name!r}; expected one of "
                     "LimitsNormalizer, GaussianNormalizer, "
                     "SafeLimitsNormalizer, FixedLimitsNormalizer")
