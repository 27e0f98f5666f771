"""Padded constraint sets for guidance.

Twin of `mmd_tpu/costs/constraints.py` (reference: mmd/common/constraints.py:
46-86, mp_baselines/planners/costs/cost_functions.py:275-326). A set holds K
constraints of up to P (point, t-range, radius) triples; waypoint h adds
relu(radius - ||q_h - q_c||) while start <= h < end. The reference's
constant offsets vanish under the gradient, which is all guidance uses.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from mmd_torch.config import params as default_params


@dataclasses.dataclass(frozen=True)
class ConstraintSet:
    q: torch.Tensor           # (K, P, q_dim) constraint centers
    t_range: torch.Tensor     # (K, P, 2) float [start, end)
    radius: torch.Tensor      # (K, P)
    weight: torch.Tensor      # (K,) guidance gradient weight (hard/soft)
    point_mask: torch.Tensor  # (K, P) 1.0 where the point is real
    active: torch.Tensor      # (K,) 1.0 where the constraint is real
    # Host copy of active.sum(): the guide skips a set with none, which adds
    # exactly zero, without reading the card.
    n_active: int = 0

    @property
    def max_constraints(self) -> int:
        return self.q.shape[0]

    @property
    def max_points(self) -> int:
        return self.q.shape[1]


def _as_set(arrays: dict, device) -> ConstraintSet:
    return ConstraintSet(n_active=int(arrays["active"].sum()),
                         **{k: torch.as_tensor(v, dtype=torch.float32, device=device)
                            for k, v in arrays.items()})


def _zeros(K: int, P: int, q_dim: int) -> dict:
    return dict(q=np.zeros((K, P, q_dim), np.float32),
                t_range=np.zeros((K, P, 2), np.float32),
                radius=np.zeros((K, P), np.float32),
                weight=np.zeros((K,), np.float32),
                point_mask=np.zeros((K, P), np.float32),
                active=np.zeros((K,), np.float32))


def empty_constraint_set(max_constraints: int, max_points: int, q_dim: int = 2,
                         device="cuda") -> ConstraintSet:
    return _as_set(_zeros(max_constraints, max_points, q_dim), device)


def pack_constraint_set(
    constraints: Sequence,  # objects with q_l, t_range_l, radius_l, is_soft
    max_constraints: int,
    max_points: int,
    hard_weight: float = default_params.weight_grad_cost_constraints,
    soft_weight: float = default_params.weight_grad_cost_soft_constraints,
    q_dim: int = 2,
    device="cuda",
) -> ConstraintSet:
    """Pack host-side constraints into one padded set (reference:
    mpd.py:329-342, 409-412 for the hard/soft weight split)."""
    K, P = max_constraints, max_points
    a = _zeros(K, P, q_dim)
    if len(constraints) > K:
        raise ValueError(f"{len(constraints)} constraints > static bound {K}")
    for k, c in enumerate(constraints):
        n = len(c.q_l)
        if n > P:
            raise ValueError(f"constraint {k} has {n} points > static bound {P}")
        a["q"][k, :n] = np.stack([np.asarray(p, np.float32)[:q_dim] for p in c.q_l])
        # The mask is start <= h < end (cost_functions.py:303-305) on the raw
        # declared range.
        a["t_range"][k, :n] = np.asarray(c.t_range_l, np.float32)
        a["radius"][k, :n] = np.asarray(c.radius_l, np.float32)
        a["point_mask"][k, :n] = 1.0
        a["weight"][k] = soft_weight if getattr(c, "is_soft", False) else hard_weight
        a["active"][k] = 1.0
    return _as_set(a, device)


@dataclasses.dataclass(frozen=True)
class SoftPathConstraints:
    """One keep-out ball per (row, waypoint): the ECBS/PP soft constraints
    (reference cbs.py:468-506), one cost term with one gradient clip."""

    points: torch.Tensor  # (R, T, q_dim) row r's ball center at waypoint t
    mask: torch.Tensor    # (R, T) 1.0 where active
    radius: torch.Tensor  # () scalar
    weight: torch.Tensor  # () scalar guidance weight

    @property
    def rows(self) -> int:
        return self.points.shape[0]


def soft_path_cost(q_pos: torch.Tensor, spc: SoftPathConstraints) -> torch.Tensor:
    """q_pos (B, T, q_dim) -> (B,): sum_{r,t} mask * relu(radius - dist)."""
    d = torch.linalg.vector_norm(q_pos[:, None, :, :] - spc.points[None], dim=-1)
    pen = relu(spc.radius - d) * spc.mask[None]
    return pen.sum(dim=(1, 2))


def relu(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) whose gradient at x == 0 is 0.5, as `jnp.maximum`'s."""
    return torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))


def constraint_costs(q_pos: torch.Tensor, cset: ConstraintSet) -> torch.Tensor:
    """Row k of q_pos under constraint k: (K, B, H, q_dim) -> (K, B)."""
    H = q_pos.shape[-2]
    h_idx = torch.arange(H, dtype=q_pos.dtype, device=q_pos.device)
    tr = cset.t_range                                              # (K, P, 2)
    in_range = (h_idx >= tr[..., 0:1]) & (h_idx < tr[..., 1:2])    # (K, P, H)
    dist = torch.linalg.vector_norm(
        q_pos[:, :, None, :, :] - cset.q[:, None, :, None, :], dim=-1)  # (K, B, P, H)
    pen = relu(cset.radius[:, None, :, None] - dist)
    pen = pen * in_range[:, None].to(q_pos.dtype) * cset.point_mask[:, None, :, None]
    return pen.sum(dim=(-1, -2)) * cset.active[:, None]


def constraint_cost_single(q_pos: torch.Tensor, cset: ConstraintSet, k: int) -> torch.Tensor:
    """Cost of constraint k over a batch. q_pos (B, H, q_dim) -> (B,)."""
    row = {f.name: getattr(cset, f.name)[k:k + 1]
           for f in dataclasses.fields(cset) if f.name != "n_active"}
    return constraint_costs(q_pos[None], ConstraintSet(**row))[0]
