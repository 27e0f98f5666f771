"""Padded constraint sets for guidance.

Twin of `mmd_tpu/costs/constraints.py` (reference: mmd/common/constraints.py:
46-86, mp_baselines/planners/costs/cost_functions.py:275-326). A set holds K
constraints of up to P (point, t-range, radius) triples; waypoint h adds
relu(radius - ||q_h - q_c||) while start <= h < end. The reference's
constant offsets vanish under the gradient, which is all guidance uses.
A multi-tile plan stacks one set per tile, (T, K, P, ...), and one
`SoftPathConstraints` per tile, (T, R, H, ...); tile m's act on tile m's
rows of a (T, B, H, D) batch. N problems of a batched plan stack theirs
the same way (`pack_constraint_sets`, `stack_constraint_sets`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from mmd_torch.config import params as default_params
from mmd_torch.utils.transfer import to_device


@dataclasses.dataclass(frozen=True)
class ConstraintSet:
    q: torch.Tensor           # (K, P, q_dim) constraint centers
    t_range: torch.Tensor     # (K, P, 2) float [start, end)
    radius: torch.Tensor      # (K, P)
    weight: torch.Tensor      # (K,) guidance gradient weight (hard/soft)
    point_mask: torch.Tensor  # (K, P) 1.0 where the point is real
    active: torch.Tensor      # (K,) 1.0 where the constraint is real
    # (A tile stack's fields lead with T: q (T, K, P, q_dim), ...)
    # Host copy of active.sum(): the guide skips a set with none, which adds
    # exactly zero, without reading the card.
    n_active: int = 0

    @property
    def max_constraints(self) -> int:
        return self.q.shape[-3]

    @property
    def max_points(self) -> int:
        return self.q.shape[-2]

    def flat(self) -> "ConstraintSet":
        """A tile stack's sets (T, K, ...) as one set of T * K constraints,
        tile-major; a single set as it is."""
        lead = self.q.dim() - 3
        if lead == 0:
            return self
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).flatten(0, lead)
            for f in dataclasses.fields(self) if f.name != "n_active"})

    def take(self, rows: slice) -> "ConstraintSet":
        """A stack's sets (N, K, ...) of problems or tiles `rows`.
        `n_active` still counts all N, as JAX's static count of the
        stacked set does: the guide only tests it for zero."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name)[rows]
            for f in dataclasses.fields(self) if f.name != "n_active"})


def _as_set(arrays: dict, device) -> ConstraintSet:
    return ConstraintSet(n_active=int(arrays["active"].sum()),
                         **{k: to_device(v, device, torch.float32)
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
    return _as_set(_pack_arrays(constraints, max_constraints, max_points, hard_weight,
                                soft_weight, q_dim), device)


def pack_constraint_sets(per_tile: Sequence[Sequence], max_constraints: Optional[int] = None,
                         max_points: Optional[int] = None, q_dim: int = 2,
                         device="cuda") -> ConstraintSet:
    """One padded set per tile (or per problem of a batched plan), packed
    on the host and moved as one (T, K, P, ...) stack, with the default hard
    and soft weights; an empty list gives the tile an empty set. K and P
    default to the largest of the lists, so that C children's sets share
    one (K, P) and every row past a child's own is inactive (weight 0,
    point_mask 0, active 0): JAX's children packed to common (K, P) buckets
    (mmd_tpu/planners/multi_agent/fused.py:119-120)."""
    if max_constraints is None:
        max_constraints = max(1, max(len(c) for c in per_tile))
    if max_points is None:
        max_points = max([1] + [len(c.q_l) for cons in per_tile for c in cons])
    arrays = [_pack_arrays(c, max_constraints, max_points,
                           default_params.weight_grad_cost_constraints,
                           default_params.weight_grad_cost_soft_constraints, q_dim)
              for c in per_tile]
    return _as_set({k: np.stack([a[k] for a in arrays]) for k in arrays[0]}, device)


def stack_constraint_sets(sets: Sequence[ConstraintSet]) -> ConstraintSet:
    """Device sets of one (K, P) as N problems' (N, K, P, ...) stack, set n
    problem n's; `n_active` counts them all."""
    return ConstraintSet(n_active=sum(c.n_active for c in sets), **{
        f.name: torch.stack([getattr(c, f.name) for c in sets])
        for f in dataclasses.fields(ConstraintSet) if f.name != "n_active"})


def _pack_arrays(constraints: Sequence, max_constraints: int, max_points: int,
                 hard_weight: float, soft_weight: float, q_dim: int) -> dict:
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
    return a


@dataclasses.dataclass(frozen=True)
class SoftPathConstraints:
    """One keep-out ball per (row, waypoint): the ECBS/PP soft constraints
    (reference cbs.py:468-506), one cost term with one gradient clip."""

    points: torch.Tensor  # (R, H, q_dim) row r's ball center at waypoint h
    mask: torch.Tensor    # (R, H) 1.0 where active
    radius: torch.Tensor  # () scalar
    weight: torch.Tensor  # () scalar guidance weight
    # A tile stack: points (T, R, H, q_dim), mask (T, R, H), radius and
    # weight (T,).

    @property
    def rows(self) -> int:
        return self.points.shape[-3]

    def take(self, rows: slice) -> "SoftPathConstraints":
        """A stack's soft rows (N, R, ...) of problems or tiles `rows`."""
        return SoftPathConstraints(points=self.points[rows], mask=self.mask[rows],
                                   radius=self.radius[rows], weight=self.weight[rows])


def soft_path_cost(q_pos: torch.Tensor, spc: SoftPathConstraints) -> torch.Tensor:
    """q_pos (B, H, q_dim) -> (B,): sum_{r,h} mask * relu(radius - dist);
    with a tile stack, (T, B, H, q_dim) -> (T, B)."""
    d = torch.linalg.vector_norm(q_pos[..., :, None, :, :] - spc.points[..., None, :, :, :],
                                 dim=-1)                                   # (..., B, R, H)
    pen = relu(spc.radius[..., None, None, None] - d) * spc.mask[..., None, :, :]
    return pen.sum(dim=(-2, -1))


# A per-waypoint group needs this many points to leave the generic set.
MIN_PATH_POINTS = 32


def split_soft_path_constraints(
    constraints_l: Sequence, horizon: int, device="cuda",
) -> Tuple[list, Optional[SoftPathConstraints]]:
    """Split the one large per-waypoint constraint out of a list (as
    `mmd_tpu/costs/constraints.py:155` does): (the rest, its
    SoftPathConstraints or None).

    A constraint qualifies with >= MIN_PATH_POINTS points, every t-range one
    waypoint wide and one radius; its weight is the hard or soft guidance
    weight of the config. Only a lone such group is split (the
    reference builds one per call); with several, all stay generic, each
    with its own gradient clip. Rows are waypoint-aligned: row r holds the
    r-th point given for each waypoint, and R is the most points any
    waypoint has (no padding to a bucket: an absent point is masked).
    """
    path_like = [c for c in constraints_l
                 if len(c.q_l) >= MIN_PATH_POINTS
                 and all(t1 - t0 == 1 for t0, t1 in c.t_range_l)
                 and len(set(c.radius_l)) == 1]
    if len(path_like) != 1:
        return list(constraints_l), None
    c = path_like[0]
    rest = [x for x in constraints_l if x is not c]
    per_t: dict = {}
    for q, (t0, _t1) in zip(c.q_l, c.t_range_l):
        t = int(t0)
        if 0 <= t < horizon:
            per_t.setdefault(t, []).append(np.asarray(q, np.float32)[:2])
    n_rows = max((len(v) for v in per_t.values()), default=0)
    if n_rows == 0:
        return rest, None
    points = np.zeros((n_rows, horizon, 2), np.float32)
    mask = np.zeros((n_rows, horizon), np.float32)
    for t, pts in per_t.items():
        for r, q in enumerate(pts):
            points[r, t] = q
            mask[r, t] = 1.0
    kw = dict(dtype=torch.float32, device=device)
    return rest, SoftPathConstraints(
        points=to_device(points, device), mask=to_device(mask, device),
        radius=torch.full((), float(c.radius_l[0]), **kw),
        weight=torch.full((), default_params.weight_grad_cost_soft_constraints if c.is_soft
                          else default_params.weight_grad_cost_constraints, **kw))


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
