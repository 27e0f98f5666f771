"""Host-side constraint records handed from the multi-agent planners to the
single-agent planner.

Twin of `mmd_tpu/common/constraints.py` (reference: mmd/common/
constraints.py:34-144). Plain Python records; `MPD._pack` turns them into
the guide's tensors (`mmd_torch.costs.constraints`).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from mmd_torch.config import params as default_params

# A vertex constraint keeps its ball over [t - VERTEX_T_PAD, t + VERTEX_T_PAD).
VERTEX_T_PAD = 2


@dataclasses.dataclass
class MultiPointConstraint:
    """A set of (q, t-range, radius) keep-out balls for one agent
    (reference: constraints.py:46-86). `t_range_l` entries are (start, end);
    the cost masks start <= h < end (cost_functions.py:303-305)."""

    q_l: List[np.ndarray]
    t_range_l: List[Tuple[int, int]]
    radius_l: Optional[List[float]] = None
    is_soft: bool = False

    def __post_init__(self):
        if self.radius_l is None:
            self.radius_l = [default_params.vertex_constraint_radius] * len(self.q_l)
        if not len(self.q_l) == len(self.t_range_l) == len(self.radius_l):
            raise ValueError("q_l, t_range_l and radius_l differ in length")

    def get_t_range_start(self) -> int:
        return min(t0 for t0, _ in self.t_range_l)

    def get_t_range_end(self) -> int:
        return max(t1 for _, t1 in self.t_range_l)

    def shifted(self, dt: int, t_min: int, t_max: int) -> "MultiPointConstraint":
        """All t-ranges shifted by dt and clamped to [t_min, t_max] (CBS
        shifts constraints by agent start times, cbs.py:399-406)."""
        new_ranges = [(int(np.clip(t0 + dt, t_min, t_max)),
                       int(np.clip(t1 + dt, t_min, t_max)))
                      for t0, t1 in self.t_range_l]
        return MultiPointConstraint(q_l=list(self.q_l), t_range_l=new_ranges,
                                    radius_l=list(self.radius_l), is_soft=self.is_soft)


@dataclasses.dataclass
class VertexConstraint:
    """Agent must avoid q at time t (reference: constraints.py:88-112)."""

    q: np.ndarray
    t: int

    def shifted(self, dt: int, t_min: int, t_max: int) -> "VertexConstraint":
        return VertexConstraint(q=self.q, t=int(np.clip(self.t + dt, t_min, t_max)))

    def as_multipoint(self) -> MultiPointConstraint:
        """The keep-out-ball form the diffusion planner consumes (it takes
        MultiPointConstraints only, mpd.py:329-342)."""
        return MultiPointConstraint(q_l=[np.asarray(self.q, np.float32)],
                                    t_range_l=[(self.t - VERTEX_T_PAD, self.t + VERTEX_T_PAD)],
                                    radius_l=[default_params.vertex_constraint_radius])


@dataclasses.dataclass
class EdgeConstraint:
    """Agent must not traverse q_from -> q_to over [t_from, t_to]
    (reference: constraints.py:114-144)."""

    q_from: np.ndarray
    q_to: np.ndarray
    t_from: int
    t_to: int

    def shifted(self, dt: int, t_min: int, t_max: int) -> "EdgeConstraint":
        return EdgeConstraint(q_from=self.q_from, q_to=self.q_to,
                              t_from=int(np.clip(self.t_from + dt, t_min, t_max)),
                              t_to=int(np.clip(self.t_to + dt, t_min, t_max)))

    def as_multipoint(self) -> MultiPointConstraint:
        """Keep-out balls at both endpoints and the edge's midpoint over
        [t_from, t_to + 1), covering the swept segment."""
        radius = default_params.vertex_constraint_radius
        q_from = np.asarray(self.q_from, np.float32)
        q_to = np.asarray(self.q_to, np.float32)
        mid = 0.5 * (q_from + q_to)
        span = (self.t_from, self.t_to + 1)
        return MultiPointConstraint(q_l=[q_from, q_to, mid], t_range_l=[span] * 3,
                                    radius_l=[radius] * 3)
