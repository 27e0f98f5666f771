"""Conflict records produced by multi-agent conflict detection.

Twin of `mmd_tpu/common/conflicts.py` (reference: mmd/common/conflicts.py:
28-106). The main pipeline uses PointConflict only
(inference_multi_agent.py:116).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np


@dataclasses.dataclass
class PointConflict:
    """Two agents within the collision margin around time t (reference:
    conflicts.py:85-106). `q_l` holds the collision midpoints, `p_l` the
    agents' positions; the time range is inclusive."""

    agent_ids: List[int]
    p_l: List[np.ndarray]
    q_l: List[np.ndarray]
    t_from: int
    t_to: int

    def get_t_range(self) -> Tuple[int, int]:
        return self.t_from, self.t_to


@dataclasses.dataclass
class VertexConflict:
    """reference: conflicts.py:40-57."""

    agent_ids: List[int]
    q_map: Dict[int, np.ndarray]
    t: int

    def get_t_range(self) -> Tuple[int, int]:
        return self.t, self.t


@dataclasses.dataclass
class EdgeConflict:
    """reference: conflicts.py:59-83."""

    agent_ids: List[int]
    q_from_map: Dict[int, np.ndarray]
    q_to_map: Dict[int, np.ndarray]
    t_from: int
    t_to: int

    def get_t_range(self) -> Tuple[int, int]:
        return self.t_from, self.t_to
