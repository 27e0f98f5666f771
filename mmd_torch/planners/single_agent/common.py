"""Single-agent planner output contract.

Twin of `mmd_tpu/planners/single_agent/common.py` (reference:
mmd/planners/single_agent/common.py:26-46). Field names are kept so the
multi-agent layer and experiment harness read the same contract.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional


@dataclasses.dataclass
class PlannerOutput:
    trajs_iters: Optional[Any] = None          # (steps+1, B, H, D) unnormalized
    trajs_final: Optional[Any] = None          # (B, H, D) smoothed
    trajs_final_coll: Optional[Any] = None
    trajs_final_coll_idxs: Optional[Any] = None
    trajs_final_free: Optional[Any] = None
    trajs_final_free_idxs: Optional[Any] = None
    success_free_trajs: Optional[int] = None
    fraction_free_trajs: Optional[float] = None
    collision_intensity_trajs: Optional[float] = None
    idx_best_traj: Optional[int] = None        # index into trajs_final
    traj_final_free_best: Optional[Any] = None
    cost_best_free_traj: Optional[float] = None
    cost_smoothness: Optional[Any] = None
    cost_path_length: Optional[Any] = None
    cost_all: Optional[Any] = None
    variance_waypoint_trajs_final_free: Optional[Any] = None
    t_total: Optional[float] = None
    constraints_l: Optional[List] = None
