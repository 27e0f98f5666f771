"""Prioritized planning: agents planned in index order, each under hard
keep-out constraints around the agents planned before it.

Twin of `mmd_tpu/planners/multi_agent/prioritized_planning.py` (reference:
mmd/planners/multi_agent/prioritized_planning.py:46-298):
- a team of batchable MPD planners with uniform start times plans in one
  device pass (`mmd_torch.parallel.team.plan_prioritized_scan`) that reads
  the host once, at its end
- staggered teams, other planners, and a pass in which some agent has no
  free candidate take the host loop: per-waypoint balls from the chosen
  paths made hard (reference :150-158), then the fewest-conflicts free
  candidate (:172-183); that loop stops at the first agent without a free
  candidate, as the reference does
- success iff no conflict remains (reference :197-201).
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence

import torch

from mmd_torch.common.multi_agent_utils import global_pad_paths
from mmd_torch.config import params as default_params
from mmd_torch.experiments.status import TrialSuccessStatus
from mmd_torch.models.diffusion import SamplerNoise
from mmd_torch.parallel.team import PrioritizedTeam, _batchable, plan_prioritized_scan
from mmd_torch.planners.multi_agent.cbs import (
    CBSBase,
    SearchState,
    _best_paths_full,
    _best_paths_pos,
)
from mmd_torch.planners.multi_agent.conflict_detection import (
    pad_team_positions,
    select_candidate_and_conflicts,
)


class PrioritizedPlanning(CBSBase):
    """PP over one low-level planner per agent. After `plan()`, `final` is
    the chosen node: every agent's (B, H, D) batch and chosen index."""

    def __init__(self, low_level_planner_l: Sequence, start_l: Sequence,
                 goal_l: Sequence, start_time_l: Optional[List[int]] = None,
                 reference_robot=None, reference_task=None,
                 validate_start_goal: bool = True):
        super().__init__(low_level_planner_l, start_l, goal_l, start_time_l=start_time_l,
                         reference_robot=reference_robot, reference_task=reference_task,
                         validate_start_goal=validate_start_goal)
        self.final: Optional[SearchState] = None
        self.used_scan = False

    def _scan_eligible(self) -> bool:
        """The device pass needs uniform start times and batchable MPD
        planners."""
        return self.uniform_time and _batchable(self.low_level_planner_l)

    def _plan_scan(self, noise_l: Sequence[SamplerNoise]):
        """The PP pass on the device, read once; the plan() tuple, or None
        when an agent had no free candidate (the host loop then reruns,
        with its failure semantics, prioritized_planning.py:66-73)."""
        self._count_plans(False, len(noise_l), calls=len(noise_l))
        out = plan_prioritized_scan(PrioritizedTeam.of(self.low_level_planner_l, self.margin),
                                   noise_l)
        free_any, ix, summary, best = self._fetch(
            (out.free_any, out.ix, out.summary, _best_paths_full(out.trajs, out.ix)),
            phase="scan")
        self.timing["agent_s"] = out.clock.seconds()
        if not free_any.all():
            return None
        final = SearchState(out.trajs, [int(i) for i in ix])
        count, t, a, b, mid = summary
        final.n_conflicts = int(count)
        final.first_conflict = self._mk_conflict(t, a, b, mid) if count else None
        final.summarized = True
        self.final = final
        status = (TrialSuccessStatus.FAIL_COLLISION_AGENTS if final.n_conflicts
                  else TrialSuccessStatus.SUCCESS)
        return list(best), 0, status, final.n_conflicts

    def plan(self, runtime_limit: float = default_params.runtime_limit,
             noise_l: Optional[Sequence[SamplerNoise]] = None):
        """(best_path_l, 0, TrialSuccessStatus, n_conflicts) (reference:
        prioritized_planning.py:101-201). `noise_l` replays one sampling
        loop's draws per agent in the device pass; without it they come
        from the team generator. `timing` then holds this plan's host
        seconds (`plan_s`), its waits on the device, its plans and UNet
        forwards, and on the device pass each agent's step seconds
        (`agent_s`)."""
        t_start = time.perf_counter()
        self._reset_timing()
        self.final, self.used_scan = None, False
        try:
            if self._scan_eligible():
                out = self._plan_scan(noise_l if noise_l is not None
                                      else self._team_noise())
                if out is not None:
                    self.used_scan = True
                    return out
            return self._plan_host(runtime_limit, t_start)
        finally:
            self.timing["plan_s"] = time.perf_counter() - t_start

    def _plan_host(self, runtime_limit: float, t_start: float):
        """The host loop (reference :101-201), one agent at a time, each
        planner drawing its own noise."""
        status = TrialSuccessStatus.UNKNOWN
        H_max = default_params.horizon - 1
        path_tiles: List[torch.Tensor] = []
        ix_best: List[int] = []
        for i in range(self.num_agents):
            constraint_l = []
            if path_tiles:
                partial = SearchState(torch.stack(path_tiles), list(ix_best))
                constraint_l = self.create_soft_constraints_from_other_agents_paths(
                    partial, i, n_agents_in_state=len(path_tiles))
            for c in constraint_l:
                c.is_soft = False  # priority constraints are hard (:150-154)
                c.t_range_l = [(max(0, min(t0, H_max)), min(H_max, t1))
                               for t0, t1 in c.t_range_l]
            res = self.low_level_planner_l[i]._run(constraint_l)
            self._count_plans(False)

            if path_tiles:
                # Fewest-conflicts choice against the agents planned so far,
                # with a far placeholder row for agent i (:172-183).
                prev_pos = _best_paths_pos(torch.stack(path_tiles), ix_best)
                cand_pos = res.trajs_final[..., :2]
                if not self.uniform_time:
                    # Compare on the team's timeline (:150-183), padded on
                    # the device.
                    H = cand_pos.shape[1]
                    max_t = max(max(self.start_time_l[j] + prev_pos.shape[1]
                                    for j in range(i)), self.start_time_l[i] + H)
                    prev_pos = pad_team_positions(prev_pos, self.start_times[:i], max_t)
                    cand_pos = pad_team_positions(
                        cand_pos, self.start_times[i].expand(cand_pos.shape[0]), max_t)
                paths_pos = torch.cat([prev_pos, torch.full(
                    (1, prev_pos.shape[1], 2), 1e6, device=prev_pos.device)])
                ix, *_, any_free = self._fetch(
                    (*select_candidate_and_conflicts(cand_pos, res.free_mask,
                                                     len(path_tiles), paths_pos,
                                                     self.margin),
                     res.free_mask.any()), phase="select")
            else:
                ix, any_free = self._fetch((res.idx_best, res.free_mask.any()),
                                           phase="select")
            if not bool(any_free):
                status = TrialSuccessStatus.FAIL_NO_SOLUTION
                break
            path_tiles.append(res.trajs_final)
            ix_best.append(int(ix))
            if time.perf_counter() - t_start > runtime_limit:
                status = TrialSuccessStatus.FAIL_RUNTIME_LIMIT
                break

        if not path_tiles:
            return [], 0, status, 0
        final = SearchState(torch.stack(path_tiles), ix_best)
        self._summarize(final)
        self.final = final
        if status == TrialSuccessStatus.UNKNOWN:
            status = (TrialSuccessStatus.FAIL_COLLISION_AGENTS if final.n_conflicts
                      else TrialSuccessStatus.SUCCESS)
        best_path_l = global_pad_paths(final.best_paths(), self.start_time_l)
        return best_path_l, 0, status, final.n_conflicts
