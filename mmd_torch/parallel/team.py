"""Team programs: prioritized planning (PP) of a whole team on the device.

Twin of `plan_prioritized_scan` of `mmd_tpu/parallel/team.py` (reference:
prioritized_planning.py:46-201); its `plan_prioritized_device` is
`PrioritizedPlanning._plan_scan`, run once `_scan_eligible` holds.
JAX runs the pass as one `lax.scan`; here it is a Python loop over the
agents whose carry, the chosen (A, H, 2) positions and the planned mask,
stays on the device. Agent i plans under hard per-waypoint keep-out balls
around the agents before it, then takes the free candidate with the fewest
team conflicts. No step reads the device: the chosen row is gathered with
a device index, and the host reads the results once, after the last agent.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, NamedTuple, Sequence, Tuple

import torch

from mmd_torch.config import params as default_params
from mmd_torch.costs.constraints import (
    ConstraintSet,
    SoftPathConstraints,
    empty_constraint_set,
)
from mmd_torch.costs.guide import GuideData
from mmd_torch.models.diffusion import HardConds, SamplerNoise
from mmd_torch.planners.multi_agent.conflict_detection import (
    candidate_conflict_counts,
    team_conflict_summary,
)
from mmd_torch.planners.single_agent.mpd import MPD, PlanResult


def stack_hard_conds(hard_l: Sequence[HardConds]) -> HardConds:
    """Per-agent HardConds with one shared mask as one (A, H, D) set."""
    return HardConds(mask=hard_l[0].mask, values=torch.stack([h.values for h in hard_l]))


def _batchable(planners: Sequence) -> bool:
    """Whether the planners share the model, schedule, configs and dataset
    (map, robot, normalizer), so that planner 0's program plans for every
    agent with only the hard conditions changed."""
    if not all(isinstance(p, MPD) for p in planners):
        return False
    p0 = planners[0]
    return all(p.model is p0.model and p.schedule is p0.schedule
               and p.cfg == p0.cfg and p.guide_cfg == p0.guide_cfg
               and p.dataset is p0.dataset for p in planners[1:])


class AgentClock:
    """Marks between the agents of a device loop that do not wait for the
    device: CUDA events on the card, the host clock on the CPU (whose ops
    finish as they are called). Read `seconds()` after the loop's sync."""

    def __init__(self, device: torch.device):
        self._cuda = torch.device(device).type == "cuda"
        self._marks: list = []

    def mark(self):
        if self._cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._marks.append(ev)
        else:
            self._marks.append(time.perf_counter())

    def seconds(self) -> List[float]:
        m = self._marks
        if self._cuda:
            return [a.elapsed_time(b) * 1e-3 for a, b in zip(m, m[1:])]
        return [b - a for a, b in zip(m, m[1:])]


@dataclasses.dataclass(frozen=True)
class PrioritizedTeam:
    """What every agent's step of the PP pass shares: planner 0's program
    (the planners are batchable), the team's hard conditions, and the
    keep-out balls' radius and hard weight (team.py:151-153, 225-226)."""

    p0: MPD
    hard_team: HardConds
    base_cset: ConstraintSet
    cons_radius: torch.Tensor  # ()
    hard_weight: torch.Tensor  # ()
    tmask: torch.Tensor        # (A, H): 0 at waypoint 0, else 1
    margin: float

    @staticmethod
    def of(planners: Sequence[MPD], margin: float) -> "PrioritizedTeam":
        p0 = planners[0]
        A, H = len(planners), p0.cfg.horizon
        kw = dict(dtype=torch.float32, device=p0.device)
        tmask = torch.ones((A, H), **kw)
        tmask[:, 0] = 0.0
        return PrioritizedTeam(
            p0=p0, hard_team=stack_hard_conds([p.hard_conds for p in planners]),
            base_cset=empty_constraint_set(1, 1, device=p0.device),
            cons_radius=torch.full((), default_params.vertex_constraint_radius, **kw),
            hard_weight=torch.full((), default_params.weight_grad_cost_constraints, **kw),
            tmask=tmask, margin=float(margin))

    def initial_carry(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(sel_pos (A, H, 2), planned (A,)): every row unplanned, at a far
        sentinel of its own, 1e6 + 1e3 i (team.py:173-176): identical
        sentinels would count as collisions with each other."""
        A, H = self.tmask.shape
        kw = dict(dtype=torch.float32, device=self.tmask.device)
        far = torch.stack([torch.full((A,), 1e6, **kw) + 1e3 * torch.arange(A, **kw),
                           torch.full((A,), 1e6, **kw)], dim=-1)
        return far[:, None, :].expand(A, H, 2).clone(), torch.zeros((A,), **kw)

    def plan_agent(self, sel_pos: torch.Tensor, planned: torch.Tensor, i: int,
                   noise: SamplerNoise) -> PlanResult:
        """Agent i's plan under hard keep-out balls around the planned rows
        of the carry (team.py:145-160)."""
        spc = SoftPathConstraints(points=sel_pos, mask=planned[:, None] * self.tmask,
                                  radius=self.cons_radius, weight=self.hard_weight)
        gd = GuideData(scene=self.p0.scene, normalizer=self.p0.dataset.normalizer,
                       constraints=self.base_cset, soft_paths=spc)
        hard = HardConds(mask=self.hard_team.mask, values=self.hard_team.values[i])
        return self.p0._plan_fresh(gd, noise, hard)

    def choose(self, sel_pos: torch.Tensor, planned: torch.Tensor, i: int,
               res: PlanResult):
        """Agent i's candidate (team.py:161-170): (sel_pos, planned, ix),
        the carry updated out of place.

        The choice minimizes counts * 1e6 + cost in float32, as JAX does:
        once a candidate has conflicts the cost term is below the float32
        spacing, so among equal counts the first index wins.
        """
        counts = candidate_conflict_counts(res.trajs_final[..., :2], i, sel_pos,
                                           self.margin)
        key = torch.where(res.free_mask, counts.to(torch.float32) * 1e6 + res.cost_all,
                          float("inf"))
        ix = torch.argmin(key)
        sel_pos = sel_pos.clone()
        sel_pos[i] = res.trajs_final.index_select(0, ix.reshape(1))[0, :, :2]
        planned = planned.clone()
        # fill_, not `planned[i] = 1.0`: setting one element from a Python
        # number copies it from the host, which waits for the card.
        planned[i].fill_(1.0)
        return sel_pos, planned, ix

    def step(self, sel_pos: torch.Tensor, planned: torch.Tensor, i: int,
             noise: SamplerNoise):
        """The loop body: (sel_pos, planned, agent i's PlanResult, ix)."""
        res = self.plan_agent(sel_pos, planned, i, noise)
        sel_pos, planned, ix = self.choose(sel_pos, planned, i, res)
        return sel_pos, planned, res, ix


class ScanResult(NamedTuple):
    """The PP pass on the device: trajs (A, B, H, D), free_any (A,), ix (A,),
    free_mask (A, B), the final selection's conflict summary (count, t, a,
    b, midpoint), and the clock of the agents' steps."""

    trajs: torch.Tensor
    free_any: torch.Tensor
    ix: torch.Tensor
    free_mask: torch.Tensor
    summary: tuple
    clock: AgentClock


def plan_prioritized_scan(team: PrioritizedTeam,
                          noise_l: Sequence[SamplerNoise]) -> ScanResult:
    """The whole PP pass, agent after agent, without a host sync."""
    sel_pos, planned = team.initial_carry()
    clock = AgentClock(sel_pos.device)
    clock.mark()
    outs: List[Tuple[PlanResult, torch.Tensor]] = []
    for i, noise in enumerate(noise_l):
        sel_pos, planned, res, ix = team.step(sel_pos, planned, i, noise)
        outs.append((res, ix))
        clock.mark()
    return ScanResult(
        trajs=torch.stack([r.trajs_final for r, _ in outs]),
        free_any=torch.stack([r.free_mask.any() for r, _ in outs]),
        ix=torch.stack([ix for _, ix in outs]),
        free_mask=torch.stack([r.free_mask for r, _ in outs]),
        summary=team_conflict_summary(sel_pos, team.margin),
        clock=clock)
