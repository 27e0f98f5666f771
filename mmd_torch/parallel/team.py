"""Team programs: a whole team's plans on the device.

Twin of `mmd_tpu/parallel/team.py`. JAX runs each pass as one `lax.scan`
or `vmap`. Here a `vmap` is a batch dimension written out: the agents'
problems run as one sampler call of A problems (`PrioritizedTeam.
plan_problems`, `MPD.plan_fresh_batch`); a `scan`, whose order between
agents is real, is a Python loop over the agents whose carry stays on the
device:
- `plan_prioritized_scan`: prioritized planning (PP, reference
  prioritized_planning.py:46-201; JAX's `plan_prioritized_device` is
  `PrioritizedPlanning._plan_scan`). Agent i plans under hard per-waypoint
  keep-out balls around the chosen paths of the agents before it, then
  takes the free candidate with the fewest team conflicts.
- `plan_fresh_team`: the CBS/XCBS root, every agent's unconstrained plan
  and the root's conflict summary (team.py:26-45, 247), one sampler call.
- `plan_sequential_root_soft`: the ECBS root (team.py:49-112, 264). Agent
  i plans under soft balls around the chosen (least-cost) paths of the
  agents before it; an agent whose batch has no free trajectory plans
  again with every ball masked.
- `plan_fresh_team_soft`: a Jacobi repair round (team.py:318-337): every
  agent plans fresh under its own soft group (`team_soft_paths`), balls
  around the other agents' current paths, one sampler call.
The chosen row is gathered with a device index. Only the ECBS root reads
the device inside its loop: one flag per agent, whether its batch has a
free trajectory, through the caller's `read`.

Under a mesh with an 'agent' axis (`parallel.sharding`; JAX's
`shard_team_inputs` placement, team.py:390-414) every rank runs the same
pass: a sampler call of A problems plans this rank's A / n agents
(`shard_team_inputs`) and gathers `trajs_final`, `free_mask` and
`idx_best` over 'agent' (`share_rows`); a call whose problem count does
not divide the axis runs whole on every rank, and rank 0's fields are
broadcast. The ECBS root stays serial over agents, as JAX's scan does:
every rank plans agent i, and rank 0's fields are broadcast. So every
tensor the host reads or a later step takes comes from a collective, and
the ranks' searches never split.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from mmd_torch.config import params as default_params
from mmd_torch.costs.constraints import (
    ConstraintSet,
    SoftPathConstraints,
    empty_constraint_set,
)
from mmd_torch.costs.guide import GuideData
from mmd_torch.models.diffusion import HardConds, SamplerNoise
from mmd_torch.parallel.sharding import (
    axis_rows,
    broadcast,
    gather_leading_axis,
    shard_leading_axis,
)
from mmd_torch.planners.multi_agent.conflict_detection import (
    candidate_conflict_counts,
    least_conflicts,
    team_candidate_counts,
    team_conflict_summary,
)
from mmd_torch.planners.single_agent.mpd import MPD, PlanResult


def stack_hard_conds(hard_l: Sequence[HardConds]) -> HardConds:
    """Per-agent HardConds with one shared mask as one (A, H, D) set."""
    return HardConds(mask=hard_l[0].mask, values=torch.stack([h.values for h in hard_l]))


# The fields of a sampler call's PlanResult that a team pass and the
# search read, and that a mesh gathers or broadcasts.
SHARED_FIELDS = ("trajs_final", "free_mask", "idx_best")


def _agent_mesh(mesh) -> bool:
    return mesh is not None and "agent" in mesh.axis_names


def team_rows(mesh, n: int) -> Optional[slice]:
    """This rank's problems of an n-problem sampler call under `mesh`, or
    None where the call is not sharded: no mesh, no 'agent' axis, or an
    axis that n does not divide (JAX's rule, team.py:403-407)."""
    if not _agent_mesh(mesh) or n % mesh.shape["agent"]:
        return None
    return axis_rows(n, mesh, "agent")


def shard_team_inputs(mesh, hard_team: HardConds, noise_l: Sequence[SamplerNoise]):
    """The team's (A, ...) inputs cut to this rank's agents over the
    mesh's 'agent' axis (JAX's `shard_team_inputs`, team.py:390-414): the
    hard conditions' values and the draws; the mask is shared. Every rank
    drew the whole team's draws from the same generator, so the sharded
    plans see exactly the draws of the unsharded one. Returns the inputs
    unchanged where `team_rows` is None."""
    rows = team_rows(mesh, hard_team.values.shape[0])
    if rows is None:
        return hard_team, list(noise_l)
    values = shard_leading_axis(hard_team.values, mesh, "agent")
    return HardConds(mask=hard_team.mask, values=values), list(noise_l[rows])


def rows_result(fields: Sequence[torch.Tensor]) -> PlanResult:
    """A PlanResult of SHARED_FIELDS alone: what a mesh's collectives hand
    on. Its other fields are None; no team pass reads them."""
    out = dict.fromkeys(f.name for f in dataclasses.fields(PlanResult))
    out.update(zip(SHARED_FIELDS, fields))
    return PlanResult(**out)


def share_rows(mesh, res: PlanResult, sharded: bool) -> PlanResult:
    """A sampler call's result on every rank of the mesh: the ranks'
    problems gathered over 'agent' where the call was `sharded` (and then
    rank 0's copy broadcast over the other axes, which only replicate), or
    rank 0's whole result broadcast where every rank ran the call. Without
    an 'agent' axis the result is returned as it is."""
    if not _agent_mesh(mesh):
        return res
    fields = [getattr(res, f) for f in SHARED_FIELDS]
    if sharded:
        fields = gather_leading_axis(fields, mesh, "agent")
        if len(mesh.axis_names) == 1:
            return rows_result(fields)
    return rows_result(broadcast(fields, mesh, src=0))


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
    """What every agent's step of a team pass shares: planner 0's program
    (the planners are batchable), the team's hard conditions, and the
    balls' radius and weights, hard for PP and soft for ECBS
    (team.py:151-153, 225-226)."""

    p0: MPD
    hard_team: HardConds
    base_cset: ConstraintSet
    cons_radius: torch.Tensor  # ()
    hard_weight: torch.Tensor  # ()
    soft_weight: torch.Tensor  # ()
    tmask: torch.Tensor        # (A, H): 0 at waypoint 0, else 1
    margin: float
    mesh: object = None        # a `sharding.Mesh` the team's calls shard over

    @staticmethod
    def of(planners: Sequence[MPD], margin: float, mesh=None) -> "PrioritizedTeam":
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
            soft_weight=torch.full((), default_params.weight_grad_cost_soft_constraints,
                                   **kw),
            tmask=tmask, margin=float(margin), mesh=mesh)

    def initial_carry(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(sel_pos (A, H, 2), planned (A,)): every row unplanned, at a far
        sentinel of its own, 1e6 + 1e3 i (team.py:173-176): identical
        sentinels would count as collisions with each other."""
        A, H = self.tmask.shape
        kw = dict(dtype=torch.float32, device=self.tmask.device)
        far = torch.stack([torch.full((A,), 1e6, **kw) + 1e3 * torch.arange(A, **kw),
                           torch.full((A,), 1e6, **kw)], dim=-1)
        return far[:, None, :].expand(A, H, 2).clone(), torch.zeros((A,), **kw)

    def plan_under(self, i: int, noise: SamplerNoise,
                   balls: Optional[SoftPathConstraints] = None) -> PlanResult:
        """Agent i's fresh plan with no constraint but `balls`."""
        gd = GuideData(scene=self.p0.scene, normalizer=self.p0.dataset.normalizer,
                       constraints=self.base_cset, soft_paths=balls)
        hard = HardConds(mask=self.hard_team.mask, values=self.hard_team.values[i])
        return self.p0._plan_fresh(gd, noise, hard)

    def plan_problems(self, noise_l: Sequence[SamplerNoise],
                      balls: Optional[SoftPathConstraints] = None) -> PlanResult:
        """Every agent's fresh plan on planner 0's program as one sampler
        call (JAX's vmapped team programs): agent i with draws noise_l[i]
        and no constraint but balls' i-th rows (A, R, H, ...) if given.
        The result leads with the agent. Under a mesh this rank plans its
        agents and the result's SHARED_FIELDS are gathered (`share_rows`)."""
        hard, noise = shard_team_inputs(self.mesh, self.hard_team, noise_l)
        rows = team_rows(self.mesh, len(noise_l))
        if rows is not None and balls is not None:
            balls = balls.take(rows)
        gd = GuideData(scene=self.p0.scene, normalizer=self.p0.dataset.normalizer,
                       constraints=self.base_cset, soft_paths=balls)
        res = self.p0.plan_fresh_batch(gd, noise, hard.values)
        return share_rows(self.mesh, res, rows is not None)

    def balls(self, sel_pos: torch.Tensor, mask: torch.Tensor,
              weight: torch.Tensor) -> SoftPathConstraints:
        """A ball around each (row, waypoint) of sel_pos (A, H, 2) where
        mask (A, H) is 1."""
        return SoftPathConstraints(points=sel_pos, mask=mask, radius=self.cons_radius,
                                   weight=weight)

    def plan_agent(self, sel_pos: torch.Tensor, planned: torch.Tensor, i: int,
                   noise: SamplerNoise) -> PlanResult:
        """Agent i's plan under hard keep-out balls around the planned rows
        of the carry (team.py:145-160)."""
        return self.plan_under(i, noise, self.balls(sel_pos, planned[:, None] * self.tmask,
                                                    self.hard_weight))

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
        sel_pos[i] = _chosen_row(res, ix)
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
    """A team pass on the device: trajs (A, B, H, D), free_any (A,), the
    chosen index ix (A,), free_mask (A, B), the final selection's conflict
    summary (count, t, a, b, midpoint), and the clock of the agents'
    steps."""

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
    return _team_result(outs, sel_pos, team.margin, clock)


def _team_result(outs: Sequence[Tuple[PlanResult, torch.Tensor]], sel_pos: torch.Tensor,
                 margin: float, clock: AgentClock) -> ScanResult:
    return ScanResult(
        trajs=torch.stack([r.trajs_final for r, _ in outs]),
        free_any=torch.stack([r.free_mask.any() for r, _ in outs]),
        ix=torch.stack([ix for _, ix in outs]),
        free_mask=torch.stack([r.free_mask for r, _ in outs]),
        summary=team_conflict_summary(sel_pos, margin),
        clock=clock)


def _chosen_row(res: PlanResult, ix: torch.Tensor) -> torch.Tensor:
    """(H, 2) positions of candidate ix, gathered with a device index."""
    return res.trajs_final.index_select(0, ix.reshape(1))[0, :, :2]


def plan_fresh_team(team: PrioritizedTeam, noise_l: Sequence[SamplerNoise]) -> ScanResult:
    """The CBS/XCBS root: every agent's unconstrained fresh plan, its
    least-cost free candidate, and the root's conflict summary
    (`plan_fresh_team` with `_fresh_team_with_summary`, team.py:26-45,
    247-261): the A plans as one sampler call, without a host sync. Its
    clock holds that one call."""
    clock = AgentClock(team.tmask.device)
    clock.mark()
    res = team.plan_problems(noise_l)
    clock.mark()
    return _batch_result(res, team.margin, clock)


def _batch_result(res: PlanResult, margin: float, clock: AgentClock) -> ScanResult:
    """A team's batched plans (fields leading with the agent) as a
    ScanResult, each agent at its least-cost candidate."""
    rows = torch.arange(res.idx_best.shape[0], device=res.idx_best.device)
    pos = res.trajs_final[rows, res.idx_best][..., :2]
    return ScanResult(trajs=res.trajs_final, free_any=res.free_mask.any(dim=-1),
                      ix=res.idx_best, free_mask=res.free_mask,
                      summary=team_conflict_summary(pos, margin), clock=clock)


def plan_sequential_root_soft(team: PrioritizedTeam, noise_l: Sequence[SamplerNoise],
                              fallback_l: Sequence[SamplerNoise],
                              read: Callable[[torch.Tensor], bool]) -> ScanResult:
    """The ECBS root (`plan_sequential_root_soft` with
    `_sequential_root_with_summary`, team.py:49-112, 264-280): agent i
    plans with noise_l[i] under soft balls around the chosen paths of the
    agents before it (masked `planned[:, None] * tmask`, waypoint 0
    excluded) and takes its least-cost free candidate. If `read`, given the
    device flag "the batch has a free trajectory", returns False, the agent
    plans again with fallback_l[i] and every ball masked (JAX's `lax.cond`,
    team.py:97-101). `read` is the loop's only host read. Under a mesh
    every rank plans each agent whole and rank 0's fields are broadcast
    (`share_rows`)."""
    A, H = team.tmask.shape
    kw = dict(dtype=torch.float32, device=team.tmask.device)
    sel_pos, planned = torch.zeros((A, H, 2), **kw), torch.zeros((A,), **kw)
    none = torch.zeros((A, H), **kw)
    clock = AgentClock(team.tmask.device)
    clock.mark()
    outs = []
    for i in range(A):
        balls = team.balls(sel_pos, planned[:, None] * team.tmask, team.soft_weight)
        res = share_rows(team.mesh, team.plan_under(i, noise_l[i], balls), sharded=False)
        if not read(res.free_mask.any()):
            res = share_rows(team.mesh, team.plan_under(
                i, fallback_l[i], team.balls(sel_pos, none, team.soft_weight)), sharded=False)
        sel_pos = sel_pos.clone()
        sel_pos[i] = _chosen_row(res, res.idx_best)
        planned = planned.clone()
        planned[i].fill_(1.0)  # not `= 1.0`, which waits for the card
        outs.append((res, res.idx_best))
        clock.mark()
    return _team_result(outs, sel_pos, team.margin, clock)


def team_soft_paths(pos: torch.Tensor, radius: float,
                    weight: Optional[float] = None) -> SoftPathConstraints:
    """Every agent's soft group from the team's chosen positions
    (team.py:366-387): pos (A, T, 2) -> SoftPathConstraints whose fields
    lead with the agent: agent i's A - 1 rows are the other agents' paths,
    masked to t in [1, T - 1]; radius and weight (A,). Built on pos's
    device."""
    A, T, _ = pos.shape
    if weight is None:
        weight = default_params.weight_grad_cost_soft_constraints
    kw = dict(dtype=torch.float32, device=pos.device)
    points = torch.stack([torch.cat([pos[:i], pos[i + 1:]]) for i in range(A)])
    live = (torch.arange(T, device=pos.device) >= 1).to(torch.float32)
    return SoftPathConstraints(points=points.to(torch.float32),
                               mask=live.expand(A, A - 1, T).contiguous(),
                               radius=torch.full((A,), float(radius), **kw),
                               weight=torch.full((A,), float(weight), **kw))


class TeamPlans(NamedTuple):
    """Every agent's batch of one team pass: trajs_final (A, B, H, D) and
    free_mask (A, B)."""

    trajs_final: torch.Tensor
    free_mask: torch.Tensor


def plan_fresh_team_soft(team: PrioritizedTeam, soft_team: SoftPathConstraints,
                         noise_l: Sequence[SamplerNoise]) -> TeamPlans:
    """A Jacobi repair round's plans (team.py:318-337): agent i plans fresh
    with noise_l[i] and no constraint but its own soft group, soft_team's
    i-th rows (`team_soft_paths`); the A plans as one sampler call, without
    a host sync."""
    res = team.plan_problems(noise_l, balls=soft_team)
    return TeamPlans(trajs_final=res.trajs_final, free_mask=res.free_mask)


def team_select_by_conflicts(cand_all: torch.Tensor, free_all: torch.Tensor,
                             prev_pos: torch.Tensor, margin: float):
    """Per-agent least-collisions selection against the team's previous
    paths (team.py:340-363): cand_all (A, B, T, 2), free_all (A, B),
    prev_pos (A, T, 2) -> (ix (A,), its count (A,), the count of the
    agent's current path (A,)); the count is INT32_MAX where an agent has
    no free candidate. No search calls it (JAX's repair does not either):
    it is JAX's public helper, held against JAX's in the tests."""
    ix, new_counts = least_conflicts(cand_all, free_all, prev_pos, margin)
    return ix, new_counts, team_candidate_counts(prev_pos[:, None], prev_pos, margin)[:, 0]
