"""CT expansions on the device: plan, select, summarize, update.

Twin of the non-speculative programs of
`mmd_tpu/planners/multi_agent/fused.py` (reference: cbs.py:390-466). Each
replans a child's agent, takes the free candidate with the fewest team
conflicts, summarizes the team's conflicts with it in place and updates the
team tensor, all on the device; the caller reads the scalars once. JAX
compiles each into one program with its invariants baked in (its program
cache and `_bake_key`); PyTorch compiles nothing, so here they are plain
functions of the planner.
- `expand_fresh`/`expand_local` (fused.py:65, 821): one child, a fresh or
  (XCBS) a local replan, under the planner's own hard conditions
- `expand_children` (fused.py:99-195): every child of a conflict, one after
  the other (`torch.func.vmap` cannot pass the kernels' ctypes calls), with
  ECBS's soft balls built on the device from the parent's chosen paths
- `expand_child_ensemble` (fused.py:732-806): one child of a multi-tile
  (`MPDEnsemble`) agent on a staggered clock: the ensemble plan, global
  assembly, stagger padding, the fewest-conflicts choice, the summary and
  the team update
- the speculative search (fused.py:198-729): `greedy_expand`, k
  best-first CT expansions down the less-conflicted child; `root_greedy`,
  the team's root and that chain from it; `frontier_greedy_expand`, the
  chains of M open nodes one after another; `frontier_expand`, both
  children of M nodes. The conflict each step expands is data on the
  device, so a chain indexes with device tensors (`index_select`,
  `index_copy`, `torch.where`) and reads one flag a step, whether its carry
  froze, to stop where JAX's `while_loop` stops.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from mmd_torch.costs.constraints import ConstraintSet, SoftPathConstraints
from mmd_torch.costs.guide import GuideData
from mmd_torch.models.diffusion import HardConds, SamplerNoise
from mmd_torch.parallel.team import (
    PrioritizedTeam,
    ScanResult,
    plan_fresh_team,
    plan_sequential_root_soft,
)
from mmd_torch.planners.multi_agent.conflict_detection import (
    INT32_MAX,
    pad_team_positions,
    select_candidate_and_conflicts,
)
from mmd_torch.planners.single_agent.mpd import MPD, PlanResult
from mmd_torch.planners.single_agent.mpd_ensemble import MPDEnsemble

# (any_free, ix, count, t, a, b, midpoint), tensors on the device.
Scalars = Tuple[torch.Tensor, ...]


def _best_pos(paths_all: torch.Tensor, ix_best: torch.Tensor) -> torch.Tensor:
    """(n, B, H, D), (n,) -> (n, H, 2) positions of the chosen paths."""
    n = paths_all.shape[0]
    return paths_all[torch.arange(n, device=paths_all.device), ix_best][..., :2]


def _select(res: PlanResult, best_pos: torch.Tensor, agent_idx: int,
            margin: float) -> Scalars:
    return (res.free_mask.any(), *select_candidate_and_conflicts(
        res.trajs_final[..., :2], res.free_mask, agent_idx, best_pos, margin))


def select_and_update(res: PlanResult, paths_all: torch.Tensor, ix_best: torch.Tensor,
                      agent_idx: int, margin: float) -> Tuple[torch.Tensor, Scalars]:
    """The team tensor with agent_idx's row replaced by the new batch, and
    the scalars of the fewest-conflicts choice (fused.py:55-62)."""
    scalars = _select(res, _best_pos(paths_all, ix_best), agent_idx, margin)
    new_paths = paths_all.clone()
    new_paths[agent_idx] = res.trajs_final
    return new_paths, scalars


def expand_fresh(planner: MPD, gd: GuideData, noise: SamplerNoise, paths_all: torch.Tensor,
                 ix_best: torch.Tensor, agent_idx: int, margin: float):
    """A fresh replan of agent_idx under `gd`, chosen and summarized."""
    res = planner._plan_fresh(gd, noise, planner.hard_conds)
    return select_and_update(res, paths_all, ix_best, agent_idx, margin)


def expand_local(planner: MPD, gd: GuideData, noise: SamplerNoise, paths_all: torch.Tensor,
                 ix_best: torch.Tensor, agent_idx: int, margin: float):
    """XCBS: agent_idx's current batch, normalized, warm-starts a local
    replan under `gd`; chosen and summarized."""
    seed = gd.normalizer.normalize(paths_all[agent_idx])
    res = planner._plan_local(gd, seed, noise, planner.hard_conds)
    return select_and_update(res, paths_all, ix_best, agent_idx, margin)


def expand_children(p0: MPD, hard_c: HardConds, csets: Sequence[ConstraintSet],
                    noise_l: Sequence[SamplerNoise], paths_all: torch.Tensor,
                    ix_best: torch.Tensor, agent_ids: Sequence[int], margin: float,
                    soft_radius: torch.Tensor, soft_weight: torch.Tensor,
                    use_soft: bool, local: bool) -> Tuple[torch.Tensor, Scalars]:
    """The children of one conflict on planner 0's program (the planners
    are batchable): child c replans agent agent_ids[c] under the hard
    conditions hard_c.values[c] (C, H, D) and its constraint set csets[c],
    with draws noise_l[c]; fresh, or local from the parent's batch with
    `local`; under soft balls around the other agents' chosen paths with
    `use_soft` (its own row and waypoint 0 masked, fused.py:165-169). Its
    choice and summary are taken against the parent's chosen paths.
    Returns (trajs (C, B, H, D), scalars each stacked over C)."""
    n, H = paths_all.shape[0], paths_all.shape[2]
    best_pos = _best_pos(paths_all, ix_best)
    if use_soft:
        tmask = torch.ones((n, H), dtype=torch.float32, device=paths_all.device)
        tmask[:, 0] = 0.0
    trajs: List[torch.Tensor] = []
    scalars: List[Scalars] = []
    for c, agent_idx in enumerate(agent_ids):
        spc = None
        if use_soft:
            rmask = torch.ones((n, 1), dtype=torch.float32, device=paths_all.device)
            rmask[agent_idx] = 0.0
            spc = SoftPathConstraints(points=best_pos, mask=rmask * tmask,
                                      radius=soft_radius, weight=soft_weight)
        gd = GuideData(scene=p0.scene, normalizer=p0.dataset.normalizer,
                       constraints=csets[c], soft_paths=spc)
        hard = HardConds(mask=hard_c.mask, values=hard_c.values[c])
        if local:
            seed = gd.normalizer.normalize(paths_all[agent_idx])
            res = p0._plan_local(gd, seed, noise_l[c], hard)
        else:
            res = p0._plan_fresh(gd, noise_l[c], hard)
        trajs.append(res.trajs_final)
        scalars.append(_select(res, best_pos, agent_idx, margin))
    return torch.stack(trajs), tuple(torch.stack(x) for x in zip(*scalars))


def expand_child_ensemble(planner: MPDEnsemble, gds: GuideData, noise: SamplerNoise,
                          paths_all: torch.Tensor, ix_best: torch.Tensor, agent_idx: int,
                          start_times: torch.Tensor, T_out: int, margin: float,
                          soft_radius: torch.Tensor, soft_weight: torch.Tensor,
                          use_soft: bool, local: bool) -> Tuple[torch.Tensor, Scalars]:
    """One CT child of the multi-tile agent agent_idx, on the device
    (reference: cbs.py:390-466 against MPDEnsemble, mpd_ensemble.py:335-528).

    paths_all (A, B, L, D) holds the team's global batches (L = T * H for
    every agent), start_times (A,) the stagger offsets on the device, and
    T_out = max(start_times) + L. `gds` carries the child's hard
    constraints, routed per tile. With `use_soft` (ECBS) the soft balls are
    built here, per tile, from the other agents' padded chosen paths: tile
    m's local step h is the agent's global time u = m * H + h, and another
    agent's position at absolute time start_times[agent_idx] + u becomes a
    ball in tile m's frame; waypoint 0 of the agent's path has none
    (reference cbs.py:468-506 routed by split_cost_constraints_to_tasks).
    With `local` (XCBS) the agent's current global batch, split into local
    normalized seeds per tile, warm-starts the replan. The candidate is
    padded onto the team's clock and chosen by fewest conflicts.
    Returns (paths_all with the agent's row replaced, scalars)."""
    A, B, L, D = paths_all.shape
    T, H = planner.n_tiles, planner.n_support_points
    others_pad = pad_team_positions(_best_pos(paths_all, ix_best), start_times, T_out)
    start = start_times[agent_idx]

    if use_soft:
        u = torch.arange(L, device=paths_all.device).reshape(T, H)
        tau = torch.clamp(start + u, 0, T_out - 1)
        pts = others_pad[:, tau].permute(1, 0, 2, 3) - planner._transforms[:, None, None, :]
        rmask = (torch.arange(A, device=paths_all.device) != agent_idx).to(torch.float32)
        msk = rmask[None, :, None] * (u[:, None, :] >= 1).to(torch.float32)   # (T, A, H)
        gds = GuideData(scene=gds.scene, normalizer=gds.normalizer,
                        constraints=gds.constraints,
                        soft_paths=SoftPathConstraints(points=pts, mask=msk,
                                                       radius=soft_radius.expand(T),
                                                       weight=soft_weight.expand(T)))

    if local:
        res = planner._plan_local(gds, planner.local_seeds(paths_all[agent_idx]), noise)
    else:
        res = planner._plan_fresh(gds, noise)

    idx = torch.clamp(torch.arange(T_out, device=paths_all.device) - start, 0, L - 1)
    cand_pad = res.trajs_final[..., :2][:, idx, :]                       # (B, T_out, 2)
    scalars = (res.free_mask.any(), *select_candidate_and_conflicts(
        cand_pad, res.free_mask, agent_idx, others_pad, margin))
    new_paths = paths_all.clone()
    new_paths[agent_idx] = res.trajs_final
    return new_paths, scalars


# ------------------------------------------------------- speculative search
def _cset_from_rows(q_rows: torch.Tensor, t_rows: torch.Tensor, n: torch.Tensor,
                    radius: torch.Tensor, weight: torch.Tensor) -> ConstraintSet:
    """Point-constraint buffer rows as a ConstraintSet of K constraints of
    one point each (fused.py:198-215): q_rows (K, 2) centres, t_rows (K, 2)
    t-ranges, n the live-row count (a device tensor, not read), radius and
    weight () tensors. `n_active` is 1: a chain's set holds at least the
    row it added, and the guide only tests the count for zero."""
    K = q_rows.shape[0]
    live = (torch.arange(K, device=q_rows.device) < n).to(torch.float32)
    return ConstraintSet(q=q_rows[:, None, :], t_range=t_rows[:, None, :],
                         radius=radius.expand(K, 1).to(torch.float32),
                         weight=weight * live, point_mask=live[:, None], active=live,
                         n_active=1)


class Carry(NamedTuple):
    """A chain's node on the device: the team's batches (A, B, H, D), the
    chosen indices (A,), the constraint buffers cons_q (A, K, 2), cons_t
    (A, K, 2), cons_n (A,), and the node's conflict summary (count, t, a,
    b, midpoint)."""

    paths: torch.Tensor
    ix: torch.Tensor
    cons_q: torch.Tensor
    cons_t: torch.Tensor
    cons_n: torch.Tensor
    conflict: tuple


class Records(NamedTuple):
    """A chain's records, one row a step (fused.py:241-246): the children's
    batches (k, 2, B, H, D), their agents, any-free flags, chosen indices,
    summaries (count, t, a, b (k, 2), midpoint (k, 2, 2)), the child the
    chain descended into (k,) and whether the step was valid (k,). Rows
    after the chain froze are zero and invalid."""

    trajs: torch.Tensor
    agents: torch.Tensor
    any_free: torch.Tensor
    ix: torch.Tensor
    counts: torch.Tensor
    t: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    mid: torch.Tensor
    chosen: torch.Tensor
    valid: torch.Tensor


def _plan_child(p0: MPD, gd: GuideData, hard: HardConds, paths: torch.Tensor,
                agent: torch.Tensor, noise: SamplerNoise, local: bool) -> PlanResult:
    """A child's replan on planner 0's program: fresh, or (XCBS) local from
    the agent's current batch."""
    if local:
        seed = gd.normalizer.normalize(paths.index_select(0, agent.reshape(1))[0])
        return p0._plan_local(gd, seed, noise, hard)
    return p0._plan_fresh(gd, noise, hard)


def _child(team: PrioritizedTeam, node: Carry, best_pos: torch.Tensor, agent: torch.Tensor,
           lo: torch.Tensor, hi: torch.Tensor, noise: SamplerNoise, use_soft: bool,
           local: bool):
    """One child of the node's first conflict (fused.py:253-295): `agent`
    (a device index) replanned under its accumulated constraints plus the
    new one, centred on the conflict's midpoint over [lo, hi], its row
    written at min(n_a, K - 1); ECBS's soft balls around the other
    agents' chosen paths (its own row and waypoint 0 masked); the free
    candidate with the fewest team conflicts and the team's summary with
    it. Returns (trajs, any_free, (ix, count, t, a, b, mid), cons_q,
    cons_t, cons_n) of the child."""
    a1 = agent.reshape(1)
    K = node.cons_q.shape[1]
    n_a = node.cons_n.index_select(0, a1)
    slot = a1 * K + torch.clamp(n_a, max=K - 1)
    cq = node.cons_q.reshape(-1, 2).index_copy(0, slot, node.conflict[4].reshape(1, 2))
    ct = node.cons_t.reshape(-1, 2).index_copy(0, slot, torch.stack([lo, hi])[None])
    cq, ct = cq.reshape(node.cons_q.shape), ct.reshape(node.cons_t.shape)
    cn = node.cons_n.index_add(0, a1, torch.ones_like(n_a))
    cset = _cset_from_rows(cq.index_select(0, a1)[0], ct.index_select(0, a1)[0],
                           cn.index_select(0, a1)[0], team.cons_radius, team.hard_weight)
    spc = None
    if use_soft:
        rows = torch.arange(best_pos.shape[0], device=best_pos.device)
        rmask = (rows != agent).to(torch.float32)[:, None]
        spc = SoftPathConstraints(points=best_pos, mask=rmask * team.tmask,
                                  radius=team.cons_radius, weight=team.soft_weight)
    p0 = team.p0
    gd = GuideData(scene=p0.scene, normalizer=p0.dataset.normalizer, constraints=cset,
                   soft_paths=spc)
    hard = HardConds(mask=team.hard_team.mask,
                     values=team.hard_team.values.index_select(0, a1)[0])
    res = _plan_child(p0, gd, hard, node.paths, agent, noise, local)
    sel = select_candidate_and_conflicts(res.trajs_final[..., :2], res.free_mask, agent,
                                         best_pos, team.margin)
    return res.trajs_final, res.free_mask.any(), sel, cq, ct, cn


def _children(team: PrioritizedTeam, node: Carry, noise2: Sequence[SamplerNoise],
              use_soft: bool, local: bool, t_pad: int = 2):
    """Both children of the node's first conflict (a, b), one after the
    other, each constraining one agent over [t - t_pad, t + t_pad] clamped
    to [0, H - 1]. Returns (agents (2,), the two children of `_child`)."""
    H = node.paths.shape[2]
    _, t0, a0, b0, _ = node.conflict
    lo = torch.clamp(t0 - t_pad, 0, H - 1).to(torch.float32)
    hi = torch.clamp(t0 + t_pad, 0, H - 1).to(torch.float32)
    agents = torch.stack([a0, b0])
    rows = torch.arange(node.paths.shape[0], device=node.paths.device)
    best_pos = node.paths[rows, node.ix][..., :2]
    return agents, [_child(team, node, best_pos, agents[c], lo, hi, noise2[c], use_soft, local)
                    for c in range(2)]


def _stack_children(kids):
    """(trajs (2, B, H, D), any_free (2,), ix, count, t, a, b (2,), mid (2, 2))."""
    return (torch.stack([k[0] for k in kids]), torch.stack([k[1] for k in kids]),
            *(torch.stack(x) for x in zip(*[k[2] for k in kids])))


def greedy_expand(team: PrioritizedTeam, noise: Sequence[Sequence[SamplerNoise]],
                  node: Carry, use_soft: bool, local: bool, k_iters: int,
                  frozen: Callable[[torch.Tensor], bool],
                  start_done: Optional[torch.Tensor] = None) -> Tuple[Records, int]:
    """k speculative best-first CT expansions from `node` (`_greedy_core`
    and `greedy_expand`, fused.py:218-422), the 2k children's draws,
    noise[s][c], drawn before the chain.

    Each step expands the current node's first conflict into its two
    children (noise[s][0], noise[s][1]) and descends into the free child
    with the fewest conflicts (the first on a tie). The carry freezes once
    the node is solved (count 0), both children are starved, or a
    constraint buffer would overflow (cons_n[a] >= K or cons_n[b] >= K,
    tested before the add): a step is valid only if none held before it.
    Before every step but an unforced first one, `frozen` reads the flag
    "the carry froze" (JAX's `while_loop` condition); that read is the
    chain's only host sync. The host then checks the records against its
    open list (`CBS._process_greedy`). Returns (records, steps run): each
    step ran two child plans."""
    dev = node.paths.device
    done = (start_done if start_done is not None
            else torch.zeros((), dtype=torch.bool, device=dev))
    K = node.cons_q.shape[1]
    rows: List[tuple] = []
    for s in range(k_iters):
        if (s > 0 or start_done is not None) and frozen(done):
            break
        agents, kids = _children(team, node, noise[s], use_soft, local)
        trajs2, free2, ix2, count2, t2, a2, b2, mid2 = _stack_children(kids)
        masked = torch.where(free2, count2, torch.full_like(count2, INT32_MAX))
        j = torch.argmin(masked).reshape(1)

        def pick(x):
            return x.index_select(0, j)[0]

        agent_j = agents.index_select(0, j)
        count0 = node.conflict[0]
        overflow = (node.cons_n.index_select(0, agents) >= K).any()
        valid = ~done & (count0 > 0) & ~overflow
        step_done = done | (count0 == 0) | ~free2.any() | overflow
        new = Carry(paths=node.paths.index_copy(0, agent_j, trajs2.index_select(0, j)),
                    ix=node.ix.index_copy(0, agent_j, ix2.index_select(0, j).to(node.ix.dtype)),
                    cons_q=pick(torch.stack([kids[0][3], kids[1][3]])),
                    cons_t=pick(torch.stack([kids[0][4], kids[1][4]])),
                    cons_n=pick(torch.stack([kids[0][5], kids[1][5]])),
                    conflict=tuple(pick(x) for x in (count2, t2, a2, b2, mid2)))
        node = Carry(*(torch.where(step_done, o, n) for o, n in zip(node[:5], new[:5])),
                     conflict=tuple(torch.where(step_done, o, n)
                                    for o, n in zip(node.conflict, new.conflict)))
        done = step_done
        rows.append((trajs2, agents, free2, ix2, count2, t2, a2, b2, mid2, j[0], valid))
    return _pad_records(rows, k_iters, node.paths), len(rows)


def _pad_records(rows: List[tuple], k_iters: int, paths: torch.Tensor) -> Records:
    """The steps' records stacked, and zero rows up to k_iters."""
    A, B, H, D = paths.shape
    kw = dict(device=paths.device)
    zero = Records(
        trajs=torch.zeros((2, B, H, D), dtype=paths.dtype, **kw),
        agents=torch.zeros((2,), dtype=torch.int64, **kw),
        any_free=torch.zeros((2,), dtype=torch.bool, **kw),
        ix=torch.zeros((2,), dtype=torch.int64, **kw),
        counts=torch.zeros((2,), dtype=torch.int32, **kw),
        t=torch.zeros((2,), dtype=torch.int64, **kw),
        a=torch.zeros((2,), dtype=torch.int64, **kw),
        b=torch.zeros((2,), dtype=torch.int64, **kw),
        mid=torch.zeros((2, 2), dtype=paths.dtype, **kw),
        chosen=torch.zeros((), dtype=torch.int64, **kw),
        valid=torch.zeros((), dtype=torch.bool, **kw))
    rows = rows + [tuple(zero)] * (k_iters - len(rows))
    return Records(*(torch.stack([r[f] for r in rows]) for f in range(len(zero))))


def frontier_greedy_expand(team: PrioritizedTeam,
                           noise_m: Sequence[Sequence[Sequence[SamplerNoise]]],
                           nodes: Sequence[Carry], use_soft: bool, local: bool, k_iters: int,
                           frozen: Callable[[torch.Tensor], bool]
                           ) -> List[Tuple[Records, int]]:
    """The chains of M open nodes (fused.py:482-541): JAX vmaps
    `_greedy_core` over the node axis; here they run one after another,
    node m with draws noise_m[m], which JAX's
    test_frontier_greedy_matches_per_node_greedy shows is the same."""
    return [greedy_expand(team, noise, node, use_soft, local, k_iters, frozen)
            for noise, node in zip(noise_m, nodes)]


def frontier_expand(team: PrioritizedTeam, noise_m: Sequence[Sequence[SamplerNoise]],
                    nodes: Sequence[Carry], use_soft: bool, local: bool) -> tuple:
    """Both children of M open nodes (fused.py:425-479, 544-615): each the
    single-node expansion of its own parent, as a chain's first step makes
    it. Returns (trajs (M, 2, B, H, D), any_free, ix, count, t, a, b
    (M, 2), mid (M, 2, 2), agents (M, 2)). `CBS` does not call it (it
    takes `frontier_greedy_expand`), as JAX's does not: it is held against
    JAX's in the tests."""
    out = []
    for noise2, node in zip(noise_m, nodes):
        agents, kids = _children(team, node, noise2, use_soft, local)
        out.append((*_stack_children(kids), agents))
    return tuple(torch.stack(x) for x in zip(*out))


def root_greedy(team: PrioritizedTeam, root_noise: Sequence[SamplerNoise],
                fallback_noise: Sequence[SamplerNoise],
                chain_noise: Sequence[Sequence[SamplerNoise]], kbuf: int, use_soft: bool,
                local: bool, k_iters: int, sequential_root: bool,
                read_free: Callable[[torch.Tensor], bool],
                frozen: Callable[[torch.Tensor], bool]) -> Tuple[ScanResult, Records, int]:
    """The root, its summary and the chain from it (fused.py:618-726): the
    ECBS sequential soft root (`plan_sequential_root_soft`, its one flag
    read an agent through `read_free`) or every agent fresh
    (`plan_fresh_team`); then the chain from empty buffers of kbuf rows,
    started frozen where the root is solved or an agent has no free
    sample, so that such a root computes no child. Returns (the root's
    pass, the records, steps run)."""
    if sequential_root:
        out = plan_sequential_root_soft(team, root_noise, fallback_noise, read_free)
    else:
        out = plan_fresh_team(team, root_noise)
    A, dev = out.trajs.shape[0], out.trajs.device
    count = out.summary[0]
    node = Carry(out.trajs, out.ix,
                 cons_q=torch.zeros((A, kbuf, 2), dtype=torch.float32, device=dev),
                 cons_t=torch.zeros((A, kbuf, 2), dtype=torch.float32, device=dev),
                 cons_n=torch.zeros((A,), dtype=torch.int32, device=dev),
                 conflict=tuple(out.summary))
    records, n = greedy_expand(team, chain_noise, node, use_soft, local, k_iters, frozen,
                               start_done=(count == 0) | ~out.free_any.all())
    return out, records, n
