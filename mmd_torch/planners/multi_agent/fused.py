"""CT expansions on the device: plan, select, summarize, update.

Twin of the non-speculative programs of
`mmd_tpu/planners/multi_agent/fused.py` (reference: cbs.py:390-466). Each
replans a child's agent, takes the free candidate with the fewest team
conflicts, summarizes the team's conflicts with it in place and updates the
team tensor, all on the device; the caller reads the scalars once. JAX
compiles each into one program with its invariants baked in (its program
cache and `_bake_key`); PyTorch compiles nothing, so here they are plain
functions of the planner. Where JAX vmaps over children or nodes, the
children here are one batch of N problems on planner 0's program, one
sampler call (`_plan_children`): `torch.func.vmap` cannot pass the
kernels' ctypes calls, so the batch dimension is written out.
- `expand_fresh`/`expand_local` (fused.py:65, 821): one child, a fresh or
  (XCBS) a local replan, under the planner's own hard conditions
- `expand_children` (fused.py:99-195): every child of a conflict in one
  sampler call, their constraint sets padded to a common (K, P), with
  ECBS's soft balls built on the device from the parent's chosen paths
- `expand_child_ensemble` (fused.py:732-806): one child of a multi-tile
  (`MPDEnsemble`) agent on a staggered clock: the ensemble plan, global
  assembly, stagger padding, the fewest-conflicts choice, the summary and
  the team update
- the speculative search (fused.py:198-729): `greedy_expand`, k
  best-first CT expansions down the less-conflicted child, a step's two
  children one sampler call; `root_greedy`, the team's root and that chain
  from it; `frontier_greedy_expand`, the chains of M open nodes in
  lockstep, a step's 2M children one sampler call; `frontier_expand`, both
  children of M nodes in one call. The conflict each step expands is data
  on the device, so a chain indexes with device tensors (`index_select`,
  `index_copy`, `torch.where`) and reads one flag a step, whether its
  carry (every chain's, in a frontier) froze, to stop where JAX's
  `while_loop` stops.
Under a `parallel.sharding` mesh with an 'agent' axis, every sampler call
of N children shards or runs replicated as `_plan_children_on` says, and
every rank then holds the same children.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from mmd_torch.costs.constraints import (
    ConstraintSet,
    SoftPathConstraints,
    stack_constraint_sets,
)
from mmd_torch.costs.guide import GuideData
from mmd_torch.models.diffusion import HardConds, SamplerNoise
from mmd_torch.parallel.sharding import shard_leading_axis
from mmd_torch.parallel.team import (
    PrioritizedTeam,
    ScanResult,
    plan_fresh_team,
    plan_sequential_root_soft,
    share_rows,
    team_rows,
)
from mmd_torch.planners.multi_agent.conflict_detection import (
    INT32_MAX,
    pad_team_positions,
    select_candidate_and_conflicts,
)
from mmd_torch.planners.single_agent.mpd import MPD, PlanResult
from mmd_torch.planners.single_agent.mpd_ensemble import MPDEnsemble
from mmd_torch.utils.transfer import to_device

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


def _soft_rows(best_pos: torch.Tensor, agents: torch.Tensor, radius: torch.Tensor,
               weight: torch.Tensor) -> SoftPathConstraints:
    """ECBS's soft balls of N children: child n's rows are the chosen
    paths best_pos[n] (N, A, H, 2) of its parent, its own agent's row
    agents[n] and waypoint 0 masked (fused.py:165-169)."""
    N, A, H = best_pos.shape[:3]
    rows = torch.arange(A, device=best_pos.device)
    rmask = (rows[None, :] != agents[:, None]).to(torch.float32)
    tmask = (torch.arange(H, device=best_pos.device) >= 1).to(torch.float32)
    return SoftPathConstraints(points=best_pos, mask=rmask[:, :, None] * tmask,
                               radius=radius.expand(N), weight=weight.expand(N))


def _plan_children(p0: MPD, gd: GuideData, hard_values: torch.Tensor,
                   seed_paths: torch.Tensor, noise_l: Sequence[SamplerNoise],
                   local: bool) -> PlanResult:
    """N children on planner 0's program as one sampler call: child n under
    the hard-condition values hard_values[n] (H, D), gd's n-th constraint
    set and soft rows, draws noise_l[n]; fresh, or (XCBS) local from its
    agent's current batch seed_paths[n] (N, B, H, D)."""
    if local:
        return p0.plan_local_batch(gd, gd.normalizer.normalize(seed_paths), noise_l,
                                   hard_values)
    return p0.plan_fresh_batch(gd, noise_l, hard_values)


def _plan_children_on(mesh, p0: MPD, gd: GuideData, hard_values: torch.Tensor,
                      seed_paths: torch.Tensor, noise_l: Sequence[SamplerNoise],
                      local: bool) -> PlanResult:
    """`_plan_children` under a mesh: where N divides its 'agent' axis this
    rank plans its children and the result's SHARED_FIELDS are gathered;
    any other N runs on every rank, as JAX leaves such a batch replicated,
    and rank 0's fields are broadcast (`team.share_rows`). Without a mesh,
    `_plan_children` itself."""
    rows = team_rows(mesh, len(noise_l))
    if rows is not None:
        gd = gd.problems(rows)
        hard_values, seed_paths = shard_leading_axis((hard_values, seed_paths), mesh, "agent")
        noise_l = noise_l[rows]
    res = _plan_children(p0, gd, hard_values, seed_paths, noise_l, local)
    return share_rows(mesh, res, rows is not None)


def expand_children(p0: MPD, hard_c: HardConds, cset: ConstraintSet,
                    noise_l: Sequence[SamplerNoise], paths_all: torch.Tensor,
                    ix_best: torch.Tensor, agent_ids: Sequence[int], margin: float,
                    soft_radius: torch.Tensor, soft_weight: torch.Tensor, mesh=None, *,
                    use_soft: bool, local: bool) -> Tuple[torch.Tensor, Scalars]:
    """The children of one conflict on planner 0's program (the planners
    are batchable) as one sampler call (JAX's vmap over the children,
    fused.py:99-196): child c replans agent agent_ids[c] under the hard
    conditions hard_c.values[c] (C, H, D) and cset's c-th set (C, K, P,
    ...: the children's sets padded to a common size,
    `pack_constraint_sets`), with draws noise_l[c]; fresh, or local from
    the parent's batch with `local`; under soft balls around the other
    agents' chosen paths with `use_soft`. Its choice and summary are taken
    against the parent's chosen paths; under `mesh` the sampler call is
    `_plan_children_on`'s. Returns (trajs (C, B, H, D), scalars each stacked
    over C)."""
    C = len(agent_ids)
    best_pos = _best_pos(paths_all, ix_best)
    agents = to_device(list(agent_ids), paths_all.device, torch.int64)
    spc = (_soft_rows(best_pos.expand(C, *best_pos.shape), agents, soft_radius, soft_weight)
           if use_soft else None)
    gd = GuideData(scene=p0.scene, normalizer=p0.dataset.normalizer, constraints=cset,
                   soft_paths=spc)
    res = _plan_children_on(mesh, p0, gd, hard_c.values, paths_all.index_select(0, agents),
                            noise_l, local)
    scalars = [(res.free_mask[c].any(), *select_candidate_and_conflicts(
        res.trajs_final[c, ..., :2], res.free_mask[c], agent_idx, best_pos, margin))
        for c, agent_idx in enumerate(agent_ids)]
    return res.trajs_final, tuple(torch.stack(x) for x in zip(*scalars))


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


def _child_constraints(team: PrioritizedTeam, node: Carry, agent: torch.Tensor,
                       lo: torch.Tensor, hi: torch.Tensor):
    """One child's constraints (fused.py:253-295): `agent` (a (1,) device
    index) under its accumulated constraints plus the new one, centred on
    the node's first conflict's midpoint over [lo, hi], its row written at
    min(n_a, K - 1). Returns (its ConstraintSet of K rows, cons_q, cons_t,
    cons_n of the child)."""
    K = node.cons_q.shape[1]
    n_a = node.cons_n.index_select(0, agent)
    slot = agent * K + torch.clamp(n_a, max=K - 1)
    cq = node.cons_q.reshape(-1, 2).index_copy(0, slot, node.conflict[4].reshape(1, 2))
    ct = node.cons_t.reshape(-1, 2).index_copy(0, slot, torch.stack([lo, hi])[None])
    cq, ct = cq.reshape(node.cons_q.shape), ct.reshape(node.cons_t.shape)
    cn = node.cons_n.index_add(0, agent, torch.ones_like(n_a))
    cset = _cset_from_rows(cq.index_select(0, agent)[0], ct.index_select(0, agent)[0],
                           cn.index_select(0, agent)[0], team.cons_radius, team.hard_weight)
    return cset, cq, ct, cn


def _node_children(team: PrioritizedTeam, node: Carry, t_pad: int = 2):
    """The two children of the node's first conflict (a, b), each
    constraining one agent over [t - t_pad, t + t_pad] clamped to
    [0, H - 1]. Returns (agents (2,), the node's chosen positions
    (A, H, 2), each child's `_child_constraints`)."""
    H = node.paths.shape[2]
    _, t0, a0, b0, _ = node.conflict
    lo = torch.clamp(t0 - t_pad, 0, H - 1).to(torch.float32)
    hi = torch.clamp(t0 + t_pad, 0, H - 1).to(torch.float32)
    agents = torch.stack([a0, b0])
    rows = torch.arange(node.paths.shape[0], device=node.paths.device)
    best_pos = node.paths[rows, node.ix][..., :2]
    return agents, best_pos, [_child_constraints(team, node, agents[c:c + 1], lo, hi)
                              for c in range(2)]


def _expand_nodes(team: PrioritizedTeam, nodes: Sequence[Carry],
                  noise2_m: Sequence[Sequence[SamplerNoise]], use_soft: bool, local: bool):
    """Both children of each node's first conflict, all 2M of them one
    sampler call (JAX's vmap over a step's two children and over the M
    nodes, fused.py:307, 482-541, 611-614): node m's children take draws
    noise2_m[m][0] and [1]; ECBS's soft balls around the node's chosen
    paths; each the free candidate with the fewest team conflicts and the
    team's summary with it. Returns per node (agents (2,), its two
    children's (trajs, any_free, (ix, count, t, a, b, mid), cons_q, cons_t,
    cons_n))."""
    specs = [_node_children(team, node) for node in nodes]
    agents = torch.cat([a for a, _, _ in specs])
    best_pos = torch.stack([bp for _, bp, _ in specs for _ in range(2)])
    kids = [k for _, _, ks in specs for k in ks]
    p0 = team.p0
    gd = GuideData(scene=p0.scene, normalizer=p0.dataset.normalizer,
                   constraints=stack_constraint_sets([k[0] for k in kids]),
                   soft_paths=(_soft_rows(best_pos, agents, team.cons_radius, team.soft_weight)
                               if use_soft else None))
    seed_paths = torch.cat([node.paths.index_select(0, a)
                            for node, (a, _, _) in zip(nodes, specs)])
    res = _plan_children_on(team.mesh, p0, gd, team.hard_team.values.index_select(0, agents),
                            seed_paths, [z for noise2 in noise2_m for z in noise2], local)
    out = []
    for m, (agents_m, _, _) in enumerate(specs):
        kids_m = []
        for c in range(2):
            n = 2 * m + c
            sel = select_candidate_and_conflicts(res.trajs_final[n, ..., :2], res.free_mask[n],
                                                 agents[n], best_pos[n], team.margin)
            kids_m.append((res.trajs_final[n], res.free_mask[n].any(), sel, *kids[n][1:]))
        out.append((agents_m, kids_m))
    return out


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
    children (noise[s][0], noise[s][1]), both one sampler call, and
    descends into the free child with the fewest conflicts (the first on a
    tie). The carry freezes once the node is solved (count 0), both
    children are starved, or a constraint buffer would overflow
    (cons_n[a] >= K or cons_n[b] >= K, tested before the add): a step is
    valid only if none held before it. Before every step but an unforced
    first one, `frozen` reads the flag "the carry froze" (JAX's
    `while_loop` condition); that read is the chain's only host sync. The
    host then checks the records against its open list
    (`CBS._process_greedy`). Returns (records, steps run): each step ran
    two child plans."""
    (records,), n, _ = _chains(team, [noise], [node], use_soft, local, k_iters, frozen,
                               start_done)
    return records, n


def _chains(team: PrioritizedTeam, noise_m: Sequence[Sequence[Sequence[SamplerNoise]]],
            nodes: Sequence[Carry], use_soft: bool, local: bool, k_iters: int,
            frozen: Callable[[torch.Tensor], bool],
            start_done: Optional[torch.Tensor] = None
            ) -> Tuple[List[Records], int, torch.Tensor]:
    """The greedy chains of M nodes in lockstep (`greedy_expand`'s step for
    each, node m with draws noise_m[m]): each step expands every node's two
    children as one sampler call of 2M problems. A frozen chain keeps its
    carry and its zero record rows through `torch.where`, as JAX's vmapped
    `while_loop` keeps them, and the chains stop when every one has
    frozen. Returns (each chain's records, steps run, each chain's own
    steps (M,) on the device: the steps it ran before it froze, as many as
    its `greedy_expand` runs alone)."""
    nodes = list(nodes)
    M, dev = len(nodes), nodes[0].paths.device
    done = (start_done.reshape(1) if start_done is not None
            else torch.zeros((M,), dtype=torch.bool, device=dev))
    K = nodes[0].cons_q.shape[1]
    rows: List[List[tuple]] = [[] for _ in range(M)]
    n_run, own_steps = 0, torch.zeros((M,), dtype=torch.int32, device=dev)
    for s in range(k_iters):
        if (s > 0 or start_done is not None) and frozen(done.all()):
            break
        expanded = _expand_nodes(team, nodes, [noise[s] for noise in noise_m], use_soft, local)
        own_steps = own_steps + (~done).to(torch.int32)
        done_l = []
        for m, (agents, kids) in enumerate(expanded):
            node, was_done = nodes[m], done[m]
            trajs2, free2, ix2, count2, t2, a2, b2, mid2 = _stack_children(kids)
            masked = torch.where(free2, count2, torch.full_like(count2, INT32_MAX))
            j = torch.argmin(masked).reshape(1)

            def pick(x):
                return x.index_select(0, j)[0]

            agent_j = agents.index_select(0, j)
            count0 = node.conflict[0]
            overflow = (node.cons_n.index_select(0, agents) >= K).any()
            valid = ~was_done & (count0 > 0) & ~overflow
            step_done = was_done | (count0 == 0) | ~free2.any() | overflow
            new = Carry(paths=node.paths.index_copy(0, agent_j, trajs2.index_select(0, j)),
                        ix=node.ix.index_copy(0, agent_j,
                                              ix2.index_select(0, j).to(node.ix.dtype)),
                        cons_q=pick(torch.stack([kids[0][3], kids[1][3]])),
                        cons_t=pick(torch.stack([kids[0][4], kids[1][4]])),
                        cons_n=pick(torch.stack([kids[0][5], kids[1][5]])),
                        conflict=tuple(pick(x) for x in (count2, t2, a2, b2, mid2)))
            nodes[m] = Carry(*(torch.where(step_done, o, n) for o, n in zip(node[:5], new[:5])),
                             conflict=tuple(torch.where(step_done, o, n)
                                            for o, n in zip(node.conflict, new.conflict)))
            done_l.append(step_done)
            row = (trajs2, agents, free2, ix2, count2, t2, a2, b2, mid2, j[0], valid)
            rows[m].append(tuple(torch.where(was_done, torch.zeros_like(x), x) for x in row))
        done = torch.stack(done_l)
        n_run += 1
    return ([_pad_records(r, k_iters, node.paths) for r, node in zip(rows, nodes)], n_run,
            own_steps)


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
                           ) -> Tuple[List[Records], int, torch.Tensor]:
    """The chains of M open nodes (fused.py:482-541): JAX vmaps
    `_greedy_core` over the node axis; here they run in lockstep
    (`_chains`), node m with draws noise_m[m], each step one sampler call
    of 2M children, one flag read a step ("every chain froze"). Returns
    (each chain's records, steps run, each chain's own steps (M,) on the
    device): a chain's records and its own steps equal its
    `greedy_expand`'s; a chain that froze still rides in the later
    steps' calls, whose rows for it are discarded."""
    return _chains(team, noise_m, nodes, use_soft, local, k_iters, frozen)


def frontier_expand(team: PrioritizedTeam, noise_m: Sequence[Sequence[SamplerNoise]],
                    nodes: Sequence[Carry], use_soft: bool, local: bool) -> tuple:
    """Both children of M open nodes (fused.py:425-479, 544-615) as one
    sampler call of (M, 2) children: each the single-node expansion of its
    own parent, as a chain's first step makes it. Returns (trajs (M, 2, B,
    H, D), any_free, ix, count, t, a, b (M, 2), mid (M, 2, 2), agents
    (M, 2)). `CBS` does not call it (it takes `frontier_greedy_expand`), as
    JAX's does not: it is held against JAX's in the tests."""
    out = [(*_stack_children(kids), agents)
           for agents, kids in _expand_nodes(team, nodes, noise_m, use_soft, local)]
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
