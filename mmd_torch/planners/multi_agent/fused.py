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
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from mmd_torch.costs.constraints import ConstraintSet, SoftPathConstraints
from mmd_torch.costs.guide import GuideData
from mmd_torch.models.diffusion import HardConds, SamplerNoise
from mmd_torch.planners.multi_agent.conflict_detection import (
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
