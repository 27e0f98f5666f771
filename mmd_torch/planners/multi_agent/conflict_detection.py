"""Multi-agent conflict detection on the device.

Twin of `mmd_tpu/planners/multi_agent/conflict_detection.py` (reference:
mmd/planners/multi_agent/cbs.py:166-246, 446-458). Every candidate of a
batch is scored in one set of tensor ops; team conflict tensors stay on the
device and only `find_conflicts`/`count_conflicts` turn them into host
records. Distances are computed as JAX computes them (`robots.disk.distance`)
so that a tie at the margin is decided alike.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from mmd_torch.common.conflicts import EdgeConflict, PointConflict, VertexConflict
from mmd_torch.robots.disk import check_rr_collisions, distance

INT32_MAX = torch.iinfo(torch.int32).max


def team_collision_tensor(paths_pos: torch.Tensor, margin: float
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """paths_pos (n, T, 2) -> (coll (T, n, n) bool, midpoints (T, n, n, 2)),
    the reference's stacked check (cbs.py:185-193)."""
    return check_rr_collisions(paths_pos.transpose(0, 1), margin)


def candidate_conflict_counts(cand_pos: torch.Tensor, agent_idx: int,
                              paths_pos: torch.Tensor, margin: float) -> torch.Tensor:
    """(B,) int32: the team's ordered-pair conflict count if candidate b
    (cand_pos (B, T, 2)) replaced agent `agent_idx`'s row of paths_pos
    (n, T, 2), as B get_conflicts calls of the reference count it
    (cbs.py:446-458)."""
    n = paths_pos.shape[0]
    hits = distance(cand_pos[:, None, :, :], paths_pos[None, :, :, :]) < margin  # (B, n, T)
    others = torch.arange(n, device=paths_pos.device) != agent_idx
    cnt_agent = (hits & others[None, :, None]).sum(dim=(1, 2))
    coll, _ = team_collision_tensor(paths_pos, margin)
    base = (coll & (others[:, None] & others[None, :])[None]).sum()
    return (2 * cnt_agent + base).to(torch.int32)


def pad_team_positions(paths_pos: torch.Tensor, start_times: torch.Tensor,
                       T_out: int) -> torch.Tensor:
    """Stagger padding as one gather: (n, L, 2), (n,) int -> (n, T_out, 2),
    agent i's first state repeated for start_times[i] steps and its last
    out to T_out (global_pad_paths, multi_agent_utils.py:120-143)."""
    L = paths_pos.shape[1]
    t = torch.arange(T_out, device=paths_pos.device)
    idx = torch.clamp(t[None, :] - start_times[:, None], 0, L - 1)
    return torch.take_along_dim(paths_pos, idx[..., None], dim=1)


def densify_positions(paths_pos: torch.Tensor, factor: int) -> torch.Tensor:
    """(n, T, 2) -> (n, (T-1) * factor + 1, 2): factor-1 evenly spaced points
    inserted between consecutive waypoints (trajectory_utils.py:54-71)."""
    if factor == 1:
        return paths_pos
    n, T, d = paths_pos.shape
    seg = paths_pos[:, 1:] - paths_pos[:, :-1]
    fr = torch.arange(factor, dtype=paths_pos.dtype, device=paths_pos.device) / factor
    pts = paths_pos[:, :-1, None, :] + seg[:, :, None, :] * fr[None, None, :, None]
    return torch.cat([pts.reshape(n, (T - 1) * factor, d), paths_pos[:, -1:]], dim=1)


def team_conflict_summary(paths_pos: torch.Tensor, margin: float):
    """paths_pos (n, T, 2) -> (count, t, a, b, midpoint (2,)), tensors on the
    device: the ordered-pair conflict count and the first hit in row-major
    (t, a, b) order (t = a = b = 0 and a NaN midpoint when there is none)."""
    coll, mid = team_collision_tensor(paths_pos, margin)
    count = coll.sum().to(torch.int32)
    first = torch.argmax(coll.reshape(-1).to(torch.int32))  # the first maximum
    n = paths_pos.shape[0]
    t, rem = first // (n * n), first % (n * n)
    return count, t, rem // n, rem % n, mid.reshape(-1, 2).index_select(0, first.reshape(1))[0]


def select_candidate_and_conflicts(cand_pos: torch.Tensor, free_mask: torch.Tensor,
                                   agent_idx: int, paths_pos: torch.Tensor,
                                   margin: float):
    """The free candidate with the fewest team conflicts (the first on a
    tie) and the team's summary with it in place: (ix, count, t, a, b,
    midpoint), on the device."""
    counts = candidate_conflict_counts(cand_pos, agent_idx, paths_pos, margin)
    masked = torch.where(free_mask, counts, torch.full_like(counts, INT32_MAX))
    ix = torch.argmin(masked)
    new_paths = put_row(paths_pos, agent_idx, cand_pos.index_select(0, ix.reshape(1))[0])
    return (ix, *team_conflict_summary(new_paths, margin))


def put_row(paths: torch.Tensor, agent_idx, row: torch.Tensor) -> torch.Tensor:
    """A copy of paths with row agent_idx replaced by `row`. agent_idx is a
    Python int, or an index on the device that is never read: a 0-d
    device tensor used as a Python index would be copied to the host."""
    if isinstance(agent_idx, torch.Tensor):
        return paths.index_copy(0, agent_idx.reshape(1), row[None].to(paths.dtype))
    out = paths.clone()
    out[agent_idx] = row
    return out


def team_candidate_counts(cand_all: torch.Tensor, paths_pos: torch.Tensor,
                          margin: float) -> torch.Tensor:
    """(A, B) int32: `candidate_conflict_counts` of every agent's candidates
    (cand_all (A, B, T, 2)) against the team's paths_pos (A, T, 2), all
    agents at once: the same distances, and the other agents' pairs counted
    by inclusion and exclusion of each agent's row and column."""
    A = paths_pos.shape[0]
    hits = distance(cand_all[:, :, None, :, :], paths_pos[None, None]) < margin  # (A,B,A,T)
    eye = torch.eye(A, dtype=torch.bool, device=paths_pos.device)
    cnt_agent = (hits & ~eye[:, None, :, None]).sum(dim=(2, 3))
    coll, _ = team_collision_tensor(paths_pos, margin)
    pair = coll.sum(dim=0)                                  # (A, A) over time
    base = pair.sum() - pair.sum(dim=1) - pair.sum(dim=0) + pair.diagonal()
    return (2 * cnt_agent + base[:, None]).to(torch.int32)


def least_conflicts(cand_all: torch.Tensor, free_all: torch.Tensor, paths_pos: torch.Tensor,
                    margin: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ix (A,), its masked count (A,)): each agent's free candidate with
    the fewest team conflicts against paths_pos, the first on a tie."""
    counts = team_candidate_counts(cand_all, paths_pos, margin)
    masked = torch.where(free_all, counts, torch.full_like(counts, INT32_MAX))
    ix = torch.argmin(masked, dim=1)
    return ix, masked.gather(1, ix[:, None])[:, 0]


def team_reselect(paths_pos_all: torch.Tensor, ix0: torch.Tensor, free_all: torch.Tensor,
                  margin: float, sweeps: int = 2):
    """Jacobi re-selection among the candidates already sampled
    (conflict_detection.py:138-179): `sweeps` rounds in which every agent
    takes its free candidate with the fewest conflicts against the others'
    current choice, a round kept only if the team's total count strictly
    drops. paths_pos_all (A, B, T, 2), ix0 (A,), free_all (A, B) ->
    (ix (A,), count, t, a, b, midpoint), on the device."""
    A = paths_pos_all.shape[0]
    rows = torch.arange(A, device=paths_pos_all.device)

    def set_count(ix):
        coll, _ = team_collision_tensor(paths_pos_all[rows, ix], margin)
        return coll.sum().to(torch.int32)

    ix, count = ix0.to(torch.int64), set_count(ix0)
    for _ in range(sweeps):
        new_ix, _ = least_conflicts(paths_pos_all, free_all, paths_pos_all[rows, ix], margin)
        new_count = set_count(new_ix)
        better = new_count < count
        ix = torch.where(better, new_ix, ix)
        count = torch.where(better, new_count, count)
    return (ix, *team_conflict_summary(paths_pos_all[rows, ix], margin))


def repair_accept(cand_pos_all: torch.Tensor, free_all: torch.Tensor, prev_pos: torch.Tensor,
                  margin: float):
    """A Jacobi repair round's choice (conflict_detection.py:182-219): each
    agent's free candidate with the fewest conflicts against prev_pos
    (A, T, 2), accepted only if the agent has a free candidate and it
    strictly beats the agent's current path; the repaired set kept only if
    its total count does not rise. cand_pos_all (A, B, T, 2), free_all
    (A, B) -> (accept (A,), ix (A,), count, t, a, b, midpoint) of the
    resulting set, on the device."""
    A = cand_pos_all.shape[0]
    ix, new_counts = least_conflicts(cand_pos_all, free_all, prev_pos, margin)
    cur = team_candidate_counts(prev_pos[:, None], prev_pos, margin)[:, 0]
    accept = free_all.any(dim=-1) & (new_counts < cur)
    rows = torch.arange(A, device=prev_pos.device)
    new_set = torch.where(accept[:, None, None], cand_pos_all[rows, ix], prev_pos)
    new = team_conflict_summary(new_set, margin)
    old = team_conflict_summary(prev_pos, margin)
    keep = new[0] <= old[0]
    return (accept & keep, ix, *(torch.where(keep, n, o) for n, o in zip(new, old)))


def _stack_positions(paths_l: Sequence) -> torch.Tensor:
    return torch.from_numpy(np.stack([np.asarray(p, np.float32)[:, :2] for p in paths_l]))


def find_conflicts(paths_l: List[np.ndarray], margin: float,
                   max_conflicts: Optional[int] = None,
                   conflict_types: Tuple = (PointConflict,)) -> List:
    """Conflict records of padded host paths, in the reference's order
    (cbs.py:166-246). With EdgeConflict requested the paths are densified
    x2; each (t_dense, a, b) hit then gives a VertexConflict (integral
    time), an EdgeConflict (fractional time) and a PointConflict (q = the
    pair's midpoint), each where requested."""
    if len(paths_l) == 0:
        return []
    factor = 2 if EdgeConflict in conflict_types else 1
    pos = _stack_positions(paths_l)
    dense = densify_positions(pos, factor)
    coll, mid = team_collision_tensor(dense, margin)
    idxs = np.argwhere(coll.numpy())  # rows [t, a, b], row-major
    mid, pos, pos_dense = mid.numpy(), pos.numpy(), dense.numpy()
    out = []
    for t_dense, a, b in idxs[:max_conflicts] if max_conflicts else idxs:
        t_dense, a, b = int(t_dense), int(a), int(b)
        t_from, t_to = t_dense // factor, -(-t_dense // factor)
        m = mid[t_dense, a, b]
        if VertexConflict in conflict_types and t_from == t_to:
            out.append(VertexConflict(agent_ids=[a, b],
                                      q_map={a: pos[a, t_from], b: pos[b, t_from]},
                                      t=t_from))
        if EdgeConflict in conflict_types and t_from != t_to:
            out.append(EdgeConflict(agent_ids=[a, b],
                                    q_from_map={a: pos[a, t_from], b: pos[b, t_from]},
                                    q_to_map={a: pos[a, t_to], b: pos[b, t_to]},
                                    t_from=t_from, t_to=t_to))
        if PointConflict in conflict_types:
            out.append(PointConflict(agent_ids=[a, b],
                                     p_l=[pos_dense[a, t_dense], pos_dense[b, t_dense]],
                                     q_l=[m, m], t_from=t_from, t_to=t_to))
    return out


def count_conflicts(paths_l: List[np.ndarray], margin: float) -> int:
    """Ordered-pair conflict count of host paths, without records."""
    if len(paths_l) == 0:
        return 0
    coll, _ = team_collision_tensor(_stack_positions(paths_l), margin)
    return int(coll.sum())
