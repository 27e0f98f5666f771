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
    new_paths = paths_pos.clone()
    new_paths[agent_idx] = cand_pos.index_select(0, ix.reshape(1))[0]
    return (ix, *team_conflict_summary(new_paths, margin))


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
