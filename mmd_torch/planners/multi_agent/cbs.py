"""The constraint-tree node and the helpers that CBS and PP share.

Twin of the shared part of `mmd_tpu/planners/multi_agent/cbs.py`
(reference: mmd/planners/multi_agent/cbs.py): `SearchState` (the CT node,
cbs.py:63-106) with lazy row updates, and `CBSBase`, which holds the team's
fields, validates its starts and goals, summarizes a node's conflicts on the
device and builds the per-waypoint constraints from other agents' paths.
`PrioritizedPlanning` subclasses it; so will CBS, whose search is not
ported yet. A team's paths are one (n_agents, B, H, D) tensor on the
device, and a node reads to the host only through `CBSBase._fetch`.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from mmd_torch.common.conflicts import PointConflict
from mmd_torch.common.constraints import MultiPointConstraint
from mmd_torch.common.multi_agent_utils import (
    global_pad_paths,
    is_multi_agent_start_goal_states_valid,
)
from mmd_torch.config import params as default_params
from mmd_torch.models.diffusion import SamplerNoise
from mmd_torch.planners.multi_agent.conflict_detection import (
    find_conflicts,
    pad_team_positions,
    team_conflict_summary,
)


def _index(ix, device) -> torch.Tensor:
    return ix if isinstance(ix, torch.Tensor) else torch.as_tensor(ix, device=device)


def _best_paths_full(paths_all: torch.Tensor, ix) -> torch.Tensor:
    """(n, B, H, D), (n,) -> (n, H, D): each agent's chosen path, gathered
    on the device so that a fetch moves n paths and not the batch."""
    n = paths_all.shape[0]
    return paths_all[torch.arange(n, device=paths_all.device), _index(ix, paths_all.device)]


def _best_paths_pos(paths_all: torch.Tensor, ix) -> torch.Tensor:
    """(n, B, H, D), (n,) -> (n, H, 2) positions of each agent's chosen path."""
    return _best_paths_full(paths_all, ix)[..., :2]


def to_host(tree):
    """Tensors of a nested tuple or list as numpy arrays; the first copy
    waits for the device."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_host(t) for t in tree)
    return tree.cpu().numpy() if isinstance(tree, torch.Tensor) else tree


class SearchState:
    """A constraint-tree node (reference: cbs.py:63-106). Its paths are one
    device tensor. A row update is deferred until `paths_all` is read: a
    search makes many children that never leave the open list. A copy
    shares the tensor; a read builds a new one, so copies stay isolated."""

    def __init__(self, paths_all: Optional[torch.Tensor], ix_best: List[int],
                 constraints: Optional[Dict[int, List[MultiPointConstraint]]] = None):
        self._paths = paths_all          # (n_agents, B, H, D)
        # [(agent_id, ref)]: ref is a (B, H, D) tensor or (tensor, index
        # tuple), a slice of a larger output taken only when read.
        self._pending: List[tuple] = []
        self.ix_best = ix_best
        self.constraints = constraints or {}
        self.n_conflicts: int = 0
        self.summarized: bool = False
        self.first_conflict: Optional[PointConflict] = None
        self.g = float("inf")

    @property
    def paths_all(self) -> Optional[torch.Tensor]:
        if self._pending:
            rows = {}
            for agent, ref in self._pending:
                rows[agent] = ref        # the last update of an agent wins
            paths = self._paths.clone()
            for agent, ref in rows.items():
                paths[agent] = ref[0][ref[1]] if isinstance(ref, tuple) else ref
            self._paths = paths
            self._pending = []
        return self._paths

    @paths_all.setter
    def paths_all(self, value: torch.Tensor):
        self._paths = value
        self._pending = []

    def add_path_update(self, agent_id: int, traj_ref) -> None:
        """Defer `paths_all[agent_id] = traj` until paths_all is read."""
        if self._paths is None:
            raise ValueError("a path update needs a node with paths")
        self._pending.append((agent_id, traj_ref))

    @property
    def has_paths(self) -> bool:
        """Whether the node has paths, without applying pending updates."""
        return self._paths is not None

    def best_paths(self) -> List[np.ndarray]:
        """Each agent's chosen path on the host, (H, D) each."""
        return list(to_host(_best_paths_full(self.paths_all, self.ix_best)))

    def add_constraint(self, agent_id: int, c: MultiPointConstraint):
        self.constraints.setdefault(agent_id, []).append(c)

    def get_copy(self) -> "SearchState":
        s = SearchState(self._paths, list(self.ix_best),
                        {k: list(v) for k, v in self.constraints.items()})
        s._pending = list(self._pending)
        s.n_conflicts = self.n_conflicts
        s.first_conflict = self.first_conflict
        s.g = self.g
        return s


class CBSBase:
    """The team's fields and the helpers CBS and PP share (JAX cbs.py:154-183,
    203-206, 263-427). Offers no `plan`: each subclass plans its own way."""

    def __init__(self, low_level_planner_l: Sequence, start_l: Sequence,
                 goal_l: Sequence, start_time_l: Optional[List[int]] = None,
                 reference_robot=None, reference_task=None,
                 validate_start_goal: bool = True):
        self.low_level_planner_l = list(low_level_planner_l)
        self.num_agents = len(start_l)
        self.start_state_pos_l = [np.asarray(s) for s in start_l]
        self.goal_state_pos_l = [np.asarray(g) for g in goal_l]
        self.start_time_l = start_time_l or [0] * self.num_agents
        self.uniform_time = all(t == 0 for t in self.start_time_l)
        p0 = self.low_level_planner_l[0]
        self.reference_robot = reference_robot or p0.robot
        self.reference_task = reference_task or p0.task
        self.margin = self.reference_robot.rr_margin
        # Reject invalid team instances up front, as the reference does
        # (cbs.py:155-163): pairwise separation, robot-robot and world
        # collisions of the start set and of the goal set.
        if validate_start_goal and not is_multi_agent_start_goal_states_valid(
                self.reference_robot, self.reference_task,
                self.start_state_pos_l, self.goal_state_pos_l):
            raise ValueError("Start or goal states are invalid (cbs.py:155-163).")
        # The team's draws come from one generator on the planners' device,
        # seeded from planner 0's (cbs.py:203-205), so that consecutive
        # searches draw afresh.
        self.device = getattr(p0, "device", torch.device("cpu"))
        gen = getattr(p0, "_generator", None)
        seed = (int(torch.randint(2 ** 62, (), generator=gen, device=gen.device))
                if gen is not None else default_params.seed)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        # Host seconds spent waiting on the device and the number of such
        # waits, over the last plan() (cbs.py:261).
        self.timing: dict = {"device_s": 0.0, "device_calls": 0}

    def _fetch(self, tree, phase: str):
        """`to_host` with the wait counted in `timing`, by phase."""
        t0 = time.perf_counter()
        out = to_host(tree)
        dt = time.perf_counter() - t0
        self.timing["device_s"] += dt
        self.timing["device_calls"] += 1
        key = f"device_{phase}_s"
        self.timing[key] = self.timing.get(key, 0.0) + dt
        return out

    def _team_noise(self) -> List[SamplerNoise]:
        """One fresh sampling loop's draws per agent, from the team generator."""
        return [SamplerNoise.draw(p.cfg, self._generator, self.device)
                for p in self.low_level_planner_l]

    def _pad_pos(self, pos: np.ndarray, agent_id: int, max_t: int) -> np.ndarray:
        """Agent `agent_id`'s positions (..., T, 2) on the team's timeline of
        max_t steps: its first state repeated for its start time, its last
        out to max_t."""
        st = self.start_time_l[agent_id]
        tail = max_t - pos.shape[-2] - st
        parts = []
        if st > 0:
            parts.append(np.repeat(pos[..., :1, :], st, axis=-2))
        parts.append(pos)
        if tail > 0:
            parts.append(np.repeat(pos[..., -1:, :], tail, axis=-2))
        return np.concatenate(parts, axis=-2)

    def _team_pos(self, state: SearchState) -> torch.Tensor:
        """The node's (n, T, 2) team positions on the device, staggered
        teams padded by start time."""
        pos = _best_paths_pos(state.paths_all, state.ix_best)
        if self.uniform_time:
            return pos
        L = state.paths_all.shape[2]
        starts = torch.as_tensor(self.start_time_l, device=pos.device)
        return pad_team_positions(pos, starts, max(self.start_time_l) + L)

    def _summarize(self, state: SearchState):
        """Fill the node's n_conflicts and first_conflict from one fetch."""
        count, t, a, b, mid = self._fetch(
            team_conflict_summary(self._team_pos(state), self.margin), phase="summary")
        state.n_conflicts = int(count)
        state.first_conflict = self._mk_conflict(t, a, b, mid) if count else None

    def _mk_conflict(self, t, a, b, mid) -> PointConflict:
        mid = np.asarray(mid)
        return PointConflict(agent_ids=[int(a), int(b)], p_l=[mid, mid],
                             q_l=[mid, mid], t_from=int(t), t_to=int(t))

    def get_conflicts(self, state: SearchState) -> List[PointConflict]:
        """The node's full conflict list as host records."""
        best = global_pad_paths(state.best_paths(), self.start_time_l)
        return find_conflicts(best, self.margin)

    def create_soft_constraints_from_other_agents_paths(
            self, state: SearchState, agent_id: int,
            n_agents_in_state: Optional[int] = None) -> List[MultiPointConstraint]:
        """One soft MultiPointConstraint holding a (q, [t, t + 1)) ball per
        waypoint of every other agent's chosen path, on agent `agent_id`'s
        clock (reference: cbs.py:468-506)."""
        n_in_state = (n_agents_in_state if n_agents_in_state is not None
                      else (state._paths.shape[0] if state.has_paths else 0))
        if n_in_state == 0:
            return []
        paths = state.paths_all
        ix = state.ix_best + [0] * (paths.shape[0] - len(state.ix_best))
        pos_all = to_host(_best_paths_pos(paths, ix))
        q_l, t_range_l, radius_l = [], [], []
        H = pos_all.shape[1]
        for other in range(n_in_state):
            if other == agent_id:
                continue
            for t_other in range(H):
                t_agent = t_other + self.start_time_l[other] - self.start_time_l[agent_id]
                if 1 <= t_agent <= H - 1:
                    q_l.append(pos_all[other, t_other])
                    t_range_l.append((t_agent, t_agent + 1))
                    radius_l.append(default_params.vertex_constraint_radius)
        if not q_l:
            return []
        return [MultiPointConstraint(q_l=q_l, t_range_l=t_range_l, radius_l=radius_l,
                                     is_soft=True)]
