"""Conflict-Based Search, its constraint-tree node, and the helpers that
CBS and PP share.

Twin of `mmd_tpu/planners/multi_agent/cbs.py` (reference:
mmd/planners/multi_agent/cbs.py): `SearchState` (the CT node,
cbs.py:63-106) with lazy row updates; `CBSBase`, which holds the team's
fields, validates its starts and goals, summarizes a node's conflicts on
the device and builds the per-waypoint constraints from other agents'
paths (`PrioritizedPlanning` subclasses it too); and `CBS`, the search of
CBS, ECBS, XCBS and XECBS in JAX's order: the fused root and greedy
descent where the team allows it, then per popped node an optional Jacobi
repair round, the parallel-descent frontier, the greedy descent, and last
the one-node expansion. A team's paths are one (n_agents, B, H, D) tensor
on the device, and the search reads the device only through `to_host`,
mostly by `CBSBase._fetch`.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mmd_torch.common.conflict_conversion import convert_conflicts_to_constraints
from mmd_torch.common.conflicts import EdgeConflict, PointConflict, VertexConflict
from mmd_torch.common.constraints import MultiPointConstraint
from mmd_torch.common.experiences import PathBatchExperience
from mmd_torch.common.multi_agent_utils import (
    global_pad_paths,
    is_multi_agent_start_goal_states_valid,
)
from mmd_torch.config import params as default_params
from mmd_torch.costs.constraints import pack_constraint_sets
from mmd_torch.costs.guide import GuideData
from mmd_torch.experiments.status import TrialSuccessStatus
from mmd_torch.models.diffusion import HardConds, SamplerNoise
from mmd_torch.parallel.team import (
    PrioritizedTeam,
    _batchable,
    plan_fresh_team,
    plan_fresh_team_soft,
    plan_sequential_root_soft,
    stack_hard_conds,
    team_soft_paths,
)
from mmd_torch.planners.multi_agent import fused
from mmd_torch.planners.multi_agent.conflict_detection import (
    densify_positions,
    find_conflicts,
    pad_team_positions,
    repair_accept,
    select_candidate_and_conflicts,
    team_conflict_summary,
    team_reselect,
)
from mmd_torch.planners.multi_agent.fused import (
    expand_child_ensemble,
    expand_children,
    expand_fresh,
    expand_local,
)
from mmd_torch.planners.single_agent.mpd import MPD
from mmd_torch.planners.single_agent.mpd_ensemble import MPDEnsemble
from mmd_torch.utils.transfer import to_device


def _index(ix, device) -> torch.Tensor:
    return ix if isinstance(ix, torch.Tensor) else to_device(ix, device, torch.int64)


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
    shares the tensor; a read builds a new one, so copies stay isolated.

    A pending update may be a row of a speculative chain's output
    (k, 2, B, H, D), which it keeps on the device while the node lives. A
    node holds at most MAX_PENDING of them (ADVICE.md:3): the update past
    that applies the ones before it first, which changes no value."""

    MAX_PENDING = 16

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
        self._apply_pending()
        return self._paths

    def _apply_pending(self):
        if self._pending:
            rows = {}
            for agent, ref in self._pending:
                rows[agent] = ref        # the last update of an agent wins
            paths = self._paths.clone()
            for agent, ref in rows.items():
                paths[agent] = ref[0][ref[1]] if isinstance(ref, tuple) else ref
            self._paths = paths
            self._pending = []

    @paths_all.setter
    def paths_all(self, value: torch.Tensor):
        self._paths = value
        self._pending = []

    def add_path_update(self, agent_id: int, traj_ref) -> None:
        """Defer `paths_all[agent_id] = traj` until paths_all is read."""
        if self._paths is None:
            raise ValueError("a path update needs a node with paths")
        if len(self._pending) >= self.MAX_PENDING:
            self._apply_pending()
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
        # The start times on the device, for padding without a host copy.
        self.start_times = to_device(self.start_time_l, self.device, torch.int64)
        self._reset_timing()

    def _reset_timing(self):
        """`timing` of a new plan(): the host's seconds waiting on the
        device and the number of such waits (cbs.py:261), by phase in
        `device_<phase>_s`; the plans it ran, fresh and local, by problem,
        and their UNet forwards (the twin of JAX's `baked.UNET_EVALS`); the
        sampler calls that ran them (`sampler_calls`, the local ones also
        in `sampler_calls_local`): a batched call plans N problems."""
        self.timing: dict = {"device_s": 0.0, "device_calls": 0, "plans_fresh": 0,
                             "plans_local": 0, "unet_forwards": 0, "sampler_calls": 0,
                             "sampler_calls_local": 0}

    def _count_plans(self, local: bool, n: int = 1, calls: int = 1):
        """Count n plans of one kind run as `calls` sampler calls, and their
        UNet forwards (none for a planner without a diffusion config)."""
        steps = default_params.n_local_inference_denoising_steps if local else None
        self.timing["plans_local" if local else "plans_fresh"] += n
        self.timing["sampler_calls"] += calls
        if local:
            self.timing["sampler_calls_local"] += calls
        cfg = getattr(self.low_level_planner_l[0], "cfg", None)
        if cfg is not None:
            self.timing["unet_forwards"] += n * cfg.n_unet_forwards(steps)

    def _fetch(self, tree, phase: str):
        """`to_host` with the wait counted in `timing`, by phase: its
        seconds in `device_<phase>_s`, its reads in `device_<phase>_calls`."""
        t0 = time.perf_counter()
        out = to_host(tree)
        dt = time.perf_counter() - t0
        self.timing["device_s"] += dt
        self.timing["device_calls"] += 1
        key = f"device_{phase}_s"
        self.timing[key] = self.timing.get(key, 0.0) + dt
        key = f"device_{phase}_calls"
        self.timing[key] = self.timing.get(key, 0) + 1
        return out

    def _team_noise(self) -> List[SamplerNoise]:
        """One fresh sampling loop's draws per agent, from the team generator."""
        return [SamplerNoise.draw(p.cfg, self._generator, self.device)
                for p in self.low_level_planner_l]

    def _draw(self, local: bool) -> SamplerNoise:
        """One loop's draws from the team generator, fresh or local."""
        steps = default_params.n_local_inference_denoising_steps if local else None
        return SamplerNoise.draw(self.low_level_planner_l[0].cfg, self._generator,
                                 self.device, steps)

    def _team_pos(self, state: SearchState) -> torch.Tensor:
        """The node's (n, T, 2) team positions on the device, staggered
        teams padded by start time."""
        pos = _best_paths_pos(state.paths_all, state.ix_best)
        if self.uniform_time:
            return pos
        L = state.paths_all.shape[2]
        return pad_team_positions(pos, self.start_times, max(self.start_time_l) + L)

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

    def render_paths(self, paths_l, constraints_l=None,
                     animation_duration: float = 10.0,
                     output_fpath: str = "ct-paths.gif",
                     n_frames: Optional[int] = None, plot_trajs: bool = True,
                     show_robot_in_image: bool = True) -> str:
        """Render the team's solution on the host: a GIF, or a PNG when
        animation_duration is falsy (JAX cbs.py:359-400; reference:
        cbs.py:248-300). Needs matplotlib (ImportError without it)."""
        from mmd_torch.viz.visualizer import PlanningVisualizer, pyplot

        plt = pyplot()
        viz = PlanningVisualizer(task=self.reference_task)
        paths_l = [p.detach().cpu().numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
                   for p in paths_l]
        if not animation_duration:
            fig = ax = None
            for i, p in enumerate(paths_l):
                fig, ax = viz.render_robot_trajectories(
                    fig=fig, ax=ax, trajs=p[None],
                    start_state=self.start_state_pos_l[i],
                    goal_state=self.goal_state_pos_l[i],
                    constraints_l=constraints_l,
                    show_robot_in_image=show_robot_in_image)
            if not output_fpath.endswith(".png"):
                output_fpath = output_fpath.rsplit(".", 1)[0] + ".png"
            ax.axis("off")
            fig.savefig(output_fpath, dpi=100, bbox_inches="tight", pad_inches=0)
            plt.close(fig)
            return output_fpath
        T = max(p.shape[0] for p in paths_l)
        return viz.animate_multi_robot_trajectories(
            trajs_l=paths_l, start_state_l=self.start_state_pos_l,
            goal_state_l=self.goal_state_pos_l, plot_trajs=plot_trajs,
            video_filepath=output_fpath,
            n_frames=n_frames or max(2, min(T, 100)),
            anim_time=animation_duration, constraints=constraints_l)

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


def _plannable(constraint_l) -> List[MultiPointConstraint]:
    """Typed vertex and edge constraints in the keep-out-ball form the
    diffusion planner takes (cbs.py:67-71)."""
    return [c if isinstance(c, MultiPointConstraint) else c.as_multipoint()
            for c in constraint_l]


class CBS(CBSBase):
    """Conflict-Based Search over guided-diffusion planners (reference:
    mmd/planners/multi_agent/cbs.py) in JAX's order (cbs.py:454-644): pop
    the open node with the fewest conflicts and expand its first conflict
    into one child per agent, each replanned on the device. The four
    variants (inference_multi_agent.py:112-113): CBS (is_ecbs=False,
    is_xcbs=False), ECBS (is_ecbs: soft balls around the other agents'
    paths), XCBS (is_xcbs: a child replans locally from its parent's
    batch), XECBS (both).

    Beyond the reference, as JAX's CBS: a team of batchable planners on a
    uniform clock plans its root and GREEDY_ITERS speculative greedy
    expansions from it together (`fused.root_greedy`), and a popped node
    runs such a chain (`fused.greedy_expand`) before the one-node
    `expand`; a step is accepted only while its node is a fewest-conflicts
    minimum of the open list. `frontier_width` > 1 runs the chains of the
    top open nodes, a power of two of them, and accepts each chain whole;
    `root_repair_rounds` replaces the root by a fresh team root improved by
    Jacobi repair rounds; `repair_period` > 0 runs one repair round on a
    popped node every that many expansions. `greedy_iters` overrides
    GREEDY_ITERS for this search (0 or None keeps the class's).

    A root and an expansion each read the device once (`_fetch`, phase
    "root", "children", "expand", "summary", "greedy", "frontier" or
    "repair"); the ECBS root also reads one flag per agent, and a chain one
    flag per step; `timing` also counts the accepted greedy steps
    ("greedy_steps"), the frontier's rounds ("frontier_rounds") and the
    sampler calls ("sampler_calls", "sampler_calls_local"): a team root
    with every agent fresh, a repair round, a conflict's children, a
    chain step's two children and a frontier step's 2M children are one
    call each. `final`
    is the node `plan()` returned; `greedy_audit`,
    when a list, gets the events of the greedy steps ("step", "freeze",
    "starved", "stop").
    """

    GREEDY_ITERS = 8
    # Constraint-buffer rows of a chain: the small one while a node's
    # agents hold few constraints, the large one for deep searches.
    GREEDY_KBUFS = (16, 48)

    def __init__(self, low_level_planner_l: Sequence, start_l: Sequence,
                 goal_l: Sequence, start_time_l: Optional[List[int]] = None,
                 is_xcbs: bool = False, is_ecbs: bool = True,
                 reference_robot=None, reference_task=None,
                 validate_start_goal: bool = True, verbose: bool = False,
                 root_repair_rounds: int = 0,
                 choose_path_strategy: Optional[str] = None,
                 conflict_types: Tuple = (PointConflict,),
                 frontier_width: int = 1, greedy_iters: Optional[int] = None,
                 repair_period: int = 0):
        super().__init__(low_level_planner_l, start_l, goal_l, start_time_l=start_time_l,
                         reference_robot=reference_robot, reference_task=reference_task,
                         validate_start_goal=validate_start_goal)
        self.is_xcbs = is_xcbs
        self.is_ecbs = is_ecbs
        self.verbose = verbose
        self.root_repair_rounds = int(root_repair_rounds)
        # Conflict types to detect (cbs.py:118-130); with EdgeConflict the
        # paths are densified x2 before detection (cbs.py:185-245).
        self.conflict_types = tuple(conflict_types)
        self._densify = 2 if EdgeConflict in self.conflict_types else 1
        # 'least_collisions' or 'least_cost' (mmd_params.py:53, cbs.py:436-462)
        self.choose_path_strategy = (choose_path_strategy or
                                     default_params.low_level_choose_path_from_batch_strategy)
        if self.choose_path_strategy not in ("least_collisions", "least_cost"):
            raise ValueError(f"choose_path_strategy {self.choose_path_strategy!r}")
        self.frontier_width = max(1, int(frontier_width))
        if self.frontier_width & (self.frontier_width - 1):
            self._log(
                f"frontier_width={self.frontier_width} is not a power of "
                "two; frontier batches are power-of-two shaped, so it runs "
                f"as width {1 << (self.frontier_width.bit_length() - 1)}.")
        if greedy_iters:
            self.GREEDY_ITERS = int(greedy_iters)
        self.repair_period = int(repair_period)
        self._last_repair = 0
        self.greedy_audit: Optional[list] = None
        self._team_cache: Optional[PrioritizedTeam] = None
        self.open_l: List[SearchState] = []
        self.final: Optional[SearchState] = None

    def _log(self, *a):
        if self.verbose:
            print(*a)

    # ------------------------------------------------------------ helpers
    def _summarize(self, state: SearchState):
        """The node's conflicts from one fetch, densified with EdgeConflict."""
        if self._densify == 1:
            return super()._summarize(state)
        pos = self._team_pos(state)
        count, t, a, b, mid, pos = self._fetch(
            (*team_conflict_summary(densify_positions(pos, self._densify), self.margin), pos),
            phase="summary")
        state.n_conflicts = int(count)
        state.first_conflict = (self._mk_conflict_dense(int(t), int(a), int(b), mid, pos)
                                if count else None)

    def _mk_conflict_dense(self, t_dense: int, a: int, b: int, mid: np.ndarray,
                           pos: np.ndarray):
        """The first conflict of a densified hit (cbs.py:195-245): a
        VertexConflict at an integral time, an EdgeConflict at a fractional
        one, where requested; else a PointConflict."""
        t_from, t_to = t_dense // self._densify, -(-t_dense // self._densify)
        if t_from == t_to and VertexConflict in self.conflict_types:
            return VertexConflict(agent_ids=[a, b],
                                  q_map={a: pos[a, t_from], b: pos[b, t_from]}, t=t_from)
        if t_from != t_to and EdgeConflict in self.conflict_types:
            return EdgeConflict(agent_ids=[a, b],
                                q_from_map={a: pos[a, t_from], b: pos[b, t_from]},
                                q_to_map={a: pos[a, t_to], b: pos[b, t_to]},
                                t_from=t_from, t_to=t_to)
        return PointConflict(agent_ids=[a, b], p_l=[mid, mid], q_l=[mid, mid],
                             t_from=t_from, t_to=t_to)

    def get_conflicts(self, state: SearchState) -> List:
        best = global_pad_paths(state.best_paths(), self.start_time_l)
        return find_conflicts(best, self.margin, conflict_types=self.conflict_types)

    def _set_conflicts(self, state: SearchState, count, t, a, b, mid):
        state.n_conflicts = int(count)
        state.first_conflict = self._mk_conflict(t, a, b, mid) if count else None

    # --------------------------------------------------------------- plan
    def plan(self, runtime_limit: float = default_params.runtime_limit,
             anytime: bool = True):
        """(best_path_l, n_ct_expansions, TrialSuccessStatus, n_conflicts)
        (reference: cbs.py:302-389; JAX cbs.py:454-644).

        The runtime limit counts wall seconds of search: the seconds that
        `ops.build` spends compiling kernels inside the call (its only
        compile; none where the caller built them first with
        `ops.build.load_kernels`) are left out, as JAX leaves out XLA's
        (JAX cbs.py:440-452), and kept in `timing["compile_s"]`. The
        deadline is checked before each pop, so a 0-conflict node made past
        it is not a success. With `anytime`, a search that ran out of time
        returns the node with the fewest conflicts seen, popped or open;
        its status stays FAIL_RUNTIME_LIMIT."""
        from mmd_torch.utils.profiling import compile_time_monitor

        self._reset_timing()
        with compile_time_monitor(self.timing):
            return self._plan_timed(runtime_limit, anytime)

    def _plan_timed(self, runtime_limit: float, anytime: bool):
        self.open_l, self.final, self._last_repair = [], None, 0
        t_start = time.perf_counter()

        def over_limit() -> bool:
            elapsed = time.perf_counter() - t_start
            return elapsed - min(self.timing["compile_s"], elapsed) > runtime_limit

        status = TrialSuccessStatus.UNKNOWN
        num_expansions = 0
        if self._root_greedy_eligible():
            # The root and a greedy chain from it (cbs.py:469-487).
            root, num_expansions = self._plan_root_greedy()
            if root is None:
                status, root = TrialSuccessStatus.FAIL_NO_SOLUTION, SearchState(None, [])
            elif num_expansions == 0 or root.n_conflicts == 0:
                self.open_l.append(root)  # else its children are open
        else:
            status, root = self._plan_root(over_limit)
            if status == TrialSuccessStatus.UNKNOWN:
                if not root.summarized or self._densify > 1:
                    self._summarize(root)
                self.open_l.append(root)
        state = root

        best_seen = state if state.has_paths else None
        while status == TrialSuccessStatus.UNKNOWN:
            if over_limit():
                status = TrialSuccessStatus.FAIL_RUNTIME_LIMIT
                break
            if not self.open_l:
                status = TrialSuccessStatus.FAIL_NO_SOLUTION
                break
            # Fewest conflicts first (cbs.py:365); the sort is stable.
            self.open_l.sort(key=lambda s: s.n_conflicts)
            state = self.open_l.pop(0)
            if best_seen is None or state.n_conflicts < best_seen.n_conflicts:
                best_seen = state
            if state.n_conflicts == 0:
                status = TrialSuccessStatus.SUCCESS
                break
            if (self.repair_period > 0
                    and num_expansions - self._last_repair >= self.repair_period
                    and self._repair_eligible()):
                # One Jacobi round on the popped node, counted as one
                # expansion; its node opens only if it has fewer conflicts.
                self._last_repair = num_expansions
                repaired, _ = self._repair_root(state)
                num_expansions += 1
                if repaired.n_conflicts < state.n_conflicts:
                    self.open_l.append(repaired)
                    if repaired.n_conflicts < best_seen.n_conflicts:
                        best_seen = repaired
            n_frontier = self._expand_frontier(state) if self.frontier_width > 1 else 0
            if n_frontier:
                num_expansions += n_frontier
            elif n_greedy := self._expand_greedy(state):
                num_expansions += n_greedy
            else:
                self.expand(state)
                num_expansions += 1

        if anytime and status == TrialSuccessStatus.FAIL_RUNTIME_LIMIT:
            cands = ([best_seen] if best_seen is not None else []) + [
                n for n in self.open_l if n.has_paths]
            if cands:
                state = min(cands, key=lambda s: s.n_conflicts)
        self.timing["plan_s"] = time.perf_counter() - t_start
        if not state.has_paths:
            return [], num_expansions, status, 0
        self.final = state
        best_path_l = global_pad_paths(state.best_paths(), self.start_time_l)
        return best_path_l, num_expansions, status, state.n_conflicts

    def _team(self) -> PrioritizedTeam:
        """What a team pass shares (the planners are batchable), made once."""
        if self._team_cache is None:
            self._team_cache = PrioritizedTeam.of(self.low_level_planner_l, self.margin)
        return self._team_cache

    def _read_free(self, free_any: torch.Tensor) -> bool:
        """The ECBS root's read of an agent's flag "the batch has a free
        trajectory"; a starved agent replans without the balls."""
        free = bool(self._fetch(free_any, phase="root"))
        if not free:
            self._log("Soft-constrained root starved; replanning unconstrained.")
            self._count_plans(False)
        return free

    def _plan_root(self, over_limit):
        """(status, root): UNKNOWN with the root node, or a failure. A team
        of batchable planners plans its root in one device pass: every
        agent fresh (CBS, XCBS, and any root with repair rounds, which the
        rounds then improve), or the ECBS sequential soft pass on a uniform
        clock; the rest plan agent by agent (cbs.py:499-584)."""
        root = SearchState(None, [])
        planners = self.low_level_planner_l
        # With repair rounds every root is the fresh team's (cbs.py:501-509).
        fresh = not self.is_ecbs or self.root_repair_rounds > 0
        if _batchable(planners) and (fresh or self.uniform_time):
            team = self._team()
            self._count_plans(False, self.num_agents, calls=1 if fresh else self.num_agents)
            if fresh:
                out = plan_fresh_team(team, self._team_noise())
            else:
                out = plan_sequential_root_soft(team, self._team_noise(), self._team_noise(),
                                                self._read_free)
            free_any, ix, summary = self._fetch((out.free_any, out.ix, out.summary),
                                                phase="root")
            self.timing["root_agent_s"] = out.clock.seconds()
            if not free_any.all():
                return TrialSuccessStatus.FAIL_NO_SOLUTION, root
            root = SearchState(out.trajs, [int(i) for i in ix])
            if self.uniform_time and self._densify == 1:
                self._set_conflicts(root, *summary)
                root.summarized = True
            if self.root_repair_rounds > 0:
                # Reselect among the sampled batches, k repair rounds, and
                # reselect again (cbs.py:538-546).
                free_all = out.free_mask
                root = self._reselect_root(root, free_all)
                for _ in range(self.root_repair_rounds):
                    root, free_all = self._repair_root(root, free_all)
                root = self._reselect_root(root, free_all)
            return TrialSuccessStatus.UNKNOWN, root

        path_tiles: List[torch.Tensor] = []
        for i, planner in enumerate(planners):
            partial = SearchState(torch.stack(path_tiles) if path_tiles else None,
                                  root.ix_best[: len(path_tiles)])
            soft_l = (self.create_soft_constraints_from_other_agents_paths(
                partial, i, n_agents_in_state=len(path_tiles))
                if self.is_ecbs and path_tiles else [])
            res = planner._run(soft_l)
            self._count_plans(False)
            free, ix = self._fetch((res.free_mask.any(), res.idx_best), phase="root")
            if not free and soft_l:
                # The soft balls starved the batch: replan this agent
                # without them (cbs.py:560-570).
                self._log(f"Soft-constrained root starved; replanning agent {i}.")
                res = planner._run([])
                self._count_plans(False)
                free, ix = self._fetch((res.free_mask.any(), res.idx_best), phase="root")
            if not free:
                self._log("Failed to find valid paths in root CT node.")
                return TrialSuccessStatus.FAIL_NO_SOLUTION, root
            path_tiles.append(res.trajs_final)
            root.ix_best.append(int(ix))
            if over_limit():  # a part of the team is no node
                return TrialSuccessStatus.FAIL_RUNTIME_LIMIT, root
        root.paths_all = torch.stack(path_tiles)
        return TrialSuccessStatus.UNKNOWN, root

    # ------------------------------------------------------ greedy search
    def _greedy_kbuf(self, state: SearchState) -> Optional[int]:
        """The smallest constraint buffer that takes the node's
        constraints and one more, or None where the greedy chain does not
        apply (cbs.py:655-677): a uniform clock, undensified point
        conflicts, the least-collisions choice, batchable MPD planners,
        and only hard one-point constraints."""
        if not (self.uniform_time and self._densify == 1
                and self.choose_path_strategy == "least_collisions"
                and isinstance(state.first_conflict, PointConflict)):
            return None
        if not _batchable(self.low_level_planner_l):
            return None
        max_cons = 0
        for cons_l in state.constraints.values():
            max_cons = max(max_cons, len(cons_l))
            if any(not isinstance(c, MultiPointConstraint) or len(c.q_l) != 1 or c.is_soft
                   for c in cons_l):
                return None
        for kbuf in self.GREEDY_KBUFS:
            if max_cons + 1 <= kbuf:
                return kbuf
        return None

    def _root_greedy_eligible(self) -> bool:
        """The fused root's gate (cbs.py:679-692): `_greedy_kbuf` of a
        constraint-free node with a point conflict, and no repair rounds."""
        if self.root_repair_rounds > 0:
            return False
        probe = SearchState(None, [])
        z = np.zeros(2)
        probe.first_conflict = PointConflict(agent_ids=[0, 1], p_l=[z, z], q_l=[z, z],
                                             t_from=0, t_to=0)
        return self._greedy_kbuf(probe) is not None

    def _chain_noise(self) -> List[List[SamplerNoise]]:
        """A chain's 2k children's draws, [step][child], from the team
        generator before the chain runs (cbs.py:789): where the chain stops
        changes no later draw."""
        return [[self._draw(self.is_xcbs) for _ in range(2)] for _ in range(self.GREEDY_ITERS)]

    def _frozen(self, phase: str):
        """A chain's read of its flag "the carry froze"."""
        return lambda done: bool(self._fetch(done, phase=phase))

    def _carry(self, state: SearchState, K: int) -> fused.Carry:
        """The node on the device for a chain: its paths, chosen indices,
        its constraints in buffers of K rows (cbs.py:770-777) and its first
        conflict."""
        A, dev = self.num_agents, self.device
        cons_q = np.zeros((A, K, 2), np.float32)
        cons_t = np.zeros((A, K, 2), np.float32)
        cons_n = np.zeros((A,), np.int32)
        for agent_id, cons_l in state.constraints.items():
            for k, c in enumerate(cons_l):
                cons_q[agent_id, k] = np.asarray(c.q_l[0], np.float32)[:2]
                cons_t[agent_id, k] = c.t_range_l[0]
            cons_n[agent_id] = len(cons_l)
        fc = state.first_conflict
        ints = to_device([state.n_conflicts, fc.t_from, *fc.agent_ids], dev, torch.int64)
        return fused.Carry(
            paths=state.paths_all, ix=to_device(state.ix_best, dev, torch.int64),
            cons_q=to_device(cons_q, dev), cons_t=to_device(cons_t, dev),
            cons_n=to_device(cons_n, dev),
            conflict=(ints[0].to(torch.int32), ints[1], ints[2], ints[3],
                      to_device(np.asarray(fc.q_l[0], np.float32)[:2], dev)))

    def _plan_root_greedy(self):
        """The root, its summary and a greedy chain from it
        (`fused.root_greedy`, cbs.py:694-746), read once at the end (and a
        flag an agent in the ECBS root, a flag a step in the chain).
        Returns (the root, or None where an agent has no free sample;
        accepted expansions). With accepted > 0 the root's greedy children
        are already open (`_process_greedy`)."""
        team = self._team()
        root_noise = self._team_noise()
        fallback = self._team_noise() if self.is_ecbs else []
        chain_noise = self._chain_noise()
        self._count_plans(False, self.num_agents, calls=self.num_agents if self.is_ecbs else 1)
        out, records, n_steps = fused.root_greedy(
            team, root_noise, fallback, chain_noise, self.GREEDY_KBUFS[0],
            use_soft=self.is_ecbs, local=self.is_xcbs, k_iters=self.GREEDY_ITERS,
            sequential_root=self.is_ecbs, read_free=self._read_free,
            frozen=self._frozen("greedy"))
        self._count_plans(self.is_xcbs, 2 * n_steps, calls=n_steps)
        free_any, ix, summary, scalars = self._fetch(
            (out.free_any, out.ix, out.summary, tuple(records[1:])), phase="root")
        self.timing["root_agent_s"] = out.clock.seconds()
        if not free_any.all():
            return None, 0
        root = SearchState(out.trajs, [int(i) for i in ix])
        self._set_conflicts(root, *summary)
        root.summarized = True
        if root.n_conflicts == 0:
            return root, 0
        return root, self._process_greedy(root, records.trajs, scalars)

    def _expand_greedy(self, state: SearchState) -> int:
        """A greedy chain from the popped node (`fused.greedy_expand`,
        cbs.py:748-808), its steps checked against the open list. Returns
        the accepted expansions (0: the caller expands the node itself)."""
        K = self._greedy_kbuf(state)
        if K is None:
            return 0
        records, n_steps = fused.greedy_expand(
            self._team(), self._chain_noise(), self._carry(state, K), self.is_ecbs,
            self.is_xcbs, self.GREEDY_ITERS, self._frozen("greedy"))
        self._count_plans(self.is_xcbs, 2 * n_steps, calls=n_steps)
        return self._process_greedy(state, records.trajs,
                                    self._fetch(tuple(records[1:]), phase="greedy"))

    def _process_greedy(self, state: SearchState, trajs: torch.Tensor, scalars,
                        validate: bool = True) -> int:
        """A chain's records against the open list (cbs.py:810-915): each
        valid step makes its two children, and the chain goes on into the
        chosen one while it is a fewest-conflicts minimum of the open list
        and the other child (`<=`; with validate=False, the frontier's, it
        goes on regardless); else both children open in expansion order. A
        freeze returns the chain's current node to the open list; a step
        whose two children starved re-expands its node under ECBS
        (`expand`, whose hard-only retry recovers them). Returns the
        accepted steps."""
        (agents_k, free_k, ix_k, counts_k, t_k, a_k, b_k, mid_k, chosen_k,
         valid_k) = scalars
        H_all = state.paths_all.shape[2]
        accepted = 0
        parent = state
        for s in range(len(valid_k)):
            if not valid_k[s]:
                if self.greedy_audit is not None:
                    self.greedy_audit.append(("freeze",))
                if parent is not state:
                    self.open_l.append(parent)
                break
            if self.greedy_audit is not None:
                self.greedy_audit.append((
                    "step", parent.n_conflicts,
                    min((n.n_conflicts for n in self.open_l), default=None)))
            t_pad = 2
            lo = int(np.clip(parent.first_conflict.t_from - t_pad, 0, H_all - 1))
            hi = int(np.clip(parent.first_conflict.t_to + t_pad, 0, H_all - 1))
            mid = np.asarray(parent.first_conflict.q_l[0], np.float32)[:2]
            children: List[Optional[SearchState]] = []
            for idx in range(2):
                agent = int(agents_k[s, idx])
                if not free_k[s, idx]:
                    self._log("Failed to find valid path in CT node.")
                    children.append(None)
                    continue
                child = parent.get_copy()
                child.add_constraint(agent, MultiPointConstraint(
                    q_l=[mid], t_range_l=[(lo, hi)],
                    radius_l=[default_params.vertex_constraint_radius]))
                child.add_path_update(agent, (trajs, (s, idx)))
                child.ix_best[agent] = int(ix_k[s, idx])
                self._set_conflicts(child, counts_k[s, idx], t_k[s, idx], a_k[s, idx],
                                    b_k[s, idx], mid_k[s, idx])
                children.append(child)

            accepted += 1
            self.timing["greedy_steps"] = self.timing.get("greedy_steps", 0) + 1
            j = int(chosen_k[s])
            chosen = children[j]
            if chosen is None:
                if self.greedy_audit is not None:
                    self.greedy_audit.append(("starved",))
                if self.is_ecbs:
                    self.expand(parent)  # counted as this step's expansion
                else:
                    self.open_l.extend(c for c in children if c is not None)
                break
            other = children[1 - j]
            min_open = min([n.n_conflicts for n in self.open_l]
                           + ([other.n_conflicts] if other is not None else []),
                           default=None)
            if chosen.n_conflicts == 0 or (validate and min_open is not None
                                           and chosen.n_conflicts > min_open):
                if self.greedy_audit is not None:
                    self.greedy_audit.append(("stop", chosen.n_conflicts, min_open))
                self.open_l.extend(c for c in children if c is not None)
                break
            if other is not None:
                self.open_l.append(other)
            parent = chosen
        else:
            if parent is not state:
                self.open_l.append(parent)  # the last chosen node, unexpanded
        return accepted

    def _expand_frontier(self, state: SearchState) -> int:
        """Greedy chains from the popped node and the next open nodes, up
        to frontier_width of them, a power of two (cbs.py:917-1039), each
        accepted whole (validate=False); a chain that froze at once has its
        node expanded by `expand`. Returns the accepted expansions (0: not
        two eligible nodes, the caller goes on to the greedy chain)."""
        if not self.open_l:
            return 0
        K0 = self._greedy_kbuf(state)
        if K0 is None:
            return 0
        nodes, rest = [(state, K0)], []
        for n in self.open_l:  # sorted, every count > 0
            Kn = None if len(nodes) >= self.frontier_width else self._greedy_kbuf(n)
            if Kn is None:
                rest.append(n)
            else:
                nodes.append((n, Kn))
        M = 1
        while M * 2 <= len(nodes):
            M *= 2
        if M < 2:
            return 0
        self.open_l = [n for n, _ in nodes[M:]] + rest
        nodes = nodes[:M]
        self.timing["frontier_rounds"] = self.timing.get("frontier_rounds", 0) + 1
        # One buffer size for the chains, over the nodes kept.
        kbuf = max(k for _, k in nodes)
        nodes = [n for n, _ in nodes]
        noise_m = [self._chain_noise() for _ in nodes]
        records_m, n_steps, own_steps = fused.frontier_greedy_expand(
            self._team(), noise_m, [self._carry(n, kbuf) for n in nodes], self.is_ecbs,
            self.is_xcbs, self.GREEDY_ITERS, self._frozen("frontier"))
        scalars_m, own_steps = self._fetch(([tuple(r[1:]) for r in records_m], own_steps),
                                           phase="frontier")
        # Plans by problem, each chain's own (as run alone before the
        # lockstep); the calls, one a lockstep step.
        self._count_plans(self.is_xcbs, 2 * int(own_steps.sum()), calls=n_steps)
        accepted = 0
        for node, records, scalars in zip(nodes, records_m, scalars_m):
            acc = self._process_greedy(node, records.trajs, scalars, validate=False)
            if acc == 0:
                self.expand(node)
                acc = 1
            accepted += acc
        return accepted

    # ------------------------------------------------------------- repair
    def _repair_eligible(self) -> bool:
        """A repair round needs the fresh team pass: a uniform clock and
        batchable planners (cbs.py:1133-1141)."""
        return self.uniform_time and _batchable(self.low_level_planner_l)

    def _reselect_root(self, root: SearchState, free_all: torch.Tensor,
                       sweeps: int = 2) -> SearchState:
        """Each agent's choice among its sampled candidates by Jacobi
        sweeps (`team_reselect`, cbs.py:1143-1160), one read."""
        paths = root.paths_all
        ix, *summary = self._fetch(team_reselect(
            paths[..., :2], to_device(root.ix_best, self.device, torch.int64), free_all,
            self.margin, sweeps=sweeps), phase="repair")
        state = SearchState(paths, [int(i) for i in ix], root.constraints)
        self._set_conflicts(state, *summary)
        state.summarized = True
        return state

    def _repair_root(self, root: SearchState, free_all: Optional[torch.Tensor] = None):
        """One Jacobi repair round (cbs.py:1162-1210): every agent replans
        fresh under soft balls around the others' chosen paths
        (`plan_fresh_team_soft`), and `repair_accept` keeps what improves,
        one read. Returns (the node, the free masks of the batch each
        agent's row now holds)."""
        paths = root.paths_all
        prev_pos = _best_paths_pos(paths, root.ix_best)
        soft_team = team_soft_paths(prev_pos, default_params.vertex_constraint_radius)
        self._count_plans(False, self.num_agents, calls=1)
        res = plan_fresh_team_soft(self._team(), soft_team, self._team_noise())
        accept_d, ix_d, *summary_d = repair_accept(res.trajs_final[..., :2], res.free_mask,
                                                   prev_pos, self.margin)
        if free_all is None:
            free_all = torch.ones(paths.shape[:2], dtype=torch.bool, device=paths.device)
        new_paths = torch.where(accept_d[:, None, None, None], res.trajs_final, paths)
        new_free = torch.where(accept_d[:, None], res.free_mask, free_all)
        accept, ix, *summary = self._fetch((accept_d, ix_d, *summary_d), phase="repair")
        new_ix = [int(ix[i]) if accept[i] else root.ix_best[i] for i in range(self.num_agents)]
        state = SearchState(new_paths, new_ix, root.constraints)
        self._set_conflicts(state, *summary)
        state.summarized = True
        return state, new_free

    # ------------------------------------------------------------- expand
    def expand(self, state: SearchState):
        """One child per agent of the node's first conflict, each with the
        conflict's constraint added and its agent replanned (reference:
        cbs.py:390-466). All children in one pass where the planners allow
        it, else one child at a time."""
        constraints = convert_conflicts_to_constraints(state.first_conflict)
        H_all = state.paths_all.shape[2]
        if self._densify == 1 and self._expand_children_batched(state, constraints, H_all):
            return
        for agent_id, constraint in constraints.items():
            self._expand_child(state, agent_id, constraint, H_all)

    def _child(self, state: SearchState, agent_id: int, constraint, H_all: int) -> SearchState:
        child = state.get_copy()
        child.add_constraint(agent_id, constraint.shifted(-self.start_time_l[agent_id], 0,
                                                          H_all - 1))
        return child

    def _expand_children_batched(self, state: SearchState, constraints: dict,
                                 H_all: int) -> bool:
        """Every child of the conflict as one sampler call on planner 0's
        program (JAX cbs.py:1041-1130), their constraint sets padded to a
        common (K, P): uniform start times, the least-collisions choice,
        batchable planners. The ECBS children whose batches the soft balls
        starved replan with their hard CT constraints only, as a second
        call of those children (JAX cbs.py:1108). Returns whether it
        handled the expansion."""
        if not (self.uniform_time and constraints
                and self.choose_path_strategy == "least_collisions"):
            return False
        agent_ids = list(constraints)
        planners = [self.low_level_planner_l[a] for a in agent_ids]
        if not _batchable(planners):
            return False
        p0 = planners[0]
        children = [self._child(state, a, constraints[a], H_all) for a in agent_ids]
        hard_ls = [_plannable(child.constraints[a]) for child, a in zip(children, agent_ids)]
        hard_c = stack_hard_conds([p.hard_conds for p in planners])
        paths_all = state.paths_all
        ix_best = to_device(state.ix_best, self.device, torch.int64)
        kw = dict(dtype=torch.float32, device=self.device)
        soft_radius = torch.full((), default_params.vertex_constraint_radius, **kw)
        soft_weight = torch.full((), default_params.weight_grad_cost_soft_constraints, **kw)

        def run(use_soft: bool, which: List[int]):
            self._count_plans(self.is_xcbs, len(which), calls=1)
            # Rows by int index and a stack: a list index would copy it
            # from the host and wait for the card.
            values = torch.stack([hard_c.values[c] for c in which])
            return expand_children(
                p0, HardConds(mask=hard_c.mask, values=values),
                pack_constraint_sets([hard_ls[c] for c in which], device=self.device),
                [self._draw(self.is_xcbs) for _ in which],
                paths_all, ix_best, [agent_ids[c] for c in which], self.margin,
                soft_radius, soft_weight, use_soft=use_soft, local=self.is_xcbs)

        trajs, scalars = run(self.is_ecbs, list(range(len(agent_ids))))
        any_free, ix, count, t, a, b, mid = (np.array(x) for x in
                                             self._fetch(scalars, phase="children"))
        starved = [c for c in range(len(agent_ids)) if not any_free[c]]
        if self.is_ecbs and starved:
            trajs2, scalars2 = run(False, starved)
            for k, (f, i_, n_, t_, a_, b_, m_) in enumerate(zip(
                    *self._fetch(scalars2, phase="children"))):
                c = starved[k]
                any_free[c], ix[c], count[c] = f, i_, n_
                t[c], a[c], b[c], mid[c] = t_, a_, b_, m_
                trajs[c] = trajs2[k]
        for c, agent_id in enumerate(agent_ids):
            if not any_free[c]:
                self._log("Failed to find valid path in CT node.")
                continue
            child = children[c]
            child.add_path_update(agent_id, (trajs, (c,)))
            child.ix_best[agent_id] = int(ix[c])
            self._set_conflicts(child, count[c], t[c], a[c], b[c], mid[c])
            self.open_l.append(child)
        return True

    def _expand_child(self, state: SearchState, agent_id: int, constraint, H_all: int):
        """One child, replanned alone (JAX cbs.py:1213-1390): on the device
        with its choice and summary where the clock is uniform and the
        choice is least-collisions, or where the agent is multi-tile
        (`MPDEnsemble`) and the choice is least-collisions; else chosen
        against the team's padded paths, by least collisions or least
        cost."""
        child = self._child(state, agent_id, constraint, H_all)
        planner = self.low_level_planner_l[agent_id]
        hard_l = _plannable(child.constraints[agent_id])
        if (self._densify == 1 and isinstance(planner, MPDEnsemble)
                and self.choose_path_strategy == "least_collisions"):
            self._expand_child_ensemble(child, agent_id, planner, hard_l)
            return
        cons_l = hard_l + (self.create_soft_constraints_from_other_agents_paths(
            child, agent_id) if self.is_ecbs else [])
        if (self.uniform_time and self._densify == 1 and isinstance(planner, MPD)
                and self.choose_path_strategy == "least_collisions"):
            ix_best = to_device(child.ix_best, self.device, torch.int64)

            def run_once(cons):
                cset, spc = planner._pack(cons)
                gd = GuideData(scene=planner.scene, normalizer=planner.dataset.normalizer,
                               constraints=cset, soft_paths=spc)
                self._count_plans(self.is_xcbs)
                expand = expand_local if self.is_xcbs else expand_fresh
                return expand(planner, gd, planner.draw_noise(local=self.is_xcbs),
                              child.paths_all, ix_best, agent_id, self.margin)

            new_paths, scalars = run_once(cons_l)
            any_free, ix, *summary = self._fetch(scalars, phase="expand")
            if not any_free and self.is_ecbs:
                new_paths, scalars = run_once(hard_l)
                any_free, ix, *summary = self._fetch(scalars, phase="expand")
            if not any_free:
                self._log("Failed to find valid path in CT node.")
                return
            child.paths_all = new_paths
            child.ix_best[agent_id] = int(ix)
            self._set_conflicts(child, *summary)
            self.open_l.append(child)
            return

        experience = (PathBatchExperience(child.paths_all[agent_id]) if self.is_xcbs
                      else None)
        res = planner._run(cons_l, experience)
        self._count_plans(self.is_xcbs)
        if self.is_ecbs and not self._fetch(res.free_mask.any(), phase="expand"):
            res = planner._run(hard_l, experience)
            self._count_plans(self.is_xcbs)
        others_pos = self._team_pos(child)
        T = others_pos.shape[1]
        B = res.trajs_final.shape[0]
        starts = torch.full((B,), self.start_time_l[agent_id], dtype=torch.int64,
                            device=self.device)
        cand_pos = pad_team_positions(res.trajs_final[..., :2], starts, T)
        if self.choose_path_strategy == "least_cost":
            # Keep the planner's least-cost choice, then summarize the team
            # with it (cbs.py:436-441).
            ix, any_free = self._fetch((res.idx_best, res.free_mask.any()), phase="expand")
            if not any_free:
                self._log("Failed to find valid path in CT node.")
                return
            chosen = others_pos.clone()
            chosen[agent_id] = cand_pos[int(ix)]
            summary = self._fetch(team_conflict_summary(chosen, self.margin), phase="expand")
        else:
            ix, *summary, any_free = self._fetch(
                (*select_candidate_and_conflicts(cand_pos, res.free_mask, agent_id,
                                                 others_pos, self.margin),
                 res.free_mask.any()), phase="expand")
            if not any_free:
                self._log("Failed to find valid path in CT node.")
                return
        new_paths = child.paths_all.clone()
        new_paths[agent_id] = res.trajs_final
        child.paths_all = new_paths
        child.ix_best[agent_id] = int(ix)
        if self._densify > 1:
            # The choice ran undensified; the node's record must not.
            self._summarize(child)
        else:
            self._set_conflicts(child, *summary)
        self.open_l.append(child)

    def _expand_child_ensemble(self, child: SearchState, agent_id: int,
                               planner: MPDEnsemble, hard_l: List[MultiPointConstraint]):
        """The multi-tile child (JAX cbs.py:1292-1331): its hard constraints
        routed per tile by the planner, ECBS's soft balls built on the
        device (`fused.expand_child_ensemble`), one read; an ECBS batch the
        soft balls starved replans with the hard constraints only."""
        gds = planner._guide_data(*planner._route_constraints(hard_l))
        paths_all = child.paths_all
        ix_best = to_device(child.ix_best, self.device, torch.int64)
        kw = dict(dtype=torch.float32, device=self.device)
        soft_radius = torch.full((), default_params.vertex_constraint_radius, **kw)
        soft_weight = torch.full((), default_params.weight_grad_cost_soft_constraints, **kw)
        T_out = max(self.start_time_l) + paths_all.shape[2]

        def run_once(use_soft: bool):
            self._count_plans(self.is_xcbs)
            new_paths, scalars = expand_child_ensemble(
                planner, gds, planner.draw_noise(local=self.is_xcbs), paths_all, ix_best,
                agent_id, self.start_times, T_out, self.margin, soft_radius, soft_weight,
                use_soft=use_soft, local=self.is_xcbs)
            return new_paths, self._fetch(scalars, phase="expand")

        new_paths, (any_free, ix, *summary) = run_once(self.is_ecbs)
        if not any_free and self.is_ecbs:
            new_paths, (any_free, ix, *summary) = run_once(False)
        if not any_free:
            self._log("Failed to find valid path in CT node.")
            return
        child.paths_all = new_paths
        child.ix_best[agent_id] = int(ix)
        self._set_conflicts(child, *summary)
        self.open_l.append(child)
