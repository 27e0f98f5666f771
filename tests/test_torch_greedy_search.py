"""Ports of tests/test_greedy_equivalence.py against the port's search,
and the bound on a node's pending row updates.

The team is the dense 6-robot circle of EnvEmptyNoWait2D (radius 0.3, as
tests/test_greedy_equivalence.py:58-62 makes it) on the committed
checkpoint at B=8 on a short schedule (8 DDPM steps, 4 guided, 5 guide
iterations a step, as tests/test_torch_experiments.py's sweeps), XECBS
with 3-step chains. What JAX's twelve tests hold is held here of the
port's search: the best-first invariant of every greedy step and the
greedy search's outcome beside the host-driven one's, the large buffer,
the buffer choice, the three recovery branches (a chain frozen at once, a
chain frozen after a step, a step whose children starved under ECBS), the
fused root against the split one, a solved root that plans no child, the
frontier's children against the chain's first step, the frontier's
chains against per-node chains, a width-4 frontier search, and a solved
and a starved root.

Where a count of device round trips differs from JAX's, what is held is
the port's: JAX's fused root is one device call, while the port's chain
reads one flag a step (JAX's `while_loop` condition) and its ECBS root one
flag an agent. So the fused root makes the split path's reads (the flag
read before the chain's first step takes the place of the split root's
read), and a solved 2-agent root reads 2 + 2 times.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from mmd_torch.common.conflicts import EdgeConflict, PointConflict, VertexConflict
from mmd_torch.common.constraints import MultiPointConstraint
from mmd_torch.common.multi_agent_utils import get_start_goal_pos_circle
from mmd_torch.experiments.status import TrialSuccessStatus
from mmd_torch.planners.multi_agent import fused
from mmd_torch.planners.multi_agent.cbs import CBS, SearchState
from mmd_torch.planners.multi_agent.conflict_detection import count_conflicts
from mmd_torch.planners.single_agent.mpd import load_planners

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _planners(starts, goals):
    ps = load_planners(os.path.join(ROOT, "data_trained_models"),
                       os.path.join(ROOT, "data_trajectories"), "EnvEmptyNoWait2D",
                       starts, goals, seeds=[100 + i for i in range(len(starts))], device="cpu")
    for p in ps:
        p.cfg = dataclasses.replace(p.cfg, n_samples=8, n_diffusion_steps=8, t_start_guide=4,
                                    n_guide_steps=5)
    return ps


def _xecbs(n_agents=6, radius=0.3, **kw):
    """The dense circle: n agents swapping antipodally through the centre."""
    starts, goals = get_start_goal_pos_circle(n_agents, radius=radius)
    return CBS(_planners(starts, goals), starts, goals, is_ecbs=True, is_xcbs=True, **kw)


def _assert_collision_free(cbs, paths, status, n_coll):
    assert status == TrialSuccessStatus.SUCCESS
    assert n_coll == 0
    assert count_conflicts(paths, cbs.margin) == 0


def _steps(audit):
    return [e for e in audit if e[0] == "step"]


@pytest.fixture(autouse=True)
def short_chains(monkeypatch):
    monkeypatch.setattr(CBS, "GREEDY_ITERS", 3)


# ---------------------------------------- the best-first invariant
def test_greedy_matches_host_driven_search(monkeypatch):
    """Greedy on and forced off, same construction: both succeed
    collision-free; every greedy step expands a minimum of the open list;
    a stop comes only on a solution or a child worse than an open node."""
    cbs_host = _xecbs()
    monkeypatch.setattr(cbs_host, "_greedy_kbuf", lambda state: None)
    paths_h, exp_h, status_h, coll_h = cbs_host.plan(runtime_limit=600)
    _assert_collision_free(cbs_host, paths_h, status_h, coll_h)

    cbs_g = _xecbs()
    cbs_g.greedy_audit = audit = []
    paths_g, exp_g, status_g, coll_g = cbs_g.plan(runtime_limit=600)
    _assert_collision_free(cbs_g, paths_g, status_g, coll_g)
    print(f"host-driven {exp_h} expansions, greedy {exp_g}; audit {audit}")
    steps = _steps(audit)
    assert exp_g > 0 and steps
    for _, n_conflicts, min_open in steps:
        assert min_open is None or n_conflicts <= min_open, audit
    for e in audit:
        if e[0] == "stop":
            _, chosen, min_open = e
            assert chosen == 0 or (min_open is not None and chosen > min_open)


def test_greedy_large_constraint_buffer(monkeypatch):
    """The 48-row buffer solves the same instance."""
    monkeypatch.setattr(CBS, "GREEDY_KBUFS", (48,))
    cbs = _xecbs()
    cbs.greedy_audit = audit = []
    paths, _, status, n_coll = cbs.plan(runtime_limit=600)
    _assert_collision_free(cbs, paths, status, n_coll)
    steps = _steps(audit)
    assert steps, "greedy path never engaged; instance too easy"
    for _, n_conflicts, min_open in steps:
        assert min_open is None or n_conflicts <= min_open


# ------------------------------------------------------ buffer choice
def _gate_state(n_agents, n_cons, *, soft=False, n_points=1, conflict=True):
    state = SearchState(torch.zeros((n_agents, 2, 64, 4)), [0] * n_agents)
    state.n_conflicts = 1 if conflict else 0
    if conflict:
        state.first_conflict = PointConflict(agent_ids=[0, 1], p_l=[np.zeros(2)] * 2,
                                             q_l=[np.zeros(2)] * 2, t_from=3, t_to=3)
    cons = [MultiPointConstraint(q_l=[np.zeros(2)] * n_points, t_range_l=[(1, 2)] * n_points,
                                 radius_l=[0.1] * n_points, is_soft=soft)
            for _ in range(n_cons)]
    if cons:
        state.constraints[0] = cons
    return state


def test_greedy_kbuf_adaptive_selection():
    starts, goals = get_start_goal_pos_circle(2)
    planners = _planners(starts, goals)
    cbs = CBS(planners, starts, goals, is_ecbs=True, is_xcbs=True)
    assert cbs._greedy_kbuf(_gate_state(2, 0)) == 16
    assert cbs._greedy_kbuf(_gate_state(2, 15)) == 16
    assert cbs._greedy_kbuf(_gate_state(2, 16)) == 48
    assert cbs._greedy_kbuf(_gate_state(2, 47)) == 48
    assert cbs._greedy_kbuf(_gate_state(2, 48)) is None
    assert cbs._greedy_kbuf(_gate_state(2, 1, soft=True)) is None
    assert cbs._greedy_kbuf(_gate_state(2, 1, n_points=3)) is None
    cbs.choose_path_strategy = "least_cost"
    assert cbs._greedy_kbuf(_gate_state(2, 0)) is None
    cbs.choose_path_strategy = "least_collisions"
    cbs.uniform_time = False
    assert cbs._greedy_kbuf(_gate_state(2, 0)) is None
    cbs.uniform_time = True
    cbs._densify = 2
    assert cbs._greedy_kbuf(_gate_state(2, 0)) is None
    cbs._densify = 1
    assert cbs._greedy_kbuf(_gate_state(2, 0)) == 16
    cbs_edge = CBS(planners, starts, goals, is_ecbs=True, is_xcbs=True,
                   conflict_types=(EdgeConflict, VertexConflict, PointConflict))
    assert cbs_edge._greedy_kbuf(_gate_state(2, 0)) is None
    assert cbs._root_greedy_eligible() and not cbs_edge._root_greedy_eligible()


# -------------------------------------------------- recovery branches
def _doctor_greedy(monkeypatch, mutate):
    """Wrap fused.greedy_expand; `mutate(records, call_index)` returns the
    records the host sees."""
    real = fused.greedy_expand
    calls = []

    def wrapper(*args, **kwargs):
        records, n = real(*args, **kwargs)
        records = mutate(records, len(calls))
        calls.append(1)
        return records, n

    monkeypatch.setattr(fused, "greedy_expand", wrapper)
    return calls


def _set(records, field, index, value):
    x = getattr(records, field).clone()
    x[index] = value
    return records._replace(**{field: x})


def test_greedy_immediate_freeze_falls_back(monkeypatch):
    """valid = False on the first chain: no step accepted, so the node is
    expanded by `expand` and the search still solves."""
    _doctor_greedy(monkeypatch, lambda r, i: _set(r, "valid", slice(None), False)
                   if i == 0 else r)
    cbs = _xecbs()
    monkeypatch.setattr(cbs, "_root_greedy_eligible", lambda: False)
    cbs.greedy_audit = audit = []
    paths, n_exp, status, n_coll = cbs.plan(runtime_limit=600)
    _assert_collision_free(cbs, paths, status, n_coll)
    assert ("freeze",) in audit


def test_greedy_mid_speculation_freeze_requeues_node(monkeypatch):
    """valid[1:] = False: the first step is accepted, then the chain's node
    returns to the open list, and the search still solves."""
    _doctor_greedy(monkeypatch, lambda r, i: _set(r, "valid", slice(1, None), False)
                   if i == 0 else r)
    cbs = _xecbs()
    monkeypatch.setattr(cbs, "_root_greedy_eligible", lambda: False)
    cbs.greedy_audit = audit = []
    paths, n_exp, status, n_coll = cbs.plan(runtime_limit=600)
    _assert_collision_free(cbs, paths, status, n_coll)
    kinds = [e[0] for e in audit]
    assert "step" in kinds and "freeze" in kinds
    assert kinds.index("step") < kinds.index("freeze")


def test_greedy_both_children_starved_ecbs_reexpands(monkeypatch):
    """Both children of the first step starved, the step valid: under ECBS
    the node is expanded again by `expand`, and the search still solves."""
    _doctor_greedy(monkeypatch, lambda r, i: _set(r, "any_free", (0, slice(None)), False)
                   if i == 0 else r)
    cbs = _xecbs()
    monkeypatch.setattr(cbs, "_root_greedy_eligible", lambda: False)
    cbs.greedy_audit = audit = []
    expand_calls = []
    real_expand = cbs.expand
    monkeypatch.setattr(cbs, "expand", lambda st: expand_calls.append(st) or real_expand(st))
    paths, n_exp, status, n_coll = cbs.plan(runtime_limit=600)
    _assert_collision_free(cbs, paths, status, n_coll)
    assert ("starved",) in audit
    assert expand_calls, "starved ECBS node was not re-expanded"


# ------------------------------------------------------ the fused root
def test_root_greedy_matches_split_path(monkeypatch):
    """The fused root against the split one (the root, then a chain from
    the popped root): the same draws in the same order, so the same
    search, paths, plans and audit, and as many reads."""
    cbs_split = _xecbs()
    monkeypatch.setattr(cbs_split, "_root_greedy_eligible", lambda: False)
    cbs_split.greedy_audit = audit_s = []
    paths_s, exp_s, status_s, coll_s = cbs_split.plan(runtime_limit=600)
    _assert_collision_free(cbs_split, paths_s, status_s, coll_s)

    cbs_fused = _xecbs()
    assert cbs_fused._root_greedy_eligible()
    cbs_fused.greedy_audit = audit_f = []
    paths_f, exp_f, status_f, coll_f = cbs_fused.plan(runtime_limit=600)
    _assert_collision_free(cbs_fused, paths_f, status_f, coll_f)

    steps = _steps(audit_f)
    assert exp_f > 0 and steps, "fused root+greedy path never engaged"
    for _, n_conflicts, min_open in steps:
        assert min_open is None or n_conflicts <= min_open, audit_f
    assert (exp_f, audit_f) == (exp_s, audit_s)
    for a, b in zip(paths_f, paths_s):
        np.testing.assert_array_equal(a, b)
    for k in ("plans_fresh", "plans_local", "unet_forwards", "device_calls"):
        assert cbs_fused.timing[k] == cbs_split.timing[k], k


def test_root_greedy_conflict_free_root_skips_child_compute(monkeypatch):
    """A conflict-free root plans no child: the chain starts frozen. The
    counter of child plans (each batched children's call counts its
    problems) does fire on a root that keeps its conflict (a head-on swap
    with independent roots)."""
    child_plans = []
    real = fused._plan_children
    monkeypatch.setattr(fused, "_plan_children",
                        lambda *a: child_plans.extend([1] * len(a[4])) or real(*a))
    starts = [np.array([-0.7, -0.7], np.float32), np.array([0.7, 0.7], np.float32)]
    goals = [np.array([-0.7, 0.7], np.float32), np.array([0.7, -0.7], np.float32)]
    cbs = CBS(_planners(starts, goals), starts, goals, is_ecbs=True, is_xcbs=True)
    assert cbs._root_greedy_eligible()
    paths, n_exp, status, n_coll = cbs.plan(runtime_limit=600)
    _assert_collision_free(cbs, paths, status, n_coll)
    assert n_exp == 0 and not child_plans
    assert cbs.timing["plans_local"] == 0

    starts2 = [np.array([-0.5, 0.0], np.float32), np.array([0.5, 0.0], np.float32)]
    goals2 = [starts2[1], starts2[0]]
    cbs2 = CBS(_planners(starts2, goals2), starts2, goals2, is_ecbs=False, is_xcbs=True)
    assert cbs2._root_greedy_eligible()
    cbs2.plan(runtime_limit=600)
    assert child_plans, "counter never fired; the test hook is dead"
    assert len(child_plans) == cbs2.timing["plans_local"]


def test_root_greedy_solved_root_and_infeasible_root(monkeypatch):
    """A conflict-free root: success with 0 expansions, its reads the two
    agents' flags, the chain's start flag and the final read. A root with
    an agent that has no free sample: FAIL_NO_SOLUTION, as the split path
    reports."""
    starts = [np.array([-0.7, -0.7], np.float32), np.array([0.7, 0.7], np.float32)]
    goals = [np.array([-0.7, 0.7], np.float32), np.array([0.7, -0.7], np.float32)]
    cbs = CBS(_planners(starts, goals), starts, goals, is_ecbs=True, is_xcbs=True)
    paths, n_exp, status, n_coll = cbs.plan(runtime_limit=600)
    _assert_collision_free(cbs, paths, status, n_coll)
    assert n_exp == 0
    assert cbs.timing["device_calls"] == 2 + 2

    real = fused.root_greedy

    def starved_root(*args, **kwargs):
        out, records, n = real(*args, **kwargs)
        return out._replace(free_any=out.free_any.clone().index_fill_(
            0, torch.tensor([0]), False)), records, n

    monkeypatch.setattr(fused, "root_greedy", starved_root)
    cbs2 = _xecbs()
    paths2, n_exp2, status2, _ = cbs2.plan(runtime_limit=600)
    assert status2 == TrialSuccessStatus.FAIL_NO_SOLUTION
    assert paths2 == [] and n_exp2 == 0


# ----------------------------------------------------------- frontier
def _root_node(cbs):
    root, _ = cbs._plan_root_greedy()
    assert root is not None and root.n_conflicts > 0
    return root


def test_frontier_child_matches_greedy_first_iteration():
    """For the same node, buffers and draws, `frontier_expand` (M=1) makes
    the first step of `greedy_expand`'s records exactly."""
    cbs = _xecbs()
    root = _root_node(cbs)
    team, K = cbs._team(), cbs.GREEDY_KBUFS[0]
    noise = cbs._chain_noise()[:1]
    g, _ = fused.greedy_expand(team, noise, cbs._carry(root, K), True, True, 1,
                               frozen=lambda d: bool(d))
    f = fused.frontier_expand(team, noise, [cbs._carry(root, K)], True, True)
    (f_trajs, f_free, f_ix, f_count, f_t, f_a, f_b, f_mid, f_agents) = f
    assert torch.equal(f_agents[0], g.agents[0])
    for got, want in ((f_trajs, g.trajs), (f_free, g.any_free), (f_ix, g.ix),
                      (f_count, g.counts), (f_t, g.t), (f_a, g.a), (f_b, g.b)):
        assert torch.equal(got[0], want[0])
    np.testing.assert_array_equal(f_mid[0].numpy(), g.mid[0].numpy())


def test_frontier_greedy_matches_per_node_greedy(monkeypatch):
    """`frontier_greedy_expand` (M=2: the root twice, with draws of their
    own) runs the chains in lockstep, one sampler call of 2M children a
    step, and makes each node's `greedy_expand` records and step count
    exactly; it runs as many steps as the longer chain, reading one flag a
    step."""
    cbs = _xecbs()
    root = _root_node(cbs)
    team, K = cbs._team(), cbs.GREEDY_KBUFS[0]
    noise_m = [cbs._chain_noise()[:2] for _ in range(2)]
    calls, reads = [], []
    real = fused._plan_children
    monkeypatch.setattr(fused, "_plan_children",
                        lambda *a: calls.append(len(a[4])) or real(*a))
    records, n_run, own_steps = fused.frontier_greedy_expand(
        team, noise_m, [cbs._carry(root, K)] * 2, True, True, 2,
        frozen=lambda d: reads.append(bool(d)) or bool(d))
    assert calls == [4] * n_run and reads == [n_run == 1]
    ns = []
    for m in range(2):
        calls.clear()
        g, n = fused.greedy_expand(team, noise_m[m], cbs._carry(root, K), True, True, 2,
                                   frozen=lambda d: bool(d))
        assert calls == [2] * n
        ns.append(n)
        for got, want in zip(records[m], g):
            assert torch.equal(got, want)
    assert n_run == max(ns) and own_steps.tolist() == ns


def test_frontier_width_search_sound(monkeypatch):
    """frontier_width=4 with the fused root and the greedy descent off, so
    that expansions go through the frontier: a collision-free solution
    with at least one round of two nodes or more."""
    cbs = _xecbs(frontier_width=4)
    monkeypatch.setattr(cbs, "_root_greedy_eligible", lambda: False)
    monkeypatch.setattr(cbs, "_expand_greedy", lambda state: 0)
    rounds = []
    orig = CBS._expand_frontier

    def spy(self, st):
        r = orig(self, st)
        rounds.append(r)
        return r

    monkeypatch.setattr(CBS, "_expand_frontier", spy)
    paths, n_exp, status, n_coll = cbs.plan(runtime_limit=900)
    _assert_collision_free(cbs, paths, status, n_coll)
    print(f"frontier rounds {rounds}, {n_exp} expansions, timing {cbs.timing}")
    assert any(r >= 2 for r in rounds), f"no multi-node round fired: {rounds}"
    assert n_exp >= sum(rounds)


def test_frontier_width_runs_as_a_power_of_two(capsys):
    """A width that is not a power of two runs as the next lower one, and
    says so (cbs.py:229-233)."""
    cbs = _xecbs(n_agents=2, frontier_width=3, verbose=True)
    assert cbs.frontier_width == 3
    assert "runs as width 2" in capsys.readouterr().out


# ------------------------------------------------- pending row updates
def test_pending_updates_are_bounded(monkeypatch):
    """A node holds at most MAX_PENDING pending row updates (each may keep
    a chain's whole output on the device); applying them early changes no
    result: a greedy search with MAX_PENDING = 1 makes the same audit,
    expansions and paths as with the default."""
    runs, default = [], SearchState.MAX_PENDING
    for bound in (default, 1):
        monkeypatch.setattr(SearchState, "MAX_PENDING", bound)
        cbs = _xecbs()
        cbs.greedy_audit = []
        peak = [0]
        real = SearchState.add_path_update

        def add(self, agent_id, ref):
            real(self, agent_id, ref)
            peak[0] = max(peak[0], len(self._pending))

        monkeypatch.setattr(SearchState, "add_path_update", add)
        paths, n_exp, status, n_coll = cbs.plan(runtime_limit=600)
        monkeypatch.setattr(SearchState, "add_path_update", real)
        _assert_collision_free(cbs, paths, status, n_coll)
        runs.append((cbs.greedy_audit, n_exp, paths, peak[0], len(_steps(cbs.greedy_audit))))
    (audit_a, exp_a, paths_a, peak_a, steps_a), (audit_b, exp_b, paths_b, peak_b, _) = runs
    assert steps_a >= 1 and peak_b == 1 <= peak_a <= default
    assert (audit_a, exp_a) == (audit_b, exp_b)
    for a, b in zip(paths_a, paths_b):
        np.testing.assert_array_equal(a, b)
