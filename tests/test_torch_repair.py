"""The port's repair rounds against the JAX package, and ports of JAX's
repair tests.

- Exact checks on seeded inputs (positions in a small box, so that many
  pairs collide): `team_reselect`, `repair_accept`,
  `team_select_by_conflicts` and `team_soft_paths` equal JAX's; indices,
  counts and flags exactly, midpoints within 1e-6.
- A repair round and a reselection on given batches: `CBS._repair_root`
  and `CBS._reselect_root` of the port and of JAX, their team plans
  replaced by the same candidate batches, make the same node (paths,
  chosen indices, conflicts) and the same free masks, and JAX's round
  asks for the port's soft groups.
- Ports of tests/test_parallel.py:71-98 (the soft groups, the selection,
  a search with a root repair round) and tests/test_multi_agent.py:318-352
  (the mid-search repair lever, with the greedy chain on and off, and the
  `greedy_iters` override), on the committed EnvEmptyNoWait2D checkpoint
  at B=8 on a short schedule.
- The dense Conveyor problems that the vd grid sweeps plan
  (`EnvConveyor2DRobotPlanarDiskRandom` at 12, 15 and 20 agents, the
  sweep's first trial seed) equal JAX's.
"""
import dataclasses
import os
import types
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmd_tpu.datasets.normalization import LimitsNormalizer as JNormalizer
from mmd_tpu.datasets.trajectories import TrajectoryDataset as JDataset
from mmd_tpu.experiments.problems import get_planning_problem as jax_problem
from mmd_tpu.parallel import team as jteam
from mmd_tpu.planners.multi_agent import cbs as jcbs
from mmd_tpu.planners.multi_agent import conflict_detection as jcd
from mmd_tpu.planners.single_agent.mpd import MPD as JMPD
from mmd_tpu.train.trainer import load_checkpoint as jax_load_checkpoint
from mmd_torch.common.multi_agent_utils import get_start_goal_pos_circle
from mmd_torch.experiments.problems import get_planning_problem
from mmd_torch.experiments.status import TrialSuccessStatus
from mmd_torch.parallel import team as tteam
from mmd_torch.planners.multi_agent import cbs as tcbs
from mmd_torch.planners.multi_agent import conflict_detection as tcd
from mmd_torch.planners.multi_agent.cbs import CBS
from mmd_torch.planners.multi_agent.conflict_detection import count_conflicts
from mmd_torch.planners.single_agent.mpd import load_planners

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MID = "EnvEmptyNoWait2D-RobotPlanarDisk"
MARGIN = 0.1
MID_TOL = 1e-6


def positions(seed, *shape):
    """Seeded positions in a 0.4-wide box: many pairs within MARGIN."""
    return np.random.default_rng(seed).uniform(-0.2, 0.2, (*shape, 2)).astype(np.float32)


def free_mask(seed, A, B):
    free = np.random.default_rng(seed + 100).uniform(size=(A, B)) > 0.3
    free[0] = False  # an agent with no free candidate
    return free


def assert_summary(got, want):
    assert [int(x) for x in got[:4]] == [int(x) for x in want[:4]]
    np.testing.assert_allclose(np.asarray(got[4]), np.asarray(want[4]), rtol=0, atol=MID_TOL,
                               equal_nan=True)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_team_reselect_matches_jax(seed):
    A, B, T = 5, 8, 16
    cand, free = positions(seed, A, B, T), free_mask(seed, A, B)
    ix0 = np.random.default_rng(seed).integers(0, B, A)
    for sweeps in (1, 2):
        want = jcd.team_reselect(jnp.asarray(cand), jnp.asarray(ix0, jnp.int32),
                                 jnp.asarray(free), MARGIN, sweeps=sweeps)
        got = tcd.team_reselect(torch.from_numpy(cand), torch.from_numpy(ix0),
                                torch.from_numpy(free), MARGIN, sweeps=sweeps)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        assert_summary(got[1:], want[1:])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_repair_accept_matches_jax(seed):
    A, B, T = 5, 8, 16
    cand, free, prev = positions(seed, A, B, T), free_mask(seed, A, B), positions(seed + 7, A, T)
    want = jcd.repair_accept(jnp.asarray(cand), jnp.asarray(free), jnp.asarray(prev), MARGIN)
    got = tcd.repair_accept(torch.from_numpy(cand), torch.from_numpy(free),
                            torch.from_numpy(prev), MARGIN)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert_summary(got[2:], want[2:])
    print(f"seed {seed}: accept {np.asarray(want[0]).tolist()}, count {int(want[2])}")


@pytest.mark.parametrize("seed", [0, 1])
def test_team_select_by_conflicts_matches_jax(seed):
    A, B, T = 5, 8, 16
    cand, free, prev = positions(seed, A, B, T), free_mask(seed, A, B), positions(seed + 7, A, T)
    want = jteam.team_select_by_conflicts(jnp.asarray(cand), jnp.asarray(free),
                                          jnp.asarray(prev), MARGIN)
    got = tteam.team_select_by_conflicts(torch.from_numpy(cand), torch.from_numpy(free),
                                         torch.from_numpy(prev), MARGIN)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_team_soft_paths_matches_jax():
    pos = positions(3, 4, 64)
    want = jteam.team_soft_paths(pos, 0.12)
    got = tteam.team_soft_paths(torch.from_numpy(pos), 0.12)
    for f in ("points", "mask", "radius", "weight"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)


# ------------------------------------------- ports of test_parallel.py
def test_team_soft_paths():
    pos = np.zeros((3, 10, 2), np.float32)
    pos[1] += 0.5
    pos[2] -= 0.5
    spc = tteam.team_soft_paths(torch.from_numpy(pos), radius=0.12)
    assert spc.points.shape == (3, 2, 10, 2)
    assert float(spc.mask[0].sum()) == 18  # agents 1 and 2, t in [1, 9]
    np.testing.assert_allclose(spc.points[0, 0, 1].numpy(), [0.5, 0.5])
    np.testing.assert_allclose(float(spc.radius[0]), 0.12)


def test_team_select_by_conflicts():
    prev = np.zeros((2, 5, 2), np.float32)
    prev[1] += 3.0
    cands = np.zeros((2, 2, 5, 2), np.float32)
    cands[1, 1] = 5.0  # candidate 0 of agent 1 collides with agent 0, 1 does not
    ix, new_counts, cur_counts = tteam.team_select_by_conflicts(
        torch.from_numpy(cands), torch.ones((2, 2), dtype=torch.bool), torch.from_numpy(prev),
        0.2)
    assert int(ix[1]) == 1 and int(new_counts[1]) == 0 and int(cur_counts[0]) == 0


# -------------------------------------------------- repair on given batches
@pytest.fixture(scope="module")
def teams():
    """Three planners of each package on the 3-robot circle (no plan)."""
    starts, goals = get_start_goal_pos_circle(3)
    tps = load_planners(os.path.join(ROOT, "data_trained_models"),
                        os.path.join(ROOT, "data_trajectories"), "EnvEmptyNoWait2D",
                        starts, goals, device="cpu")
    jmodel, params, jschedule, jinfo = jax_load_checkpoint(
        os.path.join(ROOT, "data_trained_models", MID))
    jds = JDataset.load(os.path.join(ROOT, "data_trajectories"), MID)
    jds.normalizer = JNormalizer.from_limits(jinfo["normalizer_mins"], jinfo["normalizer_maxs"])
    jps = [JMPD(jmodel, params, jschedule, jds, jnp.asarray(s), jnp.asarray(g), seed=i)
           for i, (s, g) in enumerate(zip(starts, goals))]
    for p in tps + jps:
        p.cfg = dataclasses.replace(p.cfg, n_samples=8)
    return dict(tps=tps, jps=jps, starts=starts, goals=goals)


def _node(mod, tensor, paths, ix):
    node = mod.SearchState(tensor(paths), [int(i) for i in ix])
    node.constraints = {1: ["kept"]}
    return node


def _describe(node):
    fc = node.first_conflict
    return (list(node.ix_best), node.n_conflicts, node.constraints,
            None if fc is None else (fc.agent_ids, fc.t_from, np.asarray(fc.q_l[0]).round(6)))


@pytest.mark.parametrize("seed", [0, 1])
def test_repair_round_on_given_batches_matches_jax(teams, monkeypatch, seed):
    """JAX's and the port's `_repair_root` then `_reselect_root`, their
    team plans replaced by the same batches."""
    A, B, H = 3, 8, 64
    rng = np.random.default_rng(seed)
    paths = (0.3 * rng.standard_normal((A, B, H, 4))).astype(np.float32)
    cand = (0.3 * rng.standard_normal((A, B, H, 4))).astype(np.float32)
    cand_free = rng.uniform(size=(A, B)) > 0.2
    free0 = rng.uniform(size=(A, B)) > 0.1
    ix = rng.integers(0, B, A)
    asked = {}

    def jax_plans(p0, hard_team, soft_team, keys):
        asked["jax"] = soft_team
        return types.SimpleNamespace(trajs_final=jnp.asarray(cand),
                                     free_mask=jnp.asarray(cand_free))

    def port_plans(team, soft_team, noise_l):
        asked["port"] = soft_team
        assert len(noise_l) == A
        return tteam.TeamPlans(torch.from_numpy(cand), torch.from_numpy(cand_free))

    monkeypatch.setattr(jteam, "plan_fresh_team_soft_device", jax_plans)
    monkeypatch.setattr(tcbs, "plan_fresh_team_soft", port_plans)
    out = []
    for mod, planners, tensor in ((jcbs, teams["jps"], jnp.asarray),
                                  (tcbs, teams["tps"], torch.from_numpy)):
        search = mod.CBS(planners, teams["starts"], teams["goals"], is_ecbs=False,
                         is_xcbs=True, root_repair_rounds=1)
        repaired, new_free = search._repair_root(_node(mod, tensor, paths, ix), tensor(free0))
        reselected = search._reselect_root(repaired, new_free)
        out.append((_describe(repaired), np.asarray(repaired.paths_all), np.asarray(new_free),
                    _describe(reselected)))
    (jr, jpaths, jfree, js), (tr, tpaths, tfree, ts) = out
    print(f"seed {seed}: repaired {tr[:2]}, reselected {ts[:2]}")
    assert str(tr) == str(jr) and str(ts) == str(js)
    np.testing.assert_array_equal(tpaths, jpaths)
    np.testing.assert_array_equal(tfree, jfree)
    for f in ("points", "mask", "radius", "weight"):
        np.testing.assert_array_equal(getattr(asked["port"], f).numpy(),
                                      np.asarray(getattr(asked["jax"], f)), err_msg=f)


# ------------------------------------------------------------ searches
def _planners(starts, goals):
    ps = load_planners(os.path.join(ROOT, "data_trained_models"),
                       os.path.join(ROOT, "data_trajectories"), "EnvEmptyNoWait2D",
                       starts, goals, seeds=list(range(len(starts))), device="cpu")
    for p in ps:
        p.cfg = dataclasses.replace(p.cfg, n_samples=8, n_diffusion_steps=8, t_start_guide=4,
                                    n_guide_steps=5)
    return ps


def test_cbs_with_root_repair(monkeypatch):
    """XCBS with one root repair round (bench.py's XCBS-R): the fresh team
    root, a reselection, the round and a reselection, read once each, and
    no fused root."""
    starts, goals = get_start_goal_pos_circle(4)
    cbs = CBS(_planners(starts, goals), starts, goals, is_ecbs=False, is_xcbs=True,
              root_repair_rounds=1)
    assert not cbs._root_greedy_eligible()
    order = []
    for name in ("_reselect_root", "_repair_root"):
        real = getattr(cbs, name)
        monkeypatch.setattr(cbs, name, lambda *a, _n=name, _r=real: order.append(_n) or _r(*a))
    paths, n_exp, status, n_coll = cbs.plan(runtime_limit=120)
    assert len(paths) == 4
    assert order == ["_reselect_root", "_repair_root", "_reselect_root"]
    assert cbs.timing["device_repair_calls"] == 3
    assert cbs.timing["plans_fresh"] >= 2 * 4
    if status == TrialSuccessStatus.SUCCESS:
        assert n_coll == 0 and count_conflicts(paths, cbs.margin) == 0


# -------------------------------------------- ports of test_multi_agent.py
@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "host-driven"])
def test_mid_search_repair_lever(monkeypatch, greedy):
    """repair_period=1: a repair round on a popped node never makes it
    worse, the repaired node opens only if it has fewer conflicts, and the
    search still solves. With the greedy chain off every pop after the
    root's is one expansion, so the round must fire."""
    monkeypatch.setattr(CBS, "GREEDY_ITERS", 3)
    starts, goals = get_start_goal_pos_circle(6, radius=0.3 if not greedy else 0.8)
    cbs = CBS(_planners(starts, goals), starts, goals, is_ecbs=True, is_xcbs=True,
              repair_period=1)
    assert cbs._repair_eligible()
    if not greedy:
        monkeypatch.setattr(cbs, "_greedy_kbuf", lambda state: None)
    calls = []
    real_repair = cbs._repair_root

    def counting_repair(state, free_all=None):
        out = real_repair(state, free_all)
        assert out[0].n_conflicts <= state.n_conflicts
        opened = len(cbs.open_l)
        calls.append((state.n_conflicts, out[0].n_conflicts, opened))
        return out

    monkeypatch.setattr(cbs, "_repair_root", counting_repair)
    paths, n_exp, status, n_coll = cbs.plan(runtime_limit=600)
    print(f"greedy={greedy}: {n_exp} expansions, repair rounds {calls}")
    assert status == TrialSuccessStatus.SUCCESS and n_coll == 0
    assert count_conflicts(paths, cbs.margin) == 0
    if n_exp > 3 or not greedy:
        assert calls
    assert cbs.timing.get("device_repair_calls", 0) == len(calls)


def test_greedy_iters_instance_override():
    """greedy_iters shadows CBS.GREEDY_ITERS for its instance; 0 and None
    keep the class's."""
    starts, goals = get_start_goal_pos_circle(3)
    planners = _planners(starts, goals)
    assert CBS(planners, starts, goals, greedy_iters=5).GREEDY_ITERS == 5
    for keep in (None, 0):
        assert CBS(planners, starts, goals, greedy_iters=keep).GREEDY_ITERS == CBS.GREEDY_ITERS


# ------------------------------------------------------------- problems
@pytest.mark.parametrize("n", [12, 15, 20])
def test_dense_conveyor_problem_matches_jax(n):
    name = "EnvConveyor2DRobotPlanarDiskRandom"
    seed = zlib.crc32(f"{name}:{n}".encode())
    got, want = get_planning_problem(name, n, seed=seed), jax_problem(name, n, seed=seed)
    np.testing.assert_array_equal(np.stack(got[0]), np.stack([np.asarray(s) for s in want[0]]))
    np.testing.assert_array_equal(np.stack(got[1]), np.stack([np.asarray(g) for g in want[1]]))
    assert list(got[2:]) == list(want[2:])
