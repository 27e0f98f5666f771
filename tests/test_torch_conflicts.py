"""The port's conflict detection, CT records and team helpers against JAX.

Seeded paths put agents close enough to collide, so every function sees
hits. Counts, first-hit indices and selected indices must be exactly equal;
midpoints agree within 1e-7 (both sides compute 0.5 * (a + b) in float32),
NaN where JAX has NaN. Distances use JAX's arithmetic (sqrt of the sum of
squares), so ties at the margin fall alike.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmd_tpu.common import conflicts as jconf
from mmd_tpu.common import multi_agent_utils as jmau
from mmd_tpu.common.constraints import MultiPointConstraint as JMultiPoint
from mmd_tpu.costs import constraints as jcons
from mmd_tpu.planners.multi_agent import conflict_detection as jcd
from mmd_tpu.robots.disk import DiskRobot as JDiskRobot
from mmd_tpu.robots.disk import check_rr_collisions as jax_check_rr
from mmd_tpu.tasks.task import make_task as jax_make_task
from mmd_torch.common import conflicts as tconf
from mmd_torch.common import multi_agent_utils as tmau
from mmd_torch.common.constraints import (
    EdgeConstraint,
    MultiPointConstraint,
    VertexConstraint,
)
from mmd_torch.costs import constraints as tcons
from mmd_torch.planners.multi_agent import conflict_detection as tcd
from mmd_torch.planners.multi_agent.cbs import SearchState
from mmd_torch.robots.disk import DiskRobot, check_rr_collisions
from mmd_torch.tasks.task import make_task

torch.set_num_threads(1)

MARGIN = 2.1 * 0.05
MID_TOL = 1e-7


def team_paths(seed, n=5, T=24):
    """Agents on random walks around a small box, so that pairs collide."""
    rng = np.random.default_rng(seed)
    start = rng.uniform(-0.25, 0.25, (n, 1, 2))
    steps = rng.normal(0.0, 0.03, (n, T, 2))
    return (start + np.cumsum(steps, axis=1)).astype(np.float32)


def candidates(seed, B=16, T=24):
    return team_paths(seed + 100, n=B, T=T)


def t(x):
    return torch.from_numpy(np.asarray(x))


def assert_mid(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=MID_TOL, equal_nan=True)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_check_rr_collisions_and_team_tensor(seed):
    paths = team_paths(seed)
    coll, mid = check_rr_collisions(t(paths[:, 3]), MARGIN)
    jcoll, jmid = jax_check_rr(jnp.asarray(paths[:, 3]), MARGIN)
    np.testing.assert_array_equal(coll.numpy(), np.asarray(jcoll))
    assert_mid(mid.numpy(), jmid)
    coll, mid = tcd.team_collision_tensor(t(paths), MARGIN)
    jcoll, jmid = jcd.team_collision_tensor(jnp.asarray(paths), MARGIN)
    np.testing.assert_array_equal(coll.numpy(), np.asarray(jcoll))
    assert np.asarray(jcoll).sum() > 0 and not coll.diagonal(dim1=1, dim2=2).any()
    assert_mid(mid.numpy(), jmid)
    assert np.isnan(mid.numpy()[~coll.numpy()]).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_candidate_counts_summary_and_selection(seed):
    paths, cand = team_paths(seed), candidates(seed)
    agent = seed % paths.shape[0]
    counts = tcd.candidate_conflict_counts(t(cand), agent, t(paths), MARGIN)
    jcounts = jcd.candidate_conflict_counts(jnp.asarray(cand), agent, jnp.asarray(paths),
                                            MARGIN)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert counts.dtype == torch.int32 and len(set(counts.tolist())) > 1

    summary = tcd.team_conflict_summary(t(paths), MARGIN)
    jsummary = jcd.team_conflict_summary(jnp.asarray(paths), MARGIN)
    assert [int(v) for v in summary[:4]] == [int(v) for v in jsummary[:4]]
    assert int(summary[0]) > 0
    assert_mid(summary[4].numpy(), jsummary[4])

    free = np.random.default_rng(seed).uniform(size=cand.shape[0]) < 0.6
    free[np.argmin(np.asarray(jcounts))] = False  # the best is not free
    got = tcd.select_candidate_and_conflicts(t(cand), t(free), agent, t(paths), MARGIN)
    want = jcd.select_candidate_and_conflicts(jnp.asarray(cand), jnp.asarray(free),
                                              agent, jnp.asarray(paths), MARGIN)
    assert [int(v) for v in got[:5]] == [int(v) for v in want[:5]]
    assert free[int(got[0])]
    assert_mid(got[5].numpy(), want[5])


def test_summary_without_conflicts_points_at_row_zero():
    far = np.stack([np.full((8, 2), 3.0 * i, np.float32) for i in range(3)])
    count, ti, a, b, mid = tcd.team_conflict_summary(t(far), MARGIN)
    jcount, jt, ja, jb, jmid = jcd.team_conflict_summary(jnp.asarray(far), MARGIN)
    assert [int(v) for v in (count, ti, a, b)] == [int(v) for v in (jcount, jt, ja, jb)]
    assert int(count) == 0 and np.isnan(mid.numpy()).all() and np.isnan(jmid).all()


@pytest.mark.parametrize("factor", [1, 2, 3])
def test_pad_and_densify_positions(factor):
    paths = team_paths(factor, n=4, T=10)
    np.testing.assert_array_equal(
        tcd.densify_positions(t(paths), factor).numpy(),
        np.asarray(jcd.densify_positions(jnp.asarray(paths), factor)))
    st = np.array([0, factor, 2, 5], np.int32)
    np.testing.assert_array_equal(
        tcd.pad_team_positions(t(paths), t(st).long(), 16).numpy(),
        np.asarray(jcd.pad_team_positions(jnp.asarray(paths), jnp.asarray(st), 16)))


def _record_fields(c):
    if isinstance(c, (tconf.PointConflict, jconf.PointConflict)):
        return ("point", c.agent_ids, c.t_from, c.t_to, np.stack(c.p_l), np.stack(c.q_l))
    if isinstance(c, (tconf.VertexConflict, jconf.VertexConflict)):
        return ("vertex", c.agent_ids, c.t, np.stack([c.q_map[a] for a in c.agent_ids]))
    return ("edge", c.agent_ids, c.t_from, c.t_to,
            np.stack([c.q_from_map[a] for a in c.agent_ids]),
            np.stack([c.q_to_map[a] for a in c.agent_ids]))


@pytest.mark.parametrize("types", ["point", "all"])
@pytest.mark.parametrize("seed", [0, 3])
def test_find_and_count_conflicts(types, seed):
    paths = list(np.concatenate([team_paths(seed, T=12), np.zeros((5, 12, 2), np.float32)],
                                axis=-1))
    tt = ((tconf.PointConflict,) if types == "point" else
          (tconf.EdgeConflict, tconf.VertexConflict, tconf.PointConflict))
    jt = ((jconf.PointConflict,) if types == "point" else
          (jconf.EdgeConflict, jconf.VertexConflict, jconf.PointConflict))
    got = tcd.find_conflicts(paths, MARGIN, conflict_types=tt)
    want = jcd.find_conflicts(paths, MARGIN, conflict_types=jt)
    assert len(got) == len(want) > 0
    kinds = {_record_fields(c)[0] for c in got}
    assert kinds == ({"point"} if types == "point" else {"point", "vertex", "edge"})
    for g, w in zip(got, want):
        fg, fw = _record_fields(g), _record_fields(w)
        assert fg[:-1 if fg[0] == "vertex" else -2] == fw[:-1 if fw[0] == "vertex" else -2]
        for a, b in zip(fg[2:], fw[2:]):
            if isinstance(a, np.ndarray):
                assert_mid(a, b)
    assert tcd.count_conflicts(paths, MARGIN) == jcd.count_conflicts(paths, MARGIN) > 0
    first2 = tcd.find_conflicts(paths, MARGIN, max_conflicts=2)
    assert [(c.agent_ids, c.t_from) for c in first2] == \
        [(c.agent_ids, c.t_from) for c in tcd.find_conflicts(paths, MARGIN)[:2]]
    assert tcd.find_conflicts([], MARGIN) == [] and tcd.count_conflicts([], MARGIN) == 0


def test_constraint_records_shift_and_convert():
    mp = MultiPointConstraint(q_l=[np.zeros(2), np.ones(2)], t_range_l=[(2, 5), (60, 64)])
    assert mp.radius_l == [0.05 * 2.4] * 2 and not mp.is_soft
    assert mp.shifted(3, 0, 63).t_range_l == [(5, 8), (63, 63)]
    assert (mp.get_t_range_start(), mp.get_t_range_end()) == (2, 64)
    jmp = JMultiPoint(q_l=mp.q_l, t_range_l=mp.t_range_l)
    assert jmp.radius_l == mp.radius_l and jmp.shifted(3, 0, 63).t_range_l == [(5, 8), (63, 63)]
    v = VertexConstraint(q=np.array([0.1, 0.2]), t=10).shifted(-12, 0, 63)
    assert v.t == 0 and v.as_multipoint().t_range_l == [(-2, 2)]
    e = EdgeConstraint(q_from=np.zeros(2), q_to=np.ones(2), t_from=0, t_to=1)
    mp2 = e.shifted(1, 0, 10).as_multipoint()
    assert len(mp2.q_l) == 3 and mp2.t_range_l == [(1, 3)] * 3
    np.testing.assert_allclose(mp2.q_l[2], [0.5, 0.5])
    with pytest.raises(ValueError):
        MultiPointConstraint(q_l=[np.zeros(2)], t_range_l=[])


def test_global_pad_paths_matches_jax():
    rng = np.random.default_rng(0)
    paths = [rng.normal(size=(n, 4)).astype(np.float32) for n in (4, 6, 5)]
    for st in ([0, 0, 0], [2, 0, 1], [0, 3, 0]):
        got, want = tmau.global_pad_paths(paths, st), jmau.global_pad_paths(paths, st)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert tmau.global_pad_paths([], []) == []


@pytest.mark.parametrize("env_name", ["EnvEmpty2D", "EnvConveyor2D"])
def test_start_goal_validity_gates_match_jax(env_name):
    robot, task = DiskRobot.make(device="cpu"), make_task(env_name, device="cpu")
    jrobot, jtask = JDiskRobot.make(), jax_make_task(env_name)
    starts, goals = tmau.get_start_goal_pos_circle(6)
    cases = [
        (starts, goals),
        ([np.array([0.0, 0.0]), np.array([0.01, 0.0])],      # too close
         [np.array([0.5, 0.5]), np.array([-0.5, -0.5])]),
        ([np.array([0.0, 0.0]), np.array([0.12, 0.0])],      # collide, not too close
         [np.array([0.5, 0.5]), np.array([-0.5, -0.5])]),
        ([np.array([0.0, 0.0]), np.array([0.5, 0.0])],       # in Conveyor's centre box
         [np.array([0.8, 0.8]), np.array([-0.8, -0.8])]),
        ([np.array([1.07, 0.0]), np.array([0.0, 0.5])],      # in the walls' margin
         [np.array([0.5, 0.5]), np.array([-0.5, -0.5])]),
    ]
    verdicts = []
    for s, g in cases:
        for enforce in (True, False):
            got = tmau.is_multi_agent_start_goal_states_valid(robot, task, s, g, enforce)
            want = jmau.is_multi_agent_start_goal_states_valid(jrobot, jtask, s, g, enforce)
            assert got == want, (s, g, enforce)
            verdicts.append(got)
        assert tmau.is_multi_agent_state_valid(robot, task, s) == \
            jmau.is_multi_agent_state_valid(jrobot, jtask, s)
    assert True in verdicts and False in verdicts
    # Agents 0 and 1 meet mid-way; agent 2 ends in the walls' margin.
    line = np.linspace(0.0, 1.0, 16, dtype=np.float32)[:, None]
    q = np.stack([np.array([-0.6, 0.0]) + line * [1.2, 0.0],
                  np.array([0.6, 0.02]) - line * [1.2, 0.0],
                  np.array([0.0, -0.5]) - line * [0.0, 0.58]]).astype(np.float32)
    trajs = list(np.concatenate([q, np.zeros_like(q)], axis=-1))
    got = tmau.compute_collision_intensity(trajs, robot, task)
    assert got == jmau.compute_collision_intensity(trajs, jrobot, jtask) and 0 < got < 1
    np.testing.assert_array_equal(
        task.compute_collision(t(np.stack(trajs))).numpy(),
        np.asarray(jtask.compute_collision(jnp.asarray(np.stack(trajs)))))


def per_waypoint_group(n_others=9, H=64, seed=0, clip=False, soft=True):
    """The constraint group a PP agent (clip=True: hard, ranges clipped as
    the host loop clips them) or an ECBS agent (soft) gets from n_others
    planned paths (cbs.py:468-506)."""
    pos = team_paths(seed, n=n_others, T=H) * 3
    q_l, t_l = [], []
    for o in range(n_others):
        for ti in range(1, H):
            q_l.append(pos[o, ti])
            t_l.append((ti, ti + 1))
    if clip:
        t_l = [(max(0, min(t0, H - 1)), min(H - 1, t1)) for t0, t1 in t_l]
    return dict(q_l=q_l, t_range_l=t_l, radius_l=[0.12] * len(q_l), is_soft=soft)


@pytest.mark.parametrize("case", ["ecbs", "pp-clipped", "two-groups", "few-points"])
def test_split_soft_path_constraints_matches_jax(case):
    kw = per_waypoint_group(clip=case == "pp-clipped", soft=case != "pp-clipped")
    groups = [kw, per_waypoint_group(seed=1)] if case == "two-groups" else [kw]
    if case == "few-points":
        groups = [dict(kw, q_l=kw["q_l"][:20], t_range_l=kw["t_range_l"][:20],
                       radius_l=kw["radius_l"][:20])]
    extra = dict(q_l=[np.array([0.1, 0.1])], t_range_l=[(3, 9)], radius_l=[0.3])
    t_in = [MultiPointConstraint(**g) for g in groups] + [MultiPointConstraint(**extra)]
    j_in = [JMultiPoint(**g) for g in groups] + [JMultiPoint(**extra)]
    rest, spc = tcons.split_soft_path_constraints(t_in, 64, device="cpu")
    jrest, jspc = jcons.split_soft_path_constraints(j_in, 64)
    assert len(rest) == len(jrest) and (spc is None) == (jspc is None)
    assert (spc is not None) == (case == "ecbs")
    if spc is not None:
        R = spc.rows
        assert R == 9 and jspc.rows == 16
        np.testing.assert_array_equal(spc.points.numpy(), np.asarray(jspc.points)[:R])
        np.testing.assert_array_equal(spc.mask.numpy(), np.asarray(jspc.mask)[:R])
        assert not np.asarray(jspc.mask)[R:].any()
        assert float(spc.radius) == float(jspc.radius)
        assert float(spc.weight) == float(jspc.weight)


def test_search_state_lazy_path_updates():
    """Deferred row updates: (tensor, index) refs apply only when paths_all
    is read; a later update of one agent wins; copies are isolated."""
    base = torch.zeros((3, 4, 8, 2))
    trajs = torch.arange(2 * 4 * 8 * 2, dtype=torch.float32).reshape(2, 4, 8, 2)
    s = SearchState(base, [0, 0, 0])
    s.add_path_update(1, (trajs, (0,)))
    assert s.has_paths and s._pending
    copy = s.get_copy()
    copy.add_path_update(1, (trajs, (1,)))
    copy.add_path_update(2, trajs[0])
    out = copy.paths_all
    assert not copy._pending
    assert torch.equal(out[1], trajs[1]) and torch.equal(out[2], trajs[0])
    assert not out[0].any() and not base.any()
    orig = s.paths_all
    assert torch.equal(orig[1], trajs[0]) and not orig[2].any()
    s.add_path_update(0, trajs[1])
    s.paths_all = base
    assert not s._pending and not s.paths_all.any()
    s2 = SearchState(base, [2, 1, 3])
    s2.add_path_update(0, trajs[1])
    bp = s2.best_paths()
    assert len(bp) == 3 and bp[0].shape == (8, 2)
    np.testing.assert_array_equal(bp[0], trajs[1, 2].numpy())
    with pytest.raises(ValueError):
        SearchState(None, []).add_path_update(0, trajs[0])
    mp = MultiPointConstraint(q_l=[np.zeros(2)], t_range_l=[(1, 2)])
    s2.add_constraint(1, mp)
    c2 = s2.get_copy()
    c2.add_constraint(1, mp)
    c2.add_constraint(0, mp)
    assert len(s2.constraints[1]) == 1 and 0 not in s2.constraints
    assert len(c2.constraints[1]) == 2 and c2.ix_best == s2.ix_best


def test_disk_robot_margins_and_limits_match_jax():
    robot, jrobot = DiskRobot.make(device="cpu"), JDiskRobot.make()
    assert (robot.rr_margin, robot.collision_link_margin) == \
        (jrobot.rr_margin, jrobot.collision_link_margin)
    q = np.random.default_rng(0).uniform(-1.2, 1.2, (5, 7, 2)).astype(np.float32)
    q[0, 0] = [1.0, -1.0]  # on the limits
    x = np.concatenate([q, np.ones_like(q)], axis=-1)
    np.testing.assert_array_equal(robot.within_limits(robot.get_position(t(x))).numpy(),
                                  np.asarray(jrobot.within_limits(jnp.asarray(q))))
