"""Prioritized planning (PP) of the port against the JAX package.

The team is the 3-robot circle of EnvEmptyNoWait2D on the real checkpoint at
B=8 and full depth (25+1 DDPM steps, 14 guided steps x 20 guide
iterations). JAX's `plan_prioritized_scan` runs once; its per-agent draws
are rebuilt from its keys as `tests/test_torch_mpd.py` rebuilds them.

What is held, and why so:
- Agent 0 plans with no active keep-out ball: its step agrees with JAX's
  within 1e-4 (measured 2.2e-5: the UNet's float32 rounding, as in
  test_torch_mpd.py), with the same index and free mask.
- Agents 1 and 2 plan under hard keep-out balls around the chosen paths
  before them. That guide term has a kink at each ball's edge, pushes with
  weight 0.2 on a clipped gradient, and runs 20 times a step, so a waypoint
  that rounding moves across an edge is pushed or not. JAX's own plans
  show it (test_rounding_moves_constrained_plans_in_jax_as_in_the_port,
  fed JAX's carry, x_T times 1 + 1e-7; measured with one torch thread):
  JAX's agents 1 and 2 move by 5.6e-2 and 1.1e-1, the port's by 1.5e-4
  and 1.8e-1, agent 0 by 1.0e-5 and 1.3e-5 in each; JAX's scan body
  compiled alone differs from the same body inside the scan, on the same
  draws, by 4.7e-4 and 9.0e-2, and the port's from that JAX body by
  3.0e-4 and 1.1e-1; in the chained pass the port's agents differ from
  JAX's by 7.2e-2 and 3.7e-1 (test_chained_team_plan_matches_jax_outcome):
  the size of JAX's own spread, and far outside any rounding-level
  tolerance, which does not hold even JAX against itself. So a constrained agent is held step by step, each DDPM step fed
  JAX's chain (FIRST_STEP_TOL at the first step, STEP_TOL after it,
  measured <= 6.9e-5), then the finalize and the choice on JAX's own
  result, which must give JAX's index exactly.
- The chained pass through `PrioritizedPlanning.plan` is held to the
  outcome: the device pass is taken, agent 0 as above, the same status
  and the same conflict summary as JAX's.
"""
import dataclasses
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmd_tpu.common.constraints import MultiPointConstraint as JMultiPoint
from mmd_tpu.config import params as jparams
from mmd_tpu.costs.constraints import SoftPathConstraints as JSoftPaths
from mmd_tpu.costs.guide import GuideData as JGuideData
from mmd_tpu.costs.guide import guide_gradient as jax_guide_gradient
from mmd_tpu.datasets.normalization import LimitsNormalizer as JNormalizer
from mmd_tpu.datasets.trajectories import TrajectoryDataset as JDataset
from mmd_tpu.models import diffusion as jdiff
from mmd_tpu.parallel import team as jteam
from mmd_tpu.planners.multi_agent.cbs import CBS as JCBS
from mmd_tpu.planners.multi_agent.cbs import SearchState as JSearchState
from mmd_tpu.planners.multi_agent.conflict_detection import (
    candidate_conflict_counts as jax_counts,
)
from mmd_tpu.planners.single_agent.mpd import MPD as JMPD
from mmd_tpu.planners.single_agent.mpd import _finalize_plan as jax_finalize_plan
from mmd_tpu.robots.disk import DiskRobot as JDiskRobot
from mmd_tpu.tasks.task import make_task as jax_make_task
from mmd_tpu.train.trainer import load_checkpoint as jax_load_checkpoint
from mmd_torch.common.multi_agent_utils import get_start_goal_pos_circle
from mmd_torch.costs.constraints import SoftPathConstraints
from mmd_torch.costs.guide import GuideData, guide_gradient
from mmd_torch.envs.envs import SceneData
from mmd_torch.envs.grid_sdf import GridSDF
from mmd_torch.experiments.status import TrialSuccessStatus
from mmd_torch.models import diffusion as tdiff
from mmd_torch.parallel.team import PrioritizedTeam, plan_prioritized_scan
from mmd_torch.planners.multi_agent.cbs import CBSBase, SearchState
from mmd_torch.planners.multi_agent.conflict_detection import count_conflicts
from mmd_torch.planners.multi_agent.prioritized_planning import PrioritizedPlanning
from mmd_torch.planners.single_agent.mpd import _finalize_plan, load_planners
from mmd_torch.robots.disk import DiskRobot
from mmd_torch.tasks.task import make_task

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MID = "EnvEmptyNoWait2D-RobotPlanarDisk"
A, B = 3, 8
BODY_TOL = 1e-4
# The first step (t = 24) carries the UNet's float32 rounding of eps into
# x_0 with the coefficient sqrt(1/alphabar - 1) = 4176.9 and into the
# posterior mean with 0.2378: a rounding of 2e-6 gives 0.2378 x 4176.9 x
# 2e-6 = 2.0e-3. Measured 1.61e-3 and 0.87e-3 on agents 1 and 2 (printed by
# the step test). Later steps' coefficients are small: 1e-4.
FIRST_STEP_TOL, STEP_TOL = 2e-3, 1e-4
# The issue's bound for a chained pass; rounding moves a constrained
# agent's whole plan past it, in JAX as in the port.
CHAIN_TOL = 1e-3


def rebuilt_noise(key, cfg) -> tdiff.SamplerNoise:
    """The draws JAX's guided loop makes from `key` (diffusion.py:152-163)."""
    k, init_key = jax.random.split(key)
    shape = (cfg.n_samples, cfg.horizon, cfg.state_dim)
    keys = jax.random.split(k, cfg.n_diffusion_steps + cfg.n_diffusion_steps_without_noise)
    return tdiff.SamplerNoise(
        x_T=torch.from_numpy(np.array(jax.random.normal(init_key, shape))),
        steps=torch.from_numpy(np.stack([np.asarray(jax.random.normal(kk, shape))
                                         for kk in keys])))


@pytest.fixture(scope="module")
def team():
    starts, goals = get_start_goal_pos_circle(A)
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
        p.cfg = dataclasses.replace(p.cfg, n_samples=B)
    j0 = jps[0]
    keys = jax.random.split(jax.random.PRNGKey(7), A)
    base_cset, _ = j0._pack(None)
    out = jteam.plan_prioritized_scan(
        j0.model.apply, j0.params, j0.schedule,
        jteam.stack_hard_conds([p.hard_conds for p in jps]), j0.task.scene,
        j0.dataset.normalizer, base_cset, keys, j0.cfg, j0.guide_cfg, j0.robot.radius,
        j0.robot.q_min, j0.robot.q_max, j0._savgol, jparams.vertex_constraint_radius,
        jparams.weight_grad_cost_constraints, j0.robot.rr_margin)
    trajs, free_any, ix, free_mask, summary = (np.array(v) if not isinstance(v, tuple) else v
                                               for v in jax.device_get(out))
    return dict(starts=starts, goals=goals, tps=tps, jps=jps, keys=keys,
                base_cset=base_cset, trajs=trajs, free_any=free_any, ix=ix,
                free_mask=free_mask, summary=summary,
                noise=[rebuilt_noise(k, j0.cfg) for k in keys],
                team=PrioritizedTeam.of(tps, tps[0].robot.rr_margin))


def jax_carry(tm, i):
    """JAX's carry before agent i: its chosen rows, the sentinels after."""
    sel_pos, planned = tm["team"].initial_carry()
    for j in range(i):
        sel_pos[j] = torch.from_numpy(tm["trajs"][j, tm["ix"][j], :, :2])
        planned[j] = 1.0
    return sel_pos, planned


def jax_soft_paths(sel_pos, planned) -> JSoftPaths:
    """The keep-out balls of JAX's scan body around the carry (team.py:145-153)."""
    tmask = np.ones((A, 64), np.float32)
    tmask[:, 0] = 0.0
    return JSoftPaths(points=jnp.asarray(sel_pos.numpy()),
                      mask=jnp.asarray(planned.numpy()[:, None] * tmask),
                      radius=jnp.asarray(jparams.vertex_constraint_radius),
                      weight=jnp.asarray(jparams.weight_grad_cost_constraints))


def test_agent_zero_step_matches_jax(team):
    sel_pos, planned = jax_carry(team, 0)
    new_pos, new_planned, res, ix = team["team"].step(sel_pos, planned, 0, team["noise"][0])
    np.testing.assert_allclose(res.trajs_final.numpy(), team["trajs"][0], rtol=0,
                               atol=BODY_TOL)
    assert int(ix) == int(team["ix"][0])
    np.testing.assert_array_equal(res.free_mask.numpy(), team["free_mask"][0])
    assert torch.equal(new_pos[1:], sel_pos[1:]) and new_planned.tolist() == [1, 0, 0]
    assert torch.equal(new_pos[0], res.trajs_final[int(ix), :, :2])


@pytest.mark.parametrize("i", [1, 2])
def test_constrained_agent_matches_jax_step_by_step(team, i):
    """Agent i under JAX's carry: every DDPM step fed JAX's chain, then the
    finalize and the choice on JAX's chain and result."""
    j0, tm = team["jps"][0], team["team"]
    sel_pos, planned = jax_carry(team, i)
    jgd = JGuideData(scene=j0.task.scene, normalizer=j0.dataset.normalizer,
                     constraints=team["base_cset"], soft_paths=jax_soft_paths(sel_pos, planned))
    _, jchain = jdiff.guided_p_sample_loop(j0.model.apply, j0.params, j0.schedule,
                                           team["jps"][i].hard_conds, team["keys"][i],
                                           j0.cfg, gd=jgd, guide_cfg=j0.guide_cfg)
    jchain = np.array(jchain)

    p0, noise = tm.p0, team["noise"][i]
    gd = GuideData(scene=p0.scene, normalizer=p0.dataset.normalizer,
                   constraints=tm.base_cset,
                   soft_paths=SoftPathConstraints(points=sel_pos,
                                                  mask=planned[:, None] * tm.tmask,
                                                  radius=tm.cons_radius,
                                                  weight=tm.hard_weight))
    hard = team["tps"][i].hard_conds
    assert np.array_equal(hard.apply(noise.x_T).numpy(), jchain[0])
    errs = []
    for k, step in enumerate(p0.cfg.step_indices()):
        x = tdiff._ddpm_step(p0.model, p0.schedule, torch.from_numpy(jchain[k]), step,
                             noise.steps[k], hard, gd, p0.cfg, p0.guide_cfg,
                             step < p0.cfg.t_start_guide)
        errs.append(np.abs(x.numpy() - jchain[k + 1]).max())
    print(f"agent {i}: first step {errs[0]:.3g}, later steps <= {max(errs[1:]):.3g}")
    assert errs[0] <= FIRST_STEP_TOL and max(errs[1:]) <= STEP_TOL, errs

    res = _finalize_plan(torch.from_numpy(jchain), p0.dataset.normalizer, p0.scene,
                         p0.robot.radius, p0.robot.q_min, p0.robot.q_max, p0._savgol)
    np.testing.assert_allclose(res.trajs_final.numpy(), team["trajs"][i], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(res.free_mask.numpy(), team["free_mask"][i])
    new_pos, _, ix = tm.choose(sel_pos, planned, i, res)
    assert int(ix) == int(team["ix"][i])
    assert torch.equal(new_pos[i], res.trajs_final[int(ix), :, :2])


def test_rounding_moves_constrained_plans_in_jax_as_in_the_port(team):
    """The reason agents 1 and 2 are held step by step (module docstring).
    Fed JAX's carry, each agent plans from x_T and from x_T times 1 + 1e-7,
    in JAX (its scan body as one jitted program, x_T given as the warm
    start) and in the port. Agent 0 moves by less than BODY_TOL in both,
    and JAX's body alone agrees with the scan as closely; a constrained
    agent moves past CHAIN_TOL in JAX and in the port alike."""
    j0 = team["jps"][0]

    @jax.jit
    def jax_body(x_T, key, values, soft_paths):
        gd = JGuideData(scene=j0.task.scene, normalizer=j0.dataset.normalizer,
                        constraints=team["base_cset"], soft_paths=soft_paths)
        hard = dataclasses.replace(j0.hard_conds, values=values)
        _, chain = jdiff.guided_p_sample_loop(j0.model.apply, j0.params, j0.schedule, hard,
                                              key, j0.cfg, gd=gd, guide_cfg=j0.guide_cfg,
                                              warm_start=x_T)
        return jax_finalize_plan(chain, j0.dataset.normalizer, j0.task.scene, j0.robot.radius,
                                 j0.robot.q_min, j0.robot.q_max, j0._savgol).trajs_final

    moved = {"jax": [], "port": [], "jax body vs scan": [], "port vs jax": []}
    for i in range(A):
        sel_pos, planned = jax_carry(team, i)
        noise = team["noise"][i]
        x_Ts = [noise.x_T, noise.x_T * np.float32(1 + 1e-7)]
        assert not torch.equal(*x_Ts)
        jax_out = [np.array(jax_body(jnp.asarray(x.numpy()), team["keys"][i],
                                     team["jps"][i].hard_conds.values,
                                     jax_soft_paths(sel_pos, planned))) for x in x_Ts]
        port_out = [team["team"].plan_agent(sel_pos, planned, i,
                                            dataclasses.replace(noise, x_T=x)).trajs_final.numpy()
                    for x in x_Ts]
        moved["jax"].append(float(np.abs(jax_out[1] - jax_out[0]).max()))
        moved["port"].append(float(np.abs(port_out[1] - port_out[0]).max()))
        moved["jax body vs scan"].append(float(np.abs(jax_out[0] - team["trajs"][i]).max()))
        moved["port vs jax"].append(float(np.abs(port_out[0] - jax_out[0]).max()))
    print(moved)
    assert max(v[0] for v in moved.values()) <= BODY_TOL, moved
    assert max(moved["jax"][1:]) > CHAIN_TOL and max(moved["port"][1:]) > CHAIN_TOL, moved


@pytest.mark.parametrize("case", ["random-0", "random-1", "tie"])
def test_choice_with_conflicts_matches_jax_arithmetic(team, case):
    """Candidates that collide with the planned rows, chosen by the float32
    key counts * 1e6 + cost of team.py:163-166. Past 16 conflicts the key's
    spacing exceeds the costs, so equal counts tie and the first index
    wins: in "tie", candidates 1 and 3 are one path with the cheaper cost
    on 3, and the choice must be 1, as JAX's, not a lexicographic 3."""
    tm = team["team"]
    rng = np.random.default_rng(len(case) + case.count("1"))
    cand = team["trajs"][2].copy()
    sel_pos, planned = jax_carry(team, 2)
    free = rng.uniform(size=B) < 0.8
    cost = rng.uniform(1.0, 3.0, B).astype(np.float32)
    if case == "tie":
        cand[3] = cand[1]
        free[:] = False
        free[[1, 3]] = True
        cost[3] = cost[1] - 1.5
        sel_pos[0] = torch.from_numpy(cand[1, :, :2] + 0.01)
    else:  # rows 0 and 1 run over some candidates' paths
        sel_pos[0] = torch.from_numpy(cand[1, :, :2] + rng.normal(0, 0.03, (64, 2))
                                      .astype(np.float32))
        sel_pos[1] = torch.from_numpy(cand[4, :, :2] + rng.normal(0, 0.05, (64, 2))
                                      .astype(np.float32))
    cost_all = np.where(free, cost, np.inf).astype(np.float32)
    res = SimpleNamespace(trajs_final=torch.from_numpy(cand), free_mask=torch.from_numpy(free),
                          cost_all=torch.from_numpy(cost_all))
    counts = np.asarray(jax_counts(jnp.asarray(cand[..., :2]), 2, jnp.asarray(sel_pos.numpy()),
                                   tm.margin))
    assert counts.max() > 16
    key = jnp.where(jnp.asarray(free), jnp.asarray(counts).astype(jnp.float32) * 1e6
                    + jnp.asarray(cost_all), jnp.inf)
    _, _, ix = tm.choose(sel_pos, planned, 2, res)
    assert int(ix) == int(jnp.argmin(key))
    if case == "tie":
        assert counts[1] == counts[3] and int(ix) == 1


def test_chained_team_plan_matches_jax_outcome(team):
    pp = PrioritizedPlanning(team["tps"], team["starts"], team["goals"])
    paths, n_exp, status, n_conflicts = pp.plan(noise_l=team["noise"])
    assert pp.used_scan and n_exp == 0 and len(paths) == A
    count = int(team["summary"][0])
    assert status == (TrialSuccessStatus.SUCCESS if count == 0
                      else TrialSuccessStatus.FAIL_COLLISION_AGENTS)
    assert n_conflicts == count == count_conflicts(paths, pp.margin)
    assert (pp.final.first_conflict is None) == (count == 0)
    final = pp.final.paths_all
    assert final.shape == (A, B, 64, 4) and torch.isfinite(final).all()
    print("chained pass against JAX, by agent:",
          [float(np.abs(final[i].numpy() - team["trajs"][i]).max()) for i in range(A)])
    np.testing.assert_allclose(final[0].numpy(), team["trajs"][0], rtol=0, atol=BODY_TOL)
    assert pp.final.ix_best[0] == int(team["ix"][0])
    for p, s, g in zip(paths, team["starts"], team["goals"]):
        assert p.shape == (64, 4)
        np.testing.assert_allclose(p[0, :2], s, atol=0.1)
        np.testing.assert_allclose(p[-1, :2], g, atol=0.1)
    assert len(pp.timing["agent_s"]) == A and pp.timing["device_calls"] == 1
    assert pp.timing["plan_s"] >= sum(pp.timing["agent_s"]) * 0.5
    again = plan_prioritized_scan(team["team"], team["noise"])
    assert torch.equal(again.trajs, final) and again.ix.tolist() == pp.final.ix_best


def torch_scene(scene) -> SceneData:
    def grid(g):
        return GridSDF(lower=tuple(np.asarray(g.lower).tolist()),
                       upper=tuple(np.asarray(g.upper).tolist()),
                       values=torch.from_numpy(np.array(g.values)),
                       grads=torch.from_numpy(np.array(g.grads)))
    return SceneData(grid=grid(scene.grid), extra_grid=grid(scene.extra_grid),
                     ws_min=torch.from_numpy(np.array(scene.ws_min)),
                     ws_max=torch.from_numpy(np.array(scene.ws_max)))


@pytest.mark.parametrize("case", ["pp", "pp-staggered", "ecbs"])
def test_pack_of_a_nine_predecessor_group_matches_jax(team, case):
    """The group an agent gets from 9 planned agents, as PP's host loop
    (hard, t-ranges clipped to H-1) or ECBS (soft) builds it, packed by the
    port's `_pack` and JAX's, gives the same guide step within 1e-6. PP's
    clip leaves a zero-width range at t = 63 where another agent started no
    earlier, so JAX keeps such a group on the generic path; the port does
    the same, and splits the group out where JAX does."""
    tm, jm = team["tps"][0], team["jps"][0]
    n = 10
    starts, goals = get_start_goal_pos_circle(n)
    st = [0] * n if case != "pp-staggered" else list(range(n))
    rng = np.random.default_rng(len(case))
    line = np.linspace(0.0, 1.0, 64, dtype=np.float32)[:, None]
    paths = np.zeros((n, 2, 64, 4), np.float32)
    for a in range(n):
        paths[a, :, :, :2] = starts[a] + line * (goals[a] - starts[a])
        paths[a] += rng.normal(0, 0.01, paths[a].shape).astype(np.float32)
    t_cbs = CBSBase([tm] * n, starts, goals, start_time_l=st, validate_start_goal=False)
    j_cbs = JCBS([jm] * n, starts, goals, start_time_l=st, validate_start_goal=False)
    cons = t_cbs.create_soft_constraints_from_other_agents_paths(
        SearchState(torch.from_numpy(paths[:9]), [1] * 9), 9, n_agents_in_state=9)
    jcons = j_cbs.create_soft_constraints_from_other_agents_paths(
        JSearchState(jnp.asarray(paths[:9]), [1] * 9), 9, n_agents_in_state=9)
    assert [c.t_range_l for c in cons] == [c.t_range_l for c in jcons]
    np.testing.assert_array_equal(np.stack(cons[0].q_l), np.stack(jcons[0].q_l))
    if case != "ecbs":
        for c in cons + jcons:
            c.is_soft = False
            c.t_range_l = [(max(0, min(t0, 63)), min(63, t1)) for t0, t1 in c.t_range_l]
    cons = [cons[0], dataclasses.replace(cons[0], q_l=cons[0].q_l[:1], t_range_l=[(10, 20)],
                                         radius_l=[0.3], is_soft=False)]
    jcons = [jcons[0], JMultiPoint(q_l=cons[1].q_l, t_range_l=[(10, 20)], radius_l=[0.3])]
    cset, spc = tm._pack(cons)
    jcset, jspc = jm._pack(jcons)
    assert (spc is None) == (jspc is None) == (case == "pp")
    assert cset.n_active == (2 if case == "pp" else 1)

    x = np.repeat(paths[9:10, 0], B, axis=0)
    x[..., :2] = paths[rng.integers(0, 9, B), 0, :, :2] + rng.normal(
        0, 0.05, (B, 64, 2)).astype(np.float32)
    x = np.array(jm.dataset.normalizer.normalize(jnp.asarray(x)))
    want = jax_guide_gradient(jnp.asarray(x), jm._guide_data(jcset, jspc), jm.guide_cfg)
    got = guide_gradient(torch.from_numpy(x), GuideData(
        scene=torch_scene(jm.task.scene), normalizer=tm.dataset.normalizer, constraints=cset,
        soft_paths=spc), tm.guide_cfg)
    want = np.asarray(want)
    assert np.abs(want).max() > 0.1  # the group's push is active
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


class _StubPlanner:
    """A fixed candidate batch: enough of a planner for PP's host loop."""

    def __init__(self, trajs, robot, task):
        self.trajs = torch.as_tensor(trajs, dtype=torch.float32)  # (B, H, 4)
        self.robot = robot
        self.task = task

    def _run(self, constraints_l, noise=None):
        n = self.trajs.shape[0]
        return SimpleNamespace(trajs_final=self.trajs, free_mask=torch.ones(n, dtype=torch.bool),
                               idx_best=torch.tensor(0))


def test_prioritized_planning_stagger_alignment():
    """With start times, the choice compares paths on the team's timeline
    (reference prioritized_planning.py:150-183). Candidate 'bad' is free
    when misaligned but collides on the timeline; 'good' the reverse."""
    robot, task = DiskRobot.make(device="cpu"), make_task("EnvEmpty2D", device="cpu")

    def traj(points):
        pos = np.asarray(points, np.float32)
        return np.concatenate([pos, np.zeros_like(pos)], axis=-1)[None]

    p0 = np.repeat(traj([(5, 5), (0, 0), (0, 0), (5, 5)]), 2, axis=0)
    bad = traj([(0, 0), (9, 9), (9, 9), (9, 9)])[0]
    good = traj([(9, 9), (0, 0), (8, 8), (8, 8)])[0]
    planners = [_StubPlanner(p0, robot, task), _StubPlanner(np.stack([bad, good]), robot, task)]
    pp = PrioritizedPlanning(planners, [np.array([5.0, 5.0]), np.array([0.0, 0.0])],
                             [np.array([5.0, 5.0]), np.array([8.0, 8.0])],
                             start_time_l=[0, 2], validate_start_goal=False)
    paths, _, status, n_coll = pp.plan(runtime_limit=60)
    assert n_coll == 0 and status == TrialSuccessStatus.SUCCESS and not pp.used_scan
    np.testing.assert_allclose(np.asarray(paths[1][-1, :2]), [8, 8], atol=1e-5)


def test_prioritized_planning_rejects_invalid_start_goal(team):
    """PP raises on overlapping starts (reference cbs.py:155-163)."""
    starts, goals = get_start_goal_pos_circle(2)
    starts[1] = starts[0] + 0.01
    planners = team["tps"][:2]
    with pytest.raises(ValueError):
        PrioritizedPlanning(planners, starts, goals, validate_start_goal=True)
    PrioritizedPlanning(planners, starts, goals, validate_start_goal=False)


def test_host_loop_on_a_staggered_team(team):
    """Staggered start times take the host loop with the real planners; the
    paths come back on the team's timeline, each agent's stagger leading."""
    tps = team["tps"]
    kept = [p.cfg for p in tps]
    for p in tps:
        p.cfg = dataclasses.replace(p.cfg, n_guide_steps=1)
    try:
        st = [0, 2, 4]
        pp = PrioritizedPlanning(tps, team["starts"], team["goals"], start_time_l=st)
        paths, _, status, n_conflicts = pp.plan()
    finally:
        for p, cfg in zip(tps, kept):
            p.cfg = cfg
    assert not pp.used_scan and len(paths) == A
    assert status in (TrialSuccessStatus.SUCCESS, TrialSuccessStatus.FAIL_COLLISION_AGENTS)
    for p, s0 in zip(paths, st):
        assert p.shape == (68, 4)
        np.testing.assert_array_equal(p[:s0 + 1], np.repeat(p[s0:s0 + 1], s0 + 1, axis=0))
    assert n_conflicts == count_conflicts(paths, pp.margin)
    assert pp.timing["device_calls"] == A + 1 and "agent_s" not in pp.timing


class _RecordPlanner:
    """Robot and task only: what a team's constructor reads of planner 0."""

    def __init__(self, robot, task):
        self.robot, self.task = robot, task


@pytest.mark.parametrize("start_times", [[0, 0, 0, 0], [0, 3, 1, 5]],
                         ids=["uniform", "staggered"])
def test_node_summary_and_conflicts_match_jax(start_times):
    """A CT node's conflict summary (`_team_pos` + `_summarize`, staggered
    teams padded on the device) and its full conflict list
    (`get_conflicts`) against JAX's CBS helpers."""
    rng = np.random.default_rng(sum(start_times))
    paths = np.zeros((4, 3, 16, 4), np.float32)
    paths[..., :2] = rng.uniform(-0.15, 0.15, (4, 1, 1, 2)) + np.cumsum(
        rng.normal(0.0, 0.02, (4, 3, 16, 2)), axis=2)
    ix = [2, 0, 1, 2]
    starts = [np.array([0.9 * np.cos(a), 0.9 * np.sin(a)]) for a in range(4)]
    t_cbs = CBSBase([_RecordPlanner(DiskRobot.make(device="cpu"),
                                    make_task("EnvEmpty2D", device="cpu"))] * 4,
                    starts, starts, start_time_l=start_times, validate_start_goal=False)
    j_cbs = JCBS([_RecordPlanner(JDiskRobot.make(), jax_make_task("EnvEmpty2D"))] * 4,
                 starts, starts, start_time_l=start_times, validate_start_goal=False)
    state, jstate = SearchState(torch.from_numpy(paths), ix), JSearchState(jnp.asarray(paths), ix)
    np.testing.assert_array_equal(t_cbs._team_pos(state).numpy(),
                                  np.asarray(j_cbs._team_pos(jstate)))
    t_cbs._summarize(state)
    j_cbs._summarize(jstate)
    assert state.n_conflicts == jstate.n_conflicts > 0
    a, b = state.first_conflict, jstate.first_conflict
    assert (a.agent_ids, a.t_from, a.t_to) == (b.agent_ids, b.t_from, b.t_to)
    np.testing.assert_allclose(a.q_l[0], b.q_l[0], rtol=0, atol=1e-7)
    got, want = t_cbs.get_conflicts(state), j_cbs.get_conflicts(jstate)
    assert [(c.agent_ids, c.t_from) for c in got] == [(c.agent_ids, c.t_from) for c in want]
    assert len(got) == state.n_conflicts
