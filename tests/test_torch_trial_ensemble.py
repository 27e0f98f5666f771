"""The multi-tile team layer of the port against the JAX package: the
problem registry, the global collision query, the trial's planner construction,
the solution audit, the multi-tile CT expansion and CBS's ensemble branch.

Both sides run on the CPU on the repository's real checkpoints (the port
on JAX's SDF grids where a plan is compared), B=8 on a short schedule
(8 + 1 steps, guided from t = 3, 5 guide iterations).

What is held, and why so:
- The 12 instances: the same starts, goals, model grid and skeletons as
  `mmd_tpu.experiments.problems` (the 2x2 and 3x3 at seeds 0-4): exact.
- `TaskEnsemble.compute_collision` on random global points: equal to JAX's.
- The trial's planners: the same global starts and goals, tile transforms,
  model ids, start times and normalized hard conditions as JAX's.
- `audit_solution_collisions`: JAX's count.
- `expand_child_ensemble`, fresh (ECBS) and local (XECBS), against JAX's on
  a staggered 2-agent team: the soft balls the port builds on the device
  equal JAX's exactly; on JAX's batch the port's choice and summary equal
  JAX's; and the port's own replan on JAX's draws is within BALL_FACTOR
  (2) times JAX's own spread of it (the same plan compiled as another
  program, and under a 1e-7 relative change of its first draw), or
  PLAN_TOL where that is wider, and both are printed: under the soft balls
  on the short schedule the guide amplifies float32 rounding in JAX as in
  the port (tests/test_torch_ensemble.py).
- CBS's ensemble branch engages on every child of a staggered multi-tile
  XECBS search, and PP plans a staggered multi-tile team.
"""
import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmd_tpu.common.constraints import MultiPointConstraint as JMultiPoint
from mmd_tpu.costs.constraints import SoftPathConstraints as JSoftPaths
from mmd_tpu.costs.guide import GuideData as JGuideData
from mmd_tpu.experiments import problems as jproblems
from mmd_tpu.experiments import trial as jtrial
from mmd_tpu.models import ensemble as jens
from mmd_tpu.planners.multi_agent import conflict_detection as jcd
from mmd_tpu.planners.multi_agent import fused as jfused
from mmd_tpu.planners.single_agent import mpd_ensemble as jme
from mmd_tpu.tasks import task_ensemble as jte
from mmd_torch.common.constraints import MultiPointConstraint
from mmd_torch.config import DiffusionConfig, params
from mmd_torch.envs.envs import SceneData, SceneStack
from mmd_torch.envs.grid_sdf import GridSDF
from mmd_torch.experiments import problems
from mmd_torch.experiments.status import TrialSuccessStatus
from mmd_torch.experiments.trial import (
    ModelRegistry,
    audit_solution_collisions,
    build_agent_planner,
    build_multi_agent_trial,
    tile_transform,
)
from mmd_torch.models.diffusion import SamplerNoise
from mmd_torch.planners.multi_agent import cbs as cbs_module
from mmd_torch.planners.multi_agent.fused import expand_child_ensemble
from mmd_torch.planners.multi_agent.prioritized_planning import PrioritizedPlanning
from mmd_torch.planners.single_agent.mpd import PlanResult
from mmd_torch.tasks.task import PlanningTask
from mmd_torch.tasks.task_ensemble import TaskEnsemble

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 8
SHORT = dict(n_samples=B, n_diffusion_steps=8, t_start_guide=4, n_guide_steps=5)
TWO_BY_TWO = "EnvTestTwoByTwoRobotPlanarDiskRandom"
THREE_BY_THREE = "EnvTestThreeByThreeRobotPlanarDiskRandom"
PLAN_TOL = 1e-4
BALL_FACTOR = 2.0


@pytest.fixture(scope="module")
def registries():
    return (ModelRegistry(device="cpu"),
            jtrial.ModelRegistry(os.path.join(ROOT, "data_trained_models"),
                                 os.path.join(ROOT, "data_trajectories")))


def torch_scene(scene) -> SceneData:
    """A JAX scene's arrays as the port's SceneData."""
    def grid(g):
        return GridSDF(lower=tuple(np.asarray(g.lower).tolist()),
                       upper=tuple(np.asarray(g.upper).tolist()),
                       values=torch.from_numpy(np.array(g.values)),
                       grads=torch.from_numpy(np.array(g.grads)))
    return SceneData(grid=grid(scene.grid), extra_grid=grid(scene.extra_grid),
                     ws_min=torch.from_numpy(np.array(scene.ws_min)),
                     ws_max=torch.from_numpy(np.array(scene.ws_max)))


# ------------------------------------------------------------- problems
@pytest.mark.parametrize("name,seed", [(TWO_BY_TWO, s) for s in range(5)]
                         + [(THREE_BY_THREE, s) for s in range(5)]
                         + [(n, 1) for n in sorted(jproblems.PROBLEM_REGISTRY)
                            if n not in (TWO_BY_TWO, THREE_BY_THREE)])
def test_problem_matches_jax(name, seed):
    n = 6
    s, g, ids, sk = problems.get_planning_problem(name, n, seed=seed)
    js, jg, jids, jsk = jproblems.get_planning_problem(name, n, seed=seed)
    np.testing.assert_array_equal(np.stack(s), np.stack(js))
    np.testing.assert_array_equal(np.stack(g), np.stack(jg))
    assert ids == jids and [list(map(list, k)) for k in sk] == [list(map(list, k)) for k in jsk]
    assert sorted(problems.PROBLEM_REGISTRY) == sorted(jproblems.PROBLEM_REGISTRY)


def test_global_collision_matches_jax(registries):
    reg, jreg = registries
    ids = problems.EnvTestTwoByTwoRobotPlanarDiskRandom.GLOBAL_MODEL_IDS
    coords = [[r, c] for r in range(2) for c in range(2)]
    tr = np.stack([tile_transform(rc) for rc in coords])
    jtasks = [jreg.get(ids[r][c])[3].task for r, c in coords]
    task = TaskEnsemble([PlanningTask(types.SimpleNamespace(scene=torch_scene(t.scene)),
                                      reg.get(ids[0][0])[2].robot) for t in jtasks], tr)
    jtask = jte.TaskEnsemble(jtasks, tr)
    pts = np.random.default_rng(4).uniform(-1.3, 3.3, (4000, 2)).astype(np.float32)
    pts[:, 1] -= 2.0
    got = task.compute_collision(torch.from_numpy(pts)).numpy()
    want = np.asarray(jtask.compute_collision(jnp.asarray(pts)))
    assert 0 < got.sum() < len(got)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- trial
def test_trial_planners_match_jax(registries):
    reg, jreg = registries
    n = 3
    s, g, ids, sk = problems.get_planning_problem(TWO_BY_TWO, n, seed=2)
    dcfg = DiffusionConfig(**SHORT)
    tt = build_multi_agent_trial("XECBS", s, g, ids, sk, reg, stagger_dt=10, trial_number=1,
                                 diffusion_cfg=dcfg)
    assert tt.start_time_l == [0, 10, 20]
    for i in range(n):
        jtr = np.stack([jtrial.tile_transform(rc) for rc in sk[i]])
        js = np.asarray(s[i], np.float32) + jtrial.tile_transform(sk[i][0])
        jg = np.asarray(g[i], np.float32) + jtrial.tile_transform(sk[i][-1])
        np.testing.assert_array_equal(tt.start_l[i], js)
        np.testing.assert_array_equal(tt.goal_l[i], jg)
        np.testing.assert_array_equal(tt.transforms_l[i], jtr)
        assert tt.model_ids_l[i] == [ids[r][c] for r, c in sk[i]]
        jp = jtrial.build_agent_planner(jreg, tt.model_ids_l[i], jtr, js, jg)
        tp = tt.planners[i]
        np.testing.assert_array_equal(tp.hard_conds.values[:, 0].numpy(),
                                      np.asarray(jp.hard_conds.values))
        np.testing.assert_array_equal(tp.hard_conds.mask[:, 0].numpy(),
                                      np.asarray(jp.hard_conds.mask))
        np.testing.assert_array_equal(tp.cc.rel.numpy(), np.asarray(jp.cc.rel))
        assert tp.cfg == dcfg and tp.n_tiles == 3
    assert isinstance(tt.team, cbs_module.CBS) and tt.team.is_ecbs and tt.team.is_xcbs
    assert isinstance(tt.team.reference_task, TaskEnsemble)
    assert tt.team.reference_task.n_tiles == 4
    one = build_agent_planner(reg, [ids[0][0]], np.zeros((1, 2), np.float32), s[0], g[0])
    assert type(one).__name__ == "MPD"


def test_audit_matches_jax():
    rng = np.random.default_rng(8)
    paths = [np.cumsum(rng.normal(0, 0.05, (70, 4)), axis=0).astype(np.float32)
             for _ in range(5)]
    got = audit_solution_collisions(paths, 0.05)
    assert got > 0 and got == jtrial.audit_solution_collisions(paths, 0.05)


# ------------------------------------------------------------ expansion
@pytest.fixture(scope="module")
def team(registries):
    """A staggered 2-agent team crossing head-on through two EnvEmptyNoWait2D
    tiles, as tests/test_ensemble.py builds it: the port's and JAX's
    planners, and JAX's root plans."""
    reg, jreg = registries
    mid = "EnvEmptyNoWait2D-RobotPlanarDisk"
    tr = np.array([[0.0, 0.0], [2.0, 0.0]], np.float32)
    tasks = [([-0.5, 0.05], [2.5, 0.05]), ([2.5, -0.05], [-0.5, -0.05])]
    tps, jps = [], []
    for k, (s, g) in enumerate(tasks):
        tp = build_agent_planner(reg, [mid] * 2, tr, s, g, seed=k)
        jp = jtrial.build_agent_planner(jreg, [mid] * 2, tr, np.asarray(s, np.float32),
                                        np.asarray(g, np.float32), seed=k)
        tp.cfg = dataclasses.replace(tp.cfg, **SHORT)
        jp.cfg = dataclasses.replace(jp.cfg, **SHORT)
        tp.scene = tp.task.stacked_scenes = SceneStack(tuple(
            torch_scene(t.scene) for t in jp.task.tasks))
        tps.append(tp)
        jps.append(jp)
    outs = [jp() for jp in jps]
    paths_all = jnp.stack([jnp.asarray(o.trajs_final) for o in outs])
    ix_best = jnp.asarray([int(o.idx_best_traj) for o in outs], jnp.int32)
    return dict(tps=tps, jps=jps, paths_all=paths_all, ix_best=ix_best,
                start_times=jnp.asarray([0, 3], jnp.int32))


def jax_soft_paths(jp, paths_all, ix_best, start_times, agent, T_out):
    """The soft balls JAX's expansion builds in its graph (fused.py:781-795)."""
    A, _, L, _ = paths_all.shape
    T, H = jp.n_tiles, L // jp.n_tiles
    others = jcd.pad_team_positions(paths_all[jnp.arange(A), ix_best][..., :2],
                                    start_times, T_out)
    u = jnp.arange(L).reshape(T, H)
    pts = others[:, jnp.clip(start_times[agent] + u, 0, T_out - 1)]
    pts = jnp.transpose(pts, (1, 0, 2, 3)) - jnp.asarray(jp.transforms)[:, None, None, :]
    msk = jnp.broadcast_to((jnp.arange(A) != agent).astype(jnp.float32)[None, :, None],
                           (T, A, H)) * (u[:, None, :] >= 1)
    return JSoftPaths(points=pts, mask=msk,
                      radius=jnp.full((T,), params.vertex_constraint_radius),
                      weight=jnp.full((T,), params.weight_grad_cost_soft_constraints))


def local_noise(key, cfg, n_tiles: int) -> SamplerNoise:
    """The draws of JAX's local ensemble replan from its key
    (mpd_ensemble.py:127-137): the q-sample noise, then the loop's."""
    key, nkey = jax.random.split(key)
    shape = (cfg.n_samples, cfg.horizon, cfg.state_dim)
    key, _ = jax.random.split(key)
    S = len(cfg.step_indices(params.n_local_inference_denoising_steps))
    keys = jax.random.split(key, S * n_tiles).reshape(S, n_tiles, 2)
    return SamplerNoise(
        x_T=torch.from_numpy(np.array(jax.random.normal(nkey, (n_tiles,) + shape))),
        steps=torch.from_numpy(np.stack([[np.asarray(jax.random.normal(keys[n, m], shape))
                                          for m in range(n_tiles)] for n in range(S)])))


def fresh_noise(key, cfg, n_tiles: int) -> SamplerNoise:
    key, init_key = jax.random.split(key)
    shape = (cfg.n_samples, cfg.horizon, cfg.state_dim)
    S = len(cfg.step_indices())
    keys = jax.random.split(key, S * n_tiles).reshape(S, n_tiles, 2)
    return SamplerNoise(
        x_T=torch.from_numpy(np.array(jax.random.normal(init_key, (n_tiles,) + shape))),
        steps=torch.from_numpy(np.stack([[np.asarray(jax.random.normal(keys[n, m], shape))
                                          for m in range(n_tiles)] for n in range(S)])))


def jax_own_spread(jp, jgds, key, seeds, jres, common) -> float:
    """How far JAX's plan moves from `jres` when compiled as another
    program (its first draw, x_T or the q-sample noise, given from outside)
    and when that draw is scaled by 1 + 1e-7: the larger."""
    from mmd_tpu.models.diffusion import q_sample as jq_sample
    n_noise = params.n_local_inference_noising_steps
    if seeds is None:
        _, init_key = jax.random.split(key)
        first, loop_key, n_steps = jax.random.normal(init_key, (2, B, 64, 4)), key, None
    else:
        loop_key, nkey = jax.random.split(key)
        first = jax.random.normal(nkey, seeds.shape)
        n_steps = params.n_local_inference_denoising_steps

    @jax.jit
    def run(scale):
        if seeds is None:
            warm = first * scale
        else:
            t = jnp.full((2 * B,), n_noise, jnp.int32)
            warm = jq_sample(jp.schedule, seeds.reshape(2 * B, 64, 4), t,
                             (first * scale).reshape(2 * B, 64, 4)).reshape(seeds.shape)
        _, chain = jens.ensemble_p_sample_loop(
            jp.model.apply, jp.stacked_params, jp.schedule, jp.hard_conds, jp.cc, loop_key,
            jp.cfg, gds=jgds, guide_cfg=jp.guide_cfg, n_diffusion_steps=n_steps,
            warm_start=warm, n_tiles=2)
        return jme._finalize_ensemble(chain, jgds, *common).trajs_final

    a, b = np.array(run(jnp.float32(1.0))), np.array(run(jnp.float32(1 + 1e-7)))
    return float(max(np.abs(a - np.asarray(jres.trajs_final)).max(), np.abs(a - b).max()))


def as_torch(res) -> PlanResult:
    return PlanResult(**{f.name: torch.from_numpy(np.array(getattr(res, f.name)))
                         for f in dataclasses.fields(PlanResult)})


@pytest.mark.parametrize("local", [False, True], ids=["ecbs-fresh", "xecbs-local"])
def test_expand_child_ensemble_matches_jax(team, local, monkeypatch):
    tp, jp = team["tps"][0], team["jps"][0]
    paths_all, ix_best, st = team["paths_all"], team["ix_best"], team["start_times"]
    A, _, L, _ = paths_all.shape
    T_out = 3 + L
    margin = jp.robot.rr_margin
    c = dict(q_l=[np.array([1.0, 0.0], np.float32)], t_range_l=[(60, 68)], radius_l=[0.24])
    key = jax.random.PRNGKey(21 + local)
    n_noise = params.n_local_inference_noising_steps
    n_denoise = params.n_local_inference_denoising_steps

    # JAX: the fused expansion, and the same plan by its parts.
    jgds = jp._guide_data(*jp._route_constraints([JMultiPoint(**c)]))
    jnew, jscalars = jfused.expand_child_ensemble(
        jp.model.apply, jp.stacked_params, jp.schedule, jp.hard_conds, jp.cc, jgds, key,
        jp.cfg, jp.guide_cfg, jnp.asarray(jp.transforms), jp.task.stacked_scenes,
        jp.robot.radius, jp.robot.q_min, jp.robot.q_max, jp._savgol, paths_all, ix_best, 0,
        st, margin, jnp.asarray(params.vertex_constraint_radius),
        jnp.asarray(params.weight_grad_cost_soft_constraints), n_tiles=2, use_soft=True,
        local=local, n_noise=n_noise, n_denoise=n_denoise, T_out=T_out)
    spc = jax_soft_paths(jp, paths_all, ix_best, st, 0, T_out)
    jgds_soft = JGuideData(scene=jgds.scene, normalizer=jgds.normalizer,
                           constraints=jgds.constraints, soft_paths=spc)
    common = (jnp.asarray(jp.transforms), jp.task.stacked_scenes, jp.robot.radius,
              jp.robot.q_min, jp.robot.q_max, jp._savgol)
    seeds = None
    if local:
        tiles = jnp.transpose(paths_all[0].reshape(B, 2, 64, 4), (1, 0, 2, 3))
        tiles = tiles.at[..., :2].add(-jnp.asarray(jp.transforms)[:, None, None, :])
        seeds = jax.vmap(lambda x, n: n.normalize(x))(tiles, jp._stacked_normalizers)
        jres = jme._plan_local_ensemble(
            jp.model.apply, jp.stacked_params, jp.schedule, jp.hard_conds, jp.cc, jgds_soft,
            seeds, key, jp.cfg, jp.guide_cfg, *common, n_tiles=2, n_noise=n_noise,
            n_denoise=n_denoise)
    else:
        jres = jme._plan_fresh_ensemble(jp.model.apply, jp.stacked_params, jp.schedule,
                                        jp.hard_conds, jp.cc, jgds_soft, key, jp.cfg,
                                        jp.guide_cfg, *common, n_tiles=2)
    spread = jax_own_spread(jp, jgds_soft, key, seeds if local else None, jres, common)
    others = jcd.pad_team_positions(paths_all[jnp.arange(A), ix_best][..., :2], st, T_out)
    idx = np.clip(np.arange(T_out), 0, L - 1)
    jsel = jcd.select_candidate_and_conflicts(jnp.asarray(jres.trajs_final)[:, idx, :2],
                                              jres.free_mask, 0, others, margin)
    want = [int(jnp.any(jres.free_mask))] + [np.asarray(x) for x in jsel]
    # JAX's parts give JAX's fused expansion (its reconstruction above).
    assert [int(x) for x in want[:3]] == [int(x) for x in np.asarray(jscalars[:3])]

    # The port: the balls it builds, and its choice and summary on JAX's batch.
    seen = {}

    def planned(gds, *args):
        seen["spc"] = gds.soft_paths
        return as_torch(jres)

    monkeypatch.setattr(tp, "_plan_local" if local else "_plan_fresh", planned)
    kw = dict(dtype=torch.float32)
    args = (torch.from_numpy(np.array(paths_all)), torch.from_numpy(np.array(ix_best)).long(),
            0, torch.from_numpy(np.array(st)).long(), T_out, margin,
            torch.tensor(params.vertex_constraint_radius, **kw),
            torch.tensor(params.weight_grad_cost_soft_constraints, **kw))
    gds = tp._guide_data(*tp._route_constraints([MultiPointConstraint(**c)]))
    noise = (local_noise if local else fresh_noise)(key, tp.cfg, 2)
    new, scalars = expand_child_ensemble(tp, gds, noise, *args, use_soft=True, local=local)
    np.testing.assert_array_equal(seen["spc"].points.numpy(), np.asarray(spc.points))
    np.testing.assert_array_equal(seen["spc"].mask.numpy(), np.asarray(spc.mask))
    np.testing.assert_array_equal(seen["spc"].radius.numpy(), np.asarray(spc.radius))
    got = [int(scalars[0])] + [x.numpy() for x in scalars[1:]]
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g_), np.asarray(w_))
    assert torch.equal(new[0], torch.from_numpy(np.array(jres.trajs_final)))
    assert torch.equal(new[1], torch.from_numpy(np.array(paths_all[1])))

    # The port's own replan on JAX's draws.
    monkeypatch.undo()
    new, scalars = expand_child_ensemble(tp, gds, noise, *args, use_soft=True, local=local)
    gap = float(np.abs(new[0].numpy() - np.asarray(jres.trajs_final)).max())
    print(f"{'local' if local else 'fresh'}: port's replan against JAX's {gap:.3g}; JAX's "
          f"own spread {spread:.3g}")
    assert gap <= max(PLAN_TOL, BALL_FACTOR * spread), (gap, spread)


# ------------------------------------------------------------------ CBS
def test_cbs_ensemble_branch_engages_in_xecbs(team, monkeypatch):
    calls = []
    orig = cbs_module.expand_child_ensemble

    def counting(*a, **k):
        calls.append(k["local"])
        return orig(*a, **k)

    monkeypatch.setattr(cbs_module, "expand_child_ensemble", counting)
    p0, p1 = team["tps"]
    search = cbs_module.CBS([p0, p1], [p0.start_state_pos, p1.start_state_pos],
                            [p0.goal_state_pos, p1.goal_state_pos], start_time_l=[0, 3],
                            is_xcbs=True, is_ecbs=True)
    paths, n_exp, status, n_coll = search.plan(runtime_limit=300.0)
    assert len(paths) == 2 and paths[0].shape == (3 + 128, 4)
    assert search.timing["plans_fresh"] >= 2
    assert len(calls) == search.timing["plans_local"] and all(calls)
    if n_exp:
        assert len(calls) >= 1
    if status == TrialSuccessStatus.SUCCESS:
        assert n_coll == 0 and audit_solution_collisions(paths, 0.05) == 0


def test_pp_plans_a_staggered_multi_tile_team(team):
    p0, p1 = team["tps"]
    pp = PrioritizedPlanning([p0, p1], [p0.start_state_pos, p1.start_state_pos],
                             [p0.goal_state_pos, p1.goal_state_pos], start_time_l=[0, 3])
    paths, _, status, n_coll = pp.plan(runtime_limit=300.0)
    assert not pp.used_scan and len(paths) == 2 and paths[1].shape == (3 + 128, 4)
    np.testing.assert_array_equal(paths[1][0], paths[1][3])  # the stagger's dwell
    assert pp.timing["plans_fresh"] == 2
    assert status in (TrialSuccessStatus.SUCCESS, TrialSuccessStatus.FAIL_COLLISION_AGENTS)
