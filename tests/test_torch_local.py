"""The CBS roots and XCBS's local replan of the port against the JAX package.

The team is the 3-robot circle of EnvEmptyNoWait2D on the real checkpoint at
B=8 and full depth (25+1 DDPM steps, 14 guided steps x 20 guide
iterations; a local replan: q-sampled at t=3, then steps 2, 1, 0, -1, all
guided). JAX's draws are rebuilt from its keys, as `tests/test_torch_mpd.py`
rebuilds them.

What is held, and why so:
- The CBS/XCBS root (`plan_fresh_team`): every agent plans with no
  constraint, so each whole plan agrees within 1e-4, with the same free
  mask, index and conflict summary.
- The local replan (`run_local_inference`, `MPD._plan_local`) from JAX's
  root batch, with no constraint, under ECBS's soft rows, and under one CT
  keep-out ball. With no constraint each DDPM step fed JAX's chain agrees
  within STEP_TOL and the whole plan within LOCAL_TOL, free mask and index
  equal (measured 1.1e-5 and 1.2e-5). Under the ball, the whole plan is
  held to BALL_TOL (measured 2.3e-5). Under the soft rows (weight 0.02, a
  kink at each ball's edge, 20 guide iterations a step) rounding is
  amplified in JAX as in the port: JAX's first step compiled alone lands
  3.4e-4 from its own chain (the port's 3.9e-4), and JAX's whole replan
  compiled as another program on the same draws moves by 0.087 (the
  port's gap to JAX: 0.091, the same sample), so under balls each step and
  the whole plan are held to BALL_FACTOR times JAX's own spread, which the
  test measures and prints beside the port's gap; free mask and index
  must be equal all the same.
- The ECBS root (`plan_sequential_root_soft`), agent by agent on JAX's
  carry: each DDPM step fed JAX's chain within FIRST_STEP_TOL at the first
  step (t = 24, where the UNet's float32 rounding is multiplied by
  sqrt(1/alphabar - 1) = 4176.9 and 0.2378, as in tests/test_torch_pp.py)
  and STEP_TOL after it, or BALL_FACTOR times the agent's own JAX step
  spread under the same soft balls where that is wider. It is at agent
  1's first guided step (t = 12): the port's step lands 1.07e-4 from
  JAX's, and JAX's own second half, started from the port's posterior
  mean (one float32 ulp, 1.2e-7, from JAX's), lands 9.4e-5 from JAX's
  chain. So each guided step is also held in two halves: the posterior
  mean within MEAN_TOL (measured <= 1.3e-7), and the 20 guide iterations
  and the noise, from JAX's mean, within STEP_TOL (measured <= 3.9e-5:
  a fault in the guide cannot hide behind the spread); the finalize
  and the choice on JAX's chain give JAX's index; agent 0, under no
  active ball, agrees as a whole plan. The starvation branch, forced
  through `read`, replans as JAX's cond branch does (every ball masked,
  the agent's second key). The root's summary on JAX's chosen paths
  equals JAX's.
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmd_tpu.common.constraints import MultiPointConstraint as JMultiPoint
from mmd_tpu.config import params as jparams
from mmd_tpu.costs.constraints import SoftPathConstraints as JSoftPaths
from mmd_tpu.costs.guide import GuideData as JGuideData
from mmd_tpu.costs.guide import guide_gradient as jguide_gradient
from mmd_tpu.datasets.normalization import LimitsNormalizer as JNormalizer
from mmd_tpu.datasets.trajectories import TrajectoryDataset as JDataset
from mmd_tpu.models import diffusion as jdiff
from mmd_tpu.parallel import team as jteam
from mmd_tpu.planners.single_agent.mpd import MPD as JMPD
from mmd_tpu.planners.single_agent.mpd import _finalize_plan as jax_finalize_plan
from mmd_tpu.planners.single_agent.mpd import _plan_fresh as jax_plan_fresh
from mmd_tpu.planners.single_agent.mpd import _plan_local as jax_plan_local
from mmd_tpu.train.trainer import load_checkpoint as jax_load_checkpoint
from mmd_torch.common.constraints import MultiPointConstraint
from mmd_torch.common.experiences import PathBatchExperience
from mmd_torch.common.multi_agent_utils import get_start_goal_pos_circle
from mmd_torch.costs.constraints import SoftPathConstraints
from mmd_torch.costs.guide import GuideData
from mmd_torch.models import diffusion as tdiff
from mmd_torch.parallel.team import (
    PrioritizedTeam,
    plan_fresh_team,
    plan_sequential_root_soft,
)
from mmd_torch.planners.multi_agent.conflict_detection import team_conflict_summary
from mmd_torch.planners.single_agent.mpd import _finalize_plan, load_planners

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MID = "EnvEmptyNoWait2D-RobotPlanarDisk"
A, B = 3, 8
N_NOISE = N_DENOISE = 3
PLAN_TOL = 1e-4      # a whole plan with no active constraint
LOCAL_TOL = 1e-4     # a local replan, no ball
BALL_TOL = 1e-3      # a local replan under a CT ball
FIRST_STEP_TOL, STEP_TOL = 2e-3, 1e-4
MEAN_TOL = 1e-6     # a step's posterior mean, before its guide iterations
BALL_FACTOR = 2.0    # a step under balls, over JAX's own spread at that step


def rebuilt_noise(key, cfg) -> tdiff.SamplerNoise:
    """The draws JAX's fresh loop makes from `key` (diffusion.py:152-163)."""
    k, init_key = jax.random.split(key)
    shape = (cfg.n_samples, cfg.horizon, cfg.state_dim)
    keys = jax.random.split(k, cfg.n_diffusion_steps + cfg.n_diffusion_steps_without_noise)
    return tdiff.SamplerNoise(
        x_T=torch.from_numpy(np.array(jax.random.normal(init_key, shape))),
        steps=torch.from_numpy(np.stack([np.asarray(jax.random.normal(kk, shape))
                                         for kk in keys])))


def rebuilt_local_noise(key, cfg) -> tdiff.SamplerNoise:
    """The draws of JAX's local replan from `key`: the q-sample noise from
    the second half of one split (mpd.py:138), then the loop's own split,
    whose init key goes unused under a warm start (diffusion.py:152-157)."""
    key, nkey = jax.random.split(key)
    shape = (cfg.n_samples, cfg.horizon, cfg.state_dim)
    k, _ = jax.random.split(key)
    keys = jax.random.split(k, N_DENOISE + cfg.n_diffusion_steps_without_noise)
    return tdiff.SamplerNoise(
        x_T=torch.from_numpy(np.array(jax.random.normal(nkey, shape))),
        steps=torch.from_numpy(np.stack([np.asarray(jax.random.normal(kk, shape))
                                         for kk in keys])))


def tmask() -> np.ndarray:
    m = np.ones((A, 64), np.float32)
    m[:, 0] = 0.0
    return m


@pytest.fixture(scope="module")
def setup():
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
    base_cset, _ = j0._pack(None)
    keys = jax.random.split(jax.random.PRNGKey(3), A)
    res, summary = jteam._fresh_team_with_summary(
        j0.model.apply, j0.params, j0.schedule,
        jteam.stack_hard_conds([p.hard_conds for p in jps]), j0._guide_data(base_cset),
        keys, j0.cfg, j0.guide_cfg, j0.task.scene, j0.robot.radius, j0.robot.q_min,
        j0.robot.q_max, j0._savgol, j0.robot.rr_margin)
    root = {k: np.array(getattr(res, k)) for k in ("trajs_final", "free_mask", "idx_best")}
    root["summary"] = [np.array(v) for v in summary]
    assert int(root["summary"][0]) > 0, "the root should hold a conflict"
    return dict(tps=tps, jps=jps, keys=keys, base_cset=base_cset, root=root,
                team=PrioritizedTeam.of(tps, tps[0].robot.rr_margin))


def chosen_pos(trajs, ix) -> np.ndarray:
    return np.stack([trajs[i, ix[i], :, :2] for i in range(len(ix))])


def test_fresh_team_root_matches_jax(setup):
    j0 = setup["jps"][0]
    out = plan_fresh_team(setup["team"], [rebuilt_noise(k, j0.cfg) for k in setup["keys"]])
    root = setup["root"]
    np.testing.assert_allclose(out.trajs.numpy(), root["trajs_final"], rtol=0, atol=PLAN_TOL)
    np.testing.assert_array_equal(out.free_mask.numpy(), root["free_mask"])
    np.testing.assert_array_equal(out.ix.numpy(), root["idx_best"])
    assert out.free_any.all()
    for got, want in zip(out.summary, root["summary"]):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PLAN_TOL)
    assert [int(v) for v in out.summary[:4]] == [int(v) for v in root["summary"][:4]]


# ------------------------------------------------------------ local replan
def local_case(setup, case):
    """(port GuideData, JAX GuideData, the port's constraint list) of agent
    0's replan in `case`."""
    tp, jp = setup["tps"][0], setup["jps"][0]
    root = setup["root"]
    cons_t, cons_j, spc_t, spc_j = [], [], None, None
    if case == "ball":
        # A CT ball at the root's first conflict, as conversion makes it
        # (t_pad 2, the config's radius).
        _, t, _, _, mid = root["summary"]
        rng = (int(t) - 2, int(t) + 2)
        cons_t = [MultiPointConstraint(q_l=[mid], t_range_l=[rng])]
        cons_j = [JMultiPoint(q_l=[mid], t_range_l=[rng])]
    if case == "soft":
        pos = chosen_pos(root["trajs_final"], root["idx_best"])
        mask = tmask()
        mask[0] = 0.0  # the agent's own row
        kw = dict(dtype=torch.float32)
        spc_t = SoftPathConstraints(
            points=torch.from_numpy(pos), mask=torch.from_numpy(mask),
            radius=torch.full((), jparams.vertex_constraint_radius, **kw),
            weight=torch.full((), jparams.weight_grad_cost_soft_constraints, **kw))
        spc_j = JSoftPaths(points=jnp.asarray(pos), mask=jnp.asarray(mask),
                           radius=jnp.asarray(jparams.vertex_constraint_radius),
                           weight=jnp.asarray(jparams.weight_grad_cost_soft_constraints))
    cset_t, _ = tp._pack(cons_t)
    cset_j, _ = jp._pack(cons_j)
    return (GuideData(scene=tp.scene, normalizer=tp.dataset.normalizer, constraints=cset_t,
                      soft_paths=spc_t),
            JGuideData(scene=jp.task.scene, normalizer=jp.dataset.normalizer,
                       constraints=cset_j, soft_paths=spc_j),
            cons_t)


@pytest.mark.parametrize("case", ["free", "soft", "ball"])
def test_local_replan_matches_jax(setup, case):
    tp, jp = setup["tps"][0], setup["jps"][0]
    gd, jgd, cons = local_case(setup, case)
    key = jax.random.PRNGKey(11 + len(case))
    seed = setup["root"]["trajs_final"][0]
    jseed = jp.dataset.normalizer.normalize(jnp.asarray(seed))
    want = jax_plan_local(jp.model.apply, jp.params, jp.schedule, jp.hard_conds, jgd, jseed,
                          key, jp.cfg, jp.guide_cfg, jp.task.scene, jp.robot.radius,
                          jp.robot.q_min, jp.robot.q_max, jp._savgol,
                          n_noise=N_NOISE, n_denoise=N_DENOISE)
    jchain = np.array(jdiff.run_local_inference(
        jp.model.apply, jp.params, jp.schedule, jp.hard_conds, jgd, jseed, key, jp.cfg,
        jp.guide_cfg, n_noising_steps=N_NOISE, n_denoising_steps=N_DENOISE))
    noise = rebuilt_local_noise(key, jp.cfg)
    seed_norm = tp.dataset.normalizer.normalize(torch.from_numpy(seed))

    # Each step, fed JAX's chain.
    t = torch.full((B,), N_NOISE, dtype=torch.int64)
    warm = tp.hard_conds.apply(tdiff.q_sample(tp.schedule, seed_norm, t, noise.x_T))
    np.testing.assert_allclose(warm.numpy(), jchain[0], rtol=0, atol=1e-6)
    steps = tp.cfg.step_indices(N_DENOISE)
    assert steps == [2, 1, 0, -1] and jchain.shape[0] == len(steps) + 1
    errs = []
    for k, i in enumerate(steps):
        x = tdiff._ddpm_step(tp.model, tp.schedule, torch.from_numpy(jchain[k]), i,
                             noise.steps[k], tp.hard_conds, gd, tp.cfg, tp.guide_cfg,
                             i < tp.cfg.t_start_guide)
        errs.append(float(np.abs(x.numpy() - jchain[k + 1]).max()))
    print(f"{case}: port against JAX's chain per step {errs}")
    if case == "free":
        assert max(errs) <= STEP_TOL, errs
    else:
        jax_gaps = jax_step_spread(jp, jp.hard_conds, jgd, jchain,
                                   loop_keys(key, len(steps), local=True), steps)
        print(f"{case}: JAX's own step alone against its chain, or under a 1e-7 relative "
              f"change of its input: {jax_gaps}")
        assert all(e <= max(STEP_TOL, BALL_FACTOR * g) for e, g in zip(errs, jax_gaps)), \
            (errs, jax_gaps)

    # The whole replan, and through MPD._run with an experience.
    got = tp._plan_local(gd, seed_norm, noise, tp.hard_conds)
    gap = float(np.abs(got.trajs_final.numpy() - np.array(want.trajs_final)).max())
    print(f"{case}: whole plan {gap:.3g}")
    np.testing.assert_array_equal(got.free_mask.numpy(), np.array(want.free_mask))
    assert int(got.idx_best) == int(want.idx_best)
    if case != "soft":  # MPD._run packs the soft rows its own way
        via_run = tp._run(cons, PathBatchExperience(torch.from_numpy(seed)), noise)
        assert torch.equal(via_run.trajs_final, got.trajs_final)
    if case == "free":
        assert gap <= LOCAL_TOL
        return
    other, nudged = jax_own_spread(jp, jgd, jseed, key, want)
    print(f"{case}: port against JAX {gap:.3g}; JAX's loop compiled as another program "
          f"{other:.3g}, and under a 1e-7 relative change of its q-sample noise {nudged:.3g}")
    if case == "ball":
        assert gap <= BALL_TOL, (gap, other, nudged)
    else:
        assert gap <= BALL_FACTOR * max(other, nudged), (gap, other, nudged)


def loop_keys(key, n_steps: int, local: bool):
    """The per-step keys of JAX's loop from its plan key: a local replan
    first splits off its q-sample key (mpd.py:138)."""
    if local:
        key = jax.random.split(key)[0]
    k, _ = jax.random.split(key)
    return jax.random.split(k, n_steps)


def jax_step_spread(jp, hard, jgd, jchain, keys, steps) -> list:
    """Per guided step of JAX's chain (0 for the others): the largest of
    how far its step, compiled alone, lands from the chain's next state,
    and how far that step moves when its input is scaled by 1 + 1e-7 or by
    1 - 1e-7."""
    @functools.partial(jax.jit, static_argnames="guided")
    def step(x, i, k, guided):
        return jdiff._ddpm_step(jp.model.apply, jp.params, jp.schedule, x, i, k, hard, jgd,
                                jp.cfg, jp.guide_cfg, guided)

    gaps = []
    for n, i in enumerate(steps):
        x, guided = jnp.asarray(jchain[n]), i < jp.cfg.t_start_guide
        if not guided:  # no ball acts in an unguided step
            gaps.append(0.0)
            continue
        a = np.array(step(x, jnp.int32(i), keys[n], guided))
        moved = [np.abs(a - np.array(step(x * np.float32(1 + d), jnp.int32(i), keys[n],
                                          guided))).max() for d in (1e-7, -1e-7)]
        gaps.append(float(max(np.abs(a - jchain[n + 1]).max(), *moved)))
    return gaps


def jax_own_spread(jp, jgd, jseed, key, want) -> tuple:
    """How far JAX's local replan moves from `want` (its `_plan_local`)
    when the same loop, on the same draws, is compiled as another program
    (the warm start computed outside it), and how far that program moves
    when its q-sample noise is scaled by 1 + 1e-7."""
    key2, nkey = jax.random.split(key)
    noise = jax.random.normal(nkey, jseed.shape, jseed.dtype)

    @jax.jit
    def body(scale):
        t = jnp.full((jseed.shape[0],), N_NOISE, jnp.int32)
        warm = jdiff.q_sample(jp.schedule, jseed, t, noise * scale)
        _, chain = jdiff.guided_p_sample_loop(
            jp.model.apply, jp.params, jp.schedule, jp.hard_conds, key2, jp.cfg, gd=jgd,
            guide_cfg=jp.guide_cfg, n_diffusion_steps=N_DENOISE, warm_start=warm)
        return jax_finalize_plan(chain, jgd.normalizer, jp.task.scene, jp.robot.radius,
                                 jp.robot.q_min, jp.robot.q_max, jp._savgol).trajs_final

    a, b = np.array(body(jnp.float32(1.0))), np.array(body(jnp.float32(1 + 1e-7)))
    return (float(np.abs(a - np.array(want.trajs_final)).max()),
            float(np.abs(a - b).max()))


# ------------------------------------------------------------- ECBS root
@pytest.fixture(scope="module")
def ecbs_root(setup):
    j0 = setup["jps"][0]
    keys = jax.random.split(jax.random.PRNGKey(5), A)
    out = jteam._sequential_root_with_summary(
        j0.model.apply, j0.params, j0.schedule,
        jteam.stack_hard_conds([p.hard_conds for p in setup["jps"]]), j0.task.scene,
        j0.dataset.normalizer, setup["base_cset"], keys, j0.cfg, j0.guide_cfg,
        j0.robot.radius, j0.robot.q_min, j0.robot.q_max, j0._savgol,
        jparams.vertex_constraint_radius, jparams.weight_grad_cost_soft_constraints,
        j0.robot.rr_margin)
    trajs, free_any, ix, free_mask, summary = jax.device_get(out)
    split = [jax.random.split(k) for k in keys]  # (soft, free) per agent
    return dict(trajs=np.array(trajs), free_any=np.array(free_any), ix=np.array(ix),
                free_mask=np.array(free_mask), summary=[np.array(v) for v in summary],
                soft_keys=[s[0] for s in split], free_keys=[s[1] for s in split])


def jax_carry(root, i):
    """JAX's carry before agent i: zeros, with the chosen rows before i."""
    sel_pos = np.zeros((A, 64, 2), np.float32)
    planned = np.zeros((A,), np.float32)
    for j in range(i):
        sel_pos[j] = root["trajs"][j, root["ix"][j], :, :2]
        planned[j] = 1.0
    return sel_pos, planned


def test_ecbs_root_agent_zero_and_summary_match_jax(setup, ecbs_root):
    j0, team = setup["jps"][0], setup["team"]
    assert ecbs_root["free_any"].all()
    reads = []

    def read(flag):
        reads.append(flag)
        return bool(flag)

    out = plan_sequential_root_soft(
        team, [rebuilt_noise(k, j0.cfg) for k in ecbs_root["soft_keys"]],
        [rebuilt_noise(k, j0.cfg) for k in ecbs_root["free_keys"]], read)
    assert len(reads) == A and all(f.dtype == torch.bool and f.dim() == 0 for f in reads)
    np.testing.assert_allclose(out.trajs[0].numpy(), ecbs_root["trajs"][0], rtol=0,
                               atol=PLAN_TOL)
    assert int(out.ix[0]) == int(ecbs_root["ix"][0])
    assert out.free_any.all()
    got = team_conflict_summary(
        torch.from_numpy(chosen_pos(ecbs_root["trajs"], ecbs_root["ix"])), team.margin)
    for g, w in zip(got, ecbs_root["summary"]):
        np.testing.assert_array_equal(g.numpy(), w)


def jax_guide_tail(jp, hard, jgd):
    """The second half of JAX's guided step (diffusion.py:105-117), from a
    posterior mean: the guide iterations, then the step's noise."""
    @jax.jit
    def tail(x, i, key):
        x = jax.lax.fori_loop(0, jp.cfg.n_guide_steps,
                              lambda _, x: hard.apply(x + jguide_gradient(x, jgd, jp.guide_cfg)),
                              x)
        std = jnp.exp(0.5 * jp.schedule.posterior_log_variance_clipped[jnp.maximum(i, 0)])
        noise = jax.random.normal(key, x.shape, x.dtype) * (i > 0).astype(x.dtype)
        return hard.apply(x + std * noise * jp.cfg.noise_std_extra)

    return tail


def jax_denoised_mean(jp, x, i):
    """The first half of JAX's step (diffusion.py:96-103)."""
    tb = jnp.full((x.shape[0],), max(i, 0), jnp.int32)
    x0 = jdiff.predict_start_from_noise(jp.schedule, x, tb, jp.model.apply(jp.params, x, tb))
    return np.array(jdiff.q_posterior_mean(jp.schedule, jnp.clip(x0, -1.0, 1.0), x, tb))


@pytest.fixture(scope="module")
def ecbs_steps(setup, ecbs_root):
    """For agents 1 and 2 under JAX's carry: JAX's chain, the port's error
    at each DDPM step fed that chain, and JAX's own spread at each step
    (`jax_step_spread`, widened at a guided step by how far JAX's second
    half moves when it starts from the port's posterior mean instead of its
    own). Each guided step is also split in two: the port's posterior mean
    against JAX's (`means`), and the port's guide iterations and noise
    against JAX's, both from JAX's posterior mean (`tails`)."""
    j0, team = setup["jps"][0], setup["team"]
    out = {}
    for i in (1, 2):
        tp, hard_j = setup["tps"][i], setup["jps"][i].hard_conds
        sel_pos, planned = jax_carry(ecbs_root, i)
        mask = planned[:, None] * tmask()
        jgd = JGuideData(scene=j0.task.scene, normalizer=j0.dataset.normalizer,
                         constraints=setup["base_cset"],
                         soft_paths=JSoftPaths(
                             points=jnp.asarray(sel_pos), mask=jnp.asarray(mask),
                             radius=jnp.asarray(jparams.vertex_constraint_radius),
                             weight=jnp.asarray(jparams.weight_grad_cost_soft_constraints)))
        key = ecbs_root["soft_keys"][i]
        jchain = np.array(jdiff.run_inference(j0.model.apply, j0.params, j0.schedule, hard_j,
                                              jgd, key, j0.cfg, j0.guide_cfg))
        noise = rebuilt_noise(key, j0.cfg)
        gd = GuideData(scene=tp.scene, normalizer=tp.dataset.normalizer,
                       constraints=team.base_cset,
                       soft_paths=team.balls(torch.from_numpy(sel_pos), torch.from_numpy(mask),
                                             team.soft_weight))
        assert np.array_equal(tp.hard_conds.apply(noise.x_T).numpy(), jchain[0])
        steps = tp.cfg.step_indices()
        keys = loop_keys(key, len(steps), local=False)
        tail = jax_guide_tail(j0, hard_j, jgd)
        jax_gaps = jax_step_spread(j0, hard_j, jgd, jchain, keys, steps)
        errs, means, tails = [], [], []
        for k, step in enumerate(steps):
            guided = step < tp.cfg.t_start_guide
            x_in = torch.from_numpy(jchain[k])
            x = tdiff._ddpm_step(tp.model, tp.schedule, x_in, step, noise.steps[k],
                                 tp.hard_conds, gd, tp.cfg, tp.guide_cfg, guided)
            errs.append(float(np.abs(x.numpy() - jchain[k + 1]).max()))
            if not guided:
                continue
            mean = tdiff._denoised_mean(tp.model, tp.schedule, x_in, step)
            jmean = jax_denoised_mean(j0, jnp.asarray(jchain[k]), step)
            want = np.array(tail(jnp.asarray(jmean), jnp.int32(step), keys[k]))
            got = tdiff._guide_and_noise(tp.schedule, torch.from_numpy(jmean), step,
                                         noise.steps[k], tp.hard_conds, gd, tp.cfg,
                                         tp.guide_cfg, True)
            means.append(float(np.abs(mean.numpy() - jmean).max()))
            tails.append(float(np.abs(got.numpy() - want).max()))
            moved = np.array(tail(jnp.asarray(mean.numpy()), jnp.int32(step), keys[k]))
            jax_gaps[k] = max(jax_gaps[k], float(np.abs(moved - jchain[k + 1]).max()))
        print(f"ECBS agent {i}: port first step {errs[0]:.3g}, later steps <= "
              f"{max(errs[1:]):.3g}; JAX's own spread: first step {jax_gaps[0]:.3g}, later "
              f"steps <= {max(jax_gaps[1:]):.3g}; steps past STEP_TOL (step, port, JAX): "
              f"{[(s, e, g) for s, e, g in zip(steps, errs, jax_gaps) if e > STEP_TOL]}; "
              f"guided steps' halves: mean <= {max(means):.3g}, guide and noise <= "
              f"{max(tails):.3g}")
        out[i] = dict(jchain=jchain, errs=errs, jax_gaps=jax_gaps, means=means, tails=tails)
    return out


@pytest.mark.parametrize("i", [1, 2])
def test_ecbs_root_agent_matches_jax_step_by_step(setup, ecbs_root, ecbs_steps, i):
    """Agent i under JAX's carry: each DDPM step fed JAX's chain, then the
    finalize and the choice (least-cost free) on JAX's chain. After the
    first step each step is held to STEP_TOL, or where this agent's own JAX
    step under the team's soft balls spreads wider, to BALL_FACTOR times
    that step's spread. Each guided step's halves are held apart as well:
    the posterior mean to MEAN_TOL, and the guide iterations and noise, from
    JAX's mean, to STEP_TOL."""
    tp = setup["tps"][i]
    errs, gaps = ecbs_steps[i]["errs"], ecbs_steps[i]["jax_gaps"]
    assert max(ecbs_steps[i]["means"]) <= MEAN_TOL, ecbs_steps[i]["means"]
    assert max(ecbs_steps[i]["tails"]) <= STEP_TOL, ecbs_steps[i]["tails"]
    assert errs[0] <= FIRST_STEP_TOL, errs
    assert all(e <= max(STEP_TOL, BALL_FACTOR * g) for e, g in zip(errs[1:], gaps[1:])), \
        (errs, gaps)
    res = _finalize_plan(torch.from_numpy(ecbs_steps[i]["jchain"]), tp.dataset.normalizer,
                         tp.scene, tp.robot.radius, tp.robot.q_min, tp.robot.q_max,
                         tp._savgol)
    np.testing.assert_allclose(res.trajs_final.numpy(), ecbs_root["trajs"][i], rtol=0,
                               atol=1e-6)
    assert int(res.idx_best) == int(ecbs_root["ix"][i])


def test_ecbs_root_starvation_replans_as_jax_cond_branch(setup, ecbs_root):
    """`read` says agent 0's batch is starved: the agent plans again with
    every ball masked and its second key's draws, as JAX's cond branch
    (team.py:97-101) computes it, and that plan is the one chosen."""
    j0, team = setup["jps"][0], setup["team"]
    mask = np.zeros((A, 64), np.float32)
    jgd = JGuideData(scene=j0.task.scene, normalizer=j0.dataset.normalizer,
                     constraints=setup["base_cset"],
                     soft_paths=JSoftPaths(points=jnp.zeros((A, 64, 2)), mask=jnp.asarray(mask),
                                           radius=jnp.asarray(jparams.vertex_constraint_radius),
                                           weight=jnp.asarray(
                                               jparams.weight_grad_cost_soft_constraints)))
    want = jax_plan_fresh(j0.model.apply, j0.params, j0.schedule, j0.hard_conds, jgd,
                          ecbs_root["free_keys"][0], j0.cfg, j0.guide_cfg, j0.task.scene,
                          j0.robot.radius, j0.robot.q_min, j0.robot.q_max, j0._savgol)
    calls = []

    class Enough(Exception):
        pass

    def read(flag):
        calls.append(bool(flag))
        if len(calls) > 1:
            raise Enough  # agent 0 is all this test needs
        return False

    team_noise = [rebuilt_noise(k, j0.cfg) for k in ecbs_root["soft_keys"]]
    fallback = [rebuilt_noise(k, j0.cfg) for k in ecbs_root["free_keys"]]
    planned = []
    orig = team.plan_under

    def spy(i, noise, balls=None):
        res = orig(i, noise, balls)
        planned.append((i, noise, balls, res))
        return res

    object.__setattr__(team, "plan_under", spy)  # the team is a frozen dataclass
    try:
        with pytest.raises(Enough):
            plan_sequential_root_soft(team, team_noise, fallback, read)
    finally:
        object.__delattr__(team, "plan_under")
    (i0, n0, b0, _), (i1, n1, b1, res) = planned[:2]
    assert (i0, i1) == (0, 0) and n0 is team_noise[0] and n1 is fallback[0]
    assert not b1.mask.any() and torch.equal(b1.weight, team.soft_weight)
    np.testing.assert_allclose(res.trajs_final.numpy(), np.array(want.trajs_final), rtol=0,
                               atol=PLAN_TOL)
    assert int(res.idx_best) == int(want.idx_best)
