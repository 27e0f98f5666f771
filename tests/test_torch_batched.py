"""N problems as one sampler call: the batched sampler, JAX's vmapped team
and child programs, and the lookup's packed record.

The team is the 3-robot circle of EnvEmptyNoWait2D on the committed
checkpoint at B=8 and full depth (25+1 DDPM steps, 14 guided steps x 20
guide iterations; a local replan q-sampled at t=3, then 2, 1, 0, -1), as in
tests/test_torch_local.py.

- The batched sampler against single calls (`MPD.plan_fresh_batch`,
  `plan_local_batch`): N = 2 and 3 problems, fresh and local, with and
  without soft rows, with constraint sets padded to a common (K, P) against
  each problem's own exact set. Every DDPM step of each problem's chain,
  and the finalize's fields, equal the single call's within BATCH_TOL; the
  free masks and indices are equal. In both the UNet is evaluated B rows at
  a time (`RowChunked`): the CPU's convolutions sum a row in another order
  at another batch size (2-5e-6 of epsilon between 8 and 16 rows,
  measured), and a guided step amplifies that (to 1.7e-5 of a step, and
  5.8e-4 at t = 24, where x0 = x / sqrt(abar) - 4177 eps), exactly as
  cuDNN's choice of algorithm by batch size does on the card. So what is
  held here is the batching itself: the hard conditions, the draws, the
  constraints, the soft rows, the guide, the noise and the finalize. The
  UNet's own row difference is printed.
- A padded constraint set gives the unpadded guide gradient within PAD_TOL
  (the padded rows only change the order of a sum).
- JAX's vmapped programs (`mmd_tpu.parallel.team.plan_fresh_team`, the
  CBS/XCBS root, and `plan_fresh_team_soft`, a Jacobi repair round) on
  JAX's keys: each DDPM step of the port's batched call, fed JAX's chain
  (the programs' vmapped loop before the finalize), lands within STEP_TOL
  of JAX's next state (FIRST_STEP_TOL at t = 24); under the soft rows,
  where a step does not, it is held as tests/test_torch_local.py holds the
  ECBS root's: its two halves apart (the posterior mean within MEAN_TOL,
  the guide iterations and noise from JAX's mean), each within BALL_FACTOR
  times the step's own spread. The port's whole root agrees with JAX's
  program within PLAN_TOL, free mask and indices equal.
- Each of JAX's vmapped programs is one sampler call in the port: a team
  root, a repair round, a conflict's children, a chain step's two
  children, a frontier step's 2M children; a search's `timing` counts its
  sampler calls as they ran and its plans by problem.
- The lookup's packed record: built once per scene and shared with the
  collision guide's table; the plain lookup, which reads it, equals JAX's
  gather exactly on tests/test_torch_grid_sdf.py's cases.
"""
import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmd_tpu.config import params as jparams
from mmd_tpu.costs.guide import GuideData as JGuideData
from mmd_tpu.envs.envs import make_env as jax_make_env
from mmd_tpu.envs.grid_sdf import _lookup
from mmd_tpu.models import diffusion as jdiff
from mmd_tpu.models.diffusion import HardConds as JHardConds
from mmd_tpu.parallel import team as jteam
from mmd_torch.common.constraints import MultiPointConstraint
from mmd_torch.common.multi_agent_utils import get_start_goal_pos_circle
from mmd_torch.costs.constraints import (
    SoftPathConstraints,
    pack_constraint_set,
    pack_constraint_sets,
)
from mmd_torch.costs.guide import GuideData, guide_gradient
from mmd_torch.envs.envs import make_env
from mmd_torch.models import diffusion as tdiff
from mmd_torch.models.diffusion import HardConds, SamplerNoise
from mmd_torch.ops.sdf_kernel import grid_lookup_plain, packed_cells
from mmd_torch.parallel.team import (
    PrioritizedTeam,
    plan_fresh_team,
    plan_fresh_team_soft,
    team_soft_paths,
)
from mmd_torch.planners.multi_agent import fused
from mmd_torch.planners.multi_agent.cbs import CBS
from mmd_torch.planners.single_agent.mpd import MPD, load_planners
from mmd_torch.tools.row_chunked import RowChunked
from test_torch_grid_sdf import query_points, torch_grid
from test_torch_local import (
    A,
    B,
    BALL_FACTOR,
    FIRST_STEP_TOL,
    MEAN_TOL,
    PLAN_TOL,
    STEP_TOL,
    jax_denoised_mean,
    jax_guide_tail,
    jax_step_spread,
    loop_keys,
    rebuilt_noise,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MID = "EnvEmptyNoWait2D-RobotPlanarDisk"
BATCH_TOL = 1e-6
PAD_TOL = 1e-7
RADIUS = jparams.vertex_constraint_radius


@pytest.fixture(scope="module")
def team():
    starts, goals = get_start_goal_pos_circle(A)
    tps = load_planners(os.path.join(ROOT, "data_trained_models"),
                        os.path.join(ROOT, "data_trajectories"), "EnvEmptyNoWait2D",
                        starts, goals, device="cpu")
    for p in tps:
        p.cfg = dataclasses.replace(p.cfg, n_samples=B)
    return PrioritizedTeam.of(tps, tps[0].robot.rr_margin)


def team_positions(team, seed: int) -> torch.Tensor:
    """(A, H, 2): each agent's straight line from start to goal, jittered,
    so that soft rows around them act on the others' samples."""
    vals = team.hard_team.values
    H = vals.shape[1]
    s = torch.linspace(0.0, 1.0, H)[:, None]
    line = vals[:, :1, :2] * (1 - s) + vals[:, -1:, :2] * s
    g = torch.Generator().manual_seed(seed)
    return line + 0.02 * torch.randn(line.shape, generator=g)


def problem_inputs(team, n: int, local: bool, soft: bool, padded: bool):
    """n problems' (hard values (n, H, D), draws, seeds or None, the
    single calls' GuideData each, the batch's GuideData)."""
    p0 = team.p0
    g = torch.Generator().manual_seed(17 * n + 3 * local + soft)
    agents = list(range(n))
    values = team.hard_team.values[agents]
    noise_l = [SamplerNoise.draw(p0.cfg, g, "cpu", 3 if local else None) for _ in range(n)]
    seeds = None
    if local:  # plausible batches near the straight lines, normalized
        pos = team_positions(team, 5)[agents]
        traj = torch.cat([pos, torch.zeros_like(pos)], dim=-1)[:, None]
        traj = traj + 0.05 * torch.randn((n, B, *traj.shape[2:]), generator=g)
        seeds = p0.dataset.normalizer.normalize(traj)
    cons_l = [[] for _ in range(n)]
    if padded:  # problem c holds c + 1 hard balls of c + 1 points each
        rng = np.random.default_rng(n)
        for c in range(n):
            for k in range(c + 1):
                q = [rng.uniform(-0.3, 0.3, 2).astype(np.float32) for _ in range(c + 1)]
                t0 = int(rng.integers(5, 50))
                cons_l[c].append(MultiPointConstraint(
                    q_l=q, t_range_l=[(t0, t0 + 8)] * (c + 1), radius_l=[RADIUS] * (c + 1)))
    spc = None
    if soft:
        spc = team_soft_paths(team_positions(team, 9), RADIUS)
        spc = SoftPathConstraints(points=spc.points[agents], mask=spc.mask[agents],
                                  radius=spc.radius[agents], weight=spc.weight[agents])
    kw = dict(scene=p0.scene, normalizer=p0.dataset.normalizer)
    singles = []
    for c in range(n):
        cset = (pack_constraint_set(cons_l[c], len(cons_l[c]), c + 1, device="cpu")
                if padded else team.base_cset)
        s_c = None if spc is None else SoftPathConstraints(
            points=spc.points[c], mask=spc.mask[c], radius=spc.radius[c], weight=spc.weight[c])
        singles.append(GuideData(constraints=cset, soft_paths=s_c, **kw))
    batch = GuideData(constraints=(pack_constraint_sets(cons_l, device="cpu") if padded
                                   else team.base_cset), soft_paths=spc, **kw)
    return values, noise_l, seeds, singles, batch


CASES = {  # (local, N, soft rows, padded constraint rows)
    "fresh-2": (False, 2, False, False),
    "fresh-3-soft-padded": (False, 3, True, True),
    "local-2-padded": (True, 2, False, True),
    "local-3-soft": (True, 3, True, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_batched_sampler_equals_single_calls(team, case):
    local, n, soft, padded = CASES[case]
    p = copy.copy(team.p0)
    p.model = RowChunked(team.p0.model, B)
    values, noise_l, seeds, singles, batch = problem_inputs(team, n, local, soft, padded)
    if padded:
        assert batch.constraints.q.shape[:3] == (n, n, n)
        assert batch.constraints.n_active == sum(range(1, n + 1))
    if local:
        got = p.plan_local_batch(batch, seeds, noise_l, values)
    else:
        got = p.plan_fresh_batch(batch, noise_l, values)
    for c in range(n):
        hard = HardConds(mask=p.hard_conds.mask, values=values[c])
        want = (p._plan_local(singles[c], seeds[c], noise_l[c], hard) if local
                else p._plan_fresh(singles[c], noise_l[c], hard))
        assert got.trajs_iters[c].shape == want.trajs_iters.shape
        steps = (got.trajs_iters[c] - want.trajs_iters).abs().flatten(1).amax(dim=1)
        assert float(steps.max()) <= BATCH_TOL, (c, steps.tolist())
        for f in ("trajs_final", "cost_path_length", "cost_smoothness", "variance_waypoints"):
            np.testing.assert_allclose(getattr(got, f)[c].numpy(), getattr(want, f).numpy(),
                                       rtol=0, atol=BATCH_TOL, err_msg=f)
        assert torch.equal(got.free_mask[c], want.free_mask)
        assert torch.equal(got.wp_collisions[c], want.wp_collisions)
        assert int(got.idx_best[c]) == int(want.idx_best)
    # The UNet's own rows at N * B against B (printed, not held).
    x = torch.randn((n * B, *values.shape[1:]), generator=torch.Generator().manual_seed(1))
    tb = torch.full((n * B,), 12)
    with torch.no_grad():
        rows = (team.p0.model(x, tb) - p.model(x, tb)).abs().max()
    print(f"{case}: the UNet at {n * B} rows against {B} at a time: {float(rows):.3g}")


def test_padded_constraint_set_gives_the_unpadded_gradient(team):
    p0 = team.p0
    g = torch.Generator().manual_seed(4)
    x = 0.5 * torch.randn((2, B, *team.hard_team.values.shape[1:]), generator=g)
    cons = [[MultiPointConstraint(q_l=[np.array([0.1, -0.2], np.float32)] * 2,
                                  t_range_l=[(10, 30)] * 2, radius_l=[0.2] * 2)],
            [MultiPointConstraint(q_l=[np.array([-0.2, 0.1], np.float32)], t_range_l=[(5, 40)],
                                  radius_l=[0.3])] * 3]
    kw = dict(scene=p0.scene, normalizer=p0.dataset.normalizer)
    padded = GuideData(constraints=pack_constraint_sets(cons, 5, 4, device="cpu"), **kw)
    got = guide_gradient(x, padded, p0.guide_cfg)
    for c in range(2):
        exact = GuideData(constraints=pack_constraint_set(
            cons[c], len(cons[c]), max(len(k.q_l) for k in cons[c]), device="cpu"), **kw)
        want = guide_gradient(x[c], exact, p0.guide_cfg)
        np.testing.assert_allclose(got[c].numpy(), want.numpy(), rtol=0, atol=PAD_TOL)


# ----------------------------------------------- JAX's vmapped programs
@pytest.fixture(scope="module")
def jax_team(team):
    from mmd_tpu.datasets.normalization import LimitsNormalizer as JNormalizer
    from mmd_tpu.datasets.trajectories import TrajectoryDataset as JDataset
    from mmd_tpu.planners.single_agent.mpd import MPD as JMPD
    from mmd_tpu.train.trainer import load_checkpoint as jax_load_checkpoint

    starts, goals = get_start_goal_pos_circle(A)
    jmodel, params, jschedule, jinfo = jax_load_checkpoint(
        os.path.join(ROOT, "data_trained_models", MID))
    jds = JDataset.load(os.path.join(ROOT, "data_trajectories"), MID)
    jds.normalizer = JNormalizer.from_limits(jinfo["normalizer_mins"], jinfo["normalizer_maxs"])
    jps = [JMPD(jmodel, params, jschedule, jds, jnp.asarray(s), jnp.asarray(g), seed=i)
           for i, (s, g) in enumerate(zip(starts, goals))]
    for p in jps:
        p.cfg = dataclasses.replace(p.cfg, n_samples=B)
    return jps


def jax_vmapped_chain(jps, keys, soft_team):
    """The normalized chain inside JAX's vmapped program, vmapped over the
    agents as the program vmaps it: its `one_agent` before the finalize
    (`plan_fresh_team`, team.py:37-45, the root; with `soft_team`,
    `plan_fresh_team_soft`, team.py:327-337, a repair round). The
    program's own `trajs_iters` cannot give it back: the finalize clips x
    to [-1, 1] as it unnormalizes."""
    j0 = jps[0]
    hard = jteam.stack_hard_conds([p.hard_conds for p in jps])
    base_cset, _ = j0._pack(None)

    def one(values, key, spc):
        _, chain = jdiff.guided_p_sample_loop(
            j0.model.apply, j0.params, j0.schedule, JHardConds(mask=hard.mask, values=values),
            key, j0.cfg, gd=j0._guide_data(base_cset, spc), guide_cfg=j0.guide_cfg)
        return chain

    return np.array(jax.jit(jax.vmap(one))(hard.values, keys, soft_team))


@pytest.mark.parametrize("program", ["root", "repair"])
def test_batched_team_program_steps_match_jax(team, jax_team, program):
    jps, j0, tp0 = jax_team, jax_team[0], team.p0
    keys = jax.random.split(jax.random.PRNGKey(3 if program == "root" else 8), A)
    pos = team_positions(team, 9)
    soft_t = soft_j = None
    if program == "repair":
        soft_t = team_soft_paths(pos, RADIUS)
        soft_j = jteam.team_soft_paths(pos.numpy(), RADIUS)
    jchain = jax_vmapped_chain(jps, keys, soft_j)  # (A, S+1, B, H, D)
    noise = SamplerNoise.stack([rebuilt_noise(k, j0.cfg) for k in keys])
    hard = HardConds(mask=team.hard_team.mask, values=team.hard_team.values[:, None])
    gd = GuideData(scene=tp0.scene, normalizer=tp0.dataset.normalizer,
                   constraints=team.base_cset, soft_paths=soft_t)
    steps = tp0.cfg.step_indices()
    errs = np.zeros((A, len(steps)))
    for k, i in enumerate(steps):
        x = tdiff._ddpm_step(tp0.model, tp0.schedule, torch.from_numpy(jchain[:, k]), i,
                             noise.steps[k], hard, gd, tp0.cfg, tp0.guide_cfg,
                             i < tp0.cfg.t_start_guide)
        errs[:, k] = np.abs(x.numpy() - jchain[:, k + 1]).reshape(A, -1).max(axis=1)
    tol = np.full(len(steps), STEP_TOL)
    tol[0] = FIRST_STEP_TOL
    for a in range(A):
        if not (errs[a] > tol).any():
            continue
        # Under the soft rows: JAX's own spread at that step, widened by how
        # far either side's second half moves between the two posterior
        # means (one float32 ulp apart, measured <= 1.2e-7), and
        # each guided step's halves held apart (tests/test_torch_local.py's
        # ECBS steps): the posterior mean within MEAN_TOL, the guide
        # iterations and noise from JAX's mean within STEP_TOL, or
        # BALL_FACTOR times that spread where the balls amplify rounding.
        assert program == "repair", (a, errs[a].tolist())
        jgd = JGuideData(scene=j0.task.scene, normalizer=j0.dataset.normalizer,
                         constraints=j0._pack(None)[0],
                         soft_paths=jax.tree_util.tree_map(lambda v: v[a], soft_j))
        jhard = JHardConds(mask=j0.hard_conds.mask, values=jps[a].hard_conds.values)
        keys_a = loop_keys(keys[a], len(steps), local=False)
        spread = np.array(jax_step_spread(j0, jhard, jgd, jchain[a], keys_a, steps))
        tail = jax_guide_tail(j0, jhard, jgd)
        gd_a = GuideData(scene=tp0.scene, normalizer=tp0.dataset.normalizer,
                         constraints=team.base_cset, soft_paths=SoftPathConstraints(
                             points=soft_t.points[a], mask=soft_t.mask[a],
                             radius=soft_t.radius[a], weight=soft_t.weight[a]))
        hard_a = HardConds(mask=team.hard_team.mask, values=team.hard_team.values[a])
        means, tails, tail_tols = [], [], []
        for k, i in enumerate(steps):
            if errs[a, k] <= tol[k] or i >= tp0.cfg.t_start_guide:
                continue
            mean = tdiff._denoised_mean(tp0.model, tp0.schedule,
                                        torch.from_numpy(jchain[:, k]), i)[a]
            jmean = jax_denoised_mean(j0, jnp.asarray(jchain[a, k]), i)
            got = tdiff._guide_and_noise(tp0.schedule, torch.from_numpy(jmean), i,
                                         noise.steps[k, a], hard_a, gd_a, tp0.cfg,
                                         tp0.guide_cfg, True)
            means.append(float(np.abs(mean.numpy() - jmean).max()))
            tails.append(float(np.abs(got.numpy() - np.array(
                tail(jnp.asarray(jmean), jnp.int32(i), keys_a[k]))).max()))
            moved = np.array(tail(jnp.asarray(mean.numpy()), jnp.int32(i), keys_a[k]))
            own = tdiff._guide_and_noise(tp0.schedule, mean, i, noise.steps[k, a], hard_a, gd_a,
                                         tp0.cfg, tp0.guide_cfg, True)
            spread[k] = max(spread[k], float(np.abs(moved - jchain[a, k + 1]).max()),
                            float((own - got).abs().max()))
            tail_tols.append(max(STEP_TOL, BALL_FACTOR * spread[k]))
        print(f"{program} agent {a}: JAX's own step spread <= {spread.max():.3g}; guided "
              f"steps' halves past STEP_TOL: means {means}, guide and noise {tails} "
              f"(held to {tail_tols})")
        assert max(means, default=0.0) <= MEAN_TOL
        assert all(t <= tt for t, tt in zip(tails, tail_tols)), (tails, tail_tols)
        bad = np.nonzero(errs[a] > np.maximum(tol, BALL_FACTOR * spread))[0]
        assert not len(bad), (a, [(steps[k], errs[a][k], spread[k]) for k in bad])
    print(f"{program}: port against JAX's chain per step <= {errs[:, 1:].max():.3g} "
          f"(t = 24: {errs[:, 0].max():.3g})")

    # The whole batched call against JAX's program itself: the root within
    # PLAN_TOL, free masks and indices equal (the repair round's soft rows
    # amplify rounding, in JAX as in the port: held per step above).
    if program == "root":
        j0 = jps[0]
        res = jteam.plan_fresh_team(
            j0.model.apply, j0.params, j0.schedule,
            jteam.stack_hard_conds([p.hard_conds for p in jps]), j0._guide_data(j0._pack(None)[0]),
            keys, j0.cfg, j0.guide_cfg, j0.task.scene, j0.robot.radius, j0.robot.q_min,
            j0.robot.q_max, j0._savgol)
        out = plan_fresh_team(team, [rebuilt_noise(k, j0.cfg) for k in keys])
        np.testing.assert_allclose(out.trajs.numpy(), np.array(res.trajs_final), rtol=0,
                                   atol=PLAN_TOL)
        np.testing.assert_array_equal(out.free_mask.numpy(), np.array(res.free_mask))
        np.testing.assert_array_equal(out.ix.numpy(), np.array(res.idx_best))


# ------------------------------------------------------- sampler calls
def _short_planners(starts, goals):
    ps = load_planners(os.path.join(ROOT, "data_trained_models"),
                       os.path.join(ROOT, "data_trajectories"), "EnvEmptyNoWait2D",
                       starts, goals, seeds=[100 + i for i in range(len(starts))], device="cpu")
    for p in ps:
        p.cfg = dataclasses.replace(p.cfg, n_samples=8, n_diffusion_steps=8, t_start_guide=4,
                                    n_guide_steps=5)
    return ps


@pytest.fixture
def sampler_calls(monkeypatch):
    """Every sampler call of MPD (fresh or local) as (kind, problems)."""
    calls = []
    fresh, local = MPD._plan_fresh, MPD._plan_local

    def n_of(noise):
        return noise.x_T.shape[0] if noise.x_T.dim() == 4 else 1

    monkeypatch.setattr(MPD, "_plan_fresh", lambda self, gd, noise, hard: calls.append(
        ("fresh", n_of(noise))) or fresh(self, gd, noise, hard))
    monkeypatch.setattr(MPD, "_plan_local", lambda self, gd, seed, noise, hard: calls.append(
        ("local", n_of(noise))) or local(self, gd, seed, noise, hard))
    return calls


def test_each_vmapped_program_is_one_sampler_call(sampler_calls):
    starts, goals = get_start_goal_pos_circle(4, radius=0.3)
    cbs = CBS(_short_planners(starts, goals), starts, goals, is_ecbs=True, is_xcbs=True)
    team = cbs._team()
    out = plan_fresh_team(team, cbs._team_noise())
    assert sampler_calls == [("fresh", 4)]
    sampler_calls.clear()
    pos = out.trajs[torch.arange(4), out.ix][..., :2]
    plan_fresh_team_soft(team, team_soft_paths(pos, RADIUS), cbs._team_noise())
    assert sampler_calls == [("fresh", 4)]
    root, _ = cbs._plan_root_greedy()
    assert root is not None and root.n_conflicts > 0
    sampler_calls.clear()
    cbs.open_l = []
    cbs.expand(root)  # the conflict's two children (ECBS: and the starved ones again)
    assert sampler_calls[0] == ("local", 2) and len(sampler_calls) <= 2
    sampler_calls.clear()
    K = cbs.GREEDY_KBUFS[0]
    _, n = fused.greedy_expand(team, cbs._chain_noise()[:2], cbs._carry(root, K), True, True,
                               2, frozen=lambda d: bool(d))
    assert sampler_calls == [("local", 2)] * n
    sampler_calls.clear()
    _, n, _ = fused.frontier_greedy_expand(team, [cbs._chain_noise()[:2] for _ in range(2)],
                                           [cbs._carry(root, K)] * 2, True, True, 2,
                                           frozen=lambda d: bool(d))
    assert sampler_calls == [("local", 4)] * n
    sampler_calls.clear()
    fused.frontier_expand(team, [cbs._chain_noise()[0] for _ in range(2)],
                          [cbs._carry(root, K)] * 2, True, True)
    assert sampler_calls == [("local", 4)]


@pytest.mark.parametrize("search", ["xcbs-repair-frontier", "xecbs-expand"])
def test_search_counts_its_sampler_calls(sampler_calls, monkeypatch, search):
    """A search's `timing`: one sampler call for each call the sampler
    made, the local ones apart, and its plans by problem: a frontier
    chain's plans are those of the steps it ran before it froze, not its
    rows in the later lockstep calls."""
    starts, goals = get_start_goal_pos_circle(4, radius=0.3)
    ps = _short_planners(starts, goals)
    if search == "xcbs-repair-frontier":
        cbs = CBS(ps, starts, goals, is_ecbs=False, is_xcbs=True, root_repair_rounds=1,
                  frontier_width=2, repair_period=2)
    else:
        cbs = CBS(ps, starts, goals, is_ecbs=True, is_xcbs=True)
        monkeypatch.setattr(cbs, "_root_greedy_eligible", lambda: False)
        monkeypatch.setattr(cbs, "_greedy_kbuf", lambda state: None)
    monkeypatch.setattr(CBS, "GREEDY_ITERS", 2)
    riders = []  # the frozen chains' rows of each frontier round
    real = fused.frontier_greedy_expand

    def frontier(team, noise_m, nodes, *a, **k):
        records, n_run, own_steps = real(team, noise_m, nodes, *a, **k)
        riders.append(2 * (len(nodes) * n_run - int(own_steps.sum())))
        return records, n_run, own_steps

    monkeypatch.setattr(fused, "frontier_greedy_expand", frontier)
    _, n_exp, status, _ = cbs.plan(runtime_limit=60)
    t = cbs.timing
    print(f"{search}: {status}, {n_exp} expansions, calls {sampler_calls}, timing {t}")
    assert n_exp >= 1
    assert t["sampler_calls"] == len(sampler_calls)
    assert t["sampler_calls_local"] == sum(k == "local" for k, _ in sampler_calls)
    assert t["plans_fresh"] == sum(n for k, n in sampler_calls if k == "fresh")
    assert t["plans_local"] == sum(n for k, n in sampler_calls if k == "local") - sum(riders)
    if search == "xcbs-repair-frontier":
        assert sampler_calls[:2] == [("fresh", 4)] * 2  # the team root, the repair round
        assert all(n in (2, 4) for k, n in sampler_calls[2:] if k == "local")
    else:  # the ECBS root agent by agent, then each conflict's children at once
        assert all(n == 1 for k, n in sampler_calls if k == "fresh")
        assert any(k == "local" and n == 2 for k, n in sampler_calls)


# ------------------------------------------------------ the packed record
def test_packed_record_is_built_once_and_read_by_the_plain_lookup():
    scene = make_env("EnvConveyor2D", "cpu").scene
    tables = ((scene.grid.values, scene.grid.grads),
              (scene.extra_grid.values, scene.extra_grid.grads))
    cells = packed_cells(tables)
    assert cells is packed_cells(tables) is scene.guide_table.cells
    assert cells.shape == (*scene.grid.shape, 8) and not cells[..., 6:].any()
    assert torch.equal(cells[..., 0], scene.grid.values)
    assert torch.equal(cells[..., 4:6], scene.extra_grid.grads)
    jg = jax_make_env("EnvConveyor2D").grid
    tg = torch_grid(jg)
    pts = query_points(1037, jg, seed=2)
    for shape in ((1037, 2), (17, 61, 2)):
        q = np.resize(pts, shape)
        vals, grads = grid_lookup_plain(torch.from_numpy(q), ((tg.values, tg.grads),) * 2,
                                        tg.lower, tg.upper)
        v_ref, g_ref = _lookup(jg, jnp.asarray(q))
        for k in range(2):
            np.testing.assert_array_equal(vals[k].numpy(), np.asarray(v_ref))
            np.testing.assert_array_equal(grads[k].numpy(), np.asarray(g_ref))
