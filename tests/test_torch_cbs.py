"""The port's CBS pieces against the JAX package, and the search's
branches that its whole runs seldom take.

The node is JAX's CBS root of the 3-robot circle of EnvEmptyNoWait2D (real
checkpoint, B=8, full depth), built as `tests/test_torch_local.py` builds
it, with its first conflict.
- `convert_conflicts_to_constraints`: equal records for all three conflict
  types.
- `expand_children` (XCBS + ECBS, both children): each DDPM step of a child
  fed JAX's chain within STEP_TOL, or BALL_FACTOR times JAX's own step
  spread under the same balls (a hard CT ball and the soft rows amplify
  float32 rounding in JAX as in the port; tests/test_torch_local.py);
  the choice and summary on JAX's child batches equal JAX's exactly; the
  port's whole children agree with JAX's `expand_children` as closely as
  JAX's own two programs of a child agree with each other (BALL_FACTOR).
- Ports of tests/test_multi_agent.py's CBS tests: invalid starts, the
  least-cost choice, the anytime near-miss; an ECBS child starved by its
  soft balls replans with its hard CT constraints kept; the per-child
  paths of an unbatchable team and of vertex and edge conflicts.
- `mmd_torch.bench`: its planner mapping, the repair variants and the
  guide-iteration probe it once refused.
"""
import copy
import dataclasses
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmd_tpu.common import conflict_conversion as jcc
from mmd_tpu.common import conflicts as jconf
from mmd_tpu.config import params as jparams
from mmd_tpu.costs.constraints import SoftPathConstraints as JSoftPaths
from mmd_tpu.costs.constraints import pack_constraint_set as jax_pack
from mmd_tpu.costs.guide import GuideData as JGuideData
from mmd_tpu.models import diffusion as jdiff
from mmd_tpu.models.diffusion import HardConds as JHardConds
from mmd_tpu.planners.multi_agent import conflict_detection as jcd
from mmd_tpu.planners.multi_agent import fused as jfused
from mmd_tpu.planners.single_agent.mpd import _plan_local as jax_plan_local
from mmd_torch import bench
from mmd_torch.common import conflicts as tconf
from mmd_torch.common.conflict_conversion import convert_conflicts_to_constraints
from mmd_torch.common.multi_agent_utils import get_start_goal_pos_circle
from mmd_torch.costs.constraints import (
    ConstraintSet,
    pack_constraint_set,
    stack_constraint_sets,
)
from mmd_torch.costs.guide import GuideData
from mmd_torch.experiments.status import TrialSuccessStatus
from mmd_torch.models import diffusion as tdiff
from mmd_torch.parallel.team import stack_hard_conds
from mmd_torch.planners.multi_agent import cbs as cbs_module
from mmd_torch.planners.multi_agent.cbs import CBS
from mmd_torch.planners.multi_agent.conflict_detection import (
    count_conflicts,
    select_candidate_and_conflicts,
)
from mmd_torch.planners.multi_agent.fused import expand_children
from mmd_torch.planners.multi_agent.prioritized_planning import PrioritizedPlanning
from mmd_torch.planners.single_agent.mpd import load_planners
from test_torch_local import (  # noqa: F401 (setup is a fixture)
    BALL_FACTOR,
    N_DENOISE,
    STEP_TOL,
    jax_step_spread,
    loop_keys,
    rebuilt_local_noise,
    setup,
    tmask,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MID_TOL = 1e-7


def assert_records_equal(got, want):
    assert type(got).__name__ == type(want).__name__
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, dict):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]))
        elif isinstance(w, list) and w and isinstance(w[0], (np.ndarray, jnp.ndarray)):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
                assert np.asarray(a).dtype == np.asarray(b).dtype
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("kind", ["point", "vertex", "edge"])
def test_convert_conflicts_to_constraints_matches_jax(kind):
    rng = np.random.default_rng(len(kind))
    q = [rng.uniform(-1, 1, 2).astype(np.float32) for _ in range(4)]
    args = {
        "point": lambda m: m.PointConflict(agent_ids=[2, 5], p_l=q[:2], q_l=[q[2], q[2]],
                                           t_from=7, t_to=9),
        "vertex": lambda m: m.VertexConflict(agent_ids=[1, 3], q_map={1: q[0], 3: q[1]}, t=4),
        "edge": lambda m: m.EdgeConflict(agent_ids=[0, 4], q_from_map={0: q[0], 4: q[1]},
                                         q_to_map={0: q[2], 4: q[3]}, t_from=11, t_to=12),
    }[kind]
    for radius in (None, 0.2):
        got = convert_conflicts_to_constraints(args(tconf), radius=radius)
        want = jcc.convert_conflicts_to_constraints(args(jconf), radius=radius)
        assert list(got) == list(want)
        for agent in want:
            assert_records_equal(got[agent], want[agent])


# ------------------------------------------------------- expand_children
@pytest.fixture(scope="module")
def children(setup):
    """JAX's XECBS expansion of the root's first conflict: both children
    replan locally under their CT ball and the other agents' soft rows."""
    j0, root = setup["jps"][0], setup["root"]
    count, t, a, b, mid = root["summary"]
    conflict = jconf.PointConflict(agent_ids=[int(a), int(b)], p_l=[mid, mid], q_l=[mid, mid],
                                   t_from=int(t), t_to=int(t))
    cons = jcc.convert_conflicts_to_constraints(conflict)
    agent_ids = list(cons)
    csets = [jax_pack([cons[i]], 4, 1) for i in agent_ids]
    cset_c = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *csets)
    hard_c = JHardConds(mask=j0.hard_conds.mask,
                        values=jnp.stack([setup["jps"][i].hard_conds.values for i in agent_ids]))
    keys = jax.random.split(jax.random.PRNGKey(9), len(agent_ids))
    paths_all, ix_best = jnp.asarray(root["trajs_final"]), jnp.asarray(root["idx_best"])
    trajs, scalars = jfused.expand_children(
        j0.model.apply, j0.params, j0.schedule, hard_c, cset_c, keys, j0.cfg, j0.guide_cfg,
        j0.task.scene, j0.dataset.normalizer, j0.robot.radius, j0.robot.q_min, j0.robot.q_max,
        j0._savgol, paths_all, ix_best, jnp.asarray(agent_ids), j0.robot.rr_margin,
        jparams.vertex_constraint_radius, jparams.weight_grad_cost_soft_constraints,
        use_soft=True, local=True, n_noise=3, n_denoise=N_DENOISE)
    best_pos = np.stack([root["trajs_final"][i, root["idx_best"][i], :, :2] for i in range(3)])
    jgds = []
    for c, i in enumerate(agent_ids):
        mask = tmask()
        mask[i] = 0.0
        jgds.append(JGuideData(
            scene=j0.task.scene, normalizer=j0.dataset.normalizer, constraints=csets[c],
            soft_paths=JSoftPaths(points=jnp.asarray(best_pos), mask=jnp.asarray(mask),
                                  radius=jnp.asarray(jparams.vertex_constraint_radius),
                                  weight=jnp.asarray(jparams.weight_grad_cost_soft_constraints))))
    return dict(agent_ids=agent_ids, cons=cons, keys=keys, trajs=np.array(trajs),
                scalars=[np.array(x) for x in scalars], jgds=jgds, best_pos=best_pos)


def port_child_inputs(setup, children):
    """The port's side of `children`: its constraint sets and draws."""
    tps, agent_ids = setup["tps"], children["agent_ids"]
    cons = convert_conflicts_to_constraints(tconf.PointConflict(
        agent_ids=agent_ids, p_l=[setup["root"]["summary"][4]] * 2,
        q_l=[setup["root"]["summary"][4]] * 2, t_from=int(setup["root"]["summary"][1]),
        t_to=int(setup["root"]["summary"][1])))
    csets = [pack_constraint_set([cons[i]], 1, 1, device="cpu") for i in agent_ids]
    noise = [rebuilt_local_noise(k, setup["jps"][0].cfg) for k in children["keys"]]
    return cons, csets, noise


def test_expand_children_steps_and_choice_match_jax(setup, children):
    j0, tp0, root = setup["jps"][0], setup["tps"][0], setup["root"]
    agent_ids = children["agent_ids"]
    _, csets, noise = port_child_inputs(setup, children)
    best_pos = torch.from_numpy(children["best_pos"])
    errs, spreads = [], []
    steps = tp0.cfg.step_indices(N_DENOISE)
    for c, i in enumerate(agent_ids):
        tp, jp, jgd = setup["tps"][i], setup["jps"][i], children["jgds"][c]
        seed = root["trajs_final"][i]
        jseed = j0.dataset.normalizer.normalize(jnp.asarray(seed))
        jchain = np.array(jdiff.run_local_inference(
            j0.model.apply, j0.params, j0.schedule, jp.hard_conds, jgd, jseed,
            children["keys"][c], j0.cfg, j0.guide_cfg, n_noising_steps=3,
            n_denoising_steps=N_DENOISE))
        mask = torch.from_numpy(np.array(jgd.soft_paths.mask))
        gd = GuideData(scene=tp.scene, normalizer=tp.dataset.normalizer, constraints=csets[c],
                       soft_paths=setup["team"].balls(best_pos, mask, setup["team"].soft_weight))
        for k, step in enumerate(steps):
            x = tdiff._ddpm_step(tp.model, tp.schedule, torch.from_numpy(jchain[k]), step,
                                 noise[c].steps[k], tp.hard_conds, gd, tp.cfg, tp.guide_cfg,
                                 step < tp.cfg.t_start_guide)
            errs.append(float(np.abs(x.numpy() - jchain[k + 1]).max()))
        spreads += jax_step_spread(j0, jp.hard_conds, jgd, jchain,
                                   loop_keys(children["keys"][c], len(steps), local=True),
                                   steps)
        # The choice and summary on JAX's child batch, as JAX's function
        # makes them.
        res = jax_plan_local(j0.model.apply, j0.params, j0.schedule, jp.hard_conds, jgd, jseed,
                             children["keys"][c], j0.cfg, j0.guide_cfg, j0.task.scene,
                             j0.robot.radius, j0.robot.q_min, j0.robot.q_max, j0._savgol,
                             n_noise=3, n_denoise=N_DENOISE)
        want = jcd.select_candidate_and_conflicts(res.trajs_final[..., :2], res.free_mask, i,
                                                  jnp.asarray(children["best_pos"]),
                                                  j0.robot.rr_margin)
        got = select_candidate_and_conflicts(
            torch.from_numpy(np.array(res.trajs_final[..., :2])),
            torch.from_numpy(np.array(res.free_mask)), i, best_pos, tp.robot.rr_margin)
        assert [int(v) for v in got[:5]] == [int(v) for v in want[:5]]
        np.testing.assert_allclose(got[5].numpy(), np.array(want[5]), rtol=0, atol=MID_TOL,
                                   equal_nan=True)
    print(f"children: port against JAX's chains per step <= {max(errs):.3g}; JAX's own "
          f"step spread <= {max(spreads):.3g}")
    assert max(errs) <= max(STEP_TOL, BALL_FACTOR * max(spreads)), (errs, spreads)


def test_expand_children_runs_as_jax(setup, children):
    """The port's `expand_children` on JAX's node and draws: the same
    flags, and children as close to JAX's as JAX's own `_plan_local` of a
    child is to its `expand_children` (two programs, one computation)."""
    j0, tp0, root = setup["jps"][0], setup["tps"][0], setup["root"]
    agent_ids = children["agent_ids"]
    _, csets, noise = port_child_inputs(setup, children)
    hard_c = stack_hard_conds([setup["tps"][i].hard_conds for i in agent_ids])
    kw = dict(dtype=torch.float32)
    trajs, scalars = expand_children(
        tp0, hard_c, stack_constraint_sets(csets), noise, torch.from_numpy(root["trajs_final"]),
        torch.from_numpy(root["idx_best"]).long(), agent_ids, tp0.robot.rr_margin,
        torch.full((), jparams.vertex_constraint_radius, **kw),
        torch.full((), jparams.weight_grad_cost_soft_constraints, **kw),
        use_soft=True, local=True)
    assert trajs.shape == children["trajs"].shape
    np.testing.assert_array_equal(scalars[0].numpy(), children["scalars"][0])
    own = []
    for c, i in enumerate(agent_ids):
        jp = setup["jps"][i]
        jseed = j0.dataset.normalizer.normalize(jnp.asarray(root["trajs_final"][i]))
        res = jax_plan_local(j0.model.apply, j0.params, j0.schedule, jp.hard_conds,
                             children["jgds"][c], jseed, children["keys"][c], j0.cfg,
                             j0.guide_cfg, j0.task.scene, j0.robot.radius, j0.robot.q_min,
                             j0.robot.q_max, j0._savgol, n_noise=3, n_denoise=N_DENOISE)
        own.append(float(np.abs(np.array(res.trajs_final) - children["trajs"][c]).max()))
    gap = float(np.abs(trajs.numpy() - children["trajs"]).max())
    print(f"children: port against JAX {gap:.3g}; JAX's two programs of a child {max(own):.3g}")
    assert gap <= max(STEP_TOL, BALL_FACTOR * max(own)), (gap, own)


# ------------------------------------------- ports of test_multi_agent.py
def planners(n, radius=None, n_guide_steps=5):
    starts, goals = (get_start_goal_pos_circle(n) if radius is None
                     else get_start_goal_pos_circle(n, radius=radius))
    ps = load_planners(os.path.join(ROOT, "data_trained_models"),
                       os.path.join(ROOT, "data_trajectories"), "EnvEmptyNoWait2D",
                       starts, goals, device="cpu")
    for p in ps:
        p.cfg = dataclasses.replace(p.cfg, n_samples=8, n_guide_steps=n_guide_steps)
    return ps, starts, goals


def test_cbs_rejects_invalid_start_goal():
    """CBS and PP raise on overlapping starts (reference cbs.py:155-163)."""
    starts, goals = get_start_goal_pos_circle(2)
    starts[1] = starts[0] + 0.01
    ps, _, _ = planners(2)
    with pytest.raises(ValueError):
        CBS(ps, starts, goals, validate_start_goal=True)
    with pytest.raises(ValueError):
        PrioritizedPlanning(ps, starts, goals, validate_start_goal=True)
    CBS(ps, starts, goals, validate_start_goal=False)


def test_cbs_least_cost_strategy(monkeypatch):
    """least_cost keeps each replan's least-cost choice: the children take
    the per-child path, and the search ends with the team's paths."""
    ps, starts, goals = planners(3)
    search = CBS(ps, starts, goals, is_ecbs=False, is_xcbs=True,
                 choose_path_strategy="least_cost")
    took = []
    orig = search._expand_child
    monkeypatch.setattr(search, "_expand_child", lambda *a: took.append(a[1]) or orig(*a))
    paths, n_exp, status, n_coll = search.plan(runtime_limit=120)
    assert len(paths) == 3 and all(p.shape == (64, 4) for p in paths)
    assert len(took) == 2 * n_exp
    assert status == TrialSuccessStatus.SUCCESS and n_coll == 0 and n_exp > 0


def run_until_expansions(monkeypatch, search, n, **kw):
    """plan() in the host-driven order (the greedy chain off, as JAX's
    anytime test turns it off: each pop is one `expand`), with the clock
    pushed past any limit once n expansions ran."""
    monkeypatch.setattr(search, "_greedy_kbuf", lambda state: None)
    real = time.perf_counter
    offset = [0.0]
    monkeypatch.setattr(time, "perf_counter", lambda: real() + offset[0])
    done = []
    orig = search.expand

    def expand(state):
        orig(state)
        done.append(state)
        if len(done) >= n:
            offset[0] = 1e6

    monkeypatch.setattr(search, "expand", expand)
    out = search.plan(runtime_limit=600, **kw)
    monkeypatch.setattr(time, "perf_counter", real)
    return out, done


def test_anytime_returns_best_near_miss(monkeypatch):
    """A search out of time returns the node with the fewest conflicts
    seen, popped or open, and keeps FAIL_RUNTIME_LIMIT; without anytime it
    returns the last popped node. Same seeds, same search."""
    ps, starts, goals = planners(4, radius=0.3)
    search = CBS(ps, starts, goals, is_ecbs=True, is_xcbs=True)
    (paths, n_exp, status, n_coll), done = run_until_expansions(monkeypatch, search, 1)
    assert len(paths) == 4 and n_exp == 1 and len(done) == 1
    assert status == TrialSuccessStatus.FAIL_RUNTIME_LIMIT
    assert n_coll == min([n.n_conflicts for n in search.open_l] + [done[0].n_conflicts])
    assert search.final.n_conflicts == n_coll

    ps2, _, _ = planners(4, radius=0.3)
    search2 = CBS(ps2, starts, goals, is_ecbs=True, is_xcbs=True)
    (_, _, status2, n_coll2), done2 = run_until_expansions(monkeypatch, search2, 1,
                                                          anytime=False)
    assert status2 == TrialSuccessStatus.FAIL_RUNTIME_LIMIT
    assert n_coll2 == done2[0].n_conflicts == done[0].n_conflicts and n_coll <= n_coll2


def test_soft_starved_child_replans_with_its_hard_constraints(monkeypatch):
    """ECBS: a child whose batch the soft balls starved replans alone,
    without the soft balls and with its CT ball, and enters the open list
    with that plan."""
    ps, starts, goals = planners(4, radius=0.3)
    search = CBS(ps, starts, goals, is_ecbs=True, is_xcbs=True)
    calls = []

    def spy(p0, hard_c, csets, noise_l, paths_all, ix_best, agent_ids, *a, use_soft, local):
        trajs, scalars = expand_children(p0, hard_c, csets, noise_l, paths_all, ix_best,
                                         agent_ids, *a, use_soft=use_soft, local=local)
        calls.append(dict(agent_ids=list(agent_ids), csets=csets, use_soft=use_soft,
                          trajs=trajs, scalars=scalars))
        if len(calls) == 1:  # starve the first child of the first expansion
            scalars = (scalars[0].clone().index_fill_(0, torch.tensor([0]), False),
                       *scalars[1:])
        return trajs, scalars

    monkeypatch.setattr(cbs_module, "expand_children", spy)
    (_, n_exp, _, _), done = run_until_expansions(monkeypatch, search, 1)
    assert n_exp == 1 and len(calls) == 2
    first, retry = calls
    assert first["use_soft"] and not retry["use_soft"]
    assert retry["agent_ids"] == first["agent_ids"][:1]
    for f in dataclasses.fields(ConstraintSet):  # the child's CT ball, kept
        if f.name != "n_active":
            assert torch.equal(getattr(retry["csets"], f.name)[0],
                               getattr(first["csets"], f.name)[0]), f.name
    assert int(retry["csets"].n_active) == 1
    agent = retry["agent_ids"][0]
    child = [n for n in search.open_l if agent in n.constraints]
    if bool(retry["scalars"][0][0]):
        assert len(child) == 1
        assert torch.equal(child[0].paths_all[agent], retry["trajs"][0])
        assert child[0].ix_best[agent] == int(retry["scalars"][1][0])
        assert child[0].n_conflicts == int(retry["scalars"][2][0])


@pytest.mark.parametrize("case", ["unbatchable", "edge-conflicts"])
def test_search_takes_its_per_child_paths(monkeypatch, case):
    """XECBS where one pass cannot plan the team: with a planner of its own
    model (the host root loop, then the children of its conflicts one at a
    time through `expand_local`), and with vertex and edge conflicts (detection on x2
    densified paths, each child re-summarized so). Each still solves the
    dense circle."""
    ps, starts, goals = planners(4, radius=0.3)
    kw = {}
    if case == "unbatchable":
        ps[1].model = copy.deepcopy(ps[1].model)
    else:
        kw["conflict_types"] = (tconf.PointConflict, tconf.VertexConflict, tconf.EdgeConflict)
    search = CBS(ps, starts, goals, is_ecbs=True, is_xcbs=True, **kw)
    local, batched, summaries = [], [], []
    orig_local, orig_summarize = cbs_module.expand_local, search._summarize
    orig_children = cbs_module.expand_children
    monkeypatch.setattr(cbs_module, "expand_local",
                        lambda *a: local.append(a[5]) or orig_local(*a))
    monkeypatch.setattr(cbs_module, "expand_children",
                        lambda *a, **k: batched.append(a[6]) or orig_children(*a, **k))
    monkeypatch.setattr(search, "_summarize",
                        lambda st: orig_summarize(st) or summaries.append(st.first_conflict))
    paths, n_exp, status, n_conflicts = search.plan(runtime_limit=300)
    assert status == TrialSuccessStatus.SUCCESS and n_conflicts == 0 and n_exp >= 1
    assert count_conflicts(paths, search.margin) == 0
    assert search.get_conflicts(search.final) == []
    if case == "unbatchable":
        assert "root_agent_s" not in search.timing  # the host loop made the root
        # A conflict of agent 1 expands one child at a time; the others'
        # children share one model and take one pass.
        assert local and len(local) + 2 * len(batched) == 2 * n_exp
        assert len(summaries) == 1  # the root's: a child's summary comes with its plan
        assert all(1 not in ids for ids in batched)
    else:
        assert not local and len(summaries) == 1 + 2 * n_exp
        kinds = {type(c).__name__ for c in summaries if c is not None}
        assert kinds and kinds <= {"VertexConflict", "EdgeConflict"}, kinds


# ------------------------------------------------------------------ bench
def test_bench_maps_planners_as_bench_py():
    assert bench.settings({})["planner"] == "XECBS" and bench.settings({})["bf16"]
    assert not bench.settings({"MMD_BENCH_BF16": "0"})["bf16"]
    ps, starts, goals = planners(2)
    for name, (is_ecbs, is_xcbs) in {"CBS": (False, False), "ECBS": (True, False),
                                     "XCBS": (False, True), "XECBS": (True, True)}.items():
        s = bench.settings({"MMD_BENCH_PLANNER": name, "MMD_BENCH_AGENTS": "2"})
        team = bench.make_team_planner(s, ps, starts, goals)
        assert type(team) is CBS and (team.is_ecbs, team.is_xcbs) == (is_ecbs, is_xcbs)
        assert s["agents"] == 2
    s = bench.settings({"MMD_BENCH_PLANNER": "PP"})
    assert type(bench.make_team_planner(s, ps, starts, goals)) is PrioritizedPlanning
    with pytest.raises(ValueError):
        bench.settings({"MMD_BENCH_PLANNER": "XYZ"})
    assert bench.settings({})["sampler"] == "ddpm"
    assert bench.settings({"MMD_BENCH_SAMPLER": "ddim"})["sampler"] == "ddim"
    with pytest.raises(ValueError):
        bench.settings({"MMD_BENCH_SAMPLER": "xyz"})


@pytest.mark.parametrize("env,names", [
    ({"MMD_BENCH_PLANNER": "XCBS-R"}, "repair"),
    ({"MMD_BENCH_PLANNER": "XECBS-R"}, "repair"),
    ({"MMD_BENCH_GUIDE_STEPS": "3"}, "guide-iteration probe"),
])
def test_bench_refuses_what_is_not_ported(env, names):
    """The variants the port once refused now run: XCBS-R and XECBS-R
    build CBS with MMD_BENCH_REPAIR (default 1) root repair rounds
    (bench.py:85-96), and the guide-iteration probe sets every planner's
    guide iterations (bench.py:75-78). Without a card the bench still
    exits 2 and prints no result, saying it needs one."""
    s = bench.settings(env)
    ps, starts, goals = planners(2)
    if names == "repair":
        for repair_env, rounds in (({}, 1), ({"MMD_BENCH_REPAIR": "2"}, 2)):
            s = bench.settings({**env, **repair_env, "MMD_BENCH_AGENTS": "2"})
            team = bench.make_team_planner(s, ps, starts, goals)
            assert type(team) is CBS and team.root_repair_rounds == rounds
            assert (team.is_ecbs, team.is_xcbs) == (env["MMD_BENCH_PLANNER"] == "XECBS-R", True)
        assert bench.make_team_planner(bench.settings({"MMD_BENCH_PLANNER": "XECBS"}), ps,
                                       starts, goals).root_repair_rounds == 0
    else:
        assert s["guide_steps"] == 3
        built, _, _ = bench.build_planners({**s, "agents": 2}, device="cpu")
        assert all(p.cfg.n_guide_steps == 3 for p in built)
        default, _, _ = bench.build_planners({**bench.settings({}), "agents": 2}, device="cpu")
        assert default[0].cfg.n_guide_steps == 20  # the reference's (mmd_params.py:37)
    proc = subprocess.run([sys.executable, "-m", "mmd_torch.bench"], cwd=ROOT,
                          env={**os.environ, **env}, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 2 and proc.stdout == ""
    assert "needs a CUDA card" in proc.stderr
