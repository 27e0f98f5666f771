"""The port's speculative greedy chain against the JAX package's.

The node is JAX's CBS root of the 3-robot circle of EnvEmptyNoWait2D (real
checkpoint, B=8, full depth), built as `tests/test_torch_local.py` builds
it, with its first conflict; the chain is XECBS's (local children under
their CT balls and the other agents' soft rows), 3 steps.
- `_cset_from_rows` equals JAX's on seeded rows, exactly.
- The chain's logic on JAX's child batches: JAX's `_greedy_core` runs with
  its finalize's free mask replaced by a fixed pattern (every third
  candidate not free, or none free), so that the port's chain, given
  JAX's child batches in place of its plans and the same pattern, must
  make JAX's records exactly: agents, free flags, indices, counts,
  conflicts, the chosen child and the valid flags; at a node the chain
  solves, at a step whose children are starved, and at a constraint
  buffer that overflows (K=2, tested before the add).
- Each child's plan: every DDPM step of the port's child fed JAX's chain
  for that child, under the constraint set and soft rows the port's chain
  built, within STEP_TOL, or BALL_FACTOR times JAX's own step spread under
  the same balls (tests/test_torch_local.py).
- `_process_greedy`: the port's CBS and JAX's, fed the same records and
  the same open list, leave the same open list (counts, constraints,
  chosen indices), accept as many steps and audit the same events.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmd_tpu.config import params as jparams
from mmd_tpu.costs.constraints import SoftPathConstraints as JSoftPaths
from mmd_tpu.costs.guide import GuideData as JGuideData
from mmd_tpu.models import diffusion as jdiff
from mmd_tpu.models.diffusion import HardConds as JHardConds
from mmd_tpu.planners.multi_agent import cbs as jcbs
from mmd_tpu.planners.multi_agent import fused as jfused
from mmd_torch.costs.constraints import ConstraintSet, SoftPathConstraints
from mmd_torch.models import diffusion as tdiff
from mmd_torch.planners.multi_agent import cbs as tcbs
from mmd_torch.planners.multi_agent import fused
from test_torch_local import (  # noqa: F401 (setup is a fixture)
    BALL_FACTOR,
    N_DENOISE,
    STEP_TOL,
    jax_step_spread,
    loop_keys,
    rebuilt_local_noise,
    setup,
)

torch.set_num_threads(1)

K_ITERS = 3
MID_TOL = 1e-6
RECORDS = ("agents", "any_free", "ix", "counts", "t", "a", "b", "mid", "chosen", "valid")


def free_pattern(B: int, starved: bool) -> np.ndarray:
    """Every third candidate not free, or none."""
    return np.zeros(B, bool) if starved else np.arange(B) % 3 != 1


def test_cset_from_rows_matches_jax():
    rng = np.random.default_rng(0)
    q = rng.uniform(-1, 1, (16, 2)).astype(np.float32)
    t = rng.integers(0, 64, (16, 2)).astype(np.float32)
    for n in (0, 1, 7, 16, 20):
        want = jfused._cset_from_rows(jnp.asarray(q), jnp.asarray(t), jnp.int32(n),
                                      jparams.vertex_constraint_radius,
                                      jparams.weight_grad_cost_constraints)
        got = fused._cset_from_rows(
            torch.from_numpy(q), torch.from_numpy(t), torch.tensor(n, dtype=torch.int32),
            torch.tensor(jparams.vertex_constraint_radius, dtype=torch.float32),
            torch.tensor(jparams.weight_grad_cost_constraints, dtype=torch.float32))
        for f in dataclasses.fields(ConstraintSet):
            if f.name != "n_active":
                np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                              np.asarray(getattr(want, f.name)), err_msg=f.name)


# ---------------------------------------------------------- the chain
def jax_node(setup, K: int, cons_n0: int):
    """JAX's root as a chain's node: buffers of K rows, cons_n0 of them
    taken for every agent (far centres over t in [0, 1))."""
    root = setup["root"]
    A = root["trajs_final"].shape[0]
    cons_q = np.zeros((A, K, 2), np.float32)
    cons_t = np.zeros((A, K, 2), np.float32)
    cons_q[:, :cons_n0] = 5.0
    cons_t[:, :cons_n0] = (0.0, 1.0)
    cons_n = np.full((A,), cons_n0, np.int32)
    count, t, a, b, mid = root["summary"]
    return dict(paths=root["trajs_final"], ix=root["idx_best"].astype(np.int32),
                cons_q=cons_q, cons_t=cons_t, cons_n=cons_n,
                conflict=(np.int32(count), np.int32(t), np.int32(a), np.int32(b),
                          np.asarray(mid, np.float32)))


def run_jax_chain(setup, monkeypatch, node, keys, starved: bool):
    """JAX's `_greedy_core` (XECBS, K_ITERS steps) with the free pattern in
    place of its finalize's free mask."""
    j0, jps = setup["jps"][0], setup["jps"]
    real = jfused._finalize_plan

    def patterned(*a):
        res = real(*a)
        free = free_pattern(res.free_mask.shape[0], starved)
        return dataclasses.replace(res, free_mask=jnp.asarray(free))

    monkeypatch.setattr(jfused, "_finalize_plan", patterned)
    hard_all = JHardConds(mask=j0.hard_conds.mask,
                          values=jnp.stack([p.hard_conds.values for p in jps]))

    @jax.jit
    def chain(paths, ix, cq, ct, cn, conflict, keys):
        return jfused._greedy_core(
            j0.model.apply, j0.params, j0.schedule, hard_all, keys, j0.cfg, j0.guide_cfg,
            j0.task.scene, j0.dataset.normalizer, j0.robot.radius, j0.robot.q_min,
            j0.robot.q_max, j0._savgol, paths, ix, cq, ct, cn, conflict, j0.robot.rr_margin,
            jparams.vertex_constraint_radius, jparams.weight_grad_cost_constraints,
            jparams.vertex_constraint_radius, jparams.weight_grad_cost_soft_constraints,
            use_soft=True, local=True, n_noise=jparams.n_local_inference_noising_steps,
            n_denoise=N_DENOISE, k_iters=K_ITERS)

    out = chain(*(jnp.asarray(node[k]) for k in ("paths", "ix", "cons_q", "cons_t", "cons_n")),
                tuple(jnp.asarray(c) for c in node["conflict"]), keys)
    return [np.array(x) for x in out]


def run_port_chain(setup, node, jrecords, keys, starved: bool, monkeypatch):
    """The port's chain on the same node and draws, each child's plan
    replaced by JAX's batch of that child and the free pattern. Returns
    (records, steps, reads, the children's inputs)."""
    tps = setup["tps"]
    team = tcbs.PrioritizedTeam.of(tps, tps[0].robot.rr_margin)
    seen = []

    def children_plan(p0, gd, hard_values, seed_paths, noise_l, local):
        # A step's two children, one batched call: each child's inputs
        # are its row of the batch.
        s = len(seen) // 2
        assert len(noise_l) == 2 and not len(seen) % 2
        spc = gd.soft_paths
        for c, noise in enumerate(noise_l):
            agent = next(i for i, p in enumerate(tps)
                         if torch.equal(p.hard_conds.values, hard_values[c]))
            cset = ConstraintSet(n_active=1, **{
                f.name: getattr(gd.constraints, f.name)[c]
                for f in dataclasses.fields(ConstraintSet) if f.name != "n_active"})
            soft = SoftPathConstraints(points=spc.points[c], mask=spc.mask[c],
                                       radius=spc.radius[c], weight=spc.weight[c])
            seen.append(dict(s=s, c=c, gd=dataclasses.replace(gd, constraints=cset,
                                                              soft_paths=soft),
                             hard=tdiff.HardConds(mask=p0.hard_conds.mask,
                                                  values=hard_values[c]),
                             agent=agent, noise=noise, seed=seed_paths[c]))
        B = seed_paths.shape[1]
        return types.SimpleNamespace(
            trajs_final=torch.from_numpy(jrecords[0][s]),
            free_mask=torch.from_numpy(np.stack([free_pattern(B, starved)] * 2)))

    monkeypatch.setattr(fused, "_plan_children", children_plan)
    cfg = tps[0].cfg
    noise = [[rebuilt_local_noise(keys[s, c], cfg) for c in range(2)] for s in range(K_ITERS)]
    carry = fused.Carry(
        paths=torch.from_numpy(node["paths"]), ix=torch.from_numpy(node["ix"]).long(),
        cons_q=torch.from_numpy(node["cons_q"]), cons_t=torch.from_numpy(node["cons_t"]),
        cons_n=torch.from_numpy(node["cons_n"]),
        conflict=(torch.tensor(int(node["conflict"][0]), dtype=torch.int32),
                  *(torch.tensor(int(x)) for x in node["conflict"][1:4]),
                  torch.from_numpy(node["conflict"][4])))
    reads = []
    records, n = fused.greedy_expand(team, noise, carry, use_soft=True, local=True,
                                     k_iters=K_ITERS,
                                     frozen=lambda d: reads.append(bool(d)) or bool(d))
    return records, n, reads, seen


@pytest.fixture(scope="module")
def chains(setup):
    """The three cases' JAX records and the port's runs on them."""
    out = {}
    keys = jax.random.split(jax.random.PRNGKey(21), 2 * K_ITERS).reshape(K_ITERS, 2, 2)
    for case, K, cons_n0 in (("solved", 16, 0), ("starved", 16, 0), ("overflow", 2, 2)):
        with pytest.MonkeyPatch.context() as mp:
            node = jax_node(setup, K, cons_n0)
            jrec = run_jax_chain(setup, mp, node, keys, case == "starved")
            port = run_port_chain(setup, node, jrec, keys, case == "starved", mp)
        out[case] = dict(node=node, jax=jrec, port=port, keys=keys)
    return out


@pytest.mark.parametrize("case", ["solved", "starved", "overflow"])
def test_chain_records_on_jaxs_children_match_jax(chains, case):
    run = chains[case]
    jrec = dict(zip(RECORDS, run["jax"][1:]))
    records, n_steps, reads, seen = run["port"]
    got = records._asdict()
    for name in RECORDS:
        g, w = got[name].numpy(), jrec[name]
        if name == "mid":
            np.testing.assert_allclose(g, w, rtol=0, atol=MID_TOL, equal_nan=True)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    # The port ran the steps JAX's while_loop ran: a row of JAX's records
    # is non-zero only where it ran (its valid rows, and the first frozen
    # step whose children it computed).
    ran = int(np.any(run["jax"][0].reshape(K_ITERS, -1) != 0, axis=1).sum())
    assert n_steps == ran and len(seen) == 2 * ran
    assert reads == [False] * (n_steps - 1) + [True] * (n_steps < K_ITERS)
    np.testing.assert_array_equal(records.trajs.numpy()[:n_steps], run["jax"][0][:n_steps])
    valid = jrec["valid"]
    print(f"{case}: valid {valid.tolist()}, counts {jrec['counts'].tolist()}, "
          f"free {jrec['any_free'].tolist()}")
    if case == "solved":
        assert valid[0] and not valid.all()
        last = int(np.argmin(valid))  # the step after the chain reached 0 conflicts
        assert jrec["counts"][last - 1][jrec["chosen"][last - 1]] == 0
    elif case == "starved":
        assert valid[0] and not jrec["any_free"][0].any() and not valid[1:].any()
        assert n_steps == 1
    else:
        assert not valid.any() and n_steps == 1
        # The child's row went to slot min(n_a, K - 1) = 1, over the taken row.
        for kid in seen:
            assert kid["gd"].constraints.q.shape == (2, 1, 2)
            np.testing.assert_array_equal(kid["gd"].constraints.active.numpy(), [1.0, 1.0])
            np.testing.assert_array_equal(kid["gd"].constraints.q[0, 0].numpy(), [5.0, 5.0])


def test_chain_children_steps_match_jax(setup, chains):
    """Each child of the solved case's steps: every DDPM step of the port,
    fed JAX's chain of that child (run_local_inference on the child's seed,
    draws, constraint set and soft rows), within STEP_TOL or BALL_FACTOR
    times JAX's own spread."""
    j0, tp0 = setup["jps"][0], setup["tps"][0]
    run = chains["solved"]
    _, _, _, seen = run["port"]
    steps = tp0.cfg.step_indices(N_DENOISE)
    errs, spreads = [], []
    for kid in seen:
        gd, key = kid["gd"], run["keys"][kid["s"], kid["c"]]
        jcset = type(j0._pack(None)[0])(**{
            f.name: jnp.asarray(getattr(gd.constraints, f.name).numpy())
            for f in dataclasses.fields(ConstraintSet) if f.name != "n_active"})
        spc = gd.soft_paths
        jgd = JGuideData(scene=j0.task.scene, normalizer=j0.dataset.normalizer,
                         constraints=jcset,
                         soft_paths=JSoftPaths(points=jnp.asarray(spc.points.numpy()),
                                               mask=jnp.asarray(spc.mask.numpy()),
                                               radius=jnp.asarray(spc.radius.numpy()),
                                               weight=jnp.asarray(spc.weight.numpy())))
        jhard = JHardConds(mask=j0.hard_conds.mask,
                           values=jnp.asarray(kid["hard"].values.numpy()))
        np.testing.assert_array_equal(np.asarray(jhard.values),
                                      np.asarray(setup["jps"][kid["agent"]].hard_conds.values))
        jseed = j0.dataset.normalizer.normalize(jnp.asarray(kid["seed"].numpy()))
        jchain = np.array(jdiff.run_local_inference(
            j0.model.apply, j0.params, j0.schedule, jhard, jgd, jseed, key, j0.cfg,
            j0.guide_cfg, n_noising_steps=jparams.n_local_inference_noising_steps,
            n_denoising_steps=N_DENOISE))
        # JAX's child batch is this chain, finalized.
        noise = kid["noise"]
        for k, step in enumerate(steps):
            x = tdiff._ddpm_step(tp0.model, tp0.schedule, torch.from_numpy(jchain[k]), step,
                                 noise.steps[k], kid["hard"], gd, tp0.cfg, tp0.guide_cfg,
                                 step < tp0.cfg.t_start_guide)
            errs.append(float(np.abs(x.numpy() - jchain[k + 1]).max()))
        spreads += jax_step_spread(j0, jhard, jgd, jchain,
                                   loop_keys(key, len(steps), local=True), steps)
    print(f"chain children: port against JAX's chains per step <= {max(errs):.3g}; JAX's "
          f"own step spread <= {max(spreads):.3g}")
    assert max(errs) <= max(STEP_TOL, BALL_FACTOR * max(spreads)), (errs, spreads)


# ------------------------------------------------------ _process_greedy
CASES = {
    # (valid, free (k, 2), counts (k, 2), chosen, open counts, ecbs)
    "accept-all": ([1, 1, 1], [[1, 1], [1, 1], [1, 1]], [[5, 7], [3, 4], [2, 2]], [0, 0, 0],
                   [9, 8], True),
    "stop-worse": ([1, 1, 1], [[1, 1], [1, 1], [1, 1]], [[5, 7], [6, 4], [2, 2]], [0, 1, 0],
                   [3, 8], True),
    "tie-goes-on": ([1, 1, 0], [[1, 1], [1, 1], [0, 0]], [[5, 5], [5, 6], [0, 0]], [0, 0, 0],
                    [5], True),
    "solved": ([1, 1, 0], [[1, 1], [1, 1], [0, 0]], [[5, 7], [0, 3], [0, 0]], [0, 0, 0],
               [6], True),
    "starved": ([1, 1, 0], [[1, 1], [0, 0], [0, 0]], [[5, 7], [0, 0], [0, 0]], [0, 0, 0],
                [9], False),
    "one-free": ([1, 1, 1], [[0, 1], [1, 0], [1, 1]], [[0, 7], [6, 0], [4, 4]], [1, 0, 1],
                 [9], True),
    "freeze-at-once": ([0, 0, 0], [[0, 0]] * 3, [[0, 0]] * 3, [0, 0, 0], [4], True),
}


def _records(case):
    valid, free, counts, chosen, _, _ = CASES[case]
    k = len(valid)
    rng = np.random.default_rng(len(case))
    agents = np.array([[0, 1], [1, 2], [2, 0]])[:k]
    t = rng.integers(0, 64, (k, 2))
    a = np.array([[1, 0], [2, 1], [0, 2]])[:k]
    b = (a + 1) % 3
    mid = rng.uniform(-1, 1, (k, 2, 2)).astype(np.float32)
    return (agents, np.array(free, bool), rng.integers(0, 8, (k, 2)), np.array(counts),
            t, a, b, mid, np.array(chosen), np.array(valid, bool))


def _search(mod, planners, starts, goals, ecbs, open_counts, B, H, tensor):
    search = mod.CBS(planners, starts, goals, is_ecbs=ecbs, is_xcbs=True)
    search.greedy_audit = []
    paths = tensor(np.zeros((3, B, H, 4), np.float32))
    root = mod.SearchState(paths, [0, 1, 2])
    root.n_conflicts = 6
    m = np.array([0.1, -0.2], np.float32)
    root.first_conflict = mod.PointConflict(agent_ids=[0, 1], p_l=[m, m], q_l=[m, m],
                                            t_from=1, t_to=1)
    for n in open_counts:
        node = mod.SearchState(paths, [0, 0, 0])
        node.n_conflicts = n
        search.open_l.append(node)
    return search, root


@pytest.mark.parametrize("case", list(CASES))
def test_process_greedy_matches_jax(setup, case):
    scalars = _records(case)
    *_, open_counts, ecbs = CASES[case]
    tps, jps = setup["tps"], setup["jps"]
    starts = [np.asarray(p.start_state_pos) for p in tps]
    goals = [np.asarray(p.goal_state_pos) for p in tps]
    B, H = 8, 64
    results = []
    for mod, planners, tensor in ((jcbs, jps, jnp.asarray), (tcbs, tps, torch.from_numpy)):
        search, root = _search(mod, planners, starts, goals, ecbs, open_counts, B, H, tensor)
        trajs = tensor(np.zeros((len(scalars[-1]), 2, B, H, 4), np.float32))
        accepted = search._process_greedy(root, trajs, scalars)
        results.append((accepted, search.greedy_audit, [
            (n.n_conflicts, list(n.ix_best),
             {k: [(np.asarray(c.q_l[0]).tolist(), list(c.t_range_l[0])) for c in v]
              for k, v in sorted(n.constraints.items())},
             None if n.first_conflict is None else
             (n.first_conflict.agent_ids, n.first_conflict.t_from))
            for n in search.open_l]))
    print(f"{case}: accepted {results[1][0]}, audit {results[1][1]}")
    assert results[1] == results[0]
