"""The port's whole CBS, ECBS, XCBS and XECBS searches on the CPU.

A dense 4-robot circle of EnvEmptyNoWait2D (radius 0.25; JAX's
tests/test_greedy_equivalence.py:58-62 makes its 6-robot instance at 0.3,
where this 4-robot one is too sparse: XECBS's soft root solves it with
no expansion on most planner seeds, so that whether it expands once
turned on the guide's float32 rounding), on the real
checkpoint at B=8 and full depth (25+1 DDPM steps, 14 guided steps x 20
guide iterations), in JAX's default order: the root and a greedy chain
from it, then per popped node a chain, else `expand`. A whole search is
held to its outcome, as JAX's own tests hold theirs: success with no
conflict, by the search's count and by `count_conflicts` of its paths;
every node it expands, by `expand` or as a greedy step, is a
fewest-conflicts minimum of the open list at that moment; its expansions
are those steps and expansions; the plans and UNet forwards it counts are
those its root and expansions make. JAX's search itself is not
run: it compiles its fused programs, which takes minutes on the CPU (its
pieces are held in tests/test_torch_local.py and tests/test_torch_cbs.py).
"""
import dataclasses
import os

import pytest
import torch

from mmd_torch.common.multi_agent_utils import get_start_goal_pos_circle
from mmd_torch.experiments.status import TrialSuccessStatus
from mmd_torch.planners.multi_agent.cbs import CBS
from mmd_torch.planners.multi_agent.conflict_detection import count_conflicts
from mmd_torch.planners.single_agent.mpd import load_planners

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_AGENTS, RADIUS, B = 4, 0.25, 8


@pytest.mark.parametrize("name,is_ecbs,is_xcbs", [
    ("CBS", False, False), ("ECBS", True, False), ("XCBS", False, True),
    ("XECBS", True, True)])
def test_search_solves_the_dense_circle(monkeypatch, name, is_ecbs, is_xcbs):
    starts, goals = get_start_goal_pos_circle(N_AGENTS, radius=RADIUS)
    planners = load_planners(os.path.join(ROOT, "data_trained_models"),
                             os.path.join(ROOT, "data_trajectories"), "EnvEmptyNoWait2D",
                             starts, goals, device="cpu")
    for p in planners:
        p.cfg = dataclasses.replace(p.cfg, n_samples=B)
    search = CBS(planners, starts, goals, is_ecbs=is_ecbs, is_xcbs=is_xcbs)
    popped = []
    expand = search.expand

    def spy(state):
        popped.append((state.n_conflicts, [n.n_conflicts for n in search.open_l]))
        expand(state)

    monkeypatch.setattr(search, "expand", spy)
    search.greedy_audit = audit = []
    paths, n_exp, status, n_conflicts = search.plan(runtime_limit=600)
    print(f"{name}: {status}, {n_exp} expansions, timing {search.timing}, audit {audit}")
    assert status == TrialSuccessStatus.SUCCESS and n_conflicts == 0
    assert len(paths) == N_AGENTS and all(p.shape == (64, 4) for p in paths)
    assert count_conflicts(paths, search.margin) == 0
    steps = [e for e in audit if e[0] == "step"]
    # A step whose children both starved under ECBS is expanded by `expand`
    # and counted once, as its step.
    assert len(popped) + len(steps) - audit.count(("starved",)) == n_exp
    assert search.timing.get("greedy_steps", 0) == len(steps)
    for n, open_counts in popped:
        assert n > 0 and all(n <= m for m in open_counts), popped
    for _, n, min_open in steps:
        assert n > 0 and (min_open is None or n <= min_open), audit
    if name == "XECBS":
        assert n_exp >= 1
    t = search.timing
    fresh_steps, local_steps = 26, 4
    assert t["plans_fresh"] >= N_AGENTS and t["unet_forwards"] == (
        fresh_steps * t["plans_fresh"] + local_steps * t["plans_local"])
    assert (t["plans_local"] > 0) == (is_xcbs and n_exp > 0)
    if not is_xcbs:
        assert t["plans_fresh"] >= N_AGENTS + 2 * n_exp
