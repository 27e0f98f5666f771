"""The port's CBS as a planner mode over a mesh: `CBS(..., mesh=...)`.

The twin of tests/test_mesh_planner.py. Four ranks run with gloo on the
CPU, spawned once for the file (`mmd_torch.tools.shard_cases.search_case`);
each runs the whole host search, and the team's sampler calls shard over
the mesh's 'agent' axis. The team is JAX's test instance, 4 robots on the
circle of radius 0.4 of EnvEmptyNoWait2D, planned with the committed
checkpoint's weights (the JAX package's, which the port reads through
`convert_flax_params`) at B = 8 and full depth. What is held:
- XCBS and XECBS on a 4-rank 'agent' mesh against the port's search
  without a mesh on the same seeds: both SUCCESS with no conflict, the
  same expansions and sampler calls, the paths within PATH_TOL (1e-5),
  and every rank's paths bitwise equal to rank 0's. Both sides run the
  UNet B rows at a time (`RowChunked`): the CPU's convolutions, like
  cuDNN, sum in another order at another batch size, and a rank's share
  of a call is smaller than the whole call.
- XECBS-R (one root repair round) on a (2, 2) ('agent', 'dp') mesh:
  SUCCESS with no conflict, the same paths on every rank.
- `tools.mesh_search.compare`, which times the search on 4 cards against
  one, at 2 robots on 2 ranks: every search SUCCESS, and the ranks' paths
  bitwise equal to each other and to the search in this process (which,
  like each rank, computes on one thread).
- CBS's validation (JAX cbs.py:214-221), in one process on stand-ins that
  carry `axis_names` and `shape`, as JAX's test passes planner stubs: a
  mesh without an 'agent' axis and one whose axis does not divide the
  team raise JAX's ValueErrors.
"""
import types

import pytest
import torch

from mmd_torch.common.multi_agent_utils import get_start_goal_pos_circle
from mmd_torch.experiments.status import TrialSuccessStatus
from mmd_torch.parallel import sharding
from mmd_torch.planners.multi_agent.cbs import CBS
from mmd_torch.planners.multi_agent.conflict_detection import count_conflicts
from mmd_torch.robots.disk import DiskRobot
from mmd_torch.tools import mesh_search, shard_cases

torch.set_num_threads(1)

PATH_TOL = 1e-5
A, RADIUS, B = 4, 0.4, 8
TEAM = {"n_agents": A, "radius": RADIUS, "n_samples": B, "unet_rows": B}
XCBS = {"is_ecbs": False, "is_xcbs": True}
XECBS = {"is_ecbs": True, "is_xcbs": True}
RUNS = [
    {"name": "XCBS", "team": TEAM, "search": XCBS, "mesh": [A], "axes": ("agent",)},
    {"name": "XECBS", "team": TEAM, "search": XECBS, "mesh": [A], "axes": ("agent",)},
    {"name": "XECBS-R", "team": TEAM, "search": {**XECBS, "root_repair_rounds": 1},
     "mesh": [2, 2], "axes": ("agent", "dp")},
]


@pytest.fixture(scope="module")
def ranks():
    """Per rank, per run of RUNS: the search's outcome."""
    return sharding.spawn(shard_cases.search_case, 4, "gloo", "cpu", RUNS)


@pytest.fixture(scope="module")
def unsharded():
    return {run["name"]: out for run, out in zip(
        RUNS[:2], shard_cases.searches("cpu", [{**run, "mesh": None} for run in RUNS[:2]]))}


def assert_solved(out):
    assert out["status"] == str(TrialSuccessStatus.SUCCESS) and out["n_conflicts"] == 0
    assert count_conflicts(list(out["paths"].numpy()), DiskRobot.make(device="cpu").rr_margin) == 0


@pytest.mark.parametrize("k", [0, 1], ids=["XCBS", "XECBS"])
def test_mesh_search_matches_the_unsharded_search(k, ranks, unsharded):
    name = RUNS[k]["name"]
    one = unsharded[name]
    got = ranks[0][k]
    err = float((got["paths"] - one["paths"]).abs().max())
    print(f"{name}: {got['n_exp']} expansions on the mesh, {one['n_exp']} without; "
          f"sampler calls {got['calls']} / {one['calls']}; paths {err:.3g} apart")
    assert_solved(one)
    assert_solved(got)
    assert got["n_exp"] == one["n_exp"] and got["calls"] == one["calls"]
    assert got["paths"].shape == (A, 64, 4) and err <= PATH_TOL
    for out in ranks[1:]:
        assert torch.equal(out[k]["paths"], got["paths"]) and out[k]["n_exp"] == got["n_exp"]


def test_mesh_xecbs_jacobi_root_on_a_2d_mesh(ranks):
    got = ranks[0][2]
    print(f"XECBS-R on a (2, 2) mesh: {got['status']}, {got['n_exp']} expansions")
    assert_solved(got)
    for out in ranks[1:]:
        assert torch.equal(out[2]["paths"], got["paths"])


def test_mesh_validation():
    """JAX's test_mesh_validation: a mesh without an 'agent' axis, and an
    'agent' axis of 5 for a team of 4, raise before anything is planned."""
    no_agent = types.SimpleNamespace(axis_names=("dp",), shape={"dp": 8})
    five = types.SimpleNamespace(axis_names=("agent",), shape={"agent": 5})

    class _Stub:
        robot = DiskRobot.make(device="cpu")

    starts, goals = get_start_goal_pos_circle(A, radius=RADIUS)
    with pytest.raises(ValueError, match="agent"):
        CBS([_Stub()] * A, starts, goals, validate_start_goal=False, reference_task=object(),
            mesh=no_agent)
    with pytest.raises(ValueError, match="divisible"):
        CBS([_Stub()] * A, starts, goals, validate_start_goal=False, reference_task=object(),
            mesh=five)


def test_mesh_search_tool_holds_ranks_against_one_process():
    rows = mesh_search.compare(2, "gloo", "cpu",
                               {"n_agents": 2, "radius": RADIUS, "n_samples": B, "unet_rows": B})
    assert [row["run"] for row in rows] == ["cold", "warm"]
    for row in rows:
        print(row)
        assert row["unsharded"]["status"] == str(TrialSuccessStatus.SUCCESS)
        assert all(r["status"] == str(TrialSuccessStatus.SUCCESS) for r in row["ranks"])
        assert row["ranks_bitwise_equal"] and row["bitwise_equal_to_unsharded"]
        assert all(r["plan_s"] > 0 and r["root_wait_s"] >= 0 for r in row["ranks"])
