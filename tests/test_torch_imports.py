"""The port needs nothing that the GPU machine lacks.

That machine has torch, numpy and scipy but no jax, flax, yaml or msgpack.
In a fresh interpreter those (and mmd_tpu) are blocked with a meta-path
finder that raises; then every module of mmd_torch is imported, and
chip_smoke.py's CPU-reachable setup runs: the readers, load_checkpoint on
the CPU, a short plan, a short 2-robot PP team plan, a short 2-robot
XECBS search and, on the multi-tile instance, a short 3-tile plan and a
short XECBS search. chip_smoke.py itself must exit non-zero and print
no result without a CUDA card, and when it stands alone in a directory.
"""
import os
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GUARDED = textwrap.dedent("""
    import dataclasses, importlib, importlib.util, pkgutil, sys
    BLOCKED = {"jax", "jaxlib", "flax", "yaml", "msgpack", "mmd_tpu"}
    for name in list(sys.modules):
        if name.split(".")[0] in BLOCKED:
            del sys.modules[name]

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    ROOT = sys.argv[1]
    sys.path.insert(0, ROOT)
    import torch
    torch.set_num_threads(1)
    import mmd_torch
    names = [m.name for m in pkgutil.walk_packages(mmd_torch.__path__, "mmd_torch.")]
    for name in names:
        importlib.import_module(name)
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT + "/chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from mmd_torch.common.multi_agent_utils import get_start_goal_pos_circle
    starts, goals = get_start_goal_pos_circle(10)
    start, goal = starts[cs.NOWAIT_PAIRS[0]], goals[cs.NOWAIT_PAIRS[0]]
    planner = cs.load_planner("EnvEmptyNoWait2D", start, goal, "cpu")
    cs.load_planner("EnvConveyor2D", *cs.CONVEYOR_TASK, "cpu")
    planner.cfg = dataclasses.replace(planner.cfg, n_samples=2, n_guide_steps=1)
    out = planner()
    assert out.trajs_final.shape == (2, 64, 4)
    from mmd_torch.planners.multi_agent.prioritized_planning import PrioritizedPlanning
    team_starts, team_goals = get_start_goal_pos_circle(2)
    team = cs.load_team("EnvEmptyNoWait2D", team_starts, team_goals, "cpu")
    for p in team:
        p.cfg = dataclasses.replace(p.cfg, n_samples=2, n_guide_steps=1)
    pp = PrioritizedPlanning(team, team_starts, team_goals)
    paths, _, status, _ = pp.plan()
    assert pp.used_scan and len(paths) == 2 and paths[0].shape == (64, 4)
    from mmd_torch.planners.multi_agent.cbs import CBS
    xecbs = CBS(team, team_starts, team_goals, is_ecbs=True, is_xcbs=True)
    paths, _, status, _ = xecbs.plan()
    assert len(paths) == 2 and paths[0].shape == (64, 4), status
    assert xecbs.timing["plans_fresh"] >= 2
    trial = cs.load_tiles_trial("XECBS", "cpu")
    for p in trial.planners:
        p.cfg = dataclasses.replace(p.cfg, n_samples=2, n_guide_steps=1)
    assert trial.planners[0]().trajs_final.shape == (2, 3 * 64, 4)
    trial.team.plan()
    assert trial.team.timing["plans_fresh"] >= 1
    leaked = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print("imported", len(names), "modules")
""")


def _run(args, cwd):
    return subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True,
                          text=True, timeout=300)


def test_port_imports_and_runs_without_jax_flax_yaml_msgpack():
    proc = _run(["-c", GUARDED, ROOT], cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "imported" in proc.stdout


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: there chip_smoke.py is the real run")
    proc = _run(["chip_smoke.py"], cwd=ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    proc = _run(["chip_smoke.py"], cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
