"""The experiment harness of the port against the JAX package.

What is held, and how closely:
- An experiment's trial configs (`get_single_trial_configs_from_experiment_config`)
  equal JAX's: starts and goals exactly, model ids, skeletons and every
  other field, on the 2x2 instance at 2 and 4 agents, two planners, 3
  trials.
- The same results built in both packages give the same results.txt
  text, an analyzed dict equal key for key (floats within 1e-12: both run
  the same Python arithmetic in the same order) and the same .txt
  aggregate; the port's .pkl renders to the same markdown through
  `scripts/results_to_markdown.render` and through the port's twin.
- `score_solution` against JAX's audit, adherence, path length and
  acceleration on the same paths (floats within 1e-6: the lengths and
  accelerations are float32 sums in XLA's and torch's orders): a
  single-tile team with a contact, the same team apart, and a staggered
  team of 3-tile skeletons on the 2x2 grid.
- The launcher: the dry run, a sequential run, a 2-worker pool whose
  workers are spawned (not forked), args.yaml that PyYAML reads to JAX's
  dict and the SLURM script's text equal to JAX's.
- The sweep: resume reruns only a missing trial; a trial that raises is
  counted and written to error_<time_str>.txt while the sweep goes on;
  results go to build/results by default, and the committed results/
  tree and a sweep whose results.pkl JAX wrote are refused.
- The refusal of what is not ported, a mesh, and `render_animation`'s
  ImportError without matplotlib; and
  `frontier_width`, `repair_period` and `greedy_iters`, which reach the
  CBS search of a trial and of a sweep, and not PP's.
- The CLIs take the JAX scripts' flags with their defaults;
  `pair_sweeps` puts a cell's rates and each trial's status beside JAX's.
- Whole 2-agent PP and XECBS sweeps on EnvEmptyNoWait2D's committed
  checkpoint at B=8 on a short schedule on the CPU, with 0 trial errors,
  the tree read back, and the plain collision guide and lookup called as
  often as the kernels must launch on the card: 280 / 80 (here the short
  schedule's count) a fresh / local plan, and T a plan plus one a grid
  tile for each of the team's two start-goal checks.
"""
import argparse
import ast
import dataclasses
import os
import pickle
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mmd_tpu.config import params as jparams
from mmd_tpu.datasets.trajectories import env_name_from_model_id as jenv_name
from mmd_tpu.envs.envs import make_env as jmake_env
from mmd_tpu.experiments import experiment_utils as jutils
from mmd_tpu.experiments import experiments as jexp
from mmd_tpu.experiments import launcher as jlauncher
from mmd_tpu.experiments import trial as jtrial
from mmd_tpu.experiments.status import TrialSuccessStatus as JStatus
from mmd_tpu.utils import metrics as jmetrics
from mmd_torch.config import DiffusionConfig
from mmd_torch.costs import guide
from mmd_torch.envs import grid_sdf
from mmd_torch.experiments import experiment_utils, experiments
from mmd_torch.experiments import launcher as launcher_module
from mmd_torch.experiments.status import TrialSuccessStatus
from mmd_torch.experiments.trial import (
    ModelRegistry,
    run_multi_agent_trial,
    score_solution,
    tile_transform,
)
from mmd_torch.tools import (
    inference_multi_agent,
    launch_mapf_comparison_experiment,
    launch_mapf_freespace_experiment,
    launch_multi_agent_experiment,
    launch_multi_tile_experiment,
    pair_sweeps,
    results_to_markdown,
)
from mmd_torch.tools.launch_multi_agent_experiment import run_multi_agent_experiment

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import results_to_markdown as jmarkdown  # noqa: E402  (the JAX package's script)
import torch_pool_worker  # noqa: E402  (beside this file)

TWO_BY_TWO = "EnvTestTwoByTwoRobotPlanarDiskRandom"
CIRCLE = "EnvEmptyNoWait2DRobotPlanarDiskCircle"
AGG_TOL = 1e-12
SCORE_TOL = 1e-6
SHORT = DiffusionConfig(n_samples=8, n_diffusion_steps=8, t_start_guide=4, n_guide_steps=5)


@pytest.mark.parametrize("num_agents", [2, 4])
def test_trial_configs_equal_jaxs(num_agents):
    kw = dict(time_str="t", instance_name=TWO_BY_TWO, num_agents_l=[num_agents],
              stagger_start_time_dt=10, multi_agent_planner_class_l=["XECBS", "PP"],
              single_agent_planner_class="MPDEnsemble", num_trials_per_combination=3,
              runtime_limit=240.0, bf16=True)
    ours = experiments.MultiAgentPlanningExperimentConfig(
        **kw).get_single_trial_configs_from_experiment_config()
    theirs = jexp.MultiAgentPlanningExperimentConfig(
        **kw).get_single_trial_configs_from_experiment_config()
    assert ([f.name for f in dataclasses.fields(experiments.MultiAgentPlanningSingleTrialConfig)]
            == [f.name for f in dataclasses.fields(jexp.MultiAgentPlanningSingleTrialConfig)])
    assert len(ours) == len(theirs) == 6
    for a, b in zip(ours, theirs):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if f.name in ("start_state_pos_l", "goal_state_pos_l"):
                np.testing.assert_array_equal(np.stack(x), np.stack(y))
            else:
                assert x == y, f.name
    # Trial t of both planners plans one problem.
    np.testing.assert_array_equal(np.stack(ours[0].start_state_pos_l),
                                  np.stack(ours[3].start_state_pos_l))


# (status, collisions, adherence, time, expansions, length, acceleration) a trial.
CELLS = {
    "mixed": [("SUCCESS", 0, 0.875, 2.5, 3, 5.25, 0.03125),
              ("FAIL_COLLISION_AGENTS", 6, 0.0, 9.0, 0, 0.0, 0.0),
              ("SUCCESS", 0, 0.9123456789, 1.1, 1, 6.1, 0.0271828),
              ("FAIL_RUNTIME_LIMIT", 2, 0.0, 30.2, 12, 0.0, 0.0)],
    "all success": [("SUCCESS", 0, 1.0 / 3.0, 0.7, 0, 2.0, 0.01),
                    ("SUCCESS", 0, 0.1, 0.3, 2, 2.2, 0.02)],
    "no success": [("FAIL_NO_SOLUTION", 0, 0.0, 4.0, 0, 0.0, 0.0)],
}


def _write_both(tmp_path):
    """The CELLS results saved by both packages: (port root, JAX root, cfgs)."""
    kw = dict(time_str="agg", instance_name=CIRCLE, num_agents_l=[2, 3],
              multi_agent_planner_class_l=["XECBS", "PP"], num_trials_per_combination=4)
    cfgs = (experiments.MultiAgentPlanningExperimentConfig(**kw),
            jexp.MultiAgentPlanningExperimentConfig(**kw))
    roots = (str(tmp_path / "port"), str(tmp_path / "jax"))
    cells = iter(CELLS.values())
    texts = []
    for n, planner in [(2, "XECBS"), (2, "PP"), (3, "XECBS")]:  # (3, PP) has no trial
        for t, row in enumerate(next(cells)):
            status, coll, adh, secs, exp, length, acc = row
            for pkg, Status, root in ((experiments, TrialSuccessStatus, roots[0]),
                                      (jexp, JStatus, roots[1])):
                tc = pkg.MultiAgentPlanningSingleTrialConfig(
                    time_str="agg", trial_number=t, num_agents=n,
                    multi_agent_planner_class=planner, instance_name=CIRCLE)
                r = pkg.MultiAgentPlanningSingleTrialResult(
                    trial_config=tc, success_status=Status[status],
                    num_collisions_in_solution=coll, data_adherence=adh, planning_time=secs,
                    num_ct_expansions=exp, path_length_per_agent=length,
                    mean_path_acceleration_per_agent=acc)
                d = pkg.get_result_dir_from_trial_config(tc, "agg", t, root=root)
                r.save(d)
                with open(os.path.join(d, "results.txt")) as f:
                    texts.append(f.read())
    return roots, cfgs, texts


def test_results_and_aggregate_equal_jaxs(tmp_path):
    roots, cfgs, texts = _write_both(tmp_path)
    assert texts[0::2] == texts[1::2] and len(texts) == 14
    ours = experiment_utils.combine_and_save_results_for_experiment(cfgs[0], roots[0])
    theirs = jutils.combine_and_save_results_for_experiment(cfgs[1], roots[1])
    assert list(ours) == list(theirs) == [2, 3]
    for n in ours:
        assert list(ours[n]) == list(theirs[n])
        for planner in ours[n]:
            a, b = ours[n][planner], theirs[n][planner]
            assert list(a) == list(b)
            for key in a:
                assert a[key] == pytest.approx(b[key], abs=AGG_TOL, rel=0), (n, planner, key)
    stem = f"analyzed_results__{CIRCLE}"
    with open(os.path.join(roots[0], "agg", f"{stem}.txt")) as f, \
            open(os.path.join(roots[1], "agg", f"{stem}.txt")) as g:
        assert f.read() == g.read()
    pkl = os.path.join(roots[0], "agg", f"{stem}.pkl")
    with open(pkl, "rb") as f:
        stored = pickle.load(f)
    assert type(stored[2]["PP"]) is dict and type(stored[2]["PP"]["success_rate"]) is float
    rendered = results_to_markdown.render(pkl)
    assert rendered == jmarkdown.render(pkl)
    assert rendered == jmarkdown.render(os.path.join(roots[1], "agg", f"{stem}.pkl"))
    assert results_to_markdown.render_dir(os.path.join(roots[0], "agg")) == rendered


def test_markdown_of_jaxs_committed_sweep_equals_the_scripts():
    d = os.path.join(ROOT, "results", "multitile-r5")
    assert results_to_markdown.render_dir(d) == jmarkdown.render_dir(d)


def _line(a, b, n, rng, noise=0.005):
    t = np.linspace(0.0, 1.0, n, dtype=np.float32)[:, None]
    pos = (1 - t) * np.asarray(a, np.float32) + t * np.asarray(b, np.float32)
    return pos + rng.normal(0.0, noise, pos.shape).astype(np.float32)


def _with_velocity(pos):
    vel = np.gradient(pos, axis=0).astype(np.float32) * 10.0
    return np.concatenate([pos, vel], -1).astype(np.float32)


def _team(case):
    """(paths, start times, model ids, transforms, horizons, expected status)."""
    rng = np.random.default_rng(7)
    H = 64
    if case in ("single-tile contact", "single-tile apart"):
        mid = "EnvConveyor2D-RobotPlanarDisk"
        ends = [((-0.8, 0.3), (0.8, 0.25)), ((0.8, -0.3), (-0.8, -0.2)),
                ((-0.7, -0.7), (0.7, 0.7))]
        paths = [_with_velocity(_line(a, b, H, rng)) for a, b in ends]
        if case == "single-tile contact":
            paths[1][30:33, :2] = paths[0][30:33, :2] + 0.03  # 3 steps within 2r
            paths[2][40, :2] = paths[0][40, :2]
        else:
            paths[2][:, :2] = _line((-0.7, -0.75), (0.7, -0.65), H, rng)
        n = len(paths)
        return (paths, [0] * n, [[mid]] * n, [np.zeros((1, 2), np.float32)] * n, [H] * n,
                "FAIL_COLLISION_AGENTS" if case == "single-tile contact" else "SUCCESS")
    from mmd_torch.experiments.problems import get_planning_problem

    _, _, ids, skeletons = get_planning_problem(TWO_BY_TWO, 3, seed=0)
    stagger = 10
    L = 3 * H + stagger * 2
    paths, mids_l, transforms_l = [], [], []
    for i, sk in enumerate(skeletons):
        transforms = np.stack([tile_transform(rc) for rc in sk])
        offset = np.array([0.25 * (i - 1), -0.3 * (i - 1)], np.float32)
        pos = np.concatenate([_line(transforms[k] + offset, transforms[min(k + 1, 2)] + offset,
                                    H, rng) for k in range(3)])
        pos = np.concatenate([np.repeat(pos[:1], stagger * i, 0), pos,
                              np.repeat(pos[-1:], L - len(pos) - stagger * i, 0)])
        paths.append(_with_velocity(pos))
        mids_l.append([ids[r][c] for r, c in sk])
        transforms_l.append(transforms)
    return paths, [stagger * i for i in range(3)], mids_l, transforms_l, [H] * 3, "SUCCESS"


def _jax_score(paths_l, status, start_time_l, model_ids_l, transforms_l, horizons):
    """JAX's run_multi_agent_trial from its plan on (trial.py:237-275)."""
    n_coll = 0
    if len(paths_l) > 0 and status == JStatus.SUCCESS:
        n_audit = jtrial.audit_solution_collisions(paths_l, jparams.robot_planar_disk_radius)
        if n_audit > 0:
            n_coll += n_audit
            status = JStatus.FAIL_COLLISION_AGENTS
    out = {"status": str(status), "n_audit": n_coll, "data_adherence": 0.0,
           "path_length_per_agent": 0.0, "mean_path_acceleration_per_agent": 0.0}
    if status == JStatus.SUCCESS:
        adh_total = 0.0
        for i in range(len(paths_l)):
            H, agent_adh, path = horizons[i], 0.0, np.asarray(paths_l[i])
            for step, mid in enumerate(model_ids_l[i]):
                seg = path[start_time_l[i] + step * H: start_time_l[i] + (step + 1) * H, :2]
                env = jmake_env(jenv_name(mid))
                agent_adh += env.compute_traj_data_adherence(seg - transforms_l[i][step])
            adh_total += agent_adh / len(model_ids_l[i])
        out["data_adherence"] = adh_total / len(paths_l)
        out["path_length_per_agent"] = float(np.mean(
            [float(jmetrics.compute_path_length(jnp.asarray(p)[None])[0]) for p in paths_l]))
        out["mean_path_acceleration_per_agent"] = float(np.mean(
            [float(jmetrics.compute_average_acceleration(jnp.asarray(p)[None])[0])
             for p in paths_l]))
    return out


@pytest.mark.parametrize("case", ["single-tile contact", "single-tile apart",
                                  "staggered 3-tile"])
def test_score_solution_equals_jaxs(case):
    paths, starts, mids, transforms, horizons, expected = _team(case)
    ours = score_solution(paths, TrialSuccessStatus.SUCCESS, starts, mids, transforms, horizons)
    theirs = _jax_score(paths, JStatus.SUCCESS, starts, mids, transforms, horizons)
    assert str(ours.status) == theirs["status"] == expected
    assert ours.n_audit == theirs["n_audit"]
    if expected == "SUCCESS":
        assert ours.n_audit == 0 and theirs["path_length_per_agent"] > 0
    else:
        assert ours.n_audit >= 4
    for key in ("data_adherence", "path_length_per_agent", "mean_path_acceleration_per_agent"):
        assert getattr(ours, key) == pytest.approx(theirs[key], abs=SCORE_TOL, rel=0), key
    # A status that is not SUCCESS is neither audited nor scored.
    failed = score_solution(paths, TrialSuccessStatus.FAIL_RUNTIME_LIMIT, starts, mids,
                            transforms, horizons)
    assert failed.status == TrialSuccessStatus.FAIL_RUNTIME_LIMIT and failed.n_audit == 0
    assert failed.data_adherence == failed.path_length_per_agent == 0.0


def test_launcher_dry_run_sequential_and_spawned_pool(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch_pool_worker, "MARK", "parent")
    launcher = launcher_module.Launcher("exp", exp_fn=torch_pool_worker.worker_info, n_seeds=2,
                                        base_dir=str(tmp_path / "seq"))
    launcher.add_experiment(x=1, name="a")
    launcher.add_experiment(x=2, name="b")
    assert launcher.run(test=True) == []
    assert capsys.readouterr().out.count("[dry-run] exp seed=") == 4
    assert not (tmp_path / "seq").exists()
    seq = launcher.run(local=True)
    assert [(r["x"], r["seed"], r["mark"], r["pid"]) for r in seq] == [
        (1, 0, "parent", os.getpid()), (1, 1, "parent", os.getpid()),
        (2, 0, "parent", os.getpid()), (2, 1, "parent", os.getpid())]
    pool = launcher_module.Launcher("exp", exp_fn=torch_pool_worker.worker_info, n_seeds=2,
                                    n_exps_in_parallel=2, base_dir=str(tmp_path / "pool"))
    pool.add_experiment(x=3)
    out = pool.run(local=True)
    # Spawned workers import the module afresh; forked ones would read "parent".
    assert [r["mark"] for r in out] == ["imported", "imported"]
    assert [r["seed"] for r in out] == [0, 1] and os.getpid() not in {r["pid"] for r in out}
    assert sorted(os.listdir(tmp_path / "pool" / "exp" / "x_3")) == ["0", "1"]


def test_launcher_failure_is_returned_and_written(tmp_path):
    launcher = launcher_module.Launcher("exp", exp_fn=torch_pool_worker.worker_info,
                                        base_dir=str(tmp_path))
    launcher.add_experiment(seed=5)  # a second 'seed' argument: TypeError in the run
    (err,) = launcher.run(local=True)
    assert isinstance(err, TypeError)
    with open(tmp_path / "exp" / "seed_5" / "0" / "error.txt") as f:
        assert f.read() == repr(err)


def test_launcher_args_yaml_and_slurm_script_equal_jaxs(tmp_path):
    params = {"lr": 0.1, "n": 3, "env": "EnvConveyor2D", "bf16": True,
              "agents": [2, 4, 6], "skip": None}
    texts = []
    for pkg, sub in ((launcher_module, "port"), (jlauncher, "jax")):
        base = str(tmp_path / sub)
        launcher = pkg.Launcher("exp", exp_fn=dict, exp_file="run.py", n_seeds=3,
                                base_dir=base, partition="gpu", gres="gpu:1")
        launcher.add_experiment(**params)
        launcher.run(local=True)
        run_dir = os.path.join(launcher._results_dir(params), "1")
        with open(os.path.join(run_dir, "args.yaml")) as f:
            args_text = f.read()
        with open(launcher.generate_slurm(params)) as f:
            slurm = f.read()
        texts.append((yaml.safe_load(args_text), args_text,
                      slurm.replace(base, "<base>"), run_dir.replace(base, "<base>")))
    (ours, our_text, our_slurm, ours_dir), (theirs, their_text, their_slurm, theirs_dir) = texts
    assert ours_dir == theirs_dir
    assert {**ours, "results_dir": ""} == {**theirs, "results_dir": ""}
    assert our_text.replace(str(tmp_path / "port"), "") == \
        their_text.replace(str(tmp_path / "jax"), "")
    assert our_slurm == their_slurm
    assert "#SBATCH --array=0-2" in our_slurm and "--partition=gpu" in our_slurm


def _fake_trial(raise_on=()):
    """A run_multi_agent_trial that saves a fixed result and records its calls."""
    calls = []

    def run(cfg, registry=None, results_root="./results", diffusion_cfg=None):
        calls.append((cfg.multi_agent_planner_class, cfg.trial_number))
        if (cfg.multi_agent_planner_class, cfg.trial_number) in raise_on:
            raise RuntimeError("planner fell over")
        r = experiments.MultiAgentPlanningSingleTrialResult(
            trial_config=cfg, success_status=TrialSuccessStatus.SUCCESS, planning_time=1.0,
            global_model_ids=cfg.global_model_ids, agent_skeleton_l=cfg.agent_skeleton_l,
            team_timing={"plans_fresh": 2, "plans_local": 1, "sampler_calls": 3,
                         "sampler_calls_local": 1})
        r.save(experiments.get_result_dir_from_trial_config(cfg, cfg.time_str,
                                                            cfg.trial_number, root=results_root))
        return r
    return run, calls


def _sweep_cfg(time_str="sweep", **kw):
    return experiments.MultiAgentPlanningExperimentConfig(
        **{"time_str": time_str, "instance_name": CIRCLE, "num_agents_l": [2],
           "multi_agent_planner_class_l": ["XECBS", "PP"], "num_trials_per_combination": 2,
           **kw})


def test_resume_reruns_only_the_missing_trial_and_errors_are_counted(tmp_path, monkeypatch):
    root = str(tmp_path)
    run, calls = _fake_trial()
    monkeypatch.setattr(launch_multi_agent_experiment, "run_multi_agent_trial", run)
    analyzed, n_failed = run_multi_agent_experiment(_sweep_cfg(), root)
    assert n_failed == 0 and len(calls) == 4 and analyzed[2]["PP"]["num_trials"] == 2
    missing = experiments.get_result_dir_from_trial_config(
        _sweep_cfg().get_single_trial_configs_from_experiment_config()[3], "sweep", 1, root=root)
    os.remove(os.path.join(missing, "results.pkl"))
    calls.clear()
    analyzed, n_failed = run_multi_agent_experiment(_sweep_cfg(), root)
    assert calls == [("PP", 1)] and n_failed == 0 and analyzed[2]["PP"]["success_rate"] == 1.0

    run, calls = _fake_trial(raise_on={("XECBS", 0), ("PP", 1)})
    monkeypatch.setattr(launch_multi_agent_experiment, "run_multi_agent_trial", run)
    analyzed, n_failed = run_multi_agent_experiment(_sweep_cfg("faulty"), root)
    assert n_failed == 2 and len(calls) == 4
    assert analyzed[2]["XECBS"]["num_trials"] == analyzed[2]["PP"]["num_trials"] == 1
    with open(os.path.join(root, "error_faulty.txt")) as f:
        text = f.read()
    heads = [line for line in text.splitlines() if line.startswith("MultiAgentPlanning")]
    assert len(heads) == 2 and all(h.endswith("RuntimeError('planner fell over')") for h in heads)
    assert text.count("Traceback (most recent call last)") == 2
    # The CLI exits 1 when a trial raised, and 0 on a resumed sweep with nothing to rerun.
    argv = ["--num_agents", "2", "--planners", "XECBS", "PP", "--trials", "2",
            "--results_root", root, "--device", "cpu", "--time_str"]
    assert launch_mapf_freespace_experiment.main(argv + ["faulty2"]) == 1
    assert launch_mapf_freespace_experiment.main(argv + ["sweep"]) == 0


@pytest.mark.parametrize("where", ["committed results", "JAX's sweep"])
def test_results_root_refusals(where, tmp_path, monkeypatch):
    run, calls = _fake_trial()
    monkeypatch.setattr(launch_multi_agent_experiment, "run_multi_agent_trial", run)
    if where == "committed results":
        # The CLIs default to build/results; the committed tree is refused
        # before anything is written to it, by the sweep, the trial and the CLI.
        assert launch_multi_agent_experiment.parser().parse_args([]).results_root == \
            experiments.RESULTS_ROOT == os.path.join(ROOT, "build", "results")
        committed = os.path.join(ROOT, "results")
        before = sorted(os.listdir(committed))
        for root in (committed, os.path.join(committed, "multitile-r5")):
            with pytest.raises(ValueError, match="committed sweeps"):
                run_multi_agent_experiment(_sweep_cfg("multitile-r5"), root)
        tc = _sweep_cfg().get_single_trial_configs_from_experiment_config()[0]
        with pytest.raises(ValueError, match="committed sweeps"):
            run_multi_agent_trial(tc, registry=object(), results_root=committed)
        with pytest.raises(ValueError, match="committed sweeps"):
            launch_mapf_freespace_experiment.main(["--num_agents", "2", "--results_root",
                                                   committed, "--time_str", "multitile-r5"])
        assert sorted(os.listdir(committed)) == before
    else:
        # A sweep whose results.pkl the JAX package wrote is neither resumed
        # nor aggregated: unpickling it would import the JAX package.
        root = str(tmp_path)
        tc = jexp.MultiAgentPlanningSingleTrialConfig(
            time_str="r5", num_agents=2, multi_agent_planner_class="PP", instance_name=CIRCLE)
        d = jexp.get_result_dir_from_trial_config(tc, "r5", 0, root=root)
        jexp.MultiAgentPlanningSingleTrialResult(trial_config=tc,
                                                 success_status=JStatus.SUCCESS).save(d)
        jutils.combine_and_save_results_for_experiment(jexp.MultiAgentPlanningExperimentConfig(
            time_str="r5", instance_name=CIRCLE, num_agents_l=[2],
            multi_agent_planner_class_l=["PP"]), root)
        agg = os.path.join(root, "r5", f"analyzed_results__{CIRCLE}.txt")
        with open(agg) as f:
            jax_text = f.read()
        with pytest.raises(ValueError, match="not written by the port.*mmd_tpu"):
            run_multi_agent_experiment(_sweep_cfg("r5"), root)
        with pytest.raises(ValueError, match="not written by the port"):
            experiment_utils.read_aggregated_trial_results_for_experiment(_sweep_cfg("r5"), root)
        with pytest.raises(ValueError, match="not written by the port"):
            pair_sweeps.pair(os.path.join(root, "r5"), None)
        with open(agg) as f:
            assert f.read() == jax_text
        assert not os.path.exists(os.path.join(root, "r5", "experiment_config.pkl"))
    assert calls == []


def test_pair_sweeps_puts_each_trial_beside_jaxs(tmp_path, monkeypatch):
    run, _ = _fake_trial()
    monkeypatch.setattr(launch_multi_agent_experiment, "run_multi_agent_trial", run)
    run_multi_agent_experiment(_sweep_cfg(), str(tmp_path / "port"))
    jcfg = jexp.MultiAgentPlanningExperimentConfig(
        time_str="sweep", instance_name=CIRCLE, num_agents_l=[2],
        multi_agent_planner_class_l=["XECBS", "PP"], num_trials_per_combination=2)
    for tc in jcfg.get_single_trial_configs_from_experiment_config():
        failed = (tc.multi_agent_planner_class, tc.trial_number) == ("PP", 1)
        jexp.MultiAgentPlanningSingleTrialResult(
            trial_config=tc, num_collisions_in_solution=4 * failed,
            success_status=JStatus.FAIL_COLLISION_AGENTS if failed else JStatus.SUCCESS,
        ).save(jexp.get_result_dir_from_trial_config(tc, "sweep", tc.trial_number,
                                                     root=str(tmp_path / "jax")))
    jutils.combine_and_save_results_for_experiment(jcfg, str(tmp_path / "jax"))
    text = pair_sweeps.pair(str(tmp_path / "port" / "sweep"), str(tmp_path / "jax" / "sweep"))
    (row,) = [line for line in text.splitlines() if line.startswith("| 2 | PP |")]
    # 2 trials of 2 fresh and 1 local plans, each plan a sampler call of its
    # own, and no expansion: 2 x (2 x 14 + 4) guide-loop launches (one a
    # guided step), 2 x (3 calls x 1 tile + 2 checks x 1 grid tile) lookups.
    assert row == ("| 2 | PP | 1.00 +- 0.00; 0.50 | 0.00; 2.00 | 0.0000; 0.0000 | 0.0 | "
                   "0.00 | 4 / 2 | 4 / 2 | - | 64 / 10 | SUCCESS/SUCCESS, SUCCESS/FAIL_COLL |")
    alone = pair_sweeps.pair(str(tmp_path / "port" / "sweep"), None)
    assert "| 2 | XECBS | 1.00 +- 0.00; - | 0.00; - |" in alone and "SUCCESS/-" in alone


@pytest.mark.parametrize("knob", [{"frontier_width": 2}, {"repair_period": 1},
                                  {"greedy_iters": 4}, {"mesh": object()},
                                  {"render_animation": True}], ids=lambda k: next(iter(k)))
def test_unported_knobs_are_refused(knob, tmp_path, cpu_registry, monkeypatch):
    """A mesh is still refused (ValueError naming ROADMAP.md's sharding
    item). render_animation, now ported, raises ImportError before anything
    runs or is written on a machine without matplotlib (hidden here; the
    GIF itself is tested in tests/test_torch_viz.py). The speculative
    search's knobs, which the port once refused, now reach the CBS search
    of a trial and of a sweep (JAX trial.py:201-209), and not PP's."""
    kw = {k: v for k, v in knob.items() if k != "mesh"}
    if "mesh" in knob or "render_animation" in knob:
        cfg = experiments.MultiAgentPlanningSingleTrialConfig(time_str="t", **kw)
        if "mesh" in knob:
            refusal = pytest.raises(ValueError, match="ROADMAP.md Queue 1, \"sharding\"")
        else:
            monkeypatch.setitem(sys.modules, "matplotlib", None)
            refusal = pytest.raises(ImportError, match="matplotlib")
        with refusal:
            run_multi_agent_trial(cfg, registry=object(), results_root=str(tmp_path),
                                  mesh=knob.get("mesh"))
        if "mesh" not in knob:
            with pytest.raises(ImportError, match="matplotlib"):
                run_multi_agent_experiment(_sweep_cfg(**kw), str(tmp_path))
        assert not os.listdir(tmp_path)
        return
    from mmd_torch.experiments import trial as trial_module

    (name, value), = kw.items()
    teams = []
    real = trial_module.make_team_planner
    monkeypatch.setattr(trial_module, "make_team_planner",
                        lambda *a, **k: teams.append(real(*a, **k)) or teams[-1])
    cfg = _sweep_cfg(num_trials_per_combination=1, runtime_limit=60.0, **kw)
    analyzed, n_failed = run_multi_agent_experiment(cfg, str(tmp_path), cpu_registry, SHORT)
    assert n_failed == 0 and analyzed[2]["XECBS"]["num_trials"] == 1
    cbs, pp = teams
    assert type(cbs).__name__ == "CBS" and type(pp).__name__ == "PrioritizedPlanning"
    assert {"frontier_width": cbs.frontier_width, "repair_period": cbs.repair_period,
            "greedy_iters": cbs.GREEDY_ITERS}[name] == value
    assert not hasattr(pp, name)
    # One trial alone, unsaved, as inference_multi_agent runs it.
    tc = cfg.get_single_trial_configs_from_experiment_config()[0]
    r = run_multi_agent_trial(tc, cpu_registry, str(tmp_path), save=False, diffusion_cfg=SHORT)
    assert r.success_status == TrialSuccessStatus.SUCCESS
    assert getattr(teams[-1], "GREEDY_ITERS" if name == "greedy_iters" else name) == value


@pytest.mark.parametrize("argv", [["--mesh_agents", "2"], ["--render_animation"]])
def test_inference_cli_refuses_what_is_not_ported(argv, tmp_path, monkeypatch):
    """--mesh_agents raises ValueError naming ROADMAP.md's sharding item;
    --render_animation, now ported, raises ImportError before planning
    where matplotlib is missing (hidden here)."""
    if argv[0] == "--mesh_agents":
        refusal = pytest.raises(ValueError, match="ROADMAP.md Queue 1, \"sharding\"")
    else:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
        refusal = pytest.raises(ImportError, match="matplotlib")
    with refusal:
        inference_multi_agent.main(argv + ["--results_root", str(tmp_path), "--device", "cpu",
                                           "--num_agents", "2"])
    assert not os.listdir(tmp_path)


def _jax_flags(script):
    """{flag: its add_argument keywords} of a JAX script, read from its source."""
    with open(os.path.join(ROOT, "scripts", script)) as f:
        tree = ast.parse(f.read())
    flags = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            kw = {k.arg: k.value for k in node.keywords if k.arg != "help"}
            flags[node.args[0].value] = kw
    return flags


CLIS = [("launch_multi_agent_experiment.py", launch_multi_agent_experiment),
        ("launch_multi_tile_experiment.py", launch_multi_tile_experiment),
        ("launch_mapf_comparison_experiment.py", launch_mapf_comparison_experiment),
        ("launch_mapf_freespace_experiment.py", launch_mapf_freespace_experiment),
        ("inference_multi_agent.py", inference_multi_agent),
        ("results_to_markdown.py", results_to_markdown)]
PORT_ONLY = {"--results_root", "--device"}
PATH_FLAGS = {"--models_dir", "--data_dir"}  # the port's resolve from the repository


@pytest.mark.parametrize("script,tool", CLIS, ids=[c[0] for c in CLIS])
def test_clis_take_the_jax_scripts_flags_and_defaults(script, tool):
    jax_flags = _jax_flags(script)
    actions = {a.option_strings[0] if a.option_strings else a.dest: a
               for a in tool.parser()._actions if not isinstance(a, argparse._HelpAction)}
    assert set(jax_flags) <= set(actions)
    assert set(actions) - set(jax_flags) <= PORT_ONLY | PATH_FLAGS
    names = {"int": int, "float": float, "list": list, "range": range}
    for flag, kw in jax_flags.items():
        a = actions[flag]
        if flag in PATH_FLAGS:
            assert a.default == os.path.join(ROOT, eval(compile(ast.Expression(kw["default"]),
                                                                "<flag>", "eval"), names))
            continue
        for key, node in kw.items():
            value = eval(compile(ast.Expression(node), "<flag>", "eval"), names)
            if key == "action":
                assert type(a).__name__ == {"store_true": "_StoreTrueAction"}[value], flag
            else:
                assert getattr(a, key) == value, (flag, key)


def _count_kernel_calls(monkeypatch):
    """Count the plain versions' calls that stand for kernel launches on the
    card: the outermost guide loop (one launch a guided step for all
    tiles), a collision guide and the lookups made outside it."""
    counts, depth = {"guide_loop": 0, "collision_guide": 0, "grid_sdf_lookup": 0}, [0]
    plain_loop = guide.guide_loop_plain
    plain_guide, plain_lookup = guide.collision_guide_plain, grid_sdf.grid_lookup

    def counted(name, fn):
        def call(*a, **k):
            counts[name] += depth[0] == 0
            depth[0] += 1
            try:
                return fn(*a, **k)
            finally:
                depth[0] -= 1
        return call

    def counted_lookup(*a, **k):
        counts["grid_sdf_lookup"] += depth[0] == 0
        return plain_lookup(*a, **k)

    monkeypatch.setattr(guide, "guide_loop_plain", counted("guide_loop", plain_loop))
    monkeypatch.setattr(guide, "collision_guide_plain", counted("collision_guide", plain_guide))
    monkeypatch.setattr(grid_sdf, "grid_lookup", counted_lookup)
    return counts


def _launches(trials, grid_tiles):
    want = pair_sweeps.expected_launches(trials, grid_tiles, SHORT)
    del want["plans_fresh"], want["plans_local"], want["sampler_calls"]
    return want


@pytest.fixture(scope="module")
def cpu_registry():
    return ModelRegistry(device="cpu")


@pytest.mark.parametrize("planner", ["PP", "XECBS"])
def test_sweep_on_the_committed_checkpoint(planner, tmp_path, cpu_registry, monkeypatch):
    counts = _count_kernel_calls(monkeypatch)
    cfg = _sweep_cfg(multi_agent_planner_class_l=[planner], runtime_limit=60.0)
    analyzed, n_failed = run_multi_agent_experiment(cfg, str(tmp_path), cpu_registry, SHORT)
    assert n_failed == 0 and not os.path.exists(tmp_path / "error_sweep.txt")
    trials = experiment_utils.read_aggregated_trial_results_for_experiment(
        cfg, str(tmp_path))[2][planner]
    assert len(trials) == 2 and analyzed[2][planner]["num_trials"] == 2
    for r in trials:
        assert r.success_status == TrialSuccessStatus.SUCCESS, r
        assert r.jit_compile_time == 0.0 and r.planning_time > 0
        assert [p.shape for p in r.agent_path_l] == [(64, 4)] * 2
        assert 0.0 <= r.data_adherence <= 1.0 and r.path_length_per_agent > 0
    assert analyzed[2][planner]["success_rate"] == 1.0
    assert counts == _launches(trials, grid_tiles=1)
    d = experiments.get_result_dir_from_trial_config(trials[0].trial_config, "sweep", 0,
                                                     root=str(tmp_path))
    with open(os.path.join(d, "results.txt")) as f:
        assert f.read() == str(trials[0])


def test_multi_tile_trial_launch_count(tmp_path, cpu_registry, monkeypatch):
    # The problem is drawn first: its random starts are cleared on a CPU
    # task, which launches nothing on the card.
    (tc,) = experiments.MultiAgentPlanningExperimentConfig(
        time_str="mt", instance_name=TWO_BY_TWO, num_agents_l=[2], stagger_start_time_dt=10,
        multi_agent_planner_class_l=["XECBS"], single_agent_planner_class="MPDEnsemble",
        num_trials_per_combination=1).get_single_trial_configs_from_experiment_config()
    counts = _count_kernel_calls(monkeypatch)
    r = run_multi_agent_trial(tc, cpu_registry, str(tmp_path), save=False, diffusion_cfg=SHORT)
    assert r.team_timing["plans_fresh"] >= 1 and len(r.agent_skeleton_l[0]) == 3
    assert counts == _launches([r], grid_tiles=4)
    assert not os.listdir(tmp_path)
