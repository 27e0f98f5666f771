"""The port needs nothing that the GPU machine lacks.

That machine has torch, numpy and scipy but no jax, flax, optax, yaml,
msgpack or matplotlib. In a fresh interpreter those (and mmd_tpu) are blocked with a meta-path
finder that raises; then every module of mmd_torch is imported, and
chip_smoke.py's CPU-reachable setup runs: the readers, load_checkpoint on
the CPU, a short plan, a short 2-robot PP team plan, a short 2-robot
XECBS search and, on the multi-tile instance, a short 3-tile plan and a
short XECBS search; then the training path at a small width: chip_smoke's
card-against-CPU step parity (here CPU against CPU), `train` with
validation, a summary and checkpoints, the checkpoint read back, a train
state resumed, and the training CLI's refusal of a committed model
directory; then a short DDIM plan, one generated context (RRT and GPMP2)
and the evaluation CLI with its row file; then a one-trial sweep of the
experiment harness with its aggregate rendered as markdown, and a
launcher run with its args.yaml; without matplotlib a successful trial
saves its result and skips its frame with one line on
stderr, as the training summaries skip their figures, and the renders a
user asks for (a sweep's render_animation, the evaluation CLI's
--render_dir) raise ImportError; then phase 18's CPU-reachable pieces: a
field of viz, GP-prior draws, the timer, the compile monitor and one
forward's FLOPs. The JAX package's scripts are blocked
too, by package and by module name. chip_smoke.py itself must exit
non-zero and print no result without a CUDA card, and when it stands
alone in a directory.
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
    import dataclasses, importlib, importlib.util, os, pkgutil, sys
    ROOT = sys.argv[1]
    # The JAX package's scripts, by package and by the names they import as.
    SCRIPTS = {f[:-3] for f in os.listdir(ROOT + "/scripts") if f.endswith(".py")}
    BLOCKED = {"jax", "jaxlib", "flax", "optax", "yaml", "msgpack", "matplotlib", "mmd_tpu",
               "scripts"} | SCRIPTS
    for name in list(sys.modules):
        if name.split(".")[0] in BLOCKED:
            del sys.modules[name]

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
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
    import os, tempfile
    from mmd_torch.datasets.trajectories import TrajectoryDataset, model_id
    from mmd_torch.train import trainer
    from mmd_torch.train.checkpoint import load_checkpoint
    from mmd_torch.train.train_diffusion import committed_models_dir
    ds = TrajectoryDataset.load_trajectories(ROOT + "/data_trajectories",
                                             model_id("EnvEmptyNoWait2D"), device="cpu")
    small = TrajectoryDataset.from_trajs(ds.trajs[:64, ::4].numpy(), "EnvEmptyNoWait2D",
                                         device="cpu")
    parity, _, _ = cs.train_parity("cpu", small, trainer.TrainConfig(batch_size=8, **cs.PARITY_EMA),
                                   6, unet_dim=8)
    assert parity["loss_rel"] == parity["param_abs"] == parity["ema_abs"] == 0.0, parity
    assert parity["bf16_loss_rel"] == 0.0 and parity["bf16_grad_cosine"] >= 0.999, parity
    d = os.path.join(tempfile.mkdtemp(), model_id("EnvEmptyNoWait2D"))
    for bf16, resume in ((False, False), (True, True)):
        trainer.train(small, trainer.TrainConfig(batch_size=8, bf16=bf16), num_train_steps=4,
                      unet_dim=8, dim_mults=(1, 2), model_dir=d, log_every=2,
                      validate_every=2, summary_every=4, steps_til_checkpoint=2,
                      log_fn=lambda m: None, resume=resume)
    model, _, info = load_checkpoint(d, device="cpu")
    assert info["step"] == 8, info
    assert committed_models_dir(ROOT + "/data_trained_models_vd") and not committed_models_dir(d)
    import numpy as np
    from mmd_torch.planners.single_agent.mpd import load_planners
    ddim = load_planners(ROOT + "/data_trained_models", ROOT + "/data_trajectories",
                         "EnvEmptyNoWait2D", [start], [goal], device="cpu", sampler="ddim")[0]
    ddim.cfg = dataclasses.replace(ddim.cfg, n_samples=2, n_guide_steps=1)
    assert ddim().trajs_iters.shape == (7, 2, 64, 4)
    from mmd_torch.datagen.generate import generate_context_trajectories
    ctx = generate_context_trajectories("EnvConveyor2D", np.random.default_rng(0),
                                        n_trajectories=2, gpmp_opt_iters=2, device="cpu")
    assert ctx.trajs.shape[1:] == (64, 4) and ctx.n_planned == 2
    from mmd_torch.io.flat_yaml import load_rows
    from mmd_torch.tools import eval_model
    rows = os.path.join(tempfile.mkdtemp(), "rows.yaml")
    assert eval_model.main(["--env", "EnvEmptyNoWait2D", "--n_tasks", "1", "--n_samples", "2",
                            "--device", "cpu", "--out_yaml", rows]) == 0
    assert load_rows(rows)[0]["n_tasks"] == 1
    from mmd_torch.config import DiffusionConfig
    from mmd_torch.experiments.experiments import MultiAgentPlanningExperimentConfig
    from mmd_torch.experiments.launcher import Launcher
    from mmd_torch.experiments.trial import ModelRegistry
    from mmd_torch.io.flat_yaml import load_flat_yaml
    from mmd_torch.tools import results_to_markdown
    from mmd_torch.tools.launch_multi_agent_experiment import run_multi_agent_experiment
    out = tempfile.mkdtemp()
    sweep = MultiAgentPlanningExperimentConfig(
        time_str="s", instance_name="EnvEmptyNoWait2DRobotPlanarDiskCircle", num_agents_l=[2],
        multi_agent_planner_class_l=["PP"])
    analyzed, n_failed = run_multi_agent_experiment(
        sweep, out, ModelRegistry(device="cpu"),
        DiffusionConfig(n_samples=2, n_diffusion_steps=4, t_start_guide=2, n_guide_steps=1))
    assert n_failed == 0 and analyzed[2]["PP"]["num_trials"] == 1, analyzed
    assert "| 2 |" in results_to_markdown.render_dir(os.path.join(out, "s"))
    launcher = Launcher("e", exp_fn=dict, base_dir=out)
    launcher.add_experiment(x=1)
    assert launcher.run()[0]["x"] == 1
    assert load_flat_yaml(os.path.join(out, "e", "x_1", "0", "args.yaml"))["x"] == 1
    import glob
    saved = glob.glob(os.path.join(out, "s", "**", "results.pkl"), recursive=True)
    assert len(saved) == 1
    from mmd_torch.experiments.experiments import MultiAgentPlanningSingleTrialConfig
    from mmd_torch.experiments.problems import get_planning_problem
    from mmd_torch.experiments.status import TrialSuccessStatus
    from mmd_torch.experiments.trial import run_multi_agent_trial
    tc = MultiAgentPlanningSingleTrialConfig(
        time_str="one", num_agents=2, multi_agent_planner_class="PP",
        instance_name="EnvEmptyNoWait2DRobotPlanarDiskCircle")
    (tc.start_state_pos_l, tc.goal_state_pos_l, tc.global_model_ids,
     tc.agent_skeleton_l) = get_planning_problem(tc.instance_name, 2)
    r = run_multi_agent_trial(tc, ModelRegistry(device="cpu"), out, diffusion_cfg=DiffusionConfig(
        n_samples=8, n_diffusion_steps=8, t_start_guide=4, n_guide_steps=5))
    assert r.success_status == TrialSuccessStatus.SUCCESS, r.success_status
    (saved,) = glob.glob(os.path.join(out, "one", "**", "results.pkl"), recursive=True)
    assert sorted(os.listdir(os.path.dirname(saved))) == ["results.pkl", "results.txt"]
    print("the successful trial saved its result without a frame", file=sys.stderr)
    try:
        run_multi_agent_experiment(dataclasses.replace(sweep, time_str="r",
                                                       render_animation=True), out)
    except ImportError as e:
        assert "matplotlib" in str(e)
    else:
        raise AssertionError("render_animation ran without matplotlib")
    assert not os.path.exists(os.path.join(out, "r"))
    try:
        eval_model.main(["--env", "EnvEmptyNoWait2D", "--render_dir", out + "/renders"])
    except ImportError as e:
        assert "matplotlib" in str(e)
    else:
        raise AssertionError("--render_dir ran without matplotlib")
    from mmd_torch.costs.gp import sample_gp_prior
    from mmd_torch.envs.envs import make_env
    from mmd_torch.utils.flops import unet_forward_flops
    from mmd_torch.utils.profiling import compile_time_monitor, gpu_peak_flops
    from mmd_torch.utils.timer import TimerCuda
    from mmd_torch.viz.visualizer import sdf_field
    env = make_env("EnvConveyor2D", "cpu")
    with TimerCuda(device="cpu") as t, compile_time_monitor() as acc:
        assert sdf_field(env.scene, env.limits, 20).shape == (400,)
        g = torch.Generator().manual_seed(0)
        x0 = torch.zeros(4)
        assert sample_gp_prior(g, x0, x0 + 0.5, 16, 0.1, 3).shape == (3, 16, 4)
    assert t.elapsed > 0 and acc["compile_s"] == 0.0 and gpu_peak_flops("cpu") is None
    assert unet_forward_flops(model, 2, 64, 4) > 0
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
    # Without matplotlib the figures drawn as a side effect are skipped,
    # each with one line on stderr: the training summary's (one summary a
    # run of the two) and the successful trial's frame.
    err = proc.stderr.splitlines()
    assert sum("summary_trajectory_generation: figure skipped" in e for e in err) == 2, err
    assert sum("mmd_single_trial.png skipped" in e and "matplotlib" in e for e in err) == 1, err
    assert "the successful trial saved its result without a frame" in err


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
