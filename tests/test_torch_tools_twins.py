"""The port's twins of four JAX scripts (`mmd_torch.tools.
augment_velocity_diversity`, `visualize_trajectories`, `train_flagship`,
`summarize_lowdens`) against the scripts themselves on the same inputs."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from matplotlib import image as mpimg

from mmd_tpu.datasets.trajectories import TrajectoryDataset as JaxDataset
from mmd_tpu.experiments import experiments as jexp
from mmd_tpu.experiments.status import TrialSuccessStatus as JStatus
from mmd_tpu.train.trainer import load_checkpoint as jax_load_checkpoint
from mmd_torch.datasets.trajectories import TrajectoryDataset, model_id
from mmd_torch.experiments import experiments
from mmd_torch.experiments.status import TrialSuccessStatus
from mmd_torch.tools import (
    augment_velocity_diversity,
    summarize_lowdens,
    train_flagship,
    visualize_trajectories,
)
from mmd_torch.train.checkpoint import load_checkpoint

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import augment_velocity_diversity as jaugment  # noqa: E402  (the JAX package's script)

ENV = "EnvConveyor2D"
MID = model_id(ENV)
ENV_JAX = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": ROOT}


@pytest.fixture(scope="module")
def small_data(tmp_path_factory):
    """24 of the committed Conveyor trajectories, saved as a dataset."""
    root = tmp_path_factory.mktemp("data")
    ds = TrajectoryDataset.load_trajectories(os.path.join(ROOT, "data_trajectories"), MID,
                                             device="cpu")
    TrajectoryDataset.from_trajs(ds.trajs[:24].numpy(), ENV, device="cpu").save(str(root))
    return str(root)


@pytest.mark.parametrize("variants,seed", [(3, 0), (4, 5)])
def test_augment_gives_jaxs_arrays(small_data, variants, seed, capsys):
    trajs = np.load(os.path.join(small_data, MID, "trajs-free.npz"))["trajs"]
    got = augment_velocity_diversity.augment(trajs, 5.0, variants, 2.8, (8, 16, 24), seed)
    want = jaugment.augment(trajs, 5.0, variants, 2.8, (8, 16, 24), seed)
    assert got.dtype == want.dtype and got.shape == (24 * (variants + 1), 64, 4)
    np.testing.assert_array_equal(got, want)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1] and out[0].startswith("augmented 24 -> ")


def test_augment_cli_writes_a_dataset_both_packages_read(small_data, tmp_path):
    out = tmp_path / "vd"
    assert augment_velocity_diversity.main(["--env", ENV, "--data_dir", small_data,
                                            "--out_dir", str(out)]) == 0
    trajs = np.load(os.path.join(small_data, MID, "trajs-free.npz"))["trajs"]
    want = jaugment.augment(trajs, 5.0, 3, 2.8, (8, 16, 24), 0)
    port = TrajectoryDataset.load_trajectories(str(out), MID, device="cpu")
    jax_ds = JaxDataset.load(str(out), MID)
    np.testing.assert_array_equal(port.trajs.numpy(), want)
    np.testing.assert_array_equal(np.asarray(jax_ds.trajs), want)
    assert jax_ds.env_name == ENV and port.duration == 5.0
    with pytest.raises(SystemExit, match="refusing"):
        augment_velocity_diversity.main(["--env", ENV, "--data_dir", small_data,
                                         "--out_dir", os.path.join(ROOT, "data_trajectories_vd")])


def _results(root, package, planning_times):
    """Result pickles of one sweep, written by `package`'s classes."""
    exp, status = ((jexp, JStatus) if package == "jax" else (experiments, TrialSuccessStatus))
    k = 0
    for (n, planner), times in planning_times.items():
        for i, t in enumerate(times):
            tc = exp.MultiAgentPlanningSingleTrialConfig(
                num_agents=n, multi_agent_planner_class=planner, trial_number=i)
            r = exp.MultiAgentPlanningSingleTrialResult(
                trial_config=tc, planning_time=t, jit_compile_time=0.25 * (i == 0),
                num_ct_expansions=i + n,
                success_status=status.SUCCESS if i % 3 else status.FAIL_RUNTIME_LIMIT)
            r.save(os.path.join(root, f"{n}", planner, f"{k}"))
            k += 1


def test_summarize_lowdens_prints_jaxs_lines(tmp_path):
    times = {(4, "XECBS"): [1.5, 2.25, 0.75], (4, "ECBS"): [3.0, 1.0],
             (10, "XECBS"): [4.5, 5.5, 6.0, 2.0]}
    _results(str(tmp_path / "jax"), "jax", times)
    _results(str(tmp_path / "port"), "port", times)
    want = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "summarize_lowdens.py"),
                           str(tmp_path / "jax")], capture_output=True, text=True, env=ENV_JAX,
                          timeout=120, check=True).stdout.splitlines()
    assert len(want) == 3
    assert summarize_lowdens.summary_lines(str(tmp_path / "port")) == want
    with pytest.raises(ValueError, match="not written by the port"):
        summarize_lowdens.summary_lines(str(tmp_path / "jax"))


def test_visualize_trajectories_writes_jaxs_renders(small_data, tmp_path, capsys):
    args = ["--env", ENV, "--data_dir", small_data, "--n", "12", "--n_animate", "2"]
    assert visualize_trajectories.main(args + ["--out", str(tmp_path / "port")]) == 0
    printed = capsys.readouterr().out
    jax_out = subprocess.run([sys.executable, os.path.join(ROOT, "scripts",
                                                           "visualize_trajectories.py"),
                              *args, "--out", str(tmp_path / "jax")], capture_output=True,
                             text=True, env=ENV_JAX, timeout=300, check=True).stdout
    assert printed.replace(str(tmp_path / "port"), "") == jax_out.replace(str(tmp_path / "jax"),
                                                                          "")
    files = ["joint_space.png", "robot-traj.gif", "trajectories.png"]
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == files
    for name in files[::2]:
        assert np.array_equal(mpimg.imread(tmp_path / "port" / name),
                              mpimg.imread(tmp_path / "jax" / name)), name


def test_train_flagship_writes_a_checkpoint_both_packages_read(tmp_path, capsys):
    argv = ["--steps", "4", "--contexts", "16", "--out", str(tmp_path / "models"),
            "--data_out", str(tmp_path / "data"), "--device", "cpu", "--log_every", "2"]
    assert train_flagship.main(argv) == 0
    mid = model_id("EnvEmptyNoWait2D")
    model_dir = tmp_path / "models" / mid
    assert "saved checkpoint to" in capsys.readouterr().out
    model, _, info = load_checkpoint(str(model_dir), device="cpu")
    jmodel, jparams, _, jinfo = jax_load_checkpoint(str(model_dir))
    assert info["step"] == jinfo["step"] == 4
    assert (info["unet_input_dim"], list(info["dim_mults"])) == (32, [1, 2, 4])
    x = np.random.default_rng(0).standard_normal((2, 64, 4)).astype(np.float32)
    t = np.array([0, 20], np.int64)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    want = np.asarray(jmodel.apply(jparams, jnp.asarray(x), jnp.asarray(t)))
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)
    assert JaxDataset.load(str(tmp_path / "data"), mid).n_trajs > 0
    with pytest.raises(SystemExit, match="refusing"):
        train_flagship.main(["--out", os.path.join(ROOT, "data_trained_models")])
