"""Model evaluation of the port against the JAX package.

- Each map's hooks (`get_skill_pos_seq_l` from one `np.random.Generator`,
  `compute_traj_data_adherence` on fixed paths, the data-generation gate)
  equal JAX's exactly: they are the same numpy code.
- The rejection sampler's filter, given JAX's candidates, gives JAX's free
  mask exactly; `random_coll_free_q` draws from a `torch.Generator`, so its
  configurations are its own (the evaluation's rates are compared with
  MODEL_EVAL.yaml's as rates, not task by task).
- `flat_yaml`'s row lists read and write `MODEL_EVAL.yaml` byte for byte as
  PyYAML does.
- The eval CLI prints the row and writes only `--out_yaml`.
"""
import hashlib
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from mmd_tpu.envs.envs import _densify as jdensify, make_env as jax_make_env
from mmd_tpu.tasks.task import _sample_coll_free as jsample, make_task as jax_make_task
from mmd_torch.datasets.trajectories import model_id
from mmd_torch.envs.envs import ENV_REGISTRY, _densify, make_env
from mmd_torch.experiments.trial import ModelRegistry
from mmd_torch.io.flat_yaml import dumps_rows, load_rows, loads_rows
from mmd_torch.tasks import task as task_module
from mmd_torch.tasks.task import make_task, waypoint_in_collision
from mmd_torch.tools.eval_model import model_name

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAPS = sorted(ENV_REGISTRY)
MODEL_EVAL = os.path.join(ROOT, "MODEL_EVAL.yaml")


def paths():
    """Fixed (64, 2) paths that reach every map's adherence branches."""
    t = np.linspace(0.0, 1.0, 64, dtype=np.float32)[:, None]
    line = (1 - t) * np.array([-0.8, -0.6], np.float32) + t * np.array([0.7, 0.8], np.float32)
    bottom = (1 - t) * np.array([-0.7, -0.2], np.float32) + t * np.array([0.7, -0.2],
                                                                             np.float32)
    top = bottom[::-1] * np.array([1, -1], np.float32)
    angle = np.linspace(-np.pi, 0.4 * np.pi, 64, dtype=np.float32)
    ring = 0.6 * np.stack([np.cos(angle), np.sin(angle)], -1)
    dwell = np.concatenate([np.tile([[0.4, 0.75]], (20, 1)), line[20:]]).astype(np.float32)
    noisy = np.random.default_rng(0).uniform(-0.9, 0.9, (64, 2)).astype(np.float32)
    return {"line": line, "bottom": bottom, "top": top, "ring": ring, "cw ring": ring[::-1],
            "dwell": dwell, "noisy": noisy, "still": np.zeros((64, 2), np.float32)}


@pytest.mark.parametrize("env_name", MAPS)
def test_skills_equal_jaxs(env_name):
    ours, theirs = make_env(env_name, "cpu"), jax_make_env(env_name)
    for start, goal in [((-0.5, -0.6), (0.5, 0.5)), ((0.6, 0.4), (0.4, 0.6)),
                        ((-0.55, 0.5), (-0.5, -0.45))]:
        rng_a, rng_b = np.random.default_rng(9), np.random.default_rng(9)
        a = ours.get_skill_pos_seq_l(start_pos=np.array(start), goal_pos=np.array(goal),
                                     rng=rng_a)
        b = theirs.get_skill_pos_seq_l(start_pos=np.array(start), goal_pos=np.array(goal),
                                       rng=rng_b)
        assert (a is None) == (b is None)
        if a is not None:
            assert len(a) == len(b)
            for x, y in zip(a, b):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
        assert rng_a.random() == rng_b.random()  # the same draws were taken
        assert (ours.is_start_goal_valid_for_data_gen(np.array(start), np.array(goal))
                == theirs.is_start_goal_valid_for_data_gen(np.array(start), np.array(goal)))
    np.testing.assert_array_equal(
        _densify(np.array([[0, 0], [1, 0], [1, 1]], np.float32), 10),
        jdensify(np.array([[0, 0], [1, 0], [1, 1]], np.float32), 10))


@pytest.mark.parametrize("env_name", MAPS)
def test_adherence_equals_jaxs(env_name):
    ours, theirs = make_env(env_name, "cpu"), jax_make_env(env_name)
    scores = {}
    for name, path in paths().items():
        a = ours.compute_traj_data_adherence(path)
        assert a == theirs.compute_traj_data_adherence(path), name
        scores[name] = a
    if env_name != "Env2D":
        assert len(set(scores.values())) >= 2  # the paths reach both outcomes


@pytest.mark.parametrize("env_name", MAPS)
def test_filter_on_jaxs_candidates_gives_jaxs_mask(env_name):
    jtask = jax_make_task(env_name)
    qs, free = jsample(jtask.scene, jax.random.PRNGKey(len(env_name)), jtask.robot.radius,
                       jtask.robot.q_min, jtask.robot.q_max, n_candidates=2048)
    ours = ~waypoint_in_collision(make_env(env_name, "cpu").scene,
                                  torch.from_numpy(np.array(qs)),
                                  make_task(env_name, "cpu").robot.radius)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(free))
    assert 0 < np.asarray(free).sum() <= 2048


def test_random_coll_free_q_draws_free_configurations_from_its_generator(monkeypatch):
    task = make_task("EnvConveyor2D", "cpu")
    one = task.random_coll_free_q(torch.Generator().manual_seed(0))
    many = task.random_coll_free_q(torch.Generator().manual_seed(0), n_samples=700)
    assert one.shape == (2,) and many.shape == (700, 2) and many.dtype == np.float32
    np.testing.assert_array_equal(one, many[0])
    assert not task.compute_collision(torch.from_numpy(many)).any()
    assert ((many >= -1) & (many <= 1)).all()
    seen = []

    def never_free(scene, generator, radius, q_min, q_max, n_candidates=1024):
        seen.append(n_candidates)
        qs = task_module.draw_candidates(generator, n_candidates, q_min, q_max)
        return qs, torch.zeros(n_candidates, dtype=torch.bool)

    monkeypatch.setattr(task_module, "_sample_coll_free", never_free)
    with pytest.raises(RuntimeError):
        task.random_coll_free_q(torch.Generator().manual_seed(0), n_samples=1500)
    assert seen == [3072] * 8  # 1024 * ceil(2 * 1500 / 1024), max_tries tries


def test_model_eval_yaml_reads_and_writes_as_pyyaml():
    with open(MODEL_EVAL) as f:
        text = f.read()
    rows = loads_rows(text)
    assert rows == yaml.safe_load(text) and len(rows) == 20
    assert dumps_rows(rows) == text
    assert load_rows(MODEL_EVAL) == rows


@pytest.mark.parametrize("rows", [
    [],
    [{"model": "EnvX-Robot+bf16+ddim3", "adherence": None, "n_tasks": 2, "plan_time": 1e-05}],
    [{"variant": "a long note " * 12, "model": "m"}, {"variant": "it's 'quoted': " * 8}],
    [{"variant": "1.5", "model": "#x", "fraction_free": float("inf"), "ok": True}],
])
def test_row_lists_round_trip_as_pyyaml(rows):
    text = dumps_rows(rows)
    assert text == yaml.safe_dump(rows)
    assert loads_rows(text) == yaml.safe_load(text) == rows


@pytest.mark.parametrize("text", ["- a:\n    b: 1\n", "a: 1\n", "- - 1\n", "- a: [1]\n"])
def test_row_reader_refuses_other_yaml(text):
    with pytest.raises(ValueError):
        loads_rows(text)


def test_row_names_follow_the_jax_script():
    mid = model_id("EnvConveyor2D")
    assert model_name(mid, False, "ddpm", 0) == mid
    assert model_name(mid, True, "ddpm", 0) == mid + "+bf16"
    assert model_name(mid, True, "ddim", 0) == mid + "+bf16+ddim"
    assert model_name(mid, False, "ddim", 10) == mid + "+ddim10"
    assert model_name(mid, True, "ddim", 0, tag="vd+bf16") == mid + "+vd+bf16"


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_eval_cli_prints_the_row_and_writes_only_out_yaml(tmp_path):
    before = _digest(MODEL_EVAL), sorted(os.listdir(ROOT))
    out = tmp_path / "rows.yaml"
    with open(MODEL_EVAL) as f:
        out.write_text(f.read())
    cmd = [sys.executable, "-m", "mmd_torch.tools.eval_model", "--env", "EnvEmptyNoWait2D",
           "--n_tasks", "2", "--n_samples", "8", "--device", "cpu", "--out_yaml", str(out)]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "model EnvEmptyNoWait2D-RobotPlanarDisk over 2 tasks:" in proc.stdout
    assert "fraction_free:" in proc.stdout and "plan_time:" in proc.stdout
    rows = yaml.safe_load(out.read_text())
    old = yaml.safe_load(open(MODEL_EVAL).read())
    mid = "EnvEmptyNoWait2D-RobotPlanarDisk"
    assert rows[:-1] == [r for r in old if r["model"] != mid]
    row = rows[-1]
    assert row["model"] == mid and row["n_tasks"] == 2 and row["success_rate"] == 1.0
    assert 0.0 <= row["fraction_free"] <= 1.0 and 0.0 <= row["adherence"] <= 1.0
    assert (_digest(MODEL_EVAL), sorted(os.listdir(ROOT))) == before
    # --render_dir is ported (tests/test_torch_viz.py writes its renders);
    # where matplotlib is missing (hidden here) it raises ImportError before
    # any plan, and writes nothing.
    hidden = ("import runpy, sys; sys.modules['matplotlib'] = None; sys.argv = sys.argv[1:]; "
              "runpy.run_module('mmd_torch.tools.eval_model', run_name='__main__')")
    refused = subprocess.run([sys.executable, "-c", hidden, "eval_model"] + cmd[3:5]
                             + ["--render_dir", str(tmp_path / "r")], cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
    assert refused.returncode != 0 and "ImportError" in refused.stderr
    assert "rendering needs matplotlib" in refused.stderr
    assert not (tmp_path / "r").exists()


def test_registry_falls_back_to_linear_data(tmp_path, capsys):
    registry = ModelRegistry(os.path.join(ROOT, "data_trained_models"), tmp_path, device="cpu")
    _, _, dataset = registry.get(model_id("EnvEmptyNoWait2D"))
    assert "generating 256 contexts of linear data" in capsys.readouterr().out
    assert dataset.n_trajs > 0 and dataset.trajs.shape[1:] == (64, 4)
    loaded = ModelRegistry(device="cpu").get(model_id("EnvEmptyNoWait2D"))[2]
    torch.testing.assert_close(dataset.normalizer.mins, loaded.normalizer.mins)
    torch.testing.assert_close(dataset.trajs_normalized,
                               loaded.normalizer.normalize(dataset.trajs))
