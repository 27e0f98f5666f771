"""Data generation of the port against `mmd_tpu.datagen`.

- Host code is the JAX package's numpy code: the collision checker, the
  spline resample and the Python RRTs (same generator, same path) are held
  exactly, and so are the native RRTs (skipped where g++ cannot build
  `native/rrt.cpp`).
- GPMP2's residual and assembled Jacobian against `_whitened_residuals` and
  `jax.jacrev` of it, on JAX's SDF grids, at waypoints inside a box, in its
  margin, past a wall, on cell edges, where two walls tie, and on a scene
  whose two grids tie with a band of cells exactly at the margin (relu at
  0): within JAC_RTOL (1e-5) of the largest entry. The Jacobian comes out
  equal, entry for entry.
- 5 iterations of `gpmp2_optimize` at P = 2 against JAX's within ITER_RTOL
  (2e-6) of the largest entry: JAX's own result moves by 2.4e-7 of it
  under a 1e-7 relative change of its input, and the port sits at 2.2e-7
  (`test_gpmp2_iterations_match_jax` measures both and prints them). A
  particle whose factor fails is NaN in both.
- One context with the Python RRT, 2 trajectories and 3 iterations, against
  JAX's from the same seed: the same start, goal, skill and RRT seeds, so
  the same GPMP2 input; the result within CONTEXT_TOL (1e-5, measured
  ~5e-7).
- The linear generator's batch against JAX's on the same pairs (1e-6: the
  norm's rounding), and datasets saved by either package read by the other.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmd_tpu.datagen import generate as jgenerate
from mmd_tpu.datagen import gpmp2 as jgpmp2
from mmd_tpu.datagen import native_rrt as jnative
from mmd_tpu.datagen.host_collision import HostCollisionChecker as JChecker
from mmd_tpu.datagen.hybrid import smoothen_trajectory as jsmoothen
from mmd_tpu.datagen.rrt import InfRRTStar as JInfRRTStar, RRTConnect as JRRTConnect
from mmd_tpu.datagen.rrt import RRTStar as JRRTStar
from mmd_tpu.datagen.synthetic import _linear_batch as jlinear_batch
from mmd_tpu.datasets.trajectories import TrajectoryDataset as JDataset
from mmd_tpu.envs.envs import SceneData as JScene, make_env as jax_make_env
from mmd_tpu.envs.grid_sdf import GridSDF as JGrid
from mmd_torch.datagen import generate, gpmp2, native_rrt
from mmd_torch.datagen.host_collision import HostCollisionChecker
from mmd_torch.datagen.hybrid import hybrid_plan, smoothen_trajectory
from mmd_torch.datagen.rrt import IdentityPlanner, InfRRTStar, RRTConnect, RRTStar
from mmd_torch.datagen.synthetic import _linear_batch, generate_linear_dataset
from mmd_torch.datasets.trajectories import TrajectoryDataset, model_id
from mmd_torch.envs.envs import ENV_REGISTRY, make_env
from mmd_torch.tools import generate_data
from test_torch_diffusion import torch_scene

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, D = 64, 4
JAC_RTOL, ITER_RTOL, CONTEXT_TOL = 1e-5, 2e-6, 1e-5
MAPS = sorted(ENV_REGISTRY)


# ------------------------------------------------------------------ host code
@pytest.mark.parametrize("env_name", MAPS)
def test_host_checker_equals_jaxs(env_name):
    pts = np.random.default_rng(0).uniform(-1.1, 1.1, (512, 2)).astype(np.float32)
    ours = HostCollisionChecker(make_env(env_name, "cpu"), 0.05)
    theirs = JChecker(jax_make_env(env_name), 0.05)
    np.testing.assert_array_equal(ours.in_collision(pts), theirs.in_collision(pts))
    np.testing.assert_array_equal(ours.sdf(pts), theirs.sdf(pts))
    assert ours.margin == theirs.margin
    np.testing.assert_array_equal(ours.sample_free(np.random.default_rng(1), 300),
                                  theirs.sample_free(np.random.default_rng(1), 300))


@pytest.mark.parametrize("path", [
    [[-0.5, -0.5], [0.0, 0.3], [0.5, 0.5]],
    [[-0.8, 0.1], [0.7, -0.2]],
    [[-0.9, -0.9], [-0.2, 0.4], [0.1, 0.5], [0.6, 0.2], [0.8, 0.8]],
])
def test_smoothen_trajectory_equals_jaxs(path):
    path = np.asarray(path, np.float32)
    np.testing.assert_array_equal(smoothen_trajectory(path, H, 5.0 / H),
                                  jsmoothen(path, H, 5.0 / H))


@pytest.mark.parametrize("kind,env_name,start,goal", [
    ("connect", "EnvConveyor2D", (-0.8, -0.8), (0.8, 0.8)),
    ("star", "EnvHighways2D", (-0.5, -0.5), (0.5, 0.5)),
    ("informed", "EnvDropRegion2D", (-0.8, -0.1), (0.75, 0.1)),
])
def test_python_rrts_equal_jaxs(kind, env_name, start, goal):
    ours = HostCollisionChecker(make_env(env_name, "cpu"), 0.05)
    theirs = JChecker(jax_make_env(env_name), 0.05)
    port_cls, jax_cls = {"connect": (RRTConnect, JRRTConnect), "star": (RRTStar, JRRTStar),
                         "informed": (InfRRTStar, JInfRRTStar)}[kind]
    kw = dict(n_iters=300) if kind == "informed" else {}
    a = port_cls(ours, np.array(start), np.array(goal), rng=np.random.default_rng(7),
                 **kw).optimize()
    b = jax_cls(theirs, np.array(start), np.array(goal), rng=np.random.default_rng(7),
                **kw).optimize()
    assert a is not None and len(a) > 2
    np.testing.assert_array_equal(a, b)
    skill = np.array([[0.0, 0.0], [0.1, 0.1]], np.float32)
    np.testing.assert_array_equal(IdentityPlanner(skill).optimize(), skill)


@pytest.mark.skipif(not (native_rrt.native_available() and jnative.native_available()),
                    reason="g++ cannot build native/rrt.cpp")
@pytest.mark.parametrize("kind", ["connect", "star"])
def test_native_rrts_equal_jaxs(kind):
    ours = HostCollisionChecker(make_env("EnvConveyor2D", "cpu"), 0.05)
    theirs = JChecker(jax_make_env("EnvConveyor2D"), 0.05)
    port_cls, jax_cls = {"connect": (native_rrt.NativeRRTConnect, jnative.NativeRRTConnect),
                         "star": (native_rrt.NativeRRTStar, jnative.NativeRRTStar)}[kind]
    args = (np.array([-0.8, -0.8]), np.array([0.8, 0.8]))
    a = port_cls(ours, *args, seed=3).optimize()
    np.testing.assert_array_equal(a, jax_cls(theirs, *args, seed=3).optimize())
    assert native_rrt.LIBRARY.exists() and native_rrt.LIBRARY.parent.name == "native"


# --------------------------------------------------------------- GPMP2 algebra
def tied_scenes(env_name: str, margin: float):
    """JAX's scene of `env_name` with its object grid as both grids (every
    cell ties) and rows 190-209 (x in [-0.05, 0.05)) exactly at `margin`,
    for both packages."""
    js = jax_make_env(env_name).scene
    values = np.array(js.grid.values)
    values[190:210] = np.float32(margin)
    g = JGrid(lower=js.grid.lower, upper=js.grid.upper, values=jnp.asarray(values),
              grads=js.grid.grads)
    jscene = JScene(grid=g, extra_grid=g, ws_min=js.ws_min, ws_max=js.ws_max)
    return jscene, torch_scene(jscene)


def special_theta(seed: int) -> np.ndarray:
    """(H, 4) waypoints, free ones uniform, with: box centres, points in a
    box's margin, past and inside the walls' margin, on cell edges, where
    two walls tie (the corners), and in the tied band x = 0."""
    rng = np.random.default_rng(seed)
    th = np.concatenate([rng.uniform(-0.9, 0.9, (H, 2)), rng.normal(0, 0.1, (H, 2))],
                        -1).astype(np.float32)
    special = [[0.0, 0.0], [0.3, 0.35], [0.0, 0.09], [0.2, -0.33], [1.05, 0.3], [-1.2, 0.0],
               [0.5, 1.02], [1.0, 1.0], [-1.0, -1.0], [1.0, -1.0], [0.0, 0.6], [0.01, -0.7],
               [-0.04, 0.2]]
    edges = (np.float32(-1) + rng.integers(0, 401, (8, 2)).astype(np.float32)
             / np.float32(400) * np.float32(2))
    pts = np.concatenate([np.asarray(special, np.float32), edges])
    th[2:2 + len(pts), :2] = pts
    return th


SCENES = {"EnvConveyor2D": lambda m: (jax_make_env("EnvConveyor2D").scene,
                                      torch_scene(jax_make_env("EnvConveyor2D").scene)),
          "EnvEmptyNoWait2D": lambda m: (jax_make_env("EnvEmptyNoWait2D").scene,
                                         torch_scene(jax_make_env("EnvEmptyNoWait2D").scene)),
          "tied": lambda m: tied_scenes("EnvConveyor2D", m)}
START = np.array([-0.8, -0.02, 0.0, 0.0], np.float32)
GOAL = np.array([0.8, -0.02, 0.0, 0.0], np.float32)


@pytest.mark.parametrize("scene_name", sorted(SCENES))
def test_gpmp2_residual_and_jacobian_match_jax(scene_name):
    cfg = gpmp2.GPMP2Config()
    jscene, tscene = SCENES[scene_name](cfg.collision_margin)
    th = special_theta(4)
    jcfg = jgpmp2.GPMP2Config()

    def res(flat):
        return jgpmp2._whitened_residuals(flat.reshape(H, D), jscene, jnp.asarray(START),
                                          jnp.asarray(GOAL), jcfg)

    flat = jnp.asarray(th.reshape(-1))
    r_want, j_want = np.asarray(res(flat)), np.asarray(jax.jacrev(res)(flat))
    r, J = gpmp2.residuals_and_jacobian(torch.from_numpy(th)[None], tscene,
                                        torch.from_numpy(START), torch.from_numpy(GOAL), cfg)
    assert r.shape == (1, *r_want.shape) and J.shape == (1, *j_want.shape)
    assert np.abs(r[0].numpy() - r_want).max() <= JAC_RTOL * np.abs(r_want).max()
    assert np.abs(J[0].numpy() - j_want).max() <= JAC_RTOL * np.abs(j_want).max()
    # The cases are reached: active collision rows, walls tied at a corner,
    # and on the tied scene relus at exactly 0 (slope 0.5).
    coll = j_want[-(H - 1):]
    assert (np.abs(coll).sum(-1) > 0).sum() >= 5
    if scene_name == "tied":
        assert ((r_want[-(H - 1):] == 0) & (np.abs(coll).sum(-1) > 0)).any()


def straight_inits(P: int) -> np.ndarray:
    """P straight lines through the centre box, each a little off the last."""
    t = np.linspace(0, 1, H, dtype=np.float32)[:, None]
    pos = (1 - t) * START[:2] + t * GOAL[:2]
    base = np.concatenate([pos, np.zeros_like(pos)], -1)
    return np.stack([base + np.float32(0.013 * p) for p in range(P)]).astype(np.float32)


def test_gpmp2_iterations_match_jax():
    init = straight_inits(2)
    jscene = jax_make_env("EnvConveyor2D").scene
    jcfg = jgpmp2.GPMP2Config(opt_iters=5)

    def jax_run(x):
        return np.asarray(jgpmp2.gpmp2_optimize(jscene, jnp.asarray(START), jnp.asarray(GOAL),
                                                jnp.asarray(x), jcfg))

    want = jax_run(init)
    spread = np.abs(jax_run(init * np.float32(1 + 1e-7)) - want).max()
    got = gpmp2.gpmp2_optimize(torch_scene(jscene), torch.from_numpy(START),
                               torch.from_numpy(GOAL), torch.from_numpy(init),
                               gpmp2.GPMP2Config(opt_iters=5)).numpy()
    gap = np.abs(got - want).max()
    scale = np.abs(want).max()
    print(f"gpmp2 5 iterations: port - JAX {gap:.3e}, JAX's own spread {spread:.3e}, "
          f"largest entry {scale:.3f}")
    assert gap <= ITER_RTOL * scale


def test_failed_factor_gives_nan_as_jax():
    init = straight_inits(2)
    init[1, 10, 0] = np.nan
    jscene = jax_make_env("EnvConveyor2D").scene
    want = np.asarray(jgpmp2.gpmp2_optimize(jscene, jnp.asarray(START), jnp.asarray(GOAL),
                                            jnp.asarray(init), jgpmp2.GPMP2Config(opt_iters=2)))
    got = gpmp2.gpmp2_optimize(torch_scene(jscene), torch.from_numpy(START),
                               torch.from_numpy(GOAL), torch.from_numpy(init),
                               gpmp2.GPMP2Config(opt_iters=2)).numpy()
    assert np.isnan(want[1]).all() and np.isnan(got[1]).all()
    assert np.isfinite(got[0]).all()
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=ITER_RTOL * np.abs(want[0]).max())


def test_hybrid_plan_pins_the_ends_and_times_its_segments():
    scene = make_env("EnvConveyor2D", "cpu").scene
    checker = HostCollisionChecker(make_env("EnvConveyor2D", "cpu"), 0.05)
    start, goal = np.array([-0.8, -0.5], np.float32), np.array([0.8, 0.6], np.float32)
    timing = {}
    out = hybrid_plan(scene, [lambda: RRTConnect(checker, start, goal,
                                                 rng=np.random.default_rng(0))], 2, start, goal,
                      gpmp2.GPMP2Config(opt_iters=20), timing)
    assert out.shape == (2, H, D) and torch.isfinite(out).all() and timing["segments_s"] > 0
    np.testing.assert_allclose(out[:, 0, :2].numpy(), np.tile(start, (2, 1)), atol=1e-3)
    np.testing.assert_allclose(out[:, -1, :2].numpy(), np.tile(goal, (2, 1)), atol=1e-3)


# -------------------------------------------------------------- one context
@pytest.mark.parametrize("env_name", ["EnvConveyor2D", "EnvHighways2D"])
def test_one_context_matches_jax(env_name, monkeypatch):
    monkeypatch.setattr(jnative, "native_available", lambda: False)
    want = jgenerate.generate_context_trajectories(env_name, np.random.default_rng(3),
                                                   n_trajectories=2, gpmp_opt_iters=3)
    ctx = generate.generate_context_trajectories(env_name, np.random.default_rng(3),
                                                 n_trajectories=2, gpmp_opt_iters=3,
                                                 device="cpu", native=False)
    assert ctx.planner == "python" and ctx.n_planned == 2 and ctx.seconds >= ctx.segments_s
    assert ctx.trajs.shape == want.shape and len(want) > 0
    assert np.abs(ctx.trajs - want).max() <= CONTEXT_TOL


def test_generation_takes_the_native_rrt_where_it_builds():
    ctx = generate.generate_context_trajectories("EnvConveyor2D", np.random.default_rng(0),
                                                 n_trajectories=2, gpmp_opt_iters=2,
                                                 device="cpu")
    assert ctx.planner == ("native" if native_rrt.native_available() else "python")


# ------------------------------------------------------- linear data, files
def test_linear_batch_matches_jax():
    rng = np.random.default_rng(2)
    starts, goals = (rng.uniform(-0.9, 0.9, (16, 2)).astype(np.float32) for _ in range(2))
    dist = np.linalg.norm(goals - starts, axis=-1).astype(np.float32)
    for v in (np.full(16, 0.05, np.float32), dist / np.float32(H)):
        want = np.asarray(jlinear_batch(jnp.asarray(starts), jnp.asarray(goals), H,
                                        jnp.asarray(v)))
        got = _linear_batch(torch.from_numpy(starts), torch.from_numpy(goals), H,
                            torch.from_numpy(v)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_linear_dataset_and_files_cross_both_ways(tmp_path):
    ds = generate_linear_dataset("EnvEmptyNoWait2D", n_contexts=24, seed=1, device="cpu")
    assert ds.trajs.shape[1:] == (H, D) and 0 < ds.n_trajs <= 24
    trajs = ds.trajs.numpy()
    assert (np.linalg.norm(trajs[:, -1, :2] - trajs[:, 0, :2], axis=-1) > 1.0).all()
    ds.save(str(tmp_path / "port"))
    back = JDataset.load(str(tmp_path / "port"), model_id("EnvEmptyNoWait2D"))
    np.testing.assert_array_equal(np.asarray(back.trajs), trajs)
    JDataset(trajs[::-1].copy(), "EnvConveyor2D", duration=5.0).save(str(tmp_path / "jax"))
    ours = TrajectoryDataset.load_trajectories(str(tmp_path / "jax"), model_id("EnvConveyor2D"),
                                               device="cpu")
    np.testing.assert_array_equal(ours.trajs.numpy(), trajs[::-1])
    assert ours.env_name == "EnvConveyor2D" and ours.duration == 5.0


def test_generate_data_cli_writes_a_dataset_both_packages_read(tmp_path):
    proc = subprocess.run([sys.executable, "-m", "mmd_torch.tools.generate_data", "--env",
                           "EnvConveyor2D", "--contexts", "2", "--trajs_per_context", "2",
                           "--gpmp_iters", "3", "--device", "cpu", "--out", str(tmp_path)],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "saved" in proc.stdout and "RRT + GPMP2" in proc.stdout
    mid = model_id("EnvConveyor2D")
    ours = TrajectoryDataset.load_trajectories(str(tmp_path), mid, device="cpu")
    theirs = JDataset.load(str(tmp_path), mid)
    np.testing.assert_array_equal(ours.trajs.numpy(), np.asarray(theirs.trajs))
    assert ours.trajs.shape[1:] == (H, D)


@pytest.mark.parametrize("out", ["data_trajectories", "data_trajectories_vd/x",
                                 "./data_trajectories_h128", "mmd_tpu/../data_trajectories"])
def test_generate_data_cli_refuses_the_committed_datasets(out, monkeypatch):
    monkeypatch.chdir(ROOT)
    with pytest.raises(SystemExit, match="refusing"):
        generate_data.main(["--env", "EnvEmpty2D", "--contexts", "1", "--device", "cpu",
                            "--out", out])


def test_generate_data_cli_saves_under_build_by_default(monkeypatch):
    saved = []

    class Saved:
        n_trajs = 1

        def save(self, out):
            saved.append(out)

    monkeypatch.chdir(ROOT)
    monkeypatch.setattr("mmd_torch.datagen.synthetic.generate_linear_dataset",
                        lambda *a, **k: Saved())
    assert generate_data.main(["--env", "EnvEmpty2D", "--contexts", "1", "--device", "cpu"]) == 0
    assert saved == [os.path.join(ROOT, "build", "data_trajectories")]
    assert not generate_data.committed_data_dir(saved[0])
