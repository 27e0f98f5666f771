"""Classification, interpolation, smoothing and metrics of the port against JAX.

classify_trajs compares booleans, so it must agree exactly on the JAX-built
grids (its interpolation weights i/6 may round differently from
jnp.linspace's, by ~1e-7, which only matters for a point within 1e-7 of
the margin; the data here has none). The float helpers are held to 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmd_tpu.envs.envs import make_env as jax_make_env
from mmd_tpu.tasks import task as jtask
from mmd_tpu.utils import interp as jinterp
from mmd_tpu.utils import metrics as jmetrics
from mmd_torch.envs.envs import SceneData
from mmd_torch.envs.grid_sdf import GridSDF
from mmd_torch.tasks import task as ttask
from mmd_torch.utils import interp as tinterp
from mmd_torch.utils import metrics as tmetrics

torch.set_num_threads(1)


def torch_scene(scene) -> SceneData:
    def grid(g):
        return GridSDF(lower=tuple(np.asarray(g.lower).tolist()),
                       upper=tuple(np.asarray(g.upper).tolist()),
                       values=torch.from_numpy(np.array(g.values)),
                       grads=torch.from_numpy(np.array(g.grads)))
    return SceneData(grid=grid(scene.grid), extra_grid=grid(scene.extra_grid),
                     ws_min=torch.from_numpy(np.array(scene.ws_min)),
                     ws_max=torch.from_numpy(np.array(scene.ws_max)))


def trajs(seed, B=32, H=64):
    rng = np.random.default_rng(seed)
    a, b = rng.uniform(-1.02, 1.02, (2, B, 1, 2)).astype(np.float32)
    s = np.linspace(0, 1, H, dtype=np.float32)[None, :, None]
    pos = a * (1 - s) + b * s + rng.normal(0, 0.02, (B, H, 2)).astype(np.float32)
    vel = rng.normal(0, 0.1, (B, H, 2)).astype(np.float32)
    return np.concatenate([pos, vel], -1)


@pytest.mark.parametrize("env_name", ["EnvEmptyNoWait2D", "EnvConveyor2D",
                                      "EnvHighways2D", "EnvDropRegion2D"])
def test_classify_trajs_matches_jax(env_name):
    scene = jax_make_env(env_name).scene
    x = trajs(len(env_name))
    lo, hi = np.array([-1.0, -1.0], np.float32), np.array([1.0, 1.0], np.float32)
    j_free, j_wp = jtask.classify_trajs(scene, jnp.asarray(x), 0.05, jnp.asarray(lo),
                                        jnp.asarray(hi))
    t_free, t_wp = ttask.classify_trajs(torch_scene(scene), torch.from_numpy(x), 0.05,
                                        torch.from_numpy(lo), torch.from_numpy(hi))
    np.testing.assert_array_equal(t_wp.numpy(), np.asarray(j_wp))
    np.testing.assert_array_equal(t_free.numpy(), np.asarray(j_free))
    assert 0 < t_free.sum() < len(x) or env_name == "EnvEmptyNoWait2D"


def test_boundary_distances_and_object_sdf_match_jax():
    scene = jax_make_env("EnvConveyor2D").scene
    q = np.random.default_rng(0).uniform(-1.2, 1.2, (50, 2)).astype(np.float32)
    ts = torch_scene(scene)
    np.testing.assert_allclose(
        ttask.boundary_signed_distances(ts, torch.from_numpy(q)).numpy(),
        np.asarray(jtask.boundary_signed_distances(scene, jnp.asarray(q))), atol=1e-6)
    np.testing.assert_array_equal(
        ttask.scene_object_sdf(ts, torch.from_numpy(q)).numpy(),
        np.asarray(jtask.scene_object_sdf(scene, jnp.asarray(q))))


@pytest.mark.parametrize("k", [0, 1, 5])
def test_interpolate_traj_via_points_matches_jax(k):
    x = trajs(k, B=3)
    np.testing.assert_allclose(tinterp.interpolate_traj_via_points(torch.from_numpy(x), k).numpy(),
                               np.asarray(jinterp.interpolate_traj_via_points(jnp.asarray(x), k)),
                               rtol=0, atol=1e-6)


def test_interpolate_points_matches_jax():
    """Source coordinates run to H-1 = 63, where a float32 ulp is 3.8e-6:
    torch.linspace and jnp.linspace may round them apart by that much, so the
    lerp weights may differ by ~4e-6 (times a segment's length, < 1)."""
    x = trajs(1, B=3)
    np.testing.assert_allclose(tinterp.interpolate_points(torch.from_numpy(x), 96).numpy(),
                               np.asarray(jinterp.interpolate_points(jnp.asarray(x), 96)),
                               rtol=0, atol=1e-5)


def test_savgol_matrix_matches_jax():
    np.testing.assert_array_equal(tinterp.savgol_matrix(64), jinterp.savgol_matrix(64))


@pytest.mark.parametrize("name", ["compute_path_length", "compute_smoothness",
                                  "compute_average_acceleration",
                                  "compute_variance_waypoints"])
def test_metrics_match_jax(name):
    x = trajs(2, B=8)
    np.testing.assert_allclose(getattr(tmetrics, name)(torch.from_numpy(x)).numpy(),
                               np.asarray(getattr(jmetrics, name)(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)
