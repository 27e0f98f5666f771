"""Guide gradient of the port against `mmd_tpu.costs.guide.guide_gradient`.

Both sides get the same normalized trajectories, the same SDF grids (the
JAX-built arrays) and the same constraint sets. Tolerance: atol 1e-6 on a
step whose entries are at most ~0.1 (weights 2e-2..2e-1 on gradients
clipped to norm 1); the two sides differ only in float32 rounding order.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmd_tpu.common.constraints import MultiPointConstraint
from mmd_tpu.costs import constraints as jcons
from mmd_tpu.costs import gp as jgp
from mmd_tpu.costs.guide import GuideConfig as JGuideConfig, GuideData as JGuideData
from mmd_tpu.costs.guide import guide_gradient as jax_guide_gradient
from mmd_tpu.datasets.normalization import LimitsNormalizer as JNormalizer
from mmd_tpu.envs.envs import make_env as jax_make_env
from mmd_torch.costs import constraints as tcons
from mmd_torch.costs import gp as tgp
from mmd_torch.costs.guide import GuideConfig, GuideData, guide_gradient
from mmd_torch.datasets.normalization import LimitsNormalizer
from mmd_torch.envs.envs import SceneData
from mmd_torch.envs.grid_sdf import GridSDF
from mmd_torch.io.flat_yaml import load_flat_yaml

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-6


def torch_scene(scene) -> SceneData:
    def grid(g):
        return GridSDF(lower=tuple(np.asarray(g.lower).tolist()),
                       upper=tuple(np.asarray(g.upper).tolist()),
                       values=torch.from_numpy(np.array(g.values)),
                       grads=torch.from_numpy(np.array(g.grads)))
    return SceneData(grid=grid(scene.grid), extra_grid=grid(scene.extra_grid),
                     ws_min=torch.from_numpy(np.array(scene.ws_min)),
                     ws_max=torch.from_numpy(np.array(scene.ws_max)))


def limits(env_name):
    info = load_flat_yaml(os.path.join(ROOT, "data_trained_models",
                                       f"{env_name}-RobotPlanarDisk", "args.yaml"))
    return info["normalizer_mins"], info["normalizer_maxs"]


def some_constraints():
    return [
        MultiPointConstraint(q_l=[np.array([0.0, 0.1]), np.array([0.3, -0.2])],
                             t_range_l=[(10, 30), (20, 40)], radius_l=[0.3, 0.2]),
        MultiPointConstraint(q_l=[np.array([-0.4, 0.0])], t_range_l=[(0, 64)],
                             radius_l=[0.5], is_soft=True),
        MultiPointConstraint(q_l=[np.array([0.5, 0.5]), np.array([0.6, 0.4]),
                                  np.array([0.1, -0.7])],
                             t_range_l=[(5, 6), (6, 7), (30, 50)]),
    ]


def trajectories(seed, B=8, H=64):
    """Normalized trajectories: wavy paths across the map with noise, a few
    entries beyond [-1, 1] so that unnormalize clips."""
    rng = np.random.default_rng(seed)
    s = np.linspace(-1.0, 1.0, H, dtype=np.float32)
    x = np.zeros((B, H, 4), np.float32)
    for b in range(B):
        a = rng.uniform(0, np.pi)
        x[b, :, 0] = np.cos(a) * s + 0.2 * np.sin(3 * s + b)
        x[b, :, 1] = np.sin(a) * s + 0.2 * np.cos(2 * s - b)
    x[..., 2:] = rng.uniform(-1.0, 1.0, (B, H, 2))
    x += rng.normal(0, 0.05, x.shape).astype(np.float32)
    x[0, 5] = [1.3, -1.2, 1.5, -1.5]
    return x


@pytest.mark.parametrize("env_name", ["EnvEmptyNoWait2D", "EnvConveyor2D"])
@pytest.mark.parametrize("with_constraints", [False, True], ids=["empty", "constraints"])
def test_guide_gradient_matches_jax(env_name, with_constraints):
    jscene = jax_make_env(env_name).scene
    mins, maxs = limits(env_name)
    cons = some_constraints() if with_constraints else []
    K, P = (4, 4) if cons else (4, 1)
    jcset = (jcons.pack_constraint_set(cons, K, P) if cons
             else jcons.empty_constraint_set(K, P))
    tcset = (tcons.pack_constraint_set(cons, K, P, device="cpu") if cons
             else tcons.empty_constraint_set(K, P, device="cpu"))
    x = trajectories(len(env_name) + len(cons))

    want = jax_guide_gradient(
        jnp.asarray(x), JGuideData(scene=jscene, normalizer=JNormalizer.from_limits(mins, maxs),
                                   constraints=jcset), JGuideConfig())
    got = guide_gradient(
        torch.from_numpy(x), GuideData(scene=torch_scene(jscene),
                                       normalizer=LimitsNormalizer.from_limits(mins, maxs, "cpu"),
                                       constraints=tcset), GuideConfig())
    want = np.asarray(want)
    assert np.abs(want).max() > 1e-3  # the costs are active
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    assert not got[:, 0].any() and not got[:, -1].any()


def test_conveyor_collision_cost_is_active():
    """The Conveyor trajectories above cross obstacles, so the grid lookup
    feeds the guide a non-zero gradient there (and none on the empty map)."""
    x = torch.from_numpy(trajectories(0))
    out = {}
    for env_name in ("EnvEmptyNoWait2D", "EnvConveyor2D"):
        mins, maxs = limits(env_name)
        gd = GuideData(scene=torch_scene(jax_make_env(env_name).scene),
                       normalizer=LimitsNormalizer.from_limits(mins, maxs, "cpu"),
                       constraints=tcons.empty_constraint_set(4, 1, device="cpu"))
        no_collision = dataclasses.replace(GuideConfig(), weight_collision=0.0)
        out[env_name] = (guide_gradient(x, gd, GuideConfig())
                         - guide_gradient(x, gd, no_collision)).abs().max()
    assert out["EnvConveyor2D"] > 1e-3 and out["EnvEmptyNoWait2D"] < out["EnvConveyor2D"]


def test_constraint_costs_match_jax():
    cons = some_constraints()
    jcset = jcons.pack_constraint_set(cons, 4, 4)
    tcset = tcons.pack_constraint_set(cons, 4, 4, device="cpu")
    assert tcset.n_active == 3
    q = trajectories(3)[..., :2]
    for k in range(4):
        want = np.asarray(jcons.constraint_cost_single(jnp.asarray(q), jcset, k))
        got = tcons.constraint_cost_single(torch.from_numpy(q), tcset, k).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_soft_path_cost_matches_jax():
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1, 1, (4, 64, 2)).astype(np.float32)
    mask = (rng.uniform(size=(4, 64)) < 0.5).astype(np.float32)
    q = trajectories(5)[..., :2]
    jspc = jcons.SoftPathConstraints(points=jnp.asarray(pts), mask=jnp.asarray(mask),
                                     radius=jnp.asarray(0.3), weight=jnp.asarray(0.02))
    tspc = tcons.SoftPathConstraints(points=torch.from_numpy(pts), mask=torch.from_numpy(mask),
                                     radius=torch.tensor(0.3), weight=torch.tensor(0.02))
    np.testing.assert_allclose(tcons.soft_path_cost(torch.from_numpy(q), tspc).numpy(),
                               np.asarray(jcons.soft_path_cost(jnp.asarray(q), jspc)),
                               rtol=1e-5)


def test_gp_cost_and_gradient_match_jax():
    u = trajectories(6)
    dt = 5.0 / 64
    want = np.asarray(jgp.gp_trajectory_cost(jnp.asarray(u), dt))
    want_g = np.asarray(jax.grad(lambda v: jgp.gp_trajectory_cost(v, dt).sum())(jnp.asarray(u)))
    x = torch.from_numpy(u).requires_grad_(True)
    got = tgp.gp_trajectory_cost(x, dt)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), want_g, rtol=1e-5, atol=1e-2)
