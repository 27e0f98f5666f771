"""The cost zoo, the guide's optional knobs and the task-level cost and
occupancy queries of the port against the JAX package.

Inputs come from seeded numpy and go to both sides; the scenes are the
JAX-built grids (`torch_scene`), since the port's own grids differ from
JAX's on a few tie-line cells (tests/test_torch_grid_sdf.py).

Tolerances:
- zoo costs and their gradients: rtol 1e-6 (float32 sums in another
  order; the CHOMP cost reaches 1.5e7, so relative);
- the guide step: atol 1e-6, as tests/test_torch_guide.py holds it (its
  entries are at most ~0.1: weights on gradients clipped to norm 1);
- the SDF queries, the occupancy grids and the densified paths: exact
  (the same float32 operations on the same cells).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmd_tpu.common import trajectory_utils as jtu
from mmd_tpu.costs import constraints as jcons
from mmd_tpu.costs import zoo as jzoo
from mmd_tpu.costs.guide import GuideConfig as JGuideConfig, GuideData as JGuideData
from mmd_tpu.costs.guide import guide_gradient as jax_guide_gradient
from mmd_tpu.datasets.normalization import LimitsNormalizer as JNormalizer
from mmd_tpu.envs.envs import SceneData as JScene, make_env as jax_make_env
from mmd_tpu.envs.occupancy import build_occupancy_map as jax_build_occupancy_map
from mmd_tpu.tasks import task as jtask
from mmd_tpu.utils import interp as jinterp
from mmd_torch.common import trajectory_utils as ttu
from mmd_torch.costs import constraints as tcons
from mmd_torch.costs import guide as tguide
from mmd_torch.costs import zoo
from mmd_torch.costs.guide import GuideConfig, GuideData, guide_gradient
from mmd_torch.datasets.normalization import LimitsNormalizer
from mmd_torch.envs.envs import ENV_REGISTRY, make_env
from mmd_torch.envs.occupancy import build_occupancy_map
from mmd_torch.tasks import task as ttask
from mmd_torch.utils import interp as tinterp
from test_torch_guide import limits, torch_scene, trajectories

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-6
DT = 5.0 / 64.0


def _states(seed, shape=(3, 64, 4), scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _value_and_grad(jax_fn, torch_fn, x):
    import jax

    jv, jg = jax.value_and_grad(lambda v: jax_fn(v).sum())(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_(True)
    tv = torch_fn(t)
    (tg,) = torch.autograd.grad(tv.sum(), t)
    return (np.asarray(jax_fn(jnp.asarray(x))), np.asarray(jg)), (tv.detach().numpy(), tg.numpy())


# ------------------------------------------------------------- the zoo
@pytest.mark.parametrize("method", ["central", "forward", "backward"])
def test_finite_difference_vectors_match_jax(method):
    x = _states(0)
    np.testing.assert_array_equal(
        zoo.finite_difference_vector(torch.from_numpy(x), 0.1, method).numpy(),
        np.asarray(jzoo.finite_difference_vector(jnp.asarray(x), 0.1, method)))
    np.testing.assert_array_equal(
        tinterp.finite_difference_vector(torch.from_numpy(x), 0.1, method).numpy(),
        np.asarray(jinterp.finite_difference_vector(jnp.asarray(x), 0.1, method)))
    with pytest.raises(NotImplementedError):
        zoo.finite_difference_vector(torch.from_numpy(x), 0.1, "spline")


LIMITS = (np.array([-0.5, -0.5], np.float32), np.array([0.5, 0.5], np.float32))
GOAL = np.array([0.3, -0.2, 0.1, 0.0], np.float32)
ZOO_COSTS = {
    "max_velocity": (lambda v: jzoo.cost_max_velocity(v, DT, 0.5),
                     lambda v: zoo.cost_max_velocity(v, DT, 0.5)),
    "direction_alignment": (lambda v: jzoo.cost_velocity_direction_alignment(v, DT),
                            lambda v: zoo.cost_velocity_direction_alignment(v, DT)),
    "chomp_smoothness": (lambda v: jzoo.cost_smoothness_chomp(v, DT),
                         lambda v: zoo.cost_smoothness_chomp(v, DT)),
    "joint_limits": (lambda v: jzoo.cost_joint_limits(v, jnp.asarray(LIMITS[0]),
                                                      jnp.asarray(LIMITS[1])),
                     lambda v: zoo.cost_joint_limits(v, torch.from_numpy(LIMITS[0]),
                                                     torch.from_numpy(LIMITS[1]))),
    "goal_prior": (lambda v: jzoo.cost_goal_prior(v, jnp.asarray(GOAL), 0.7),
                   lambda v: zoo.cost_goal_prior(v, torch.from_numpy(GOAL), 0.7)),
}


@pytest.mark.parametrize("name", sorted(ZOO_COSTS))
def test_zoo_cost_and_gradient_match_jax(name):
    x = _states(1, (2, 3, 64, 4))
    (jv, jg), (tv, tg) = _value_and_grad(*ZOO_COSTS[name], x)
    assert tv.shape == jv.shape
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=1e-6)
    assert np.abs(jg).max() > 0
    np.testing.assert_allclose(tg, jg, rtol=RTOL, atol=RTOL * np.abs(jg).max())


def test_chomp_precision_is_jaxs_and_read_only():
    got = zoo.chomp_precision(64, DT)
    np.testing.assert_array_equal(got, jzoo.chomp_precision(64, DT))
    assert got is zoo.chomp_precision(64, DT) and not got.flags.writeable


def test_joint_limits_cost_splits_the_hinge_at_the_limit_as_jax():
    """A waypoint exactly at q_min + eps: relu's gradient there is 0.5 in both."""
    x = np.zeros((1, 8, 4), np.float32)
    x[0, :, 0] = np.float32(-0.5) + np.float32(0.1)
    x[0, 3, 1] = 0.7
    eps = 0.1
    (jv, jg), (tv, tg) = _value_and_grad(
        lambda v: jzoo.cost_joint_limits(v, jnp.asarray(LIMITS[0]), jnp.asarray(LIMITS[1]), eps),
        lambda v: zoo.cost_joint_limits(v, torch.from_numpy(LIMITS[0]),
                                        torch.from_numpy(LIMITS[1]), eps), x)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tg, jg)


# ------------------------------------------------------- the guide's knobs
def _guide_pair(jscene, env_name="EnvConveyor2D"):
    mins, maxs = limits(env_name)
    jgd = JGuideData(scene=jscene, normalizer=JNormalizer.from_limits(mins, maxs),
                     constraints=jcons.empty_constraint_set(4, 1))
    tgd = GuideData(scene=torch_scene(jscene),
                    normalizer=LimitsNormalizer.from_limits(mins, maxs, "cpu"),
                    constraints=tcons.empty_constraint_set(4, 1, device="cpu"))
    return jgd, tgd


def _extra_scene():
    """A scene whose extra objects are Conveyor's boxes and whose own grid
    is Highways': the extra-objects-only knob reads the first alone."""
    conveyor, highways = jax_make_env("EnvConveyor2D").scene, jax_make_env("EnvHighways2D").scene
    return JScene(grid=highways.grid, extra_grid=conveyor.grid, ws_min=conveyor.ws_min,
                  ws_max=conveyor.ws_max)


KNOBS = {
    "interpolate_collision": dict(interpolate_collision=True),
    "use_extra_objects_only": dict(use_extra_objects_only=True),
    "both_collision_knobs": dict(interpolate_collision=True, use_extra_objects_only=True),
    "max_velocity": dict(weight_max_velocity=0.05, max_velocity=0.5),
    "chomp_smoothness": dict(weight_chomp_smoothness=0.01),
    "joint_limits": dict(weight_joint_limits=0.1, joint_limit_eps=0.1),
    "all": dict(interpolate_collision=True, weight_max_velocity=0.05, max_velocity=0.5,
                weight_chomp_smoothness=0.01, weight_joint_limits=0.1),
}


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_guide_gradient_under_each_knob_matches_jax(knob):
    jscene = _extra_scene()
    jgd, tgd = _guide_pair(jscene)
    x = trajectories(7)
    x[1] *= 1.15  # past the joint limits' shrunk box
    kw = KNOBS[knob]
    want = np.asarray(jax_guide_gradient(jnp.asarray(x), jgd, JGuideConfig(**kw)))
    got = guide_gradient(torch.from_numpy(x), tgd, GuideConfig(**kw)).numpy()
    default = np.asarray(jax_guide_gradient(jnp.asarray(x), jgd, JGuideConfig()))
    assert np.abs(want - default).max() > 1e-3  # the knob changes the step
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert not got[:, 0].any() and not got[:, -1].any()


def test_guide_config_knobs_have_jaxs_defaults_and_routing():
    ours, theirs = GuideConfig(), JGuideConfig()
    for f in dataclasses.fields(JGuideConfig):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert ours.collision_kernel_applies
    for kw in KNOBS.values():
        collision_knob = kw.get("interpolate_collision") or kw.get("use_extra_objects_only")
        assert GuideConfig(**kw).collision_kernel_applies == (not collision_knob)


def test_default_guide_is_unchanged_and_a_zero_weight_adds_no_term(monkeypatch):
    """The default config's step is JAX's default step; setting a zoo
    term's other parameters with its weight at 0 changes not a bit; and the
    default never calls the zoo."""
    jgd, tgd = _guide_pair(jax_make_env("EnvConveyor2D").scene)
    x = torch.from_numpy(trajectories(3))
    base = guide_gradient(x, tgd, GuideConfig())
    np.testing.assert_allclose(
        base.numpy(), np.asarray(jax_guide_gradient(jnp.asarray(x.numpy()), jgd, JGuideConfig())),
        rtol=0, atol=ATOL)
    idle = GuideConfig(max_velocity=3.0, joint_limit_eps=0.3, num_interpolated_points=80)
    assert torch.equal(guide_gradient(x, tgd, idle), base)

    def no_zoo(*a, **k):
        raise AssertionError("a zero weight evaluated its cost")
    for name in ("cost_max_velocity", "cost_smoothness_chomp", "cost_joint_limits"):
        monkeypatch.setattr(tguide, name, no_zoo)
    assert torch.equal(guide_gradient(x, tgd, GuideConfig()), base)


def test_knob_guide_batches_problems():
    """With a collision knob the autograd path takes N problems' (N, B, H, D)
    rows of one scene, each as its own call would."""
    _, tgd = _guide_pair(_extra_scene())
    cfg = GuideConfig(interpolate_collision=True, use_extra_objects_only=True,
                      weight_max_velocity=0.05, max_velocity=0.5)
    x = torch.from_numpy(np.stack([trajectories(1), trajectories(2)]))
    both = guide_gradient(x, tgd, cfg)
    for n in range(2):
        torch.testing.assert_close(both[n], guide_gradient(x[n], tgd, cfg), rtol=0, atol=1e-7)


# ------------------------------------------------------------ task queries
def _points(seed, n=2048):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.15, 1.15, (n, 2)).astype(np.float32)
    pts[:4] = [[0.0, 0.0], [1.08, 0.0], [-1.08, -1.08], [0.3, -0.05]]
    return pts


@pytest.mark.parametrize("env_name", ["EnvConveyor2D", "EnvDropRegion2D"])
def test_collision_cost_sdf_matches_jax(env_name):
    jscene = jax_make_env(env_name).scene
    pts = _points(len(env_name))
    margin = 1.1 * 0.05 + 0.01
    want = np.asarray(jtask.compute_collision_cost_sdf(jscene, jnp.asarray(pts), margin))
    got = ttask.compute_collision_cost_sdf(torch_scene(jscene), torch.from_numpy(pts), margin)
    assert (want > 0).any() and (want == 0).any()
    np.testing.assert_array_equal(got.numpy(), want)


def test_task_collision_cost_matches_jax():
    jt = jtask.make_task("EnvConveyor2D")
    tt = ttask.PlanningTask(make_env("EnvConveyor2D", "cpu"))
    tt.scene = torch_scene(jt.scene)
    x = np.concatenate([_points(5, 256), np.zeros((256, 2), np.float32)], -1)
    np.testing.assert_array_equal(tt.compute_collision_cost(torch.from_numpy(x)).numpy(),
                                  np.asarray(jt.compute_collision_cost(jnp.asarray(x))))


@pytest.mark.parametrize("env_name", sorted(ENV_REGISTRY))
def test_compute_sdf_exact_matches_jax(env_name):
    pts = _points(11)
    np.testing.assert_array_equal(
        make_env(env_name, "cpu").compute_sdf_exact(torch.from_numpy(pts)).numpy(),
        np.asarray(jax_make_env(env_name).compute_sdf_exact(jnp.asarray(pts))))


@pytest.mark.parametrize("env_name,cell,margin", [("EnvConveyor2D", 0.02, 0.0),
                                                  ("EnvHighways2D", 0.01, 0.05),
                                                  ("EnvDropRegion2D", 0.03, 0.0)])
def test_occupancy_map_matches_jax(env_name, cell, margin):
    ours = build_occupancy_map(make_env(env_name, "cpu"), cell_size=cell, margin=margin)
    theirs = jax_build_occupancy_map(jax_make_env(env_name), cell_size=cell, margin=margin)
    np.testing.assert_array_equal(ours.grid.numpy(), np.asarray(theirs.grid))
    pts = _points(13)
    pts[4:8] = [[5.0, 5.0], [-1.0, -1.0], [1.0, 1.0], [0.999, -1.0]]
    np.testing.assert_array_equal(ours.get_collisions(torch.from_numpy(pts)).numpy(),
                                  np.asarray(theirs.get_collisions(jnp.asarray(pts))))


def test_occupancy_map_lookups():
    """The JAX package's own check (tests/test_classical.py), on the port."""
    occ = build_occupancy_map(make_env("EnvConveyor2D", "cpu"), cell_size=0.02)
    hits = occ.get_collisions(torch.tensor([[0.0, 0.0], [0.0, -0.2], [5.0, 5.0]])).numpy()
    assert hits[0] and not hits[1] and hits[2]  # inside a box / corridor / outside


# ----------------------------------------------------- trajectory helpers
@pytest.mark.parametrize("n_points", [0, 1, 2, 5])
def test_densify_trajs_matches_jax(n_points):
    rng = np.random.default_rng(n_points)
    trajs = [rng.normal(size=(h, 4)).astype(np.float32) for h in (1, 2, 17)]
    got, want = ttu.densify_trajs(trajs, n_points), jtu.densify_trajs(trajs, n_points)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_are_points_closer_than_margin_matches_jax():
    rng = np.random.default_rng(0)
    for margin in (0.01, 0.1, 0.3):
        pts = rng.uniform(-1, 1, (12, 2))
        assert (ttu.are_points_closer_than_margin(pts, margin)
                == jtu.are_points_closer_than_margin(pts, margin))
    assert not ttu.are_points_closer_than_margin(np.array([[0.0, 0.0], [1.0, 0.0]]), 1.0)
    assert ttu.are_points_closer_than_margin(np.array([[0.0, 0.0], [0.5, 0.0]]), 1.0)


# ------------------------------------------------------------------ tools
def test_bench_kernels_needs_a_card(monkeypatch, capsys):
    """The lookup's micro-benchmark measures on a card or not at all."""
    from mmd_torch.tools import bench_kernels

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_kernels.main([]) == 2
    out = capsys.readouterr()
    assert "no CUDA device" in out.err and out.out == ""
