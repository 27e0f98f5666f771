"""Forward kinematics, Jacobians, IK and the planar arm's GPMP2 of the port
against `mmd_tpu.robots.kinematics` and `mmd_tpu.datagen.gpmp2`.

Inputs are seeded numpy on both sides; the scene is JAX's DropRegion grid
(`torch_scene`). Tolerances:
- FK, sphere centers, the analytic Jacobians against `jax.jacfwd` and
  `jax.jacrev`, IK: 1e-6 (4x4 float32 products in another order;
  measured 1.8e-7);
- the clearances: exact (the same cells and float32 operations);
- GPMP2's collision residuals and Jacobian rows with the arm's `coll_fn`,
  and the damped normal equations built from them, against `jax.jacrev`'s
  J: within 1e-5 of the largest entry (the collision rows are 2e4 x the
  FK Jacobian; sums in another order);
- `plan_arm_gpmp2` for 3 iterations from JAX's via points: 1e-5
  (measured 2.6e-6 of
  entries up to ~4; a damped Gauss-Newton step amplifies the rounding of
  a (384, 384) Cholesky solve);
The 400-iteration plan, like the guided loop, crosses cell edges where
rounding decides, so it is held by its outcome (the twin of
tests/test_kinematics.py's drop-region test).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmd_tpu.datagen import gpmp2 as jgpmp2
from mmd_tpu.envs.envs import make_env as jax_make_env
from mmd_tpu.robots import kinematics as jk
from mmd_torch.datagen import gpmp2
from mmd_torch.envs.envs import make_env
from mmd_torch.robots import kinematics as tk
from test_torch_guide import torch_scene

torch.set_num_threads(1)

TOL, JAC_RTOL, ITER_TOL = 1e-6, 1e-5, 1e-5
Q_START = np.zeros(3, np.float32)                       # along +x
Q_GOAL = np.array([np.pi / 2, 0.0, 0.0], np.float32)    # along +y


def _mdh_full(a, alpha, d, theta):
    """Independent oracle: the full modified-DH matrix (Craig convention)."""
    ct, st = np.cos(theta), np.sin(theta)
    ca, sa = np.cos(alpha), np.sin(alpha)
    return np.array([
        [ct, -st, 0.0, a],
        [st * ca, ct * ca, -sa, -d * sa],
        [st * sa, ct * sa, ca, d * ca],
        [0.0, 0.0, 0.0, 1.0],
    ])


@pytest.fixture(scope="module")
def drop_region():
    jscene = jax_make_env("EnvDropRegion2D").scene
    return jscene, torch_scene(jscene)


@pytest.fixture(scope="module")
def arms():
    return jk.make_planar_arm(3, link_length=0.2), tk.make_planar_arm(3, link_length=0.2,
                                                                      device="cpu")


def _panda_configs(seed, n=16):
    tree = jk.make_panda()
    rng = np.random.default_rng(seed)
    return rng.uniform(np.asarray(tree.q_min), np.asarray(tree.q_max), (n, 7)).astype(np.float32)


# ------------------------------------------------------------------- FK
def test_panda_fk_matches_mdh_oracle():
    tree = tk.make_panda(device="cpu")
    q = np.random.default_rng(0).uniform(tree.q_min.numpy(), tree.q_max.numpy())
    got = tk.fk(tree, torch.as_tensor(q, dtype=torch.float32)).numpy()
    T = np.eye(4)
    for j, (a, alpha, d) in enumerate(tk.PANDA_MDH):
        T = T @ _mdh_full(a, alpha, d, q[j])
        np.testing.assert_allclose(got[j], T, atol=1e-5)
    T = T @ _mdh_full(0.0, 0.0, 0.107, 0.0)  # fixed flange
    np.testing.assert_allclose(got[7], T, atol=1e-5)


def test_fk_and_spheres_match_jax_over_a_batch():
    qs = _panda_configs(1)
    jt, tt = jk.make_panda(), tk.make_panda(device="cpu")
    got = tk.fk(tt, torch.from_numpy(qs))
    assert got.shape == (16, 8, 4, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.vmap(lambda q: jk.fk(jt, q))(
        jnp.asarray(qs))), rtol=0, atol=TOL)
    spheres = tk.fk_collision_spheres(tt, torch.from_numpy(qs))
    assert spheres.shape == (16, 8, 3)
    np.testing.assert_allclose(spheres.numpy(), np.asarray(jax.vmap(
        lambda q: jk.fk_collision_spheres(jt, q))(jnp.asarray(qs))), rtol=0, atol=TOL)
    np.testing.assert_allclose(tk.link_positions(tt, torch.from_numpy(qs[0])).numpy(),
                               np.asarray(jk.link_positions(jt, jnp.asarray(qs[0]))),
                               rtol=0, atol=TOL)


def test_planar_arm_fk_trig():
    tree = tk.make_planar_arm(2, link_length=0.5, n_spheres_per_link=1, sphere_radius=0.05,
                              device="cpu")
    q = torch.tensor([np.pi / 2, -np.pi / 2])
    pos = tk.link_positions(tree, q).numpy()
    # Joint 1's frame sits at the end of link 0 (rotated to +y).
    np.testing.assert_allclose(pos[1], [0.0, 0.5, 0.0], atol=1e-6)
    # The tip sphere: link 1 rotated back to +x.
    np.testing.assert_allclose(tk.fk_collision_spheres(tree, q)[-1].numpy(), [0.5, 0.5, 0.0],
                               atol=1e-6)


def test_prismatic_and_fixed_joints_match_jax():
    """A chain with every joint type, with a base offset and tilted axes."""
    rng = np.random.default_rng(4)
    origins = np.stack([tk._mdh_origin(*rng.uniform(-0.5, 0.5, 3)) for _ in range(4)])
    axes = rng.normal(size=(4, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    types = [tk.REVOLUTE, tk.PRISMATIC, tk.FIXED, tk.REVOLUTE]
    spheres = [(j, tuple(rng.uniform(-0.1, 0.1, 3)), 0.05) for j in range(4)]
    lim = np.ones(3, np.float32)
    jt = jk.make_chain(origins, axes, types, -lim, lim, spheres)
    tt = tk.make_chain(origins, axes, types, -lim, lim, spheres, device="cpu")
    qs = rng.uniform(-1, 1, (5, 3)).astype(np.float32)
    np.testing.assert_allclose(tk.fk(tt, torch.from_numpy(qs)).numpy(), np.asarray(
        jax.vmap(lambda q: jk.fk(jt, q))(jnp.asarray(qs))), rtol=0, atol=TOL)
    for link in range(4):
        np.testing.assert_allclose(
            tk.position_jacobian(tt, torch.from_numpy(qs), link).numpy(),
            np.asarray(jax.vmap(lambda q: jk.position_jacobian(jt, q, link))(jnp.asarray(qs))),
            rtol=0, atol=TOL)


# ---------------------------------------------------------- Jacobians, IK
def test_position_jacobian_matches_jacfwd_and_finite_differences():
    jt, tt = jk.make_panda(), tk.make_panda(device="cpu")
    qs = np.random.default_rng(1).uniform(-1, 1, (4, 7)).astype(np.float32)
    J = tk.position_jacobian(tt, torch.from_numpy(qs), 7)
    assert J.shape == (4, 3, 7)
    np.testing.assert_allclose(J.numpy(), np.asarray(jax.vmap(
        lambda q: jk.position_jacobian(jt, q, 7))(jnp.asarray(qs))), rtol=0, atol=TOL)
    q, eps = torch.from_numpy(qs[0]), 1e-3
    for i in range(7):
        dq = torch.zeros(7)
        dq[i] = eps
        fd = (tk.fk(tt, q + dq)[7, :3, 3] - tk.fk(tt, q - dq)[7, :3, 3]) / (2 * eps)
        np.testing.assert_allclose(J[0, :, i].numpy(), fd.numpy(), atol=1e-3)


def test_ik_iterations_match_jax_and_reach_the_target():
    jt, tt = jk.make_panda(), tk.make_panda(device="cpu")
    rng = np.random.default_rng(2)
    q_true = rng.uniform(np.asarray(jt.q_min) * 0.6, np.asarray(jt.q_max) * 0.6).astype(np.float32)
    target = np.array(jk.fk(jt, jnp.asarray(q_true))[7, :3, 3])
    q0 = np.zeros(7, np.float32)
    q0[3] = -1.5  # elbow-bent neutral
    for n in (1, 5):
        np.testing.assert_allclose(
            tk.ik_position(tt, torch.from_numpy(target), torch.from_numpy(q0), n_iters=n).numpy(),
            np.asarray(jk.ik_position(jt, jnp.asarray(target), jnp.asarray(q0), n_iters=n)),
            rtol=0, atol=TOL)
    q_sol = tk.ik_position(tt, torch.from_numpy(target), torch.from_numpy(q0), n_iters=120)
    err = float(torch.linalg.vector_norm(tk.fk(tt, q_sol)[7, :3, 3] - torch.from_numpy(target)))
    assert err < 5e-3, err


# ------------------------------------------------------ the arm in a scene
def test_planar_arm_scene_collision():
    scene = make_env("EnvConveyor2D", "cpu").scene
    # Base in the bottom corridor (free band y in (-0.3, -0.05)).
    tree = tk.make_planar_arm(3, link_length=0.25, base_xy=(-0.6, -0.2), device="cpu")
    # Straight along +x at y = -0.2 stays in the corridor; tilted up 0.6 rad
    # a mid-arm sphere lands in the conveyor's center box.
    hit = tk.arm_scene_collision(tree, scene, torch.tensor([0.6, 0.0, 0.0]))
    free = tk.arm_scene_collision(tree, scene, torch.zeros(3))
    assert bool(hit) and not bool(free)


def test_clearances_and_their_jacobian_match_jax(drop_region, arms):
    jscene, tscene = drop_region
    ja, ta = arms
    qs = np.random.default_rng(3).uniform(-np.pi, np.pi, (64, 3)).astype(np.float32)
    want = np.asarray(jax.vmap(lambda q: jk.arm_scene_clearances(ja, jscene, q, 0.01))(
        jnp.asarray(qs)))
    assert (want < 0).any() and (want > 0).any()
    np.testing.assert_array_equal(
        tk.arm_scene_clearances(ta, tscene, torch.from_numpy(qs), 0.01).numpy(), want)
    np.testing.assert_array_equal(tk.arm_scene_collision(ta, tscene, torch.from_numpy(qs)).numpy(),
                                  np.asarray(jax.vmap(lambda q: jk.arm_scene_collision(
                                      ja, jscene, q))(jnp.asarray(qs))))
    clear, jac = tk.arm_clearances_and_jacobian(ta, tscene, torch.from_numpy(qs), 0.01)
    np.testing.assert_array_equal(clear.numpy(), want)
    jj = np.asarray(jax.jit(jax.vmap(jax.jacrev(
        lambda q: jk.arm_scene_clearances(ja, jscene, q, 0.01))))(jnp.asarray(qs)))
    np.testing.assert_allclose(jac.numpy(), jj, rtol=0, atol=TOL)


def _jax_seeds(vias, horizon=64):
    """JAX's via-point seeds, as `jk.plan_arm_gpmp2` builds them."""
    def one_seed(via):
        h2 = horizon // 2
        a = jnp.linspace(0.0, 1.0, h2)[:, None]
        first = (1 - a) * Q_START[None] + a * via[None]
        b = jnp.linspace(0.0, 1.0, horizon - h2)[:, None]
        second = (1 - b) * via[None] + b * Q_GOAL[None]
        qs = jnp.concatenate([first, second], 0)
        return jnp.concatenate([qs, jnp.gradient(qs, axis=0)], -1)
    return np.asarray(jax.vmap(one_seed)(jnp.asarray(vias)))


def _arm_problem(ja, n=16):
    vias = np.array(jax.random.uniform(jax.random.PRNGKey(0), (n, 3), minval=ja.q_min,
                                       maxval=ja.q_max))
    vias[0] = 0.5 * (Q_START + Q_GOAL)
    start = np.concatenate([Q_START, np.zeros(3, np.float32)])
    goal = np.concatenate([Q_GOAL, np.zeros(3, np.float32)])
    return vias, start, goal


def test_via_point_seeds_match_jax(arms):
    ja, _ = arms
    vias, _, _ = _arm_problem(ja)
    got = tk.via_point_seeds(torch.from_numpy(Q_START), torch.from_numpy(Q_GOAL),
                             torch.from_numpy(vias), 64)
    np.testing.assert_allclose(got.numpy(), _jax_seeds(vias), rtol=0, atol=TOL)


def _arm_cfgs(n_iters):
    kw = dict(n_support_points=64, opt_iters=n_iters, sigma_coll=5e-5, step_size=0.15)
    return jgpmp2.GPMP2Config(**kw), gpmp2.GPMP2Config(**kw)


def test_gpmp2_arm_collision_rows_and_normal_equations_match_jax(drop_region, arms):
    """The arm's collision residuals and their rows of `jax.jacrev`'s J
    (each row nonzero only at its waypoint t + 1's positions), and the
    damped normal equations against those of JAX's whole J."""
    jscene, tscene = drop_region
    ja, ta = arms
    vias, start, goal = _arm_problem(ja, 2)
    theta = _jax_seeds(vias)
    jcfg, tcfg = _arm_cfgs(1)

    def jcoll(states):
        return jax.vmap(lambda s: jk.arm_scene_clearances(ja, jscene, s[:3], 0.01))(states)

    def tcoll(states):
        return tk.arm_clearances_and_jacobian(ta, tscene, states[..., :3], 0.01)

    @jax.jit
    def res(flat):
        return jgpmp2._whitened_residuals(flat.reshape(64, 6), jscene, jnp.asarray(start),
                                          jnp.asarray(goal), jcfg, jcoll)

    r_coll, grad = gpmp2._collision_rows(torch.from_numpy(theta), tcfg, tcoll)
    assert grad.shape == (2, 63, 9, 3)
    damped, g = gpmp2._damped_normal_equations(torch.from_numpy(theta), torch.from_numpy(start),
                                               torch.from_numpy(goal), tcfg, tcoll)
    n_active, t = 0, np.arange(63)
    for p in range(2):
        flat = jnp.asarray(theta[p].reshape(-1))
        rj, Jj = np.asarray(res(flat)), np.array(jax.jit(jax.jacrev(res))(flat))
        n_active += int((rj[-63 * 9:] > 0).sum())
        np.testing.assert_allclose(r_coll[p].reshape(-1).numpy(), rj[-63 * 9:], rtol=0,
                                   atol=JAC_RTOL * np.abs(rj).max())
        rows = Jj[-63 * 9:].reshape(63, 9, 64, 6).copy()
        own = rows[t, :, t + 1, :3]                                  # (63, 9, 3)
        np.testing.assert_allclose(grad[p].numpy(), own, rtol=0,
                                   atol=JAC_RTOL * np.abs(Jj).max())
        rows[t, :, t + 1, :3] = 0.0
        assert not rows.any()  # nothing else in a collision row
        JtJ = Jj.T @ Jj
        dense = JtJ + tcfg.delta * np.diag(np.diag(JtJ)) + np.float32(1e-9) * np.eye(384)
        np.testing.assert_allclose(damped[p].numpy(), dense, rtol=0,
                                   atol=JAC_RTOL * np.abs(dense).max())
        np.testing.assert_allclose(g[p, :, 0].numpy(), Jj.T @ rj, rtol=0,
                                   atol=JAC_RTOL * np.abs(Jj.T @ rj).max())
    assert n_active > 0  # the seeds cross the boxes


def test_plan_arm_gpmp2_iterations_match_jax(drop_region, arms):
    """The whole plan (seeds, GPMP2 with the arm's `coll_fn`, the free
    mask) for 3 iterations, on JAX's via points."""
    jscene, tscene = drop_region
    ja, ta = arms
    vias, _, _ = _arm_problem(ja, 4)
    for n in (3,):
        want, want_free = jk.plan_arm_gpmp2(ja, jscene, jnp.asarray(Q_START), jnp.asarray(Q_GOAL),
                                            jax.random.PRNGKey(0), n_particles=4, opt_iters=n)
        got, free = tk.plan_arm_gpmp2(ta, tscene, torch.from_numpy(Q_START),
                                      torch.from_numpy(Q_GOAL), vias=torch.from_numpy(vias),
                                      n_particles=4, opt_iters=n)
        assert np.abs(np.asarray(want) - _jax_seeds(vias)).max() > 1e-2  # it moved
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ITER_TOL)
        np.testing.assert_array_equal(free.numpy(), np.asarray(want_free))


def test_plan_arm_gpmp2_folds_through_drop_region():
    """GPMP2 over joint space with the FK-sphere collision factor: rotating
    a 3-link arm from +x to +y at the DropRegion center must fold around
    the (0.4, 0.4) box; the straight joint interpolation collides."""
    scene = make_env("EnvDropRegion2D", "cpu").scene
    tree = tk.make_planar_arm(3, link_length=0.2, device="cpu")
    q_start, q_goal = torch.from_numpy(Q_START), torch.from_numpy(Q_GOAL)
    assert bool(tk.arm_scene_collision(tree, scene, 0.5 * (q_start + q_goal)))
    trajs, free = tk.plan_arm_gpmp2(tree, scene, q_start, q_goal,
                                    generator=torch.Generator().manual_seed(0), n_particles=16,
                                    horizon=64, opt_iters=400)
    assert trajs.shape == (16, 64, 6)
    assert bool(free.any()), "no collision-free arm plan found"
    best = trajs[int(torch.argmax(free.to(torch.int64)))].numpy()
    np.testing.assert_allclose(best[0, :3], Q_START, atol=2e-2)
    np.testing.assert_allclose(best[-1, :3], Q_GOAL, atol=2e-2)
    with pytest.raises(ValueError, match="generator or the vias"):
        tk.plan_arm_gpmp2(tree, scene, q_start, q_goal, opt_iters=1)
