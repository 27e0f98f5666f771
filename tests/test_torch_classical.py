"""The classical baselines of the port (CHOMP, STOMP, MPPI, stochastic GPMP)
against `mmd_tpu.datagen.classical`.

Both sides start from the same straight-line inits on JAX's EnvConveyor2D
grids (`torch_scene`), and the sampling optimizers get JAX's own draws:
JAX splits its key into one key an iteration and draws one normal tensor
from each, and the port takes those arrays as `draws`. Each optimizer is
held after 1, 2 and 3 iterations (one JAX program each, since JAX's
config is static):
- CHOMP within 1e-6: plain float32 rounding of the same gradient steps
  (measured 6e-8);
- MPPI within 1e-5 and stochastic GPMP within 1e-5: the costs feed a
  softmax whose weights move with the costs' last bits (measured 4e-7 and
  9e-7);
- STOMP within 2e-5: its costs reach ~1e3 (the GP term of noisy
  velocities), where a float32 ulp is 6e-5, and the softmax turns that
  into ~2e-6 of a step (measured 2.2e-6).
Over tens of iterations a waypoint that rounding moves across a cell edge
reads another cell, as in the guided loop, so whole runs are held by
their outcome: the twins of tests/test_classical.py, on the port's own
grids and generators.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmd_tpu.datagen import classical as jc
from mmd_tpu.envs.envs import make_env as jax_make_env
from mmd_torch.datagen import classical as tc
from mmd_torch.tasks.task import make_task
from test_torch_guide import torch_scene

torch.set_num_threads(1)

P, H = 4, 64
TOL = {"chomp": 1e-6, "stomp": 2e-5, "mppi": 1e-5, "stoch_gpmp": 1e-5}


def straight(start, goal, h=H):
    t = np.linspace(0, 1, h, dtype=np.float32)[:, None]
    pos = (1 - t) * np.asarray(start, np.float32) + t * np.asarray(goal, np.float32)
    vel = np.gradient(pos, axis=0) / (5.0 / 64.0)
    return np.concatenate([pos, vel], axis=-1).astype(np.float32)


def problem(seed=0, n=P):
    """n straight-line inits between random starts and goals (some through
    the Conveyor's boxes), and the first one's start and goal states."""
    rng = np.random.default_rng(seed)
    inits = np.stack([straight(rng.uniform(-0.9, 0.9, 2), rng.uniform(-0.9, 0.9, 2))
                      for _ in range(n)])
    s4 = np.concatenate([inits[0, 0, :2], [0.0, 0.0]]).astype(np.float32)
    g4 = np.concatenate([inits[0, -1, :2], [0.0, 0.0]]).astype(np.float32)
    return s4, g4, inits


SAMPLERS = {
    "stomp": (jc.stomp_optimize, tc.stomp_optimize, jc.STOMPConfig, tc.STOMPConfig,
              lambda c: (c.n_noisy, P, H, 4)),
    "mppi": (jc.mppi_optimize, tc.mppi_optimize, jc.MPPIConfig, tc.MPPIConfig,
             lambda c: (c.n_rollouts, P, H, 2)),
    "stoch_gpmp": (jc.stoch_gpmp_optimize, tc.stoch_gpmp_optimize, jc.StochGPMPConfig,
                   tc.StochGPMPConfig, lambda c: (c.n_samples_per_particle, P, H, 4)),
}


@pytest.fixture(scope="module")
def scenes():
    jscene = jax_make_env("EnvConveyor2D").scene
    return jscene, torch_scene(jscene)


def test_chomp_iterations_match_jax(scenes):
    jscene, tscene = scenes
    s4, g4, inits = problem()
    for n in (1, 2, 3):
        want = np.asarray(jc.chomp_optimize(jscene, jnp.asarray(s4), jnp.asarray(g4),
                                            jnp.asarray(inits), jc.CHOMPConfig(opt_iters=n)))
        got = tc.chomp_optimize(tscene, torch.from_numpy(s4), torch.from_numpy(g4),
                                torch.from_numpy(inits), tc.CHOMPConfig(opt_iters=n)).numpy()
        assert np.abs(want - inits).max() > 1e-3  # it moved
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL["chomp"])


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sampling_optimizer_iterations_match_jax_on_jaxs_draws(name, scenes):
    jscene, tscene = scenes
    jax_fn, torch_fn, jcfg, tcfg, shape = SAMPLERS[name]
    s4, g4, inits = problem(1)
    key = jax.random.PRNGKey(3)
    for n in (1, 2, 3):
        cfg = jcfg(opt_iters=n)
        draws = np.stack([np.asarray(jax.random.normal(k, shape(cfg)))
                          for k in jax.random.split(key, n)])
        want = np.asarray(jax_fn(jscene, jnp.asarray(s4), jnp.asarray(g4), jnp.asarray(inits),
                                 key, cfg))
        got = torch_fn(tscene, torch.from_numpy(s4), torch.from_numpy(g4),
                       torch.from_numpy(inits), tcfg(opt_iters=n),
                       draws=torch.from_numpy(draws)).numpy()
        assert got.shape == want.shape == inits.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL[name])


def test_configs_are_jaxs():
    for jcfg, tcfg in ((jc.CHOMPConfig, tc.CHOMPConfig), (jc.STOMPConfig, tc.STOMPConfig),
                       (jc.MPPIConfig, tc.MPPIConfig),
                       (jc.StochGPMPConfig, tc.StochGPMPConfig)):
        assert jcfg().__dict__ == tcfg().__dict__


def test_smooth_noise_is_jnp_convolve_same():
    """conv1d cross-correlates and pads by its own rule: each column must be
    `jnp.convolve(col, kernel, mode="same")`, an impulse giving the kernel
    centered on it, cut at the ends. Held within 1e-6: nine-term float32
    sums in another order (a few ulps of values ~1)."""
    kernel = np.exp(-0.5 * (np.arange(-4, 5) / 2.0) ** 2).astype(np.float32)
    jkernel = jnp.asarray(kernel) / jnp.asarray(kernel).sum()
    np.testing.assert_allclose(tc.smoothing_kernel(), np.asarray(jkernel), rtol=0, atol=1e-8)
    x = np.random.default_rng(0).normal(size=(2, 3, H, 4)).astype(np.float32)
    x[0, 0, :, 0] = 0.0
    x[0, 0, 2, 0] = 1.0  # an impulse near the start
    got = tc.smooth_noise(torch.from_numpy(x)).numpy()
    want = np.stack([np.stack([np.stack([np.asarray(jnp.convolve(x[a, b, :, d], jkernel,
                                                                  mode="same"))
                                         for d in range(4)], -1) for b in range(3)])
                     for a in range(2)])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[0, 0, :7, 0], tc.smoothing_kernel()[2:], rtol=0, atol=1e-8)


def test_sampling_optimizers_need_a_generator_or_draws(scenes):
    _, tscene = scenes
    s4, g4, inits = (torch.from_numpy(a) for a in problem())
    with pytest.raises(ValueError, match="generator or its draws"):
        tc.stomp_optimize(tscene, s4, g4, inits, tc.STOMPConfig(opt_iters=1))
    with pytest.raises(ValueError, match="an iteration needs"):
        tc.mppi_optimize(tscene, s4, g4, inits, tc.MPPIConfig(opt_iters=1),
                         draws=torch.zeros(1, 3, P, H, 2))


def test_generator_draws_replay_exactly(scenes):
    """The same generator state gives the same run: what the card's replay
    with the plain lookup relies on."""
    _, tscene = scenes
    s4, g4, inits = (torch.from_numpy(a) for a in problem(2))
    gen = torch.Generator().manual_seed(5)
    state = gen.get_state()
    cfg = tc.StochGPMPConfig(opt_iters=4)
    first = tc.stoch_gpmp_optimize(tscene, s4, g4, inits, cfg, generator=gen)
    gen.set_state(state)
    assert torch.equal(tc.stoch_gpmp_optimize(tscene, s4, g4, inits, cfg, generator=gen), first)


# ------------------------------------ twins of tests/test_classical.py
def _setup():
    task = make_task("EnvConveyor2D", device="cpu")
    start = np.array([-0.8, -0.02], np.float32)
    goal = np.array([0.8, -0.02], np.float32)
    init = torch.from_numpy(straight(start, goal)[None])
    s4 = torch.from_numpy(np.concatenate([start, np.zeros(2)]).astype(np.float32))
    g4 = torch.from_numpy(np.concatenate([goal, np.zeros(2)]).astype(np.float32))
    return task, s4, g4, init


def _coll_count(task, traj):
    return int(task.compute_collision(traj[..., :2]).sum())


def test_chomp_reduces_collisions():
    task, s, g, init = _setup()
    out = tc.chomp_optimize(task.scene, s, g, init, tc.CHOMPConfig(opt_iters=150))
    assert torch.isfinite(out).all()
    assert _coll_count(task, out[0]) < _coll_count(task, init[0])


def test_stomp_runs_and_improves():
    task, s, g, init = _setup()
    out = tc.stomp_optimize(task.scene, s, g, init, tc.STOMPConfig(opt_iters=80),
                            generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(out).all()
    assert _coll_count(task, out[0]) <= _coll_count(task, init[0])


def test_mppi_reaches_goal_region():
    task, s, g, init = _setup()
    out = tc.mppi_optimize(task.scene, s, g, init, tc.MPPIConfig(),
                           generator=torch.Generator().manual_seed(1))
    assert torch.isfinite(out).all()
    # Rollouts start exactly at the start position.
    np.testing.assert_allclose(out[0, 0, :2].numpy(), s[:2].numpy(), atol=1e-5)


def test_stoch_gpmp_runs():
    task, s, g, init = _setup()
    out = tc.stoch_gpmp_optimize(task.scene, s, g, init, tc.StochGPMPConfig(opt_iters=60),
                                 generator=torch.Generator().manual_seed(2))
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out[0, 0, :2].numpy(), s[:2].numpy(), atol=1e-5)
