"""GP-prior sampling of the port (`mmd_torch.costs.gp`) against the JAX
package's (`mmd_tpu/costs/gp.py:57-119`).

The precision K_inv is built by the same numpy arithmetic and must be equal.
The constant-velocity mean agrees within 1e-6. The samples, on JAX's own
`jax.random.normal` draws, are both float32 Choleskys of an ill-conditioned
K_inv (1/sigma^2 = 1e6 beside O(1) entries): each lies within the float32
factor's error of the float64 draw, so the two are held within twice the
port's measured float32-against-float64 gap (measured here at H = 64:
6.0e-4 on samples of magnitude 0.65; port against JAX 6.0e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmd_tpu.costs import gp as jgp
from mmd_torch.costs import gp as tgp

torch.set_num_threads(1)

START = np.array([-0.5, -0.5, 0.0, 0.0], np.float32)
GOAL = np.array([0.5, 0.5, 0.0, 0.0], np.float32)


@pytest.mark.parametrize("horizon,dt", [(32, 0.1), (64, 5.0 / 63)])
def test_precision_equals_jax(horizon, dt):
    got = tgp.gp_prior_precision(horizon, 2, dt)
    want = jgp.gp_prior_precision(horizon, 2, dt)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert not got.flags.writeable


@pytest.mark.parametrize("zero_endpoint_vel", [True, False])
def test_const_vel_trajectory_matches_jax(zero_endpoint_vel):
    got = tgp.const_vel_trajectory(torch.from_numpy(START), torch.from_numpy(GOAL), 64,
                                   5.0 / 63, zero_endpoint_vel)
    want = jgp.const_vel_trajectory(jnp.asarray(START), jnp.asarray(GOAL), 64, 5.0 / 63,
                                    zero_endpoint_vel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("horizon,seed", [(32, 0), (64, 1)])
def test_samples_on_jax_draws_match_jax(horizon, seed):
    dt, n = 5.0 / (horizon - 1), 64
    key = jax.random.PRNGKey(seed)
    z = np.array(jax.random.normal(key, (n, 4 * horizon)))
    want = np.asarray(jgp.sample_gp_prior(key, jnp.asarray(START), jnp.asarray(GOAL),
                                          horizon, dt, n))
    start, goal = torch.from_numpy(START), torch.from_numpy(GOAL)
    got = tgp.sample_gp_prior(torch.from_numpy(z), start, goal, horizon, dt, n)
    f64 = tgp.sample_gp_prior(torch.from_numpy(z), start, goal, horizon, dt, n,
                              dtype=torch.float64)
    gap = float((got.double() - f64).abs().max())
    err = float(np.abs(got.numpy() - want).max())
    print(f"H={horizon}: port against JAX {err:.2e}; port float32 against float64 {gap:.2e}")
    assert got.shape == (n, horizon, 4) and got.dtype == torch.float32
    assert 0 < gap < 5e-3
    assert err <= 2 * gap


def test_generator_draws_match_explicit_noise():
    g = torch.Generator().manual_seed(3)
    z = torch.randn((8, 4 * 32), generator=torch.Generator().manual_seed(3))
    start, goal = torch.from_numpy(START), torch.from_numpy(GOAL)
    torch.testing.assert_close(tgp.sample_gp_prior(g, start, goal, 32, 0.1, 8),
                               tgp.sample_gp_prior(z, start, goal, 32, 0.1, 8),
                               rtol=0, atol=0)


def test_sampling_statistics():
    """tests/test_costs.py::test_gp_prior_sampling_statistics on the port's
    own generator: endpoints pinned, the middle scattered, the sample mean
    near the constant-velocity mean."""
    H, dt = 32, 0.1
    start, goal = torch.from_numpy(START), torch.from_numpy(GOAL)
    trajs = tgp.sample_gp_prior(torch.Generator().manual_seed(0), start, goal, H, dt, 256)
    assert trajs.shape == (256, H, 4)
    mean = tgp.const_vel_trajectory(start, goal, H, dt)
    t = trajs.numpy()
    np.testing.assert_allclose(t[:, 0, :2].mean(0), [-0.5, -0.5], atol=5e-3)
    assert float(np.abs(t[:, 0, :2] - (-0.5)).std()) < 5e-3
    np.testing.assert_allclose(t[:, -1, :2].mean(0), [0.5, 0.5], atol=5e-3)
    assert float(t[:, H // 2, :2].std(0).mean()) > 0.02
    err = np.abs(t.mean(0) - mean.numpy())[:, :2].max()
    assert err < 0.05, err
