"""The port's training dataset and normalizers against the JAX package.

Tolerances: the limits normalizers (min and max), normalize and unnormalize
with them, and the dataset's trajectories are held exactly: both sides do
the same float32 element operations. The Gaussian normalizer is held to
1e-6 of its largest statistic: its mean and std are float32 sums over
~640000 elements, which XLA and torch add in different orders (measured
<= 3.7e-7 relative on the repository's datasets).
"""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mmd_tpu.datasets import normalization as jnorm
from mmd_tpu.datasets.trajectories import TrajectoryDataset as JDataset
from mmd_torch.datasets import normalization as tnorm
from mmd_torch.datasets.trajectories import TrajectoryDataset, model_id

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATASETS = sorted(glob.glob(os.path.join(ROOT, "data_trajectories", "*", "trajs-free.npz")))
NAMES = ["LimitsNormalizer", "SafeLimitsNormalizer", "FixedLimitsNormalizer",
         "GaussianNormalizer"]
GAUSS_TOL = 1e-6


def _stats(n):
    if hasattr(n, "mins"):
        return [np.asarray(n.mins), np.asarray(n.maxs)]
    return [np.asarray(n.means), np.asarray(n.stds)]


def _check(name, x):
    want = jnorm.make_normalizer(name, jnp.asarray(x))
    got = tnorm.make_normalizer(name, torch.from_numpy(x))
    for g, w in zip(_stats(got), _stats(want)):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        if name == "GaussianNormalizer":
            np.testing.assert_allclose(g, w, rtol=0, atol=GAUSS_TOL * np.abs(w).max())
        else:
            np.testing.assert_array_equal(g, w)
    y = x[:64]
    ty = got.normalize(torch.from_numpy(y)).numpy()
    jy = np.asarray(want.normalize(jnp.asarray(y)))
    back = got.unnormalize(torch.from_numpy(jy)).numpy()
    jback = np.asarray(want.unnormalize(jnp.asarray(jy)))
    if name == "GaussianNormalizer":
        np.testing.assert_allclose(ty, jy, rtol=0, atol=GAUSS_TOL * 10)
        np.testing.assert_allclose(back, jback, rtol=0, atol=GAUSS_TOL * 10)
    else:
        np.testing.assert_array_equal(ty, jy)
        np.testing.assert_array_equal(back, jback)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("path", DATASETS, ids=lambda p: os.path.basename(os.path.dirname(p)))
def test_normalizer_fit_on_repository_data_matches_jax(path, name):
    _check(name, np.load(path)["trajs"].astype(np.float32))


@pytest.mark.parametrize("name", NAMES)
def test_normalizer_on_degenerate_data_matches_jax(name):
    # Two constant dimensions: the safe normalizer widens EVERY dimension
    # by 2 (the reference's quirk), and the plain one divides by 1e-12.
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (7, 5, 4)).astype(np.float32)
    x[..., 1] = 0.25
    x[..., 3] = -3.0
    _check(name, x)
    if name == "SafeLimitsNormalizer":
        n = tnorm.safe_limits_from_data(torch.from_numpy(x))
        assert float(n.maxs[1] - n.mins[1]) == 4.0


def test_unknown_normalizer_is_refused():
    with pytest.raises(ValueError, match="Unknown normalizer"):
        tnorm.make_normalizer("MinMax", torch.zeros(3, 2))


@pytest.fixture(scope="module")
def conveyor():
    mid = model_id("EnvConveyor2D")
    return (TrajectoryDataset.load_trajectories(os.path.join(ROOT, "data_trajectories"), mid,
                                                device="cpu"),
            JDataset.load(os.path.join(ROOT, "data_trajectories"), mid))


def test_loaded_dataset_matches_jax(conveyor):
    ds, jds = conveyor
    assert (ds.n_trajs, ds.n_support_points, ds.state_dim) == (
        jds.n_trajs, jds.n_support_points, jds.state_dim)
    assert ds.env_name == jds.env_name and ds.duration == jds.duration
    np.testing.assert_array_equal(ds.trajs.numpy(), np.asarray(jds.trajs))
    np.testing.assert_array_equal(ds.trajs_normalized.numpy(), np.asarray(jds.trajs_normalized))
    y = np.asarray(jds.trajs_normalized[:16])
    np.testing.assert_array_equal(ds.unnormalize_trajectories(torch.from_numpy(y)).numpy(),
                                  np.asarray(jds.unnormalize_trajectories(jnp.asarray(y))))
    np.testing.assert_array_equal(ds.normalize_trajectories(ds.trajs[:16]).numpy(), y)


@pytest.mark.parametrize("start_idx", [0, 417, 8336])
def test_sample_batch_stays_in_range_and_pins_endpoints(conveyor, start_idx):
    ds, _ = conveyor
    g = torch.Generator().manual_seed(start_idx)
    batch, hard = ds.sample_batch(g, 4096, start_idx=start_idx)
    assert batch.shape == (4096, ds.n_support_points, ds.state_dim)
    # Every row is one of the allowed trajectories: found by a float64
    # projection, which equal rows share; any duplicate of a held-out row
    # would have to lie in [start_idx, N) too.
    w = torch.from_numpy(np.random.default_rng(1).standard_normal(
        ds.n_support_points * ds.state_dim))
    keys = ds.trajs_normalized.reshape(ds.n_trajs, -1).double() @ w
    match = batch.reshape(len(batch), -1).double() @ w
    pos = torch.searchsorted(keys[start_idx:].sort().values, match)
    assert bool((keys[start_idx:].sort().values[pos.clamp(max=ds.n_trajs - start_idx - 1)]
                 == match).all())
    idx = (match[:, None] == keys[None, :]).float().argmax(1)
    assert torch.equal(batch, ds.trajs_normalized[idx])
    if start_idx == 0:
        assert int(idx.max()) - int(idx.min()) > ds.n_trajs // 2
    assert torch.equal(hard.mask[:, 0], torch.tensor([1.0] + [0.0] * 62 + [1.0]))
    x = torch.zeros_like(batch)
    assert torch.equal(hard.apply(x)[:, [0, -1]], batch[:, [0, -1]])


def test_dataset_save_and_load_round_trip(conveyor, tmp_path):
    ds, jds = conveyor
    small = TrajectoryDataset.from_trajs(ds.trajs[:50].numpy(), ds.env_name, device="cpu")
    small.save(str(tmp_path))
    d = tmp_path / model_id(ds.env_name)
    np.testing.assert_array_equal(np.load(d / "trajs-free.npz")["trajs"], small.trajs.numpy())
    with open(d / "metadata.yaml") as f:
        meta = yaml.safe_load(f)
    assert meta == {"env_id": "EnvConveyor2D", "robot_id": "RobotPlanarDisk",
                    "num_trajectories": 50, "horizon": 64, "duration": 5.0, "state_dim": 4}
    back = TrajectoryDataset.load_trajectories(str(tmp_path), model_id(ds.env_name), device="cpu")
    assert torch.equal(back.trajs, small.trajs)
    # The JAX package reads what the port wrote, and fits the same normalizer.
    jback = JDataset.load(str(tmp_path), model_id(ds.env_name))
    np.testing.assert_array_equal(np.asarray(jback.trajs_normalized), back.trajs_normalized.numpy())


def test_dataset_hard_conditions_match_jax(conveyor):
    ds, jds = conveyor
    start, goal = np.array([-0.5, 0.25], np.float32), np.array([0.75, -0.8], np.float32)
    got = ds.get_hard_conditions(torch.from_numpy(start), torch.from_numpy(goal))
    want = jds.get_hard_conditions(jnp.asarray(start), jnp.asarray(goal))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))


def test_from_trajs_refuses_a_flat_array():
    with pytest.raises(ValueError, match="N, H, D"):
        TrajectoryDataset.from_trajs(np.zeros((5, 4), np.float32), "EnvEmpty2D", device="cpu")
