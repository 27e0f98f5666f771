"""The slice as a whole: the port's MPD against JAX's `_plan_fresh`.

Both plan on the real EnvEmptyNoWait2D checkpoint at B=8, full depth (25+1
DDPM steps, 14 guided steps x 20 guide iterations), from the same normal
draws (the JAX key sequence rebuilt in the test). trajs_final is held to
atol 1e-4 (measured ~1e-5: float32 rounding in the UNet, amplified at the
first large-coefficient step and contracted by the loop); the free mask and
the chosen best trajectory must be equal.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmd_tpu.common.constraints import MultiPointConstraint
from mmd_tpu.datasets.normalization import LimitsNormalizer as JNormalizer
from mmd_tpu.datasets.trajectories import TrajectoryDataset as JDataset
from mmd_tpu.planners.single_agent.mpd import MPD as JMPD, _plan_fresh
from mmd_tpu.train.trainer import load_checkpoint as jax_load_checkpoint
from mmd_torch.datasets.normalization import LimitsNormalizer
from mmd_torch.datasets.trajectories import TrajectoryDataset, model_id, npz_array_shape
from mmd_torch.models.diffusion import SamplerNoise
from mmd_torch.planners.single_agent.mpd import MPD
from mmd_torch.train.checkpoint import load_checkpoint

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MID = model_id("EnvEmptyNoWait2D")
B = 8
START, GOAL = np.array([0.8, 0.0], np.float32), np.array([-0.8, 0.0], np.float32)


@pytest.fixture(scope="module")
def planners():
    model, schedule, info = load_checkpoint(os.path.join(ROOT, "data_trained_models", MID),
                                            device="cpu")
    ds = TrajectoryDataset.load(
        os.path.join(ROOT, "data_trajectories"), MID,
        LimitsNormalizer.from_limits(info["normalizer_mins"], info["normalizer_maxs"], "cpu"),
        device="cpu")
    jmodel, params, jschedule, jinfo = jax_load_checkpoint(
        os.path.join(ROOT, "data_trained_models", MID))
    jds = JDataset.load(os.path.join(ROOT, "data_trajectories"), MID)
    jds.normalizer = JNormalizer.from_limits(jinfo["normalizer_mins"], jinfo["normalizer_maxs"])

    def make(start, goal, seed):
        tm = MPD(model, schedule, ds, start, goal, seed=seed)
        tm.cfg = dataclasses.replace(tm.cfg, n_samples=B)
        jm = JMPD(jmodel, params, jschedule, jds, jnp.asarray(start), jnp.asarray(goal),
                  seed=seed)
        jm.cfg = dataclasses.replace(jm.cfg, n_samples=B)
        return tm, jm
    return make


def jax_plan_and_noise(jm, constraints_l):
    """Run JAX's fresh plan and rebuild the draws it made from its key."""
    key = jm._next_key()
    gd = jm._guide_data(*jm._pack(constraints_l))
    res = _plan_fresh(jm.model.apply, jm.params, jm.schedule, jm.hard_conds, gd, key,
                      jm.cfg, jm.guide_cfg, jm.task.scene, jm.robot.radius,
                      jm.robot.q_min, jm.robot.q_max, jm._savgol)
    k, init_key = jax.random.split(key)
    shape = (jm.cfg.n_samples, jm.cfg.horizon, jm.cfg.state_dim)
    n_steps = jm.cfg.n_diffusion_steps + jm.cfg.n_diffusion_steps_without_noise
    keys = jax.random.split(k, n_steps)
    noise = SamplerNoise(
        x_T=torch.from_numpy(np.array(jax.random.normal(init_key, shape))),
        steps=torch.from_numpy(np.stack([np.asarray(jax.random.normal(kk, shape))
                                         for kk in keys])))
    return res, noise


@pytest.mark.parametrize("constrained", [False, True], ids=["lone", "constrained"])
def test_mpd_matches_jax_plan_fresh(planners, constrained):
    tm, jm = planners(START, GOAL, seed=3)
    cons = ([MultiPointConstraint(q_l=[np.array([0.0, 0.05])], t_range_l=[(20, 44)],
                                  radius_l=[0.3])] if constrained else None)
    res, noise = jax_plan_and_noise(jm, cons)
    out = tm(constraints_l=cons, noise=noise)
    np.testing.assert_allclose(out.trajs_final.numpy(), np.asarray(res.trajs_final),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(out.trajs_iters.numpy(), np.asarray(res.trajs_iters),
                               rtol=0, atol=2e-3)
    free = np.asarray(res.free_mask)
    np.testing.assert_array_equal(np.isin(np.arange(B), out.trajs_final_free_idxs), free)
    assert free.any() and out.success_free_trajs == 1
    assert out.idx_best_traj == int(res.idx_best)
    assert out.fraction_free_trajs == float(free.mean())


def test_mpd_own_draws_are_seeded_and_outputs_are_complete(planners):
    tm_a, _ = planners(START, GOAL, seed=11)
    tm_b, _ = planners(START, GOAL, seed=11)
    a, b = tm_a(), tm_b()
    assert torch.equal(a.trajs_final, b.trajs_final)
    assert a.trajs_iters.shape == (27, B, 64, 4)
    assert a.trajs_final.shape == (B, 64, 4) and torch.isfinite(a.trajs_final).all()
    np.testing.assert_allclose(a.traj_final_free_best[0, :2].numpy(), START, atol=0.1)
    np.testing.assert_allclose(a.traj_final_free_best[-1, :2].numpy(), GOAL, atol=0.1)
    with pytest.raises(ValueError):
        tm_a(start_state_pos=GOAL)


def test_dataset_reads_only_metadata_and_npz_header():
    d = os.path.join(ROOT, "data_trajectories", MID)
    assert npz_array_shape(os.path.join(d, "trajs-free.npz")) == \
        np.load(os.path.join(d, "trajs-free.npz"))["trajs"].shape
