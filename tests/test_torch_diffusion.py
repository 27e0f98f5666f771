"""Schedule, DDPM step and guided sampling loop of the port against JAX.

The loop is compared step by step: the port is fed the normal draws that
`mmd_tpu.models.diffusion.guided_p_sample_loop` makes, rebuilt from its
`jax.random.split` sequence (diffusion.py:152-163). Tolerances: the
schedule is computed by the same numpy code (exact); one step agrees to
1e-5 (the UNet's float32 rounding, ~3e-6, scaled by the step's
coefficients); the chain to 2e-3 at its first step, where the largest
coefficient (sqrt(1/alpha_bar - 1) at t=24) multiplies the UNet's rounding,
and to 1e-4 from the middle of the loop on, where the steps contract it.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmd_tpu.config import DiffusionConfig as JConfig
from mmd_tpu.costs.constraints import empty_constraint_set as jax_empty_cset
from mmd_tpu.costs.guide import GuideConfig as JGuideConfig, GuideData as JGuideData
from mmd_tpu.datasets.normalization import LimitsNormalizer as JNormalizer
from mmd_tpu.envs.envs import make_env as jax_make_env
from mmd_tpu.models import diffusion as jdiff
from mmd_tpu.models.schedules import make_schedule as jax_make_schedule
from mmd_tpu.models.temporal_unet import TemporalUnet as FlaxUnet
from mmd_torch.config import DiffusionConfig
from mmd_torch.costs.constraints import empty_constraint_set
from mmd_torch.costs.guide import GuideConfig, GuideData
from mmd_torch.datasets.normalization import LimitsNormalizer
from mmd_torch.envs.envs import SceneData
from mmd_torch.envs.grid_sdf import GridSDF
from mmd_torch.io.msgpack import load_msgpack
from mmd_torch.models import diffusion as tdiff
from mmd_torch.models.schedules import make_schedule
from mmd_torch.train.checkpoint import load_checkpoint

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_DIR = os.path.join(ROOT, "data_trained_models", "EnvEmptyNoWait2D-RobotPlanarDisk")
B, H, D = 4, 64, 4


@pytest.fixture(scope="module")
def models():
    model, schedule, info = load_checkpoint(MODEL_DIR, device="cpu")
    flax_params = load_msgpack(os.path.join(MODEL_DIR, "ema_model.msgpack"))
    flax_model = FlaxUnet()
    return model, schedule, info, flax_model, flax_params


def torch_scene(scene) -> SceneData:
    def grid(g):
        return GridSDF(lower=tuple(np.asarray(g.lower).tolist()),
                       upper=tuple(np.asarray(g.upper).tolist()),
                       values=torch.from_numpy(np.array(g.values)),
                       grads=torch.from_numpy(np.array(g.grads)))
    return SceneData(grid=grid(scene.grid), extra_grid=grid(scene.extra_grid),
                     ws_min=torch.from_numpy(np.array(scene.ws_min)),
                     ws_max=torch.from_numpy(np.array(scene.ws_max)))


def guide_data(env_name, info):
    jscene = jax_make_env(env_name).scene
    mins, maxs = info["normalizer_mins"], info["normalizer_maxs"]
    jgd = JGuideData(scene=jscene, normalizer=JNormalizer.from_limits(mins, maxs),
                     constraints=jax_empty_cset(4, 1))
    tgd = GuideData(scene=torch_scene(jscene),
                    normalizer=LimitsNormalizer.from_limits(mins, maxs, "cpu"),
                    constraints=empty_constraint_set(4, 1, device="cpu"))
    return jgd, tgd


def hard_conds():
    start = np.array([-0.5, 0.6, 0.0, 0.0], np.float32)
    goal = np.array([0.7, -0.4, 0.0, 0.0], np.float32)
    j = jdiff.make_start_goal_hard_conds(jnp.asarray(start), jnp.asarray(goal), H)
    t = tdiff.make_start_goal_hard_conds(torch.from_numpy(start), torch.from_numpy(goal), H)
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    np.testing.assert_array_equal(t.values.numpy(), np.asarray(j.values))
    return j, t


@pytest.mark.parametrize("name", ["exponential", "cosine", "linear"])
def test_schedule_matches_jax(name):
    j = jax_make_schedule(name, 25)
    t = make_schedule(name, 25, device="cpu")
    for f in dataclasses.fields(t):
        np.testing.assert_array_equal(getattr(t, f.name).numpy(),
                                      np.asarray(getattr(j, f.name)), err_msg=f.name)
    assert np.all(np.isfinite(t.sqrt_recipm1_alphas_cumprod.numpy()))  # the beta clip


def test_forward_and_posterior_helpers_match_jax():
    j = jax_make_schedule("exponential", 25)
    s = make_schedule("exponential", 25, device="cpu")
    rng = np.random.default_rng(0)
    x, eps = (rng.standard_normal((B, H, D)).astype(np.float32) for _ in range(2))
    t = np.array([0, 5, 13, 24])
    pairs = [
        (jdiff.q_sample(j, jnp.asarray(x), jnp.asarray(t), jnp.asarray(eps)),
         tdiff.q_sample(s, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(eps))),
        (jdiff.predict_start_from_noise(j, jnp.asarray(x), jnp.asarray(t), jnp.asarray(eps)),
         tdiff.predict_start_from_noise(s, torch.from_numpy(x), torch.from_numpy(t),
                                        torch.from_numpy(eps))),
        (jdiff.q_posterior_mean(j, jnp.asarray(x), jnp.asarray(eps), jnp.asarray(t)),
         tdiff.q_posterior_mean(s, torch.from_numpy(x), torch.from_numpy(eps),
                                torch.from_numpy(t))),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("env_name", ["EnvEmptyNoWait2D", "EnvConveyor2D"])
@pytest.mark.parametrize("i,guided", [(20, False), (5, True), (-1, True)])
def test_ddpm_step_matches_jax(models, env_name, i, guided):
    model, schedule, info, flax_model, flax_params = models
    jgd, tgd = guide_data(env_name, info)
    jhard, thard = hard_conds()
    rng = np.random.default_rng(i + 10)
    x = np.clip(rng.standard_normal((B, H, D)), -1, 1).astype(np.float32)
    cfg = JConfig(n_samples=B, n_guide_steps=4)
    key = jax.random.PRNGKey(i + 100)
    noise = np.array(jax.random.normal(key, (B, H, D)))
    want = jdiff._ddpm_step(flax_model.apply, flax_params, jax_make_schedule("exponential", 25),
                            jnp.asarray(x), jnp.asarray(i), key, jhard, jgd, cfg,
                            JGuideConfig(), guided)
    got = tdiff._ddpm_step(model, schedule, torch.from_numpy(x), i, torch.from_numpy(noise),
                           thard, tgd, DiffusionConfig(n_samples=B, n_guide_steps=4),
                           GuideConfig(), guided)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_guided_loop_matches_jax_step_by_step(models):
    model, schedule, info, flax_model, flax_params = models
    jgd, tgd = guide_data("EnvEmptyNoWait2D", info)
    jhard, thard = hard_conds()
    jcfg = JConfig(n_samples=B, n_guide_steps=5)
    cfg = DiffusionConfig(n_samples=B, n_guide_steps=5)
    key = jax.random.PRNGKey(7)
    _, want = jdiff.guided_p_sample_loop(flax_model.apply, flax_params,
                                         jax_make_schedule("exponential", 25), jhard, key,
                                         jcfg, gd=jgd, guide_cfg=JGuideConfig())
    # The loop's draws: split once for x_T, then one key per step.
    k, init_key = jax.random.split(key)
    steps = cfg.step_indices()
    keys = jax.random.split(k, len(steps))
    noise = tdiff.SamplerNoise(
        x_T=torch.from_numpy(np.array(jax.random.normal(init_key, (B, H, D)))),
        steps=torch.from_numpy(np.stack([np.asarray(jax.random.normal(kk, (B, H, D)))
                                         for kk in keys])))
    x, got = tdiff.guided_p_sample_loop(model, schedule, thard, cfg, noise, gd=tgd,
                                        guide_cfg=GuideConfig())
    want = np.asarray(want)
    assert got.shape == want.shape == (len(steps) + 1, B, H, D)
    assert torch.equal(x, got[-1])
    err = np.abs(got.numpy() - want).max(axis=(1, 2, 3))
    assert err[0] == 0.0
    assert err.max() < 2e-3
    assert err[len(steps) // 2:].max() < 1e-4


def test_sampler_noise_draw_shapes():
    cfg = DiffusionConfig(n_samples=3)
    g = torch.Generator().manual_seed(0)
    n = tdiff.SamplerNoise.draw(cfg, g, "cpu")
    assert n.x_T.shape == (3, 64, 4) and n.steps.shape == (26, 3, 64, 4)
    assert cfg.n_guided_steps() == 14  # steps 12..0 and the noise-free step
