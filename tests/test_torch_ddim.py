"""DDIM sampling of the port against `mmd_tpu.models.diffusion.ddim_sample_loop`.

- The time pairs equal JAX's for every `ddim_substeps` in [0, 25] (JAX's
  pairs are read off the t's its loop feeds the model); -1 and 26 raise.
- The whole DDIM chain on EnvEmptyNoWait2D, from JAX's x_T, on the
  repository's checkpoint and on a width-16 UNet initialized by JAX with
  its parameters carried across; on EnvConveyor2D each substep alone, fed
  JAX's chain (there a rounding difference can move a waypoint across an
  SDF cell edge and the guide amplifies it over a chain, ROADMAP Queue 3).
  Tolerance: RTOL (1e-6, ~10 float32 ulps) of the largest entry, plus
  UNET_TOL (3e-6, one UNet forward's float32 difference between the
  packages) times the substeps' gains so far. A substep from t to t'
  multiplies the UNet's output by sqrt(1 / alpha_bar_t - 1) sqrt(alpha_bar_t'):
  3282 from t = 24, where DDIM (which does not clamp x0) also drives the
  samples to ~150 in normalized units, then 0.76 and less.
- The planner, the noise draws, the UNet-forward count and the bench twin
  take the sampler as JAX's do.
Both sides plan on JAX's SDF grids (`torch_scene`).
"""
import dataclasses
import functools
import os
import subprocess
import sys

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
from mmd_tpu.models.temporal_unet import init_unet as jinit_unet
from mmd_tpu.models.temporal_unet import TemporalUnet as FlaxUnet
from mmd_torch.config import DiffusionConfig
from mmd_torch.io.msgpack import load_msgpack
from mmd_torch.costs.constraints import empty_constraint_set
from mmd_torch.costs.guide import GuideConfig, GuideData
from mmd_torch.datasets.normalization import LimitsNormalizer
from mmd_torch.models import diffusion as tdiff
from mmd_torch.models.schedules import make_schedule
from mmd_torch.models.temporal_unet import TemporalUnet, convert_flax_params
from mmd_torch.planners.multi_agent.cbs import CBS
from mmd_torch.planners.single_agent.mpd import load_planners
from mmd_torch.train.checkpoint import load_checkpoint
from test_torch_diffusion import torch_scene

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, D, DIM, MULTS = 4, 64, 4, 16, (1, 2)
GUIDE_STEPS = 5
RTOL, UNET_TOL = 1e-6, 3e-6
MINS = np.array([-1.0, -1.0, -0.5, -0.5], np.float32)
MAXS = np.array([1.0, 1.0, 0.5, 0.5], np.float32)


def jax_pairs(substeps: int):
    """(t, t_next) of JAX's DDIM loop: the t's it feeds the model, each
    followed by the next one, and -1 after the last."""
    seen = []

    def apply_fn(params, x, t):
        seen.append(int(t[0]))
        return jnp.zeros_like(x)

    hard = jdiff.HardConds(mask=jnp.zeros((H, 1)), values=jnp.zeros((H, D)))
    jdiff.ddim_sample_loop(apply_fn, None, jax_make_schedule("exponential", 25), hard,
                           jax.random.PRNGKey(0),
                           JConfig(n_samples=1, sampler="ddim", ddim_substeps=substeps))
    return list(zip(seen, seen[1:] + [-1]))


@pytest.mark.parametrize("substeps", range(26))
def test_time_pairs_equal_jaxs(substeps):
    cfg = DiffusionConfig(sampler="ddim", ddim_substeps=substeps)
    assert cfg.ddim_time_pairs() == jax_pairs(substeps)
    assert cfg.n_unet_forwards() == len(cfg.ddim_time_pairs())


@pytest.mark.parametrize("bad", [-1, 26])
def test_substeps_outside_the_range_raise(bad):
    with pytest.raises(ValueError):
        DiffusionConfig(sampler="ddim", ddim_substeps=bad)
    with pytest.raises(ValueError):
        DiffusionConfig(sampler="ddmi")


def test_default_counts_are_the_reference_fast_mode():
    cfg = DiffusionConfig(sampler="ddim")
    assert cfg.ddim_time_pairs() == [(24, 19), (19, 14), (14, 9), (9, 4), (4, 0), (0, -1)]
    # Guided where t_next is 9, 4 or 0: 3 x 20 guide calls, one UNet forward a pair.
    assert (cfg.n_guided_steps(), cfg.n_unet_forwards()) == (3, 6)
    assert (cfg.n_guided_steps(3), cfg.n_unet_forwards(3)) == (4, 4)  # a local replan: DDPM
    assert (DiffusionConfig().n_guided_steps(), DiffusionConfig().n_unet_forwards()) == (14, 26)


def width16():
    """A width-16 UNet initialized by JAX, its parameters carried to the port."""
    kw = dict(horizon=H, state_dim=D, unet_input_dim=DIM, dim_mults=MULTS)
    params = jax.jit(lambda key: jinit_unet(key, **kw)[1])(jax.random.PRNGKey(5))
    jmodel = FlaxUnet(state_dim=D, unet_input_dim=DIM, dim_mults=MULTS)
    model = TemporalUnet(state_dim=D, unet_input_dim=DIM, dim_mults=MULTS)
    model.load_state_dict(convert_flax_params(jax.tree_util.tree_map(np.asarray, params),
                                              n_levels=len(MULTS)))
    return jmodel, params, model.eval()


def checkpoint(env_name):
    """The repository's checkpoint of `env_name`, read by both packages."""
    d = os.path.join(ROOT, "data_trained_models", f"{env_name}-RobotPlanarDisk")
    model, _, _ = load_checkpoint(d, device="cpu")
    return FlaxUnet(), load_msgpack(os.path.join(d, "ema_model.msgpack")), model


def guide_data(env_name):
    jscene = jax_make_env(env_name).scene
    jgd = JGuideData(scene=jscene, normalizer=JNormalizer.from_limits(MINS, MAXS),
                     constraints=jax_empty_cset(4, 1))
    tgd = GuideData(scene=torch_scene(jscene),
                    normalizer=LimitsNormalizer.from_limits(MINS, MAXS, "cpu"),
                    constraints=empty_constraint_set(4, 1, device="cpu"))
    return jgd, tgd


def jax_chain(unet, env_name, key):
    jmodel, params, _ = unet
    jgd, _ = guide_data(env_name)
    start = jnp.asarray([-0.8, 0.1, 0.0, 0.0])
    goal = jnp.asarray([0.7, -0.2, 0.0, 0.0])
    hard = jdiff.make_start_goal_hard_conds(start, goal, H)
    _, init_key = jax.random.split(key)
    x_T = np.array(jax.random.normal(init_key, (B, H, D)))
    thard = tdiff.HardConds(mask=torch.from_numpy(np.array(hard.mask)),
                            values=torch.from_numpy(np.array(hard.values)))
    return np.asarray(_jax_loop(jmodel, key, params, jgd, hard)), x_T, thard


@functools.partial(jax.jit, static_argnums=0)
def _jax_loop(jmodel, key, params, gd, hard):
    """JAX's DDIM chain, compiled once per UNet shape: the scene and the
    parameters are arguments."""
    cfg = JConfig(n_samples=B, n_guide_steps=GUIDE_STEPS, sampler="ddim")
    return jdiff.ddim_sample_loop(jmodel.apply, params, jax_make_schedule("exponential", 25),
                                  hard, key, cfg, gd=gd, guide_cfg=JGuideConfig())[1]


def gains(cfg):
    """What each substep multiplies the UNet's output by (1 at the final
    pair, which returns x0 scaled by sqrt(1 / alpha_bar_0 - 1) ~ 0.01)."""
    ac = make_schedule("exponential", 25, "cpu").alphas_cumprod.double().numpy()
    return [np.sqrt(1 / ac[t] - 1) * (np.sqrt(ac[tn]) if tn >= 0 else 1.0)
            for t, tn in cfg.ddim_time_pairs()]


@pytest.mark.parametrize("net", ["checkpoint", "width16"])
def test_ddim_chain_matches_jax_on_the_empty_map(net):
    unet = checkpoint("EnvEmptyNoWait2D") if net == "checkpoint" else width16()
    chain, x_T, hard = jax_chain(unet, "EnvEmptyNoWait2D", jax.random.PRNGKey(11))
    _, tgd = guide_data("EnvEmptyNoWait2D")
    cfg = DiffusionConfig(n_samples=B, n_guide_steps=GUIDE_STEPS, sampler="ddim")
    noise = tdiff.SamplerNoise(x_T=torch.from_numpy(x_T), steps=torch.zeros((0, B, H, D)))
    # The dispatch: a fresh full loop of a DDIM config is the DDIM loop.
    x, got = tdiff.guided_p_sample_loop(unet[2], make_schedule("exponential", 25, "cpu"),
                                        hard, cfg, noise, gd=tgd, guide_cfg=GuideConfig())
    assert got.shape == chain.shape == (7, B, H, D)
    assert torch.equal(x, got[-1])
    err = np.abs(got.numpy() - chain).max(axis=(1, 2, 3))
    assert err[0] == 0.0
    bound = RTOL * np.abs(chain).max(axis=(1, 2, 3)) + UNET_TOL * np.cumsum([0.0] + gains(cfg))
    assert (err <= bound).all(), (err, bound)


def test_each_ddim_substep_matches_jax_on_conveyor():
    unet = checkpoint("EnvConveyor2D")
    chain, _, hard = jax_chain(unet, "EnvConveyor2D", jax.random.PRNGKey(12))
    _, tgd = guide_data("EnvConveyor2D")
    cfg = DiffusionConfig(n_samples=B, n_guide_steps=GUIDE_STEPS, sampler="ddim")
    schedule = make_schedule("exponential", 25, "cpu")
    for k, ((t, t_next), gain) in enumerate(zip(cfg.ddim_time_pairs(), gains(cfg))):
        with torch.no_grad():
            got = tdiff.ddim_step(unet[2], schedule, torch.from_numpy(chain[k]), t, t_next, hard,
                                  tgd, cfg, GuideConfig())
        err = float(np.abs(got.numpy() - chain[k + 1]).max())
        assert err <= RTOL * np.abs(chain[k + 1]).max() + UNET_TOL * gain, (k, err)


@pytest.fixture(scope="module")
def planners():
    return load_planners(os.path.join(ROOT, "data_trained_models"),
                         os.path.join(ROOT, "data_trajectories"), "EnvEmptyNoWait2D",
                         [np.array([0.8, 0.0], np.float32)], [np.array([-0.8, 0.0], np.float32)],
                         device="cpu", sampler="ddim")


def test_ddim_planner_draws_x_T_alone_and_plans(planners):
    planner = planners[0]
    planner.cfg = dataclasses.replace(planner.cfg, n_samples=B, n_guide_steps=2)
    assert planner.cfg.sampler == "ddim"
    noise = planner.draw_noise()
    assert noise.x_T.shape == (B, H, D) and noise.steps.shape == (0, B, H, D)
    local = planner.draw_noise(local=True)  # a local replan stays DDPM
    assert local.steps.shape == (4, B, H, D)
    tiles = tdiff.SamplerNoise.draw(planner.cfg, torch.Generator().manual_seed(0), "cpu",
                                    n_tiles=3)  # so does a multi-tile loop
    assert tiles.steps.shape == (26, 3, B, H, D)
    out = planner(noise=noise)
    assert out.trajs_iters.shape == (7, B, H, D) and torch.isfinite(out.trajs_final).all()
    again = planner(noise=noise)
    assert torch.equal(out.trajs_final, again.trajs_final)


def test_local_replan_of_a_ddim_planner_is_ddpm(planners):
    planner = planners[0]
    ddpm = dataclasses.replace(planner.cfg, n_samples=B, n_guide_steps=1, sampler="ddpm")
    ddim = dataclasses.replace(ddpm, sampler="ddim")
    noise = tdiff.SamplerNoise.draw(ddpm, torch.Generator().manual_seed(1), "cpu", 3)
    seed = torch.zeros((B, H, D))
    chains = [tdiff.run_local_inference(planner.model, planner.schedule, planner.hard_conds,
                                        None, seed, noise, cfg, planner.guide_cfg)
              for cfg in (ddpm, ddim)]
    assert torch.equal(*chains)


def test_search_counts_ddim_unet_forwards(planners):
    search = CBS(planners, [np.array([0.8, 0.0])], [np.array([-0.8, 0.0])])
    search._count_plans(local=False, n=2)
    search._count_plans(local=True)
    assert search.timing["unet_forwards"] == 2 * 6 + 4


def test_bench_twin_takes_ddim_and_asks_for_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: there the bench runs")
    proc = subprocess.run([sys.executable, "-m", "mmd_torch.bench"], cwd=ROOT,
                          env={**os.environ, "MMD_BENCH_SAMPLER": "ddim"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and proc.stdout == ""
    assert "needs a CUDA card" in proc.stderr and "not port" not in proc.stderr
