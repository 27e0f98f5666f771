"""The multi-tile ensemble of the port against the JAX package.

Both sides run on the CPU on the repository's real checkpoints and on
JAX's SDF grids, from the same normal draws (JAX's keys rebuilt here as its
ensemble loop splits them: the loop key into (key, init_key), then one key
per step and tile).

What is held, and why so:
- `CrossConds` and the seams: exact (the same float32 min/max).
- The batched per-tile forward (`stack_params`, vmap over the stacked
  parameters) against a loop of per-tile forwards and against flax's
  vmapped apply of JAX's `stack_params`: FORWARD_TOL (1e-5) on outputs of
  magnitude ~10 (vmap runs the convolutions as one grouped convolution,
  whose float32 sums are ordered otherwise: measured ~4e-6). The bf16
  twins batch too: against their loop within BF16_TOL.
- The checkpoint stack: each tile's converted parameters equal JAX's
  `stack_params` of the flax trees, the normalizers JAX's stacked ones.
- `ensemble_p_sample_loop` on two EnvEmptyNoWait2D tiles (no obstacle),
  B=8, at full depth and on a short schedule (8 + 1 steps, guided from
  t = 3, 5 guide iterations): each step fed JAX's chain within STEP_TOL
  (1e-4; the full loop's first step, t = 24, within FIRST_STEP_TOL), the
  whole loop's final state within LOOP_TOL (1e-4) at full depth and, on
  the short schedule, within BALL_FACTOR times JAX's own spread there
  (the test's docstring says why); the finalize's free mask and index
  equal.
- The same steps on an EnvConveyor2D + EnvHighways2D skeleton: under
  obstacles the guided loop amplifies float32 rounding in JAX as in the
  port (PERF.md section 6), so a step is held to BALL_FACTOR (2) times
  JAX's own spread at that step (its step compiled alone against its
  chain, and under a 1e-7 relative change of its input), or STEP_TOL
  where that is wider, and both are printed.
- `_route_constraints`, hard and soft, global -> per tile: exact (the
  port's soft rows are not padded to JAX's row bucket; JAX's extra rows
  are masked out).
- `_finalize_ensemble` on JAX's chain: free mask, waypoint collisions and
  index equal, trajectories within FINAL_TOL (1e-5).
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmd_tpu.common.constraints import MultiPointConstraint as JMultiPoint
from mmd_tpu.datasets.normalization import LimitsNormalizer as JNormalizer
from mmd_tpu.datasets.trajectories import TrajectoryDataset as JDataset
from mmd_tpu.models import ensemble as jens
from mmd_tpu.models.diffusion import HardConds as JHardConds
from mmd_tpu.models.diffusion import _ddpm_step as jax_ddpm_step
from mmd_tpu.planners.single_agent import mpd_ensemble as jme
from mmd_tpu.train.trainer import load_checkpoint as jax_load_checkpoint
from mmd_torch.common.constraints import MultiPointConstraint
from mmd_torch.datasets.normalization import LimitsNormalizer
from mmd_torch.datasets.trajectories import TrajectoryDataset
from mmd_torch.envs.envs import SceneData, SceneStack
from mmd_torch.envs.grid_sdf import GridSDF
from mmd_torch.models import ensemble as tens
from mmd_torch.models.diffusion import SamplerNoise
from mmd_torch.models.temporal_unet import bf16_model, convert_flax_params
from mmd_torch.planners.single_agent import mpd_ensemble as tme
from mmd_torch.train.checkpoint import load_checkpoint, load_tile_checkpoints

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENVS = ("EnvEmptyNoWait2D", "EnvConveyor2D", "EnvHighways2D", "EnvDropRegion2D")
B = 8
SHORT = dict(n_samples=B, n_diffusion_steps=8, t_start_guide=4, n_guide_steps=5)
FORWARD_TOL = 1e-5
BF16_TOL = 5e-2      # bf16 twins, batched against their loop (bf16 keeps 8 bits)
STEP_TOL = LOOP_TOL = 1e-4
FIRST_STEP_TOL = 2e-3
FINAL_TOL = 1e-5
BALL_FACTOR = 2.0


def mid(env: str) -> str:
    return f"{env}-RobotPlanarDisk"


@pytest.fixture(scope="module")
def tiles():
    """Per env: the port's (model, schedule, dataset) and JAX's (model,
    params, schedule, dataset), each dataset with its checkpoint's
    normalizer."""
    out = {}
    for env in ENVS:
        d = os.path.join(ROOT, "data_trained_models", mid(env))
        model, schedule, info = load_checkpoint(d, device="cpu")
        ds = TrajectoryDataset.load(
            os.path.join(ROOT, "data_trajectories"), mid(env),
            LimitsNormalizer.from_limits(info["normalizer_mins"], info["normalizer_maxs"],
                                         "cpu"), device="cpu")
        jmodel, params, jschedule, jinfo = jax_load_checkpoint(d)
        jds = JDataset.load(os.path.join(ROOT, "data_trajectories"), mid(env))
        jds.normalizer = JNormalizer.from_limits(jinfo["normalizer_mins"],
                                                 jinfo["normalizer_maxs"])
        out[env] = ((model, schedule, ds), (jmodel, params, jschedule, jds))
    return out


def make_pair(tiles, envs, transforms, start, goal, **cfg):
    """The port's and JAX's MPDEnsemble over the same tiles and task."""
    t = [tiles[e][0] for e in envs]
    j = [tiles[e][1] for e in envs]
    tp = tme.MPDEnsemble([m for m, _, _ in t], t[0][1], [d for _, _, d in t], transforms,
                         start, goal)
    jp = jme.MPDEnsemble([m for m, _, _, _ in j], [p for _, p, _, _ in j], j[0][2],
                         [d for _, _, _, d in j], transforms, np.asarray(start),
                         np.asarray(goal))
    tp.cfg = dataclasses.replace(tp.cfg, **cfg)
    jp.cfg = dataclasses.replace(jp.cfg, **cfg)
    # The port plans on JAX's grids: its own differ from them by 1 ulp in
    # their points, which moves the gradient of a few cells on the box
    # SDF's tie lines (tests/test_torch_grid_sdf.py).
    tp.scene = tp.task.stacked_scenes = SceneStack(tuple(
        torch_scene(t.scene) for t in jp.task.tasks))
    return tp, jp


def torch_scene(scene) -> SceneData:
    """A JAX scene's arrays as the port's SceneData."""
    def grid(g):
        return GridSDF(lower=tuple(np.asarray(g.lower).tolist()),
                       upper=tuple(np.asarray(g.upper).tolist()),
                       values=torch.from_numpy(np.array(g.values)),
                       grads=torch.from_numpy(np.array(g.grads)))
    return SceneData(grid=grid(scene.grid), extra_grid=grid(scene.extra_grid),
                     ws_min=torch.from_numpy(np.array(scene.ws_min)),
                     ws_max=torch.from_numpy(np.array(scene.ws_max)))


def loop_noise(key, cfg, n_tiles: int, n_steps=None) -> SamplerNoise:
    """The draws of JAX's ensemble loop from its key (ensemble.py:106-117);
    `cfg` is the port's config (its step list)."""
    key, init_key = jax.random.split(key)
    shape = (cfg.n_samples, cfg.horizon, cfg.state_dim)
    S = len(cfg.step_indices(n_steps))
    keys = jax.random.split(key, S * n_tiles).reshape(S, n_tiles, 2)
    return SamplerNoise(
        x_T=torch.from_numpy(np.array(jax.random.normal(init_key, (n_tiles,) + shape))),
        steps=torch.from_numpy(np.stack([[np.asarray(jax.random.normal(keys[n, m], shape))
                                          for m in range(n_tiles)] for n in range(S)])))


def loop_keys(key, cfg, n_tiles: int):
    key, _ = jax.random.split(key)
    S = len(cfg.step_indices())
    return jax.random.split(key, S * n_tiles).reshape(S, n_tiles, 2)


# ---------------------------------------------------------------- seams
@pytest.mark.parametrize("transforms", [
    [[0.0, 0.0], [2.0, 0.0]],
    [[0.0, 0.0], [2.0, 0.0], [2.0, -2.0]],
    [[2.0, -2.0], [2.0, 0.0], [2.0, -2.0]],
    [[0.0, 0.0]],
], ids=["right", "right-down", "up-down", "one"])
def test_cross_conds_and_seams_match_jax(transforms):
    tr = np.asarray(transforms, np.float32)
    cc = tens.CrossConds.from_transforms(tr, device="cpu")
    jcc = jens.CrossConds.from_transforms(tr)
    np.testing.assert_array_equal(cc.rel.numpy(), np.asarray(jcc.rel))
    np.testing.assert_array_equal(cc.boundary.numpy(), np.asarray(jcc.boundary))
    rng = np.random.default_rng(len(transforms))
    x = rng.uniform(-1.3, 1.3, (len(tr), 3, 6, 4)).astype(np.float32)
    got = tens.apply_cross_conditioning(torch.from_numpy(x), cc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jens.apply_cross_conditioning(
        jnp.asarray(x), jcc)))
    assert float(tens.seam_residual(got, cc)) == 0.0
    if len(tr) > 1:
        assert float(tens.seam_residual(torch.from_numpy(x), cc)) > 0.0


# ------------------------------------------------------------- forwards
def test_stacked_forward_matches_tile_loop_and_flax(tiles):
    envs = ENVS[:3]
    models = [tiles[e][0][0] for e in envs]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, B, 64, 4)).astype(np.float32)
    t = rng.integers(0, 25, B)
    stacked = tens.stack_params(models)
    with torch.no_grad():
        got = stacked(torch.from_numpy(x), torch.from_numpy(t)).numpy()
        loop = np.stack([m(torch.from_numpy(x[k]), torch.from_numpy(t)).numpy()
                         for k, m in enumerate(models)])
    jmodel = tiles[envs[0]][1][0]
    jstacked = jens.stack_params([tiles[e][1][1] for e in envs])
    flax = np.asarray(jax.vmap(jmodel.apply, in_axes=(0, 0, None))(
        jstacked, jnp.asarray(x), jnp.asarray(t, jnp.int32)))
    gaps = (np.abs(got - loop).max(), np.abs(got - flax).max())
    print(f"stacked forward against the tile loop {gaps[0]:.3g}, against flax's vmap "
          f"{gaps[1]:.3g}, outputs up to {np.abs(flax).max():.3g}")
    assert gaps[0] <= FORWARD_TOL and gaps[1] <= FORWARD_TOL, gaps

    twins = [bf16_model(m) for m in models]
    with torch.no_grad():
        got16 = tens.stack_params(twins)(torch.from_numpy(x), torch.from_numpy(t))
        loop16 = torch.stack([m(torch.from_numpy(x[k]), torch.from_numpy(t))
                              for k, m in enumerate(twins)])
    assert got16.dtype == torch.float32
    gap16 = float((got16 - loop16).abs().max() / loop16.abs().max())
    print(f"bf16 twins, batched against their loop: {gap16:.3g} of max |eps|")
    assert gap16 <= BF16_TOL


def test_checkpoint_stack_matches_jax_stack_params(tiles):
    dirs = [os.path.join(ROOT, "data_trained_models", mid(e)) for e in ENVS]
    stacked, schedule, normalizer, infos = load_tile_checkpoints(dirs, device="cpu")
    assert stacked.n_tiles == len(ENVS) and len(infos) == len(ENVS)
    jstacked = jens.stack_params([tiles[e][1][1] for e in ENVS])
    for m in range(len(ENVS)):
        tile_tree = jax.tree_util.tree_map(lambda a: np.asarray(a[m]), jstacked)
        want = convert_flax_params(jax.device_get(tile_tree))
        assert set(want) == set(stacked.params)
        for name, value in want.items():
            assert torch.equal(stacked.params[name][m], value), name
    jnorm = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                   *[tiles[e][1][3].normalizer for e in ENVS])
    np.testing.assert_array_equal(normalizer.mins[:, 0, 0].numpy(), np.asarray(jnorm.mins))
    np.testing.assert_array_equal(normalizer.maxs[:, 0, 0].numpy(), np.asarray(jnorm.maxs))
    assert schedule.n_steps == tiles[ENVS[0]][1][2].n_steps


# ----------------------------------------------------------------- loop
def jax_chain(jp, key, gds):
    _, chain = jens.ensemble_p_sample_loop(jp.model.apply, jp.stacked_params, jp.schedule,
                                           jp.hard_conds, jp.cc, key, jp.cfg, gds=gds,
                                           guide_cfg=jp.guide_cfg, n_tiles=jp.n_tiles)
    return np.array(chain)


def port_steps(tp, jchain, noise, gds):
    """The port's step from each state of JAX's chain."""
    errs = []
    for n, i in enumerate(tp.cfg.step_indices()):
        x = tens.ensemble_step(tp.model, tp.schedule, torch.from_numpy(jchain[n]), i,
                               noise.steps[n], tp.hard_conds, tp.cc, gds, tp.cfg,
                               tp.guide_cfg)
        errs.append(float(np.abs(x.numpy() - jchain[n + 1]).max()))
    return errs


def jax_loop_spread(jp, key, jgds, chain) -> float:
    """How far JAX's whole loop moves from its chain when compiled as
    another program (x_T given as a warm start) and when x_T is scaled by
    1 + 1e-7: the larger, over the final state."""
    _, init_key = jax.random.split(key)
    x_T = jax.random.normal(init_key, chain.shape[1:])

    @jax.jit
    def run(scale):
        _, c = jens.ensemble_p_sample_loop(jp.model.apply, jp.stacked_params, jp.schedule,
                                           jp.hard_conds, jp.cc, key, jp.cfg, gds=jgds,
                                           guide_cfg=jp.guide_cfg, warm_start=x_T * scale,
                                           n_tiles=jp.n_tiles)
        return c[-1]

    a, b = np.array(run(jnp.float32(1.0))), np.array(run(jnp.float32(1 + 1e-7)))
    return float(max(np.abs(a - chain[-1]).max(), np.abs(a - b).max()))


@pytest.mark.parametrize("depth", ["short", "full"])
def test_ensemble_loop_matches_jax_on_two_empty_tiles(tiles, depth):
    """Full depth is the planner's (25 + 1 steps, 14 guided x 20 guide
    iterations); its first step (t = 24) multiplies the UNet's float32
    rounding by sqrt(1/alphabar - 1) = 4176.9 and is held to
    FIRST_STEP_TOL, as in tests/test_torch_local.py. The short schedule
    starts its guided steps from rougher samples, where the guide's
    per-waypoint clip amplifies rounding: there JAX's own loop moves by
    ~1e-4-2.3e-4 when compiled as another program or nudged by 1e-7, so
    its whole chain is held to BALL_FACTOR times that spread."""
    cfg = SHORT if depth == "short" else dict(n_samples=B)
    tp, jp = make_pair(tiles, ["EnvEmptyNoWait2D"] * 2, [[0.0, 0.0], [2.0, 0.0]],
                       [-0.5, 0.1], [2.5, -0.1], **cfg)
    key = jax.random.PRNGKey(3)
    jgds = jp._guide_data(*jp._route_constraints(None))
    chain = jax_chain(jp, key, jgds)
    noise = loop_noise(key, tp.cfg, 2)
    gds = tp._guide_data(*tp._route_constraints(None))
    errs = port_steps(tp, chain, noise, gds)
    _, got = tens.ensemble_p_sample_loop(tp.model, tp.schedule, tp.hard_conds, tp.cc,
                                         tp.cfg, noise, gds=gds, guide_cfg=tp.guide_cfg)
    whole = float(np.abs(got[-1].numpy() - chain[-1]).max())
    first = errs[0] if depth == "full" else 0.0
    print(f"{depth}: first step {first:.3g}, later steps {max(errs[1:]):.3g}, "
          f"whole {whole:.3g}")
    assert first <= FIRST_STEP_TOL and max(errs[1:] if depth == "full" else errs) <= STEP_TOL
    if depth == "full":
        assert whole <= LOOP_TOL, whole
    else:
        spread = jax_loop_spread(jp, key, jgds, chain)
        print(f"short: JAX's own spread {spread:.3g}")
        assert whole <= max(LOOP_TOL, BALL_FACTOR * spread), (whole, spread)

    want = jme._finalize_ensemble(jnp.asarray(chain), jgds, jnp.asarray(jp.transforms),
                                  jp.task.stacked_scenes, jp.robot.radius, jp.robot.q_min,
                                  jp.robot.q_max, jp._savgol)
    res = tp._plan_fresh(gds, noise)
    np.testing.assert_array_equal(res.free_mask.numpy(), np.asarray(want.free_mask))
    assert int(res.idx_best) == int(want.idx_best)
    assert float(tens.seam_residual(got[-1], tp.cc)) == 0.0


def jax_step_spread(jp, jgds, chain, keys, steps) -> list:
    """Per guided step of JAX's chain (0 for the others): the largest of how
    far its ensemble step, compiled alone, lands from the chain's next
    state, and how far that step moves when its input is scaled by
    1 +- 1e-7."""
    @functools.partial(jax.jit, static_argnames="guided")
    def step(x, i, ks, guided):
        def tile_step(params_m, x_m, key_m, hard_m, gd_m):
            return jax_ddpm_step(jp.model.apply, params_m, jp.schedule, x_m, i, key_m,
                                 JHardConds(mask=hard_m[0], values=hard_m[1]), gd_m, jp.cfg,
                                 jp.guide_cfg, guided)
        x = jax.vmap(tile_step, in_axes=(0, 0, 0, (0, 0), 0))(
            jp.stacked_params, x, ks, (jp.hard_conds.mask, jp.hard_conds.values), jgds)
        return jens.apply_cross_conditioning(x, jp.cc)

    gaps = []
    for n, i in enumerate(steps):
        guided = i < jp.cfg.t_start_guide
        if not guided:
            gaps.append(0.0)
            continue
        x = jnp.asarray(chain[n])
        a = np.array(step(x, jnp.int32(i), keys[n], guided))
        moved = [np.abs(a - np.array(step(x * np.float32(1 + d), jnp.int32(i), keys[n],
                                          guided))).max() for d in (1e-7, -1e-7)]
        gaps.append(float(max(np.abs(a - chain[n + 1]).max(), *moved)))
    return gaps


def test_ensemble_steps_match_jax_under_obstacles(tiles):
    tp, jp = make_pair(tiles, ["EnvConveyor2D", "EnvHighways2D"], [[2.0, 0.0], [2.0, -2.0]],
                       [2.6, 0.65], [2.3, -2.8], **SHORT)
    key = jax.random.PRNGKey(7)
    jgds = jp._guide_data(*jp._route_constraints(None))
    chain = jax_chain(jp, key, jgds)
    noise = loop_noise(key, tp.cfg, 2)
    errs = port_steps(tp, chain, noise, tp._guide_data(*tp._route_constraints(None)))
    gaps = jax_step_spread(jp, jgds, chain, loop_keys(key, tp.cfg, 2), tp.cfg.step_indices())
    print(f"port against JAX's chain per step {errs}; JAX's own spread {gaps}")
    assert all(e <= max(STEP_TOL, BALL_FACTOR * g) for e, g in zip(errs, gaps)), (errs, gaps)


# -------------------------------------------------------------- routing
def route_cases():
    """(hard and soft CT constraints across tile boundaries, an ECBS-style
    soft path over the global horizon, the PP-style clipped one)."""
    rng = np.random.default_rng(5)
    ct = [dict(q_l=[rng.uniform(-1, 5, 2).astype(np.float32)], t_range_l=[(t0, t0 + 4)],
               radius_l=[0.12], is_soft=soft)
          for t0, soft in ((3, False), (62, False), (64, True), (130, False), (190, True))]
    path = dict(q_l=[rng.uniform(-1, 5, 2).astype(np.float32) for _ in range(2 * 191)],
                t_range_l=[(t, t + 1) for t in range(1, 192)] * 2,
                radius_l=[0.12] * (2 * 191), is_soft=True)
    pp = dict(path, t_range_l=[(min(t0, 63), min(63, t1)) for t0, t1 in path["t_range_l"]],
              is_soft=False)
    return {"ct": ct, "ecbs": ct[:2] + [path], "pp": [pp]}


@pytest.mark.parametrize("case", ["ct", "ecbs", "pp"])
def test_route_constraints_matches_jax(tiles, case):
    envs = ["EnvEmptyNoWait2D", "EnvConveyor2D", "EnvHighways2D"]
    tp, jp = make_pair(tiles, envs, [[0.0, 0.0], [2.0, 0.0], [2.0, -2.0]],
                       [-0.5, 0.3], [2.3, -2.4], **SHORT)
    cons = route_cases()[case]
    cset, spc = tp._route_constraints([MultiPointConstraint(**c) for c in cons])
    jcset, jspc = jp._route_constraints([JMultiPoint(**c) for c in cons])
    for f in ("q", "t_range", "radius", "weight", "point_mask", "active"):
        np.testing.assert_array_equal(getattr(cset, f).numpy(), np.asarray(getattr(jcset, f)),
                                      err_msg=f)
    assert cset.n_active == int(np.asarray(jcset.active).sum())
    assert (spc is None) == (jspc is None) == (case != "ecbs")
    if spc is not None:
        R = spc.rows
        np.testing.assert_array_equal(spc.points.numpy(), np.asarray(jspc.points)[:, :R])
        np.testing.assert_array_equal(spc.mask.numpy(), np.asarray(jspc.mask)[:, :R])
        assert not np.asarray(jspc.mask)[:, R:].any()
        np.testing.assert_array_equal(spc.radius.numpy(), np.asarray(jspc.radius))
        np.testing.assert_array_equal(spc.weight.numpy(), np.asarray(jspc.weight))


# ------------------------------------------------------------- finalize
def test_finalize_ensemble_matches_jax(tiles):
    envs = ["EnvEmptyNoWait2D", "EnvConveyor2D", "EnvHighways2D"]
    tp, jp = make_pair(tiles, envs, [[0.0, 0.0], [2.0, 0.0], [2.0, -2.0]],
                       [-0.5, 0.3], [2.3, -2.4], **SHORT)
    rng = np.random.default_rng(9)
    # Straight lines in each tile's frame, a little noisy: the first half
    # along a free corridor of each map (anywhere on the empty map, y = 0.65
    # on the conveyor, x = 0.5 between the highways' boxes), the rest
    # between random points, most of them through an obstacle.
    ends = rng.uniform(-0.9, 0.9, (2, 3, 3, 4 * B, 1, 4)).astype(np.float32)
    ends[:, :, 1, :2 * B, 0, 1] = 0.65
    ends[:, :, 2, :2 * B, 0, 0] = 0.5
    line = np.linspace(0.0, 1.0, 64, dtype=np.float32)[:, None]
    world = torch.from_numpy(ends[0] + line * (ends[1] - ends[0])
                             + rng.normal(0, 0.005, (3, 3, 4 * B, 64, 4)).astype(np.float32))
    chain = tp.normalizer.normalize(world).numpy()
    res = tp._finalize(torch.from_numpy(chain))
    want = jme._finalize_ensemble(jnp.asarray(chain), jp._guide_data(*jp._route_constraints(None)),
                                  jnp.asarray(jp.transforms), jp.task.stacked_scenes,
                                  jp.robot.radius, jp.robot.q_min, jp.robot.q_max, jp._savgol)
    free = np.asarray(want.free_mask)
    assert 0 < free.sum() < len(free), free  # both kinds present
    np.testing.assert_array_equal(res.free_mask.numpy(), free)
    np.testing.assert_array_equal(res.wp_collisions.numpy(), np.asarray(want.wp_collisions))
    assert int(res.idx_best) == int(want.idx_best)
    for f in ("trajs_iters", "trajs_final", "cost_path_length", "cost_smoothness"):
        gap = float(np.abs(getattr(res, f).numpy() - np.asarray(getattr(want, f))).max())
        assert gap <= FINAL_TOL, (f, gap)
