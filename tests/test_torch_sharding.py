"""The port's sharding (`mmd_torch.parallel.sharding`) against the JAX package.

Four ranks run with gloo on the CPU, spawned once for the whole file
(`mmd_torch.tools.shard_cases.sharding_case`, which the ranks import by
name: no rank imports this file or JAX). JAX runs in this process on the
8 virtual CPU devices of tests/conftest.py, on meshes of the same shapes.
What is held, and how closely:
- `_factor_mesh`: JAX's factors, exactly; `make_mesh`'s shapes and its
  errors as JAX's (tests/test_parallel.py:42-50,123-140), and its refusal
  without a process group; a backend that cannot serve a device raises.
- A shard and then `gather_leading_axis` under ('agent',) and under
  ('agent', 'dp') (2, 2): the identity, exactly.
- The CBS root (`plan_fresh_team`) of the 4-robot circle (radius 0.4),
  B = 8 at full depth, on JAX's draws, each rank one agent of a 4-rank
  'agent' mesh: bitwise equal on every rank; within ROOT_TOL (1e-5) of
  the unsharded port on the same draws with its UNet run B rows at a time
  (`RowChunked`, as each rank runs its share; the CPU's convolutions sum
  in another order at another batch size, tests/test_torch_batched.py),
  with the same free masks and indices; within TEAM_TOL (1e-4,
  tests/test_torch_local.py's team-root tolerance) of the plain unsharded
  port and of JAX's `plan_fresh_team` on JAX's 4-device 'agent' mesh.
  Both packages plan with the committed checkpoint's JAX-trained weights
  (the port's reader carries them across with `convert_flax_params`). A
  small UNet of JAX's random init does not serve here: its guided loop
  moves the port's own root by 7.6e-4 when x_T changes by 1e-7 relative,
  so that no 1e-4 comparison with JAX could be told from rounding.
- Three data-parallel train steps (`train_step_dp`) on a 4-rank 'dp'
  mesh, 4 rows a rank, against the unsharded `train_step` and against
  JAX's jitted step with the batch on a 4-device 'dp' mesh: the losses
  within LOSS_RTOL (1e-6 relative); Adam's first moments, which scale
  with the gradients, within MU_TOL (1e-5 of each leaf's largest value;
  measured 2.4e-6 against the unsharded step: the global mean is summed
  in another order); parameters and EMA within PARAM_TOL (1e-5
  absolute, 3% of one Adam step of lr 3e-4; measured 1.3e-6). Adam
  divides each gradient by its own scale, so the moments, not the
  parameters, show a gradient that is off by a factor; the parameters
  cannot be held to 1e-6: where a gradient is near 0 its rounding
  difference moves the step by up to lr.
- The tile ensemble's loop, 2 tiles over a 2-rank 'tile' mesh, each rank
  one tile's UNet: both ranks bitwise equal, within TILE_TOL (1e-5) of
  the unsharded loop and of JAX's `ensemble_p_sample_loop` on a 2-device
  'tile' mesh with the stacked parameters replicated over it. JAX's loop
  with them sharded on 'tile' (the JAX dry run's placement) is not
  JAX's own loop on this backend: XLA's partitioned vmap of the
  convolutions returns another forward (max |diff| 3.6 on outputs of max
  3.3), and the loop lands 0.79 away. The test prints that gap and holds
  nothing to it.
- `dryrun_multichip(4, "gloo", "cpu")` prints its OK line.
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from mmd_tpu.config import DiffusionConfig as JDiffusionConfig
from mmd_tpu.costs.constraints import empty_constraint_set as jempty_constraint_set
from mmd_tpu.costs.guide import GuideConfig as JGuideConfig
from mmd_tpu.costs.guide import GuideData as JGuideData
from mmd_tpu.datasets.normalization import LimitsNormalizer as JNormalizer
from mmd_tpu.datasets.trajectories import TrajectoryDataset as JDataset
from mmd_tpu.envs.envs import make_env as jmake_env
from mmd_tpu.models import ensemble as jens
from mmd_tpu.models.diffusion import HardConds as JHardConds
from mmd_tpu.models.schedules import make_schedule as jmake_schedule
from mmd_tpu.models.temporal_unet import TemporalUnet as JUnet
from mmd_tpu.models.temporal_unet import init_unet as jinit_unet
from mmd_tpu.parallel import sharding as jsharding
from mmd_tpu.parallel import team as jteam
from mmd_tpu.planners.single_agent.mpd import MPD as JMPD
from mmd_tpu.train import trainer as jtrainer
from mmd_tpu.train.trainer import load_checkpoint as jax_load_checkpoint
from mmd_torch.common.multi_agent_utils import get_start_goal_pos_circle
from mmd_torch.config import DiffusionConfig
from mmd_torch.models.diffusion import SamplerNoise
from mmd_torch.models.temporal_unet import convert_flax_params
from mmd_torch.parallel import dryrun, sharding
from mmd_torch.tools import shard_cases

torch.set_num_threads(1)

ROOT_TOL, TEAM_TOL = 1e-5, 1e-4
LOSS_RTOL, MU_TOL, PARAM_TOL = 1e-6, 1e-5, 1e-5
TILE_TOL = 1e-5
A, RADIUS, B = 4, 0.4, 8
H, B_DP, N_DP = 16, 16, 25
WIDTH, MULTS = 16, (1, 2)
TILE_CFG = dict(horizon=H, state_dim=4, n_samples=4, n_diffusion_steps=3, t_start_guide=2,
                n_guide_steps=2)
TRAIN = dict(step_start_ema=5, update_ema_every=2, batch_size=B_DP)
LIMITS = ([-1.0, -1.0, -2.0, -2.0], [1.0, 1.0, 2.0, 2.0])


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


_flax_init = jax.jit(lambda key: jinit_unet(key, horizon=H, state_dim=4, unet_input_dim=WIDTH,
                                            dim_mults=MULTS)[1])


def flax_init(seed: int):
    """JAX's init of the small UNet, compiled once."""
    return _flax_init(jax.random.PRNGKey(seed))


def weights(params, n_steps: int) -> dict:
    return {"state_dict": convert_flax_params(np_tree(params), n_levels=len(MULTS)),
            "unet_dim": WIDTH, "dim_mults": MULTS, "n_steps": n_steps}


def normals(keys, shape) -> torch.Tensor:
    """jax.random.normal(k, shape) for every key k of `keys` (..., 2), in
    one compiled call: the same draws as one call a key."""
    lead = keys.shape[:-1]
    draw = jax.jit(jax.vmap(lambda k: jax.random.normal(k, shape)))
    return torch.from_numpy(np.array(draw(keys.reshape(-1, 2))).reshape(lead + shape))


def rebuilt_noise(key, cfg) -> SamplerNoise:
    """The draws JAX's fresh loop makes from `key` (diffusion.py:152-163)."""
    k, init_key = jax.random.split(key)
    shape = (cfg.n_samples, cfg.horizon, cfg.state_dim)
    keys = jax.random.split(k, cfg.n_diffusion_steps + cfg.n_diffusion_steps_without_noise)
    return SamplerNoise(x_T=normals(init_key, shape), steps=normals(keys, shape))


def loop_noise(key, cfg, n_tiles: int) -> SamplerNoise:
    """The draws of JAX's ensemble loop from its key (ensemble.py:106-117)."""
    key, init_key = jax.random.split(key)
    shape = (cfg.n_samples, cfg.horizon, cfg.state_dim)
    S = len(cfg.step_indices())
    keys = jax.random.split(key, S * n_tiles).reshape(S, n_tiles, 2)
    return SamplerNoise(x_T=normals(init_key, (n_tiles,) + shape), steps=normals(keys, shape))


def jax_draws(key, shape):
    """The t and noise JAX's diffusion_loss draws from `key`."""
    tkey, nkey = jax.random.split(key)
    t = jax.random.randint(tkey, (shape[0],), 0, N_DP)
    return np.asarray(t), np.asarray(jax.random.normal(nkey, shape, jnp.float32))


@pytest.fixture(scope="module")
def spec():
    keys = jax.random.split(jax.random.PRNGKey(3), A)
    cfg = DiffusionConfig(n_samples=B)  # the checkpoint's planners' at B = 8
    team = {"n_agents": A, "radius": RADIUS, "n_samples": B}
    rng = np.random.default_rng(0)
    mask = np.zeros((H, 1), np.float32)
    mask[[0, -1]] = 1.0
    steps = []
    for k in range(3):
        batch = rng.uniform(-1, 1, (B_DP, H, 4)).astype(np.float32)
        t, noise = jax_draws(jax.random.PRNGKey(100 + k), batch.shape)
        steps.append((torch.from_numpy(batch), torch.from_numpy(t), torch.from_numpy(noise)))
    dp_params = flax_init(5)
    tile_params = [flax_init(6), flax_init(7)]
    tile_cfg = DiffusionConfig(**TILE_CFG)
    return {
        "team": team, "noise": [rebuilt_noise(k, cfg) for k in keys],
        "jax_keys": keys,
        "dp": {**weights(dp_params, N_DP), "train": TRAIN, "mask": torch.from_numpy(mask),
               "steps": steps},
        "jax_dp": dp_params,
        "tiles": {"tiles": [weights(p, 4) for p in tile_params], "n_steps": 4,
                  "cfg": tile_cfg, "env": "EnvEmpty2D", "transforms": [[0.0, 0.0], [2.0, 0.0]],
                  "start": [-0.5, 0.0], "goal": [0.5, 0.0], "limits": LIMITS,
                  "noise": loop_noise(jax.random.PRNGKey(9), tile_cfg, 2)},
        "jax_tiles": tile_params,
    }


@pytest.fixture(scope="module")
def ranks(spec):
    shared = {k: spec[k] for k in ("team", "noise", "dp", "tiles")}
    return sharding.spawn(shard_cases.sharding_case, 4, "gloo", "cpu", shared)


# ----------------------------------------------------------------- helpers
@pytest.mark.parametrize("n,axes", [(8, 2), (8, 3), (6, 2), (7, 2), (4, 2)])
def test_factor_mesh_is_jaxs(n, axes):
    assert sharding._factor_mesh(n, axes) == jsharding._factor_mesh(n, axes)


def test_make_mesh_shapes_and_errors_are_jaxs(ranks):
    """tests/test_parallel.py:42-50,123-140 on four ranks: a 1-D mesh is
    {'dp': n}, an ('agent', 'dp') mesh of 4 factors as (2, 2), a shape
    that names other axes or needs more ranks than exist raises."""
    for r, out in enumerate(ranks):
        dp, grid2, agent, grid, agent_at, grid_at = out["shapes"]
        assert dp == {"dp": 4} and grid2 == [2, 2]
        assert agent == {"agent": 4} and grid == {"agent": 2, "dp": 2}
        assert agent_at == {"agent": r} and grid_at == {"agent": r // 2, "dp": r % 2}
        needs, names, more = out["errors"]
        assert "needs 16 ranks, have 4" in needs and "axis_names" in names
        assert "needs 8 ranks" in more
    assert jsharding.make_mesh(4, ("agent", "dp")).devices.shape == (2, 2)
    with pytest.raises(ValueError):
        jsharding.make_mesh([4, 4], axis_names=("agent", "dp"))


def test_make_mesh_needs_a_process_group_and_backends_need_their_devices():
    with pytest.raises(RuntimeError, match="process group"):
        sharding.make_mesh([1], axis_names=("agent",))
    with pytest.raises(ValueError, match="gloo"):
        sharding.rank_device("nccl", "cpu", 0, 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="nccl on cuda, but this machine has no GPU"):
            sharding.spawn(shard_cases.search_case, 2, "nccl", "cuda", [])


def test_shard_then_gather_is_the_identity(ranks):
    x = torch.arange(48, dtype=torch.float32).reshape(16, 3)
    y = torch.arange(192, dtype=torch.float32).reshape(8, 12, 2)
    for r, out in enumerate(ranks):
        assert torch.equal(out["agent_part"], x[4 * r: 4 * r + 4])
        assert torch.equal(out["agent_whole"], x)
        a, d = r // 2, r % 2
        assert torch.equal(out["grid_block"], y[4 * a: 4 * a + 4, 6 * d: 6 * d + 6])
        assert torch.equal(out["grid_whole"], y)


# ----------------------------------------------------------- the team root
@pytest.fixture(scope="module")
def unsharded_root(spec):
    """The unsharded port's root, its UNet run B rows at a time, and plain."""
    return (shard_cases.team_root("cpu", {**spec["team"], "unet_rows": B}, noise=spec["noise"]),
            shard_cases.team_root("cpu", spec["team"], noise=spec["noise"]))


def test_sharded_root_is_the_same_on_every_rank(ranks):
    first = ranks[0]["root"]
    for out in ranks[1:]:
        for k in ("trajs", "free_mask", "ix"):
            assert torch.equal(out["root"][k], first[k]), k
        for got, want in zip(out["root"]["summary"], first["summary"]):
            assert torch.equal(got, want)


def test_sharded_root_matches_the_unsharded_port(ranks, unsharded_root):
    got = ranks[0]["root"]
    chunked, plain = unsharded_root
    err = float((got["trajs"] - chunked["trajs"]).abs().max())
    gap = float((got["trajs"] - plain["trajs"]).abs().max())
    print(f"sharded root against the unsharded port: {err:.3g} (B rows at a time), "
          f"{gap:.3g} (plain)")
    assert err <= ROOT_TOL and gap <= TEAM_TOL
    for want in (chunked, plain):
        assert torch.equal(got["free_mask"], want["free_mask"])
        assert torch.equal(got["ix"], want["ix"])
        assert [int(v) for v in got["summary"][:4]] == [int(v) for v in want["summary"][:4]]


def test_sharded_root_matches_jaxs_on_an_agent_mesh(spec, ranks):
    keys = spec["jax_keys"]
    jmodel, params, jschedule, info = jax_load_checkpoint(
        os.path.join(shard_cases.MODELS, shard_cases.MID))
    jds = JDataset.load(shard_cases.DATA, shard_cases.MID)
    jds.normalizer = JNormalizer.from_limits(info["normalizer_mins"], info["normalizer_maxs"])
    starts, goals = get_start_goal_pos_circle(A, radius=RADIUS)
    jps = [JMPD(jmodel, params, jschedule, jds, jnp.asarray(s), jnp.asarray(g),
                cfg=JDiffusionConfig(n_samples=B), seed=i)
           for i, (s, g) in enumerate(zip(starts, goals))]
    j0 = jps[0]
    mesh = jsharding.make_mesh([A], axis_names=("agent",))
    hard_team, skeys = jteam.shard_team_inputs(
        mesh, jteam.stack_hard_conds([p.hard_conds for p in jps]), keys)
    assert skeys.sharding.spec == P("agent")
    base_cset, _ = j0._pack(None)
    res = jteam.plan_fresh_team(j0.model.apply, j0.params, j0.schedule, hard_team,
                                j0._guide_data(base_cset), skeys, j0.cfg, j0.guide_cfg,
                                j0.task.scene, j0.robot.radius, j0.robot.q_min, j0.robot.q_max,
                                j0._savgol)
    got = ranks[0]["root"]
    err = float(np.abs(got["trajs"].numpy() - np.asarray(res.trajs_final)).max())
    print(f"sharded root against JAX's on a 4-device agent mesh: {err:.3g}")
    assert err <= TEAM_TOL
    np.testing.assert_array_equal(got["free_mask"].numpy(), np.asarray(res.free_mask))
    np.testing.assert_array_equal(got["ix"].numpy(), np.asarray(res.idx_best))


# --------------------------------------------------------------- dp steps
def assert_dp_close(got: dict, want: dict):
    """Losses, Adam's first moments, parameters and EMA (module docstring)."""
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    for what, tol, relative in (("mu", MU_TOL, True), ("params", PARAM_TOL, False),
                                ("ema", PARAM_TOL, False)):
        assert got[what].keys() == want[what].keys()
        for k, w in want[what].items():
            scale = max(float(w.abs().max()), 1e-30) if relative else 1.0
            err = float((got[what][k] - w).abs().max())
            assert err <= tol * scale, (what, k, err, scale)


def test_dp_steps_match_the_unsharded_steps(spec, ranks):
    want = shard_cases.dp_steps("cpu", spec["dp"])
    for out in ranks:
        assert_dp_close(out["dp"], want)
        for what in ("params", "ema", "mu"):
            for k, v in out["dp"][what].items():
                assert torch.equal(v, ranks[0]["dp"][what][k]), (what, k)


def test_dp_steps_match_jaxs_step_on_a_dp_mesh(spec, ranks):
    mesh = jsharding.make_mesh([4], axis_names=("dp",))
    jcfg = jtrainer.TrainConfig(**TRAIN)
    optimizer = jtrainer.make_optimizer(jcfg)
    model = JUnet(state_dim=4, unet_input_dim=WIDTH, dim_mults=MULTS)
    step_fn = jtrainer.make_train_step(model.apply, jmake_schedule("exponential", N_DP),
                                       optimizer, jcfg)
    state = jsharding.replicate(jtrainer.init_train_state(
        jax.tree_util.tree_map(jnp.array, spec["jax_dp"]), optimizer), mesh)
    mask = jnp.asarray(spec["dp"]["mask"].numpy())
    losses = []
    for k, (batch, _, _) in enumerate(spec["dp"]["steps"]):
        xb = jax.device_put(jnp.asarray(batch.numpy()), NamedSharding(mesh, P("dp")))
        state, loss = step_fn(state, xb, JHardConds(mask=mask, values=xb),
                              jax.random.PRNGKey(100 + k))
        losses.append(float(loss))
    adam = state.opt_state[1][0]
    want = {"losses": losses}
    for name, tree in (("params", state.params), ("ema", state.ema_params), ("mu", adam.mu)):
        want[name] = {k: torch.from_numpy(np.array(v)) for k, v in convert_flax_params(
            np_tree(tree), n_levels=len(MULTS)).items()}
    got = ranks[0]["dp"]
    want["mu"] = {k: v for k, v in want["mu"].items() if k in got["mu"]}
    assert_dp_close(got, want)


# ------------------------------------------------------------ tile loop
def test_tile_loop_matches_the_unsharded_loop(spec, ranks):
    x, chain = shard_cases.tile_loop("cpu", spec["tiles"])
    gx, gchain = ranks[0]["tiles"]
    assert torch.equal(gx, ranks[1]["tiles"][0]) and torch.equal(gchain, ranks[1]["tiles"][1])
    assert "tiles" not in ranks[2] and "tiles" not in ranks[3]
    err = float((gchain - chain).abs().max())
    print(f"tile-sharded loop against the unsharded loop: {err:.3g}")
    assert gchain.shape == chain.shape and err <= TILE_TOL


def test_tile_loop_matches_jaxs_on_a_tile_mesh(spec, ranks):
    tiles = spec["tiles"]
    cfg = JDiffusionConfig(**TILE_CFG, unet_dim=WIDTH)
    mesh = jsharding.make_mesh([2], axis_names=("tile",))
    stacked = jens.stack_params(spec["jax_tiles"])
    mask = np.zeros((2, H, 1), np.float32)
    mask[0, 0] = mask[-1, H - 1] = 1.0
    values = np.zeros((2, H, 4), np.float32)
    values[0, 0, :2], values[-1, H - 1, :2] = tiles["start"], tiles["goal"]
    hard = JHardConds(mask=jnp.asarray(mask), values=jnp.asarray(values))
    gd = JGuideData(scene=jmake_env(tiles["env"]).scene,
                    normalizer=JNormalizer.from_limits(*tiles["limits"]),
                    constraints=jempty_constraint_set(4, 1))
    gds = jax.tree_util.tree_map(lambda v: jnp.stack([v] * 2), gd)
    model = JUnet(state_dim=4, unet_input_dim=WIDTH, dim_mults=MULTS)
    cc = jens.CrossConds.from_transforms(np.asarray(tiles["transforms"]), 4)
    loop = jax.jit(lambda p, k: jens.ensemble_p_sample_loop(
        model.apply, p, jmake_schedule("exponential", tiles["n_steps"]), hard, cc, k, cfg,
        gds=gds, guide_cfg=JGuideConfig(), n_tiles=2)[1])
    key = jax.random.PRNGKey(9)
    chain = np.asarray(loop(jsharding.replicate(stacked, mesh), key))
    sharded = np.asarray(loop(jsharding.shard_leading_axis(stacked, mesh, "tile"), key))
    got = ranks[0]["tiles"][1].numpy()
    err = float(np.abs(got - chain).max())
    print(f"tile-sharded loop against JAX's on a 2-device tile mesh: {err:.3g}; JAX's loop "
          f"with its parameters sharded on 'tile' lands {np.abs(sharded - chain).max():.3g} "
          f"from its own")
    assert err <= TILE_TOL


# ---------------------------------------------------------------- dry run
def test_dryrun_multichip_prints_its_ok_line(capsys):
    outs = dryrun.dryrun_multichip(4, "gloo", "cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(r"dryrun_multichip OK on 4 ranks: dp train loss [0-9.]+, team plan "
                        r"\(4, 4, 16, 4\), tile ensemble \(4, 4, 16, 4\), 2-D mesh \(2, 2\) "
                        r"team plan OK", line), line
    assert len(outs) == 4


def test_entry_is_the_flagship_forward():
    fn, args = dryrun.entry(device="cpu")
    assert fn(*args).shape == (64, 64, 4)
