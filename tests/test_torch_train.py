"""Training of the port (`mmd_torch.train`) against the JAX package's.

Small widths (UNet dim 16, mults (1, 2), H=16) on the CPU; JAX runs on the
CPU too. Tolerances, each measured with margin:
- init: the tree's shapes equal flax's; biases 0, GroupNorm scale 1; each
  kernel's std within 6 standard errors of 1/sqrt(fan_in) (for n draws the
  std of a sample std is about std * sqrt(0.5 * (kurtosis - 1) / n), and
  the truncated normal's kurtosis is below 3), every draw within 2 / 0.8796
  std of 0;
- conversion round trip and the checkpoints' bytes: exact;
- the loss on JAX's parameters, t and noise: 1e-5 relative; each gradient
  leaf within 1e-5 of its largest |g| (float32 convolutions summed in
  another order: measured 2.4e-6). Width 16 keeps two channels in each of
  GroupNorm's 8 groups: with one, the bias of the conv before it would
  cancel in the group's mean, its exact gradient would be 0, and both
  packages would return only rounding noise;
- clip, Adam and EMA fed JAX's gradients, 12 steps over both clip and both
  EMA branches: params, EMA, mu and nu within 1e-6 of each leaf's largest
  value, count equal (the same float32 operations in the same order but
  for the global norm's sum: measured <= 4.6e-7);
- 12 chained train steps, each side on its own gradients: the losses and
  every leaf within 1e-4 of its largest value (the gradients' ~1e-7
  rounding differences, divided by Adam's sqrt(nu), move a parameter by
  ~lr x 1e-3; measured 4.2e-5, so JAX's own spread was not needed as a
  yardstick), and the forward after the 12 steps within 1e-4 of its
  largest |eps|;
- the bf16 step: the loss within 1e-2 relative of JAX's bf16 loss, the
  gradients' cosine with JAX's bf16 gradients at least 0.999;
- a checkpoint or train state read by the other package: equal leaves, and
  the forward on it within 1e-5 (the float32 forward tolerance);
- the summary statistics on JAX's grids: equal.
"""
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from mmd_tpu.datasets.trajectories import TrajectoryDataset as JDataset
from mmd_tpu.envs.envs import make_env as jax_make_env
from mmd_tpu.models import generic as jgeneric
from mmd_tpu.models.diffusion import HardConds as JHardConds
from mmd_tpu.models.diffusion import diffusion_loss as jdiffusion_loss
from mmd_tpu.models.schedules import make_schedule as jmake_schedule
from mmd_tpu.models.temporal_unet import TemporalUnet as JUnet
from mmd_tpu.models.temporal_unet import init_unet as jinit_unet
from mmd_tpu.models.temporal_unet import init_unet_abstract
from mmd_tpu.tasks.task import make_task as jmake_task
from mmd_tpu.train import trainer as jtrainer
from mmd_torch.datasets.trajectories import TrajectoryDataset, model_id
from mmd_torch.envs.envs import SceneData
from mmd_torch.envs.grid_sdf import GridSDF
from mmd_torch.io.msgpack import load_msgpack
from mmd_torch.models import generic as tgeneric
from mmd_torch.models.diffusion import HardConds, diffusion_loss
from mmd_torch.models.schedules import make_schedule
from mmd_torch.models.temporal_unet import (Bf16Forward, TemporalUnet, bf16_model,
                                            convert_flax_params, init_unet, to_flax_params)
from mmd_torch.tasks.task import make_task
from mmd_torch.train import checkpoint as tcheckpoint
from mmd_torch.train import trainer as ttrainer
from mmd_torch.train.summary import summary_trajectory_generation
from mmd_torch.train.train_loaders import get_dataset, get_loss, get_model

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, D, DIM, MULTS, N_STEPS, B = 16, 4, 16, (1, 2), 25, 16
LOSS_RTOL, GRAD_TOL, OPT_TOL, CHAIN_TOL, FWD_TOL = 1e-5, 1e-5, 1e-6, 1e-4, 1e-5
BF16_LOSS_RTOL, BF16_COSINE = 1e-2, 0.999


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def flat_leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def assert_trees_close(got, want, tol, what=""):
    g, w = flat_leaves(got), flat_leaves(want)
    assert set(g) == set(w), what
    for k in w:
        assert g[k].shape == w[k].shape, (what, k)
        scale = max(float(np.abs(w[k]).max()), 1e-30)
        err = float(np.abs(g[k].astype(np.float64) - w[k]).max())
        assert err <= tol * scale, (what, k, err, scale)


def port_model(jparams) -> TemporalUnet:
    m = TemporalUnet(state_dim=D, unet_input_dim=DIM, dim_mults=MULTS)
    m.load_state_dict(convert_flax_params(np_tree(jparams), n_levels=len(MULTS)))
    return m


def jax_draws(key, shape):
    """The t and noise JAX's diffusion_loss draws from `key`."""
    tkey, nkey = jax.random.split(key)
    t = jax.random.randint(tkey, (shape[0],), 0, N_STEPS)
    return np.asarray(t), np.asarray(jax.random.normal(nkey, shape, jnp.float32))


@pytest.fixture(scope="module")
def data():
    trajs = np.load(os.path.join(ROOT, "data_trajectories", model_id("EnvEmptyNoWait2D"),
                                 "trajs-free.npz"))["trajs"][:96, ::4].astype(np.float32)
    jds = JDataset(trajs, "EnvEmptyNoWait2D")
    return trajs, jds, np.asarray(jds.trajs_normalized)


def jax_init(seed: int):
    """JAX's init_unet at the test width, its init compiled as one program."""
    kw = dict(horizon=H, state_dim=D, unet_input_dim=DIM, dim_mults=MULTS)
    params = jax.jit(lambda key: jinit_unet(key, **kw)[1])(jax.random.PRNGKey(seed))
    return JUnet(state_dim=D, unet_input_dim=DIM, dim_mults=MULTS), params


@pytest.fixture(scope="module")
def jax_model():
    return jax_init(3)


def endpoint_hard(batch):
    mask = np.zeros((batch.shape[1], 1), np.float32)
    mask[[0, -1]] = 1.0
    return (JHardConds(mask=jnp.asarray(mask), values=jnp.asarray(batch)),
            HardConds(mask=torch.from_numpy(mask), values=torch.from_numpy(batch)))


# --------------------------------------------------------------- the model
def test_init_tree_has_flax_shapes():
    _, shapes = init_unet_abstract(horizon=64, state_dim=4, unet_input_dim=32,
                                   dim_mults=(1, 2, 4))
    tree = to_flax_params(init_unet(torch.Generator().manual_seed(0), device="cpu").state_dict())
    got = {k: v.shape for k, v in flat_leaves(tree).items()}
    want = {k: tuple(v.shape) for k, v in flat_leaves(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)).items()}
    assert got == want


def test_init_statistics_are_flax_defaults():
    tree = flat_leaves(to_flax_params(
        init_unet(torch.Generator().manual_seed(1), device="cpu").state_dict()))
    n_kernels = 0
    for name, v in tree.items():
        if name.endswith("/bias"):
            assert not v.any(), name
        elif name.endswith("/scale"):
            assert (v == 1.0).all(), name
        else:
            n_kernels += 1
            fan_in = int(np.prod(v.shape[:-1]))
            std = 1.0 / np.sqrt(fan_in)
            se = std * np.sqrt(1.0 / v.size)
            assert abs(float(v.std()) - std) <= 6 * se, (name, float(v.std()), std)
            assert abs(float(v.mean())) <= 6 * std / np.sqrt(v.size), name
            assert np.abs(v).max() <= 2.0 * std / 0.87962566103423978 * (1 + 1e-6), name
    assert n_kernels == 49  # every Dense, Conv and ConvTranspose of the full-width net


def test_init_is_seeded():
    a = init_unet(torch.Generator().manual_seed(5), 4, 8, (1, 2), device="cpu").state_dict()
    b = init_unet(torch.Generator().manual_seed(5), 4, 8, (1, 2), device="cpu").state_dict()
    c = init_unet(torch.Generator().manual_seed(6), 4, 8, (1, 2), device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["final_conv.weight"], c["final_conv.weight"])


def test_conversion_round_trip_is_exact(jax_model):
    _, params = jax_model
    tree = np_tree(params)
    back = to_flax_params(convert_flax_params(tree, n_levels=len(MULTS)), n_levels=len(MULTS))
    assert_trees_close(back, tree, 0.0)
    # In the same sorted key order as flax's own files.
    assert list(back["params"]) == sorted(tree["params"])


# ---------------------------------------------------------------- the loss
def test_loss_and_gradients_match_jax(jax_model, data):
    model, params = jax_model
    _, _, normalized = data
    batch = normalized[:B]
    jhard, thard = endpoint_hard(batch)
    key = jax.random.PRNGKey(11)
    jsched = jmake_schedule("exponential", N_STEPS)
    want, jgrads = jax.jit(jax.value_and_grad(lambda p: jdiffusion_loss(
        model.apply, p, jsched, jnp.asarray(batch), jhard, key, N_STEPS)))(params)
    t, noise = jax_draws(key, batch.shape)
    net = port_model(params)
    got = diffusion_loss(net, make_schedule("exponential", N_STEPS, device="cpu"),
                         torch.from_numpy(batch), thard, torch.from_numpy(t),
                         torch.from_numpy(noise))
    assert abs(got.item() - float(want)) <= LOSS_RTOL * abs(float(want))
    grads = torch.autograd.grad(got, list(net.parameters()))
    names = [n for n, _ in net.named_parameters()]
    gtree = to_flax_params(dict(zip(names, grads)), n_levels=len(MULTS))
    assert_trees_close(gtree, np_tree(jgrads), GRAD_TOL)


def test_conditioned_rows_carry_no_gradient(data):
    _, _, normalized = data
    batch = normalized[:4]
    _, hard = endpoint_hard(batch)
    out = {}

    def model(x, t):
        out["eps"] = torch.randn(x.shape, generator=torch.Generator().manual_seed(0),
                                 requires_grad=True)
        return out["eps"]

    loss = diffusion_loss(model, make_schedule("exponential", N_STEPS, device="cpu"),
                          torch.from_numpy(batch), hard, torch.arange(4) % N_STEPS,
                          torch.randn(batch.shape))
    (g,) = torch.autograd.grad(loss, out["eps"])
    assert not g[:, [0, -1]].any() and g[:, 1:-1].abs().min() > 0


# ------------------------------------------------------- optimizer and EMA
def jax_apply_gradients(cfg):
    """optax's clip + Adam (the JAX trainer's make_optimizer) and the EMA
    of `_update` (mmd_tpu/train/trainer.py:106-121), on given gradients."""
    optimizer = jtrainer.make_optimizer(cfg)

    @jax.jit
    def update(params, ema, opt_state, step, grads):
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        step = step + 1

        def ema_update(e):
            return jax.tree_util.tree_map(
                lambda e, p: jnp.where(step < cfg.step_start_ema, p,
                                       e * cfg.ema_decay + p * (1 - cfg.ema_decay)), e, params)

        ema = jax.lax.cond(step % cfg.update_ema_every == 0, ema_update, lambda e: e, ema)
        return params, ema, opt_state, step

    return optimizer, update


def test_clip_adam_and_ema_on_given_gradients_match_optax(jax_model):
    _, params = jax_model
    cfg = ttrainer.TrainConfig(step_start_ema=5, update_ema_every=2)
    jcfg = jtrainer.TrainConfig(step_start_ema=5, update_ema_every=2)
    optimizer, update = jax_apply_gradients(jcfg)
    jstate = (params, jax.tree_util.tree_map(jnp.array, params), optimizer.init(params),
              jnp.asarray(0, jnp.int32))
    net = port_model(params)
    state = ttrainer.TrainState.create(net)
    names = [n for n, _ in net.named_parameters()]
    rng = np.random.default_rng(0)
    norms = [3.0, 0.5, 2.0, 0.8, 1.5, 0.2, 4.0, 0.9, 1.0, 0.3, 2.5, 0.7]
    for norm in norms:
        g = jax.tree_util.tree_map(lambda p: rng.standard_normal(p.shape).astype(np.float32),
                                   np_tree(params))
        scale = np.float32(norm / np.sqrt(sum(float((x.astype(np.float64) ** 2).sum())
                                              for x in jax.tree_util.tree_leaves(g))))
        g = jax.tree_util.tree_map(lambda x: x * scale, g)
        jstate = update(*jstate, g)
        sd = convert_flax_params(g, n_levels=len(MULTS))
        ttrainer.apply_gradients(state, [sd[n] for n in names], cfg)
    jparams, jema, jopt, jstep = jstate
    adam = jopt[1][0]
    assert state.step == int(jstep) == 12 and state.count == int(adam.count) == 12
    tree = lambda ts: to_flax_params(dict(zip(names, ts)), n_levels=len(MULTS))  # noqa: E731
    assert_trees_close(to_flax_params(net.state_dict(), len(MULTS)), np_tree(jparams), OPT_TOL,
                       "params")
    assert_trees_close(to_flax_params(state.ema.state_dict(), len(MULTS)), np_tree(jema),
                       OPT_TOL, "ema")
    assert_trees_close(tree(state.mu), np_tree(adam.mu), OPT_TOL, "mu")
    assert_trees_close(tree(state.nu), np_tree(adam.nu), OPT_TOL, "nu")


def test_clip_is_optax_on_both_sides_of_the_norm():
    rng = np.random.default_rng(4)
    for norm in (0.25, 1.0, 7.0):
        leaves = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
        scale = norm / np.sqrt(sum((x.astype(np.float64) ** 2).sum() for x in leaves))
        leaves = [(x * scale).astype(np.float32) for x in leaves]
        want, _ = optax.clip_by_global_norm(1.0).update(leaves, optax.EmptyState())
        got = ttrainer.clip_by_global_norm([torch.from_numpy(x) for x in leaves], 1.0)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)


def test_chained_train_steps_match_jax(jax_model, data):
    model, params = jax_model
    _, _, normalized = data
    cfg = ttrainer.TrainConfig(step_start_ema=5, update_ema_every=2, batch_size=B)
    jcfg = jtrainer.TrainConfig(step_start_ema=5, update_ema_every=2, batch_size=B)
    jsched = jmake_schedule("exponential", N_STEPS)
    tsched = make_schedule("exponential", N_STEPS, device="cpu")
    optimizer = jtrainer.make_optimizer(jcfg)
    step_fn = jtrainer.make_train_step(model.apply, jsched, optimizer, jcfg)
    # The step donates its state: start it from a copy of the fixture's.
    jstate = jtrainer.init_train_state(jax.tree_util.tree_map(jnp.array, params), optimizer)
    net = port_model(params)
    state = ttrainer.TrainState.create(net)
    rng = np.random.default_rng(2)
    for k in range(12):
        batch = normalized[rng.integers(0, len(normalized), B)]
        jhard, thard = endpoint_hard(batch)
        key = jax.random.PRNGKey(100 + k)
        jstate, jloss = step_fn(jstate, jnp.asarray(batch), jhard, key)
        t, noise = jax_draws(key, batch.shape)
        loss = ttrainer.train_step(state, net, tsched, cfg, torch.from_numpy(batch), thard,
                                   torch.from_numpy(t), torch.from_numpy(noise))
        assert abs(float(loss) - float(jloss)) <= CHAIN_TOL * abs(float(jloss))
    assert state.step == int(jstate.step) == 12
    for got, want, what in ((net, jstate.params, "params"), (state.ema, jstate.ema_params, "ema")):
        assert_trees_close(to_flax_params(got.state_dict(), len(MULTS)), np_tree(want),
                           CHAIN_TOL, what)
        x, t = normalized[:8], np.arange(8) * 3
        with torch.no_grad():
            out = got(torch.from_numpy(x), torch.from_numpy(t)).numpy()
        ref = jax_forward(model, want, x, t)
        assert np.abs(out - ref).max() <= CHAIN_TOL * np.abs(ref).max(), what


def test_bf16_step_matches_jax_bf16(jax_model, data):
    model, params = jax_model
    _, _, normalized = data
    batch = normalized[B:3 * B]
    jhard, thard = endpoint_hard(batch)
    key = jax.random.PRNGKey(7)
    jsched = jmake_schedule("exponential", N_STEPS)
    bf16_apply = model.clone(dtype=jnp.bfloat16).apply
    want, jgrads = jax.jit(jax.value_and_grad(lambda p: jdiffusion_loss(
        bf16_apply, p, jsched, jnp.asarray(batch), jhard, key, N_STEPS)))(params)
    t, noise = jax_draws(key, batch.shape)
    net = port_model(params)
    got = diffusion_loss(Bf16Forward(net), make_schedule("exponential", N_STEPS, device="cpu"),
                         torch.from_numpy(batch), thard, torch.from_numpy(t),
                         torch.from_numpy(noise))
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= BF16_LOSS_RTOL * abs(float(want))
    grads = torch.autograd.grad(got, list(net.parameters()))
    assert all(g.dtype == torch.float32 for g in grads)
    names = [n for n, _ in net.named_parameters()]
    g = flat_leaves(to_flax_params(dict(zip(names, grads)), n_levels=len(MULTS)))
    w = flat_leaves(np_tree(jgrads))
    a = np.concatenate([g[k].ravel() for k in sorted(w)]).astype(np.float64)
    b = np.concatenate([w[k].ravel() for k in sorted(w)]).astype(np.float64)
    cosine = a @ b / np.linalg.norm(a) / np.linalg.norm(b)
    assert cosine >= BF16_COSINE, cosine
    assert all(p.dtype == torch.float32 for p in net.parameters())


def test_bf16_training_forward_equals_the_inference_twin(jax_model, data):
    _, params = jax_model
    _, _, normalized = data
    net = port_model(params)
    x, t = torch.from_numpy(normalized[:8]), torch.arange(8) * 3
    with torch.no_grad():
        assert torch.equal(Bf16Forward(net)(x, t), bf16_model(net)(x, t))


def test_bf16_train_step_updates_float32_masters(data):
    _, _, normalized = data
    net = init_unet(torch.Generator().manual_seed(2), D, DIM, MULTS, device="cpu")
    before = [p.detach().clone() for p in net.parameters()]
    state = ttrainer.TrainState.create(net)
    batch = normalized[:B]
    _, hard = endpoint_hard(batch)
    loss = ttrainer.train_step(state, Bf16Forward(net), make_schedule("exponential", N_STEPS,
                                                                       device="cpu"),
                               ttrainer.TrainConfig(bf16=True), torch.from_numpy(batch), hard,
                               torch.arange(B) % N_STEPS, torch.randn(batch.shape))
    assert torch.isfinite(loss)
    assert all(p.dtype == torch.float32 for p in net.parameters())
    assert sum(not torch.equal(a, b) for a, b in zip(before, net.parameters())) > 30


# ------------------------------------------------------------- checkpoints
def small_datasets(trajs, n=64):
    return (JDataset(trajs[:n], "EnvEmptyNoWait2D"),
            TrajectoryDataset.from_trajs(trajs[:n], "EnvEmptyNoWait2D", device="cpu"))


def jax_forward(jmodel, params, x, t):
    return np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(x), jnp.asarray(t)))


@pytest.fixture(scope="module")
def jax_run(data, tmp_path_factory):
    """A JAX training run of 4 steps, with its checkpoint and train state."""
    trajs, _, _ = data
    jds, _ = small_datasets(trajs)
    d = str(tmp_path_factory.mktemp("jax_run") / "m")
    cfg = jtrainer.TrainConfig(batch_size=8, n_diffusion_steps=N_STEPS)
    jmodel, jstate, _, _ = jtrainer.train(jds, cfg, num_train_steps=4, unet_dim=DIM,
                                          dim_mults=MULTS, model_dir=d, log_every=2,
                                          log_fn=lambda m: None)
    return d, jmodel, jstate


@pytest.fixture(scope="module")
def port_run(data, tmp_path_factory):
    trajs, _, _ = data
    _, ds = small_datasets(trajs)
    d = str(tmp_path_factory.mktemp("port_run") / "m")
    cfg = ttrainer.TrainConfig(batch_size=8, n_diffusion_steps=N_STEPS)
    _, state, _, _ = ttrainer.train(ds, cfg, num_train_steps=4, unet_dim=DIM, dim_mults=MULTS,
                                    model_dir=d, log_every=2, log_fn=lambda m: None)
    return d, state, ds


def test_jax_reads_the_ports_checkpoint(port_run, data):
    d, state, ds = port_run
    _, _, normalized = data
    for use_ema, net in ((True, state.ema), (False, state.model)):
        jmodel, jparams, _, info = jtrainer.load_checkpoint(d, use_ema=use_ema)
        assert_trees_close(np_tree(jparams), to_flax_params(net.state_dict(), len(MULTS)), 0.0)
        x, t = normalized[:6], np.array([0, 3, 8, 13, 21, 24])
        with torch.no_grad():
            got = net(torch.from_numpy(x), torch.from_numpy(t)).numpy()
        np.testing.assert_allclose(got, jax_forward(jmodel, jparams, x, t), rtol=0,
                                   atol=FWD_TOL)
    assert info["step"] == 4 and info["dim_mults"] == list(MULTS)
    assert info["normalizer_mins"] == ds.normalizer.mins.tolist()


def test_port_reads_jaxs_checkpoint(jax_run, data):
    d, jmodel, jstate = jax_run
    _, _, normalized = data
    for use_ema, jp in ((True, jstate.ema_params), (False, jstate.params)):
        net, schedule, info = tcheckpoint.load_checkpoint(d, device="cpu", use_ema=use_ema)
        assert_trees_close(to_flax_params(net.state_dict(), len(MULTS)), np_tree(jp), 0.0)
        x, t = normalized[:6], np.array([1, 2, 5, 9, 17, 24])
        with torch.no_grad():
            got = net(torch.from_numpy(x), torch.from_numpy(t)).numpy()
        np.testing.assert_allclose(got, jax_forward(jmodel, jp, x, t), rtol=0, atol=FWD_TOL)
    assert schedule.n_steps == N_STEPS and info["step"] == 4


def test_checkpoint_bytes_equal_flax_serialization(port_run):
    d, state, _ = port_run
    with open(os.path.join(d, "ema_model.msgpack"), "rb") as f:
        data_bytes = f.read()
    assert data_bytes == serialization.to_bytes(load_msgpack(os.path.join(d, "ema_model.msgpack")))


def _jax_template():
    _, params = jax_init(0)
    optimizer = jtrainer.make_optimizer(jtrainer.TrainConfig())
    return jtrainer.init_train_state(params, optimizer)


def test_train_state_crosses_from_the_port_to_jax(port_run):
    d, state, _ = port_run
    jstate = jtrainer.load_train_state(d, _jax_template())
    assert int(jstate.step) == state.step == 4
    adam = jstate.opt_state[1][0]
    assert int(adam.count) == state.count == 4
    names = [n for n, _ in state.model.named_parameters()]
    tree = lambda ts: to_flax_params(dict(zip(names, ts)), len(MULTS))  # noqa: E731
    assert_trees_close(np_tree(jstate.params), to_flax_params(state.model.state_dict(),
                                                              len(MULTS)), 0.0)
    assert_trees_close(np_tree(jstate.ema_params), to_flax_params(state.ema.state_dict(),
                                                                  len(MULTS)), 0.0)
    assert_trees_close(np_tree(adam.mu), tree(state.mu), 0.0)
    assert_trees_close(np_tree(adam.nu), tree(state.nu), 0.0)


def test_train_state_crosses_from_jax_to_the_port(jax_run):
    d, _, jstate = jax_run
    net = TemporalUnet(state_dim=D, unet_input_dim=DIM, dim_mults=MULTS)
    state = tcheckpoint.load_train_state(d, ttrainer.TrainState.create(net))
    adam = jstate.opt_state[1][0]
    assert state.step == int(jstate.step) == 4 and state.count == int(adam.count)
    names = [n for n, _ in net.named_parameters()]
    tree = lambda ts: to_flax_params(dict(zip(names, ts)), len(MULTS))  # noqa: E731
    assert_trees_close(to_flax_params(net.state_dict(), len(MULTS)), np_tree(jstate.params), 0.0)
    assert_trees_close(to_flax_params(state.ema.state_dict(), len(MULTS)),
                       np_tree(jstate.ema_params), 0.0)
    assert_trees_close(tree(state.mu), np_tree(adam.mu), 0.0)
    assert_trees_close(tree(state.nu), np_tree(adam.nu), 0.0)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_resumed_port_run_continues_the_step_count(writer, port_run, jax_run, data, tmp_path):
    trajs, _, _ = data
    _, ds = small_datasets(trajs)
    d = str(tmp_path / "m")
    shutil.copytree((port_run if writer == "port" else jax_run)[0], d)
    kept = tcheckpoint.load_train_state(d, ttrainer.TrainState.create(
        TemporalUnet(state_dim=D, unet_input_dim=DIM, dim_mults=MULTS)))
    msgs = []
    _, state, _, _ = ttrainer.train(ds, ttrainer.TrainConfig(batch_size=8), num_train_steps=2,
                                    unet_dim=DIM, dim_mults=MULTS, model_dir=d, log_every=2,
                                    log_fn=msgs.append, resume=True)
    assert msgs[0] == "resumed from step 4"
    assert state.step == 6 and state.count == 6
    moved = [not torch.equal(a, b) for a, b in zip(kept.model.parameters(),
                                                     state.model.parameters())]
    assert all(moved)
    assert int(jtrainer.load_train_state(d, _jax_template()).step) == 6


# ----------------------------------------------------------------- summary
def torch_scene(scene) -> SceneData:
    def grid(g):
        return GridSDF(lower=tuple(np.asarray(g.lower).tolist()),
                       upper=tuple(np.asarray(g.upper).tolist()),
                       values=torch.from_numpy(np.array(g.values)),
                       grads=torch.from_numpy(np.array(g.grads)))
    return SceneData(grid=grid(scene.grid), extra_grid=grid(scene.extra_grid),
                     ws_min=torch.from_numpy(np.array(scene.ws_min)),
                     ws_max=torch.from_numpy(np.array(scene.ws_max)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_summary_statistics_match_jax(seed):
    jtask = jmake_task("EnvConveyor2D")
    task = make_task("EnvConveyor2D", device="cpu")
    task.scene = torch_scene(jax_make_env("EnvConveyor2D").scene)
    rng = np.random.default_rng(seed)
    a, b = rng.uniform(-0.95, 0.95, (2, 25, 1, 2)).astype(np.float32)
    s = np.linspace(0, 1, 64, dtype=np.float32)[None, :, None]
    pos = a * (1 - s) + b * s + rng.normal(0, 0.01, (25, 64, 2)).astype(np.float32)
    x = np.concatenate([pos, np.zeros_like(pos)], -1)
    if seed == 2:
        x[:, :, :2] = x[:1, :, :2] * 0.05  # all 25 short paths near the centre box
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    for name in ("compute_fraction_free_trajs", "compute_collision_intensity_trajs",
                 "compute_success_free_trajs"):
        got, want = getattr(task, name)(tx), getattr(jtask, name)(jx)
        assert type(got) is type(want) and got == want, (name, got, want)


def test_summary_generation_scores_its_samples(data):
    trajs, _, _ = data
    ds = TrajectoryDataset.from_trajs(trajs[:32], "EnvEmptyNoWait2D", device="cpu")
    net = init_unet(torch.Generator().manual_seed(0), D, DIM, MULTS, device="cpu")
    stats = summary_trajectory_generation(net, make_schedule("exponential", 4, device="cpu"),
                                          ds, torch.Generator().manual_seed(0), n_samples=5,
                                          step=7)
    assert stats["step"] == 7 and stats["success"] in (0, 1)
    assert 0.0 <= stats["fraction_free"] <= 1.0 and 0.0 <= stats["collision_intensity"] <= 1.0


# ------------------------------------------------------ loaders and models
@pytest.mark.parametrize("name", ["MLPModel", "PointUnet", "NoModel"])
def test_generic_model_forward_matches_flax(name):
    kw = {"MLPModel": dict(horizon=H, hidden_dims=(32, 16)), "PointUnet": dict(hidden_dim=24),
          "NoModel": {}}[name]
    jm = getattr(jgeneric, name)(**kw)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, H, D)).astype(np.float32)
    t = np.array([0, 5, 24], np.int32)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(t))
    want = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(t)))
    tm = getattr(tgeneric, name)(**kw)
    if params:
        tm.load_state_dict(tgeneric.convert_generic_params(np_tree(params)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_TOL)


def test_loaders_build_models_losses_and_datasets(tmp_path, port_run):
    d, state, _ = port_run
    net = get_model("TemporalUnet", device="cpu", unet_input_dim=DIM, dim_mults=MULTS)
    assert not net.final_conv.bias.any() and net.final_conv.weight.abs().max() > 0
    restored = get_model(checkpoint_dir=d, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(restored.parameters(), state.ema.parameters()))
    mlp = get_model("MLPModel", device="cpu", horizon=H)
    assert mlp(torch.zeros(2, H, D), torch.zeros(2, dtype=torch.long)).shape == (2, H, D)
    ds = get_dataset("TrajectoryDataset", model_id("EnvEmptyNoWait2D"),
                     trajectories_dir=os.path.join(ROOT, "data_trajectories"), device="cpu")
    assert ds.n_trajs == 10000
    batch, hard = ds.sample_batch(torch.Generator().manual_seed(0), 4)
    out = get_loss("GaussianDiffusionLoss").loss_fn(
        init_unet(torch.Generator().manual_seed(0), D, DIM, MULTS, device="cpu"),
        make_schedule("exponential", 4, device="cpu"),
        {"traj_normalized": batch, "hard_conds": hard}, torch.Generator().manual_seed(1), 4)
    assert torch.isfinite(out["diffusion_loss"])


# ---------------------------------------------------------- the train loop
@pytest.mark.parametrize("cadences,steps,want", [
    ((1000, 1000, None, None), 2000, 1000), ((500, None, None, None), 5000, 500),
    ((10, 20, None, 30), 60, 10), ((7, None, None, None), 20, 1), ((50, 30, None, None), 150, 1)])
def test_chunk_follows_jaxs_rule(cadences, steps, want):
    assert ttrainer.chunk_size(steps, cadences) == want


def test_train_end_to_end_logs_the_chunk_mean_and_writes_its_files(data, tmp_path):
    trajs, _, _ = data
    ds = TrajectoryDataset.from_trajs(trajs, "EnvEmptyNoWait2D", device="cpu")
    d = str(tmp_path / "m")
    cfg = ttrainer.TrainConfig(batch_size=16, lr=2e-3, step_start_ema=10)
    seen = []
    real_step = ttrainer.train_step

    def spy(*args):
        loss = real_step(*args)
        seen.append(float(loss))
        return loss

    msgs, starts = [], []
    real_sample = ds.sample_batch

    def sample(generator, batch_size, start_idx=0):
        starts.append(start_idx)
        return real_sample(generator, batch_size, start_idx=start_idx)

    ds.sample_batch = sample
    ttrainer.train_step = spy
    try:
        _, state, _, losses = ttrainer.train(ds, cfg, num_train_steps=30, unet_dim=DIM,
                                             dim_mults=MULTS, model_dir=d, log_every=10,
                                             validate_every=10, summary_every=30,
                                             steps_til_checkpoint=10, log_fn=msgs.append)
    finally:
        ttrainer.train_step = real_step
    assert [s for s, _ in losses] == [10, 20, 30] and state.step == 30
    for (s, lv) in losses:  # the mean over the chunk since the last log
        assert abs(lv - float(np.mean(seen[s - 10:s], dtype=np.float32))) <= 1e-6
    assert losses[-1][1] < losses[0][1]
    assert any(m.startswith("summary {") for m in msgs)
    files = set(os.listdir(d))
    for suffix in ("", "_step_0000010", "_step_0000020", "_step_0000030"):
        assert {f"model{suffix}.msgpack", f"ema_model{suffix}.msgpack"} <= files
    assert {"args.yaml", "train_state.msgpack", "train_losses.npy", "val_losses.npy"} <= files
    np.testing.assert_array_equal(np.load(os.path.join(d, "train_losses.npy")),
                                  np.asarray(losses))
    assert np.load(os.path.join(d, "val_losses.npy")).shape == (3, 2)
    # The held-out prefix, max(1, 5% of 96) = 4 trajectories, is never drawn.
    assert starts == [4] * 30


# ------------------------------------------------------------------- CLI
@pytest.mark.parametrize("out", ["data_trained_models", "data_trained_models_vd/x",
                                 "./data_trained_models_h128"])
def test_cli_refuses_the_committed_model_directories(out):
    proc = subprocess.run([sys.executable, "-m", "mmd_torch.train.train_diffusion", "--env",
                           "EnvEmpty2D", "--out", out, "--device", "cpu", "--steps", "1"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "refusing" in proc.stderr
