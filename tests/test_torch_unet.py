"""TemporalUnet of the port, on converted flax weights, against the flax model.

Tolerance: atol 5e-5 on outputs of magnitude ~10. Both sides run float32
on the CPU; only the summation order inside the convolutions, GroupNorm's
variance formula (flax E[x^2] - E[x]^2, torch two-pass) and Mish's softplus
differ, which measures ~3e-6 here.
"""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from mmd_tpu.models import temporal_unet as flax_unet
from mmd_tpu.models.temporal_unet import TemporalUnet as FlaxUnet, Upsample1d
from mmd_torch.io.msgpack import load_msgpack
from mmd_torch.models.temporal_unet import TemporalUnet, _conv_t, bf16_model, convert_flax_params
from mmd_torch.train.checkpoint import load_checkpoint

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = sorted(glob.glob(os.path.join(ROOT, "data_trained_models", "*")))
ATOL = 5e-5


def test_upsample_layer_alone_matches_flax_conv_transpose():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 16, 8)).astype(np.float32)
    layer = Upsample1d(8)
    p = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]["ConvTranspose_0"]
    want = np.asarray(layer.apply({"params": {"ConvTranspose_0": p}}, jnp.asarray(x)))
    up = torch.nn.ConvTranspose1d(8, 8, 4, stride=2, padding=1)
    up.weight.data = torch.from_numpy(_conv_t(np.array(p["kernel"])))
    up.bias.data = torch.from_numpy(np.array(p["bias"]))
    with torch.no_grad():
        got = up(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).numpy()
    assert got.shape == want.shape == (3, 32, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("model_dir", BASE, ids=os.path.basename)
def test_converted_forward_matches_flax(model_dir):
    model, schedule, info = load_checkpoint(model_dir, device="cpu")
    with open(os.path.join(model_dir, "ema_model.msgpack"), "rb") as f:
        flax_params = serialization.msgpack_restore(f.read())
    flax_model = FlaxUnet(state_dim=info["state_dim"], unet_input_dim=info["unet_input_dim"],
                          dim_mults=tuple(info["dim_mults"]))
    rng = np.random.default_rng(len(model_dir))
    x = rng.standard_normal((4, info["horizon"], info["state_dim"])).astype(np.float32)
    t = np.array([0, 7, 13, 24], np.int32)
    want = np.asarray(flax_model.apply(flax_params, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_converter_fills_every_parameter():
    tree = load_msgpack(os.path.join(BASE[0], "ema_model.msgpack"))
    sd = convert_flax_params(tree)
    net = TemporalUnet()
    assert set(sd) == set(net.state_dict())
    n_flax = sum(v.size for v in jax.tree_util.tree_leaves(tree))
    assert sum(v.numel() for v in sd.values()) == n_flax


# The bfloat16 forward. flax rounds each op's result to bfloat16 (8
# significant bits), and the port's twin rounds at the same ops (the
# product and the bias add of a conv or dense layer apart, GroupNorm's
# output, each op of Mish's softplus). Fed the same bfloat16 input, each
# block of the twin gives flax's bfloat16 block bit for bit (measured: no
# element differs; a float32 block differs in all). Through the whole net
# the rare one-ulp differences of the transcendental functions (6e-5 of
# the first block's elements) spread: on this checkpoint's eps (|eps| up to
# ~10) mean |port - flax bf16| measured 0.0022, against 0.0118 between
# flax's own bf16 and float32 forwards (how far a float32 forward lands),
# and max |port - flax bf16| 0.0625, 0.68% of max |eps| (the test prints
# them).
BF16_TOL = 2e-2         # on max |port - flax| / max |eps|
BF16_BIAS_FACTOR = 1.5  # port bf16 against flax f32, over flax bf16 against flax f32
BF16_MEAN_TOL = 5e-3    # mean |port - flax bf16|, below flax's own bf16-f32 gap
BLOCK_FLIP_TOL = 1e-3   # share of a block's elements that differ from flax's bf16 block


@pytest.fixture(scope="module")
def bf16_case():
    model_dir = os.path.join(ROOT, "data_trained_models", "EnvEmptyNoWait2D-RobotPlanarDisk")
    model, _, info = load_checkpoint(model_dir, device="cpu")
    with open(os.path.join(model_dir, "ema_model.msgpack"), "rb") as f:
        flax_params = serialization.msgpack_restore(f.read())
    kw = dict(state_dim=info["state_dim"], unet_input_dim=info["unet_input_dim"],
              dim_mults=tuple(info["dim_mults"]))
    rng = np.random.default_rng(11)
    x = rng.standard_normal((8, info["horizon"], info["state_dim"])).astype(np.float32)
    t = np.array([0, 1, 2, 3, 7, 13, 20, 24], np.int32)
    args = (flax_params, jnp.asarray(x), jnp.asarray(t))
    return dict(model=model, x=torch.from_numpy(x), t=torch.from_numpy(t),
                flax_params=flax_params,
                flax_bf16=np.asarray(FlaxUnet(**kw, dtype=jnp.bfloat16).apply(*args)),
                flax_f32=np.asarray(FlaxUnet(**kw).apply(*args)))


def test_bf16_forward_matches_flax_bf16(bf16_case):
    model = bf16_case["model"]
    with torch.no_grad():
        got = bf16_model(model)(bf16_case["x"], bf16_case["t"])
    assert got.dtype == torch.float32
    got = got.numpy()
    want, f32 = bf16_case["flax_bf16"], bf16_case["flax_f32"]
    err = np.abs(got - want).max() / np.abs(want).max()
    own = np.abs(want - f32).max()
    mean_err, own_mean = np.abs(got - want).mean(), np.abs(want - f32).mean()
    print(f"bf16: port against flax {err:.4f} of max |eps|; "
          f"flax bf16 against f32 {own:.4f}, port bf16 against flax f32 "
          f"{np.abs(got - f32).max():.4f}; mean |port - flax bf16| {mean_err:.4f}, "
          f"|flax bf16 - f32| {own_mean:.4f}, |port - flax f32| "
          f"{np.abs(got - f32).mean():.4f}")
    assert err <= BF16_TOL
    assert np.abs(got - f32).max() <= BF16_BIAS_FACTOR * own
    assert mean_err <= BF16_MEAN_TOL < own_mean
    assert 2 * mean_err <= np.abs(got - f32).mean()  # nearer flax's bf16 than its f32


def _blocks():
    """(port submodule, flax module, its parameters' name, input channels;
    0 for the time encoder), one of each kind of block."""
    bf = dict(dtype=jnp.bfloat16)
    res = flax_unet.ResidualTemporalBlock
    return [("time_mlp", flax_unet.TimeEncoder(32, 32, **bf), "TimeEncoder_0", 0),
            ("downs.0.0", res(32, **bf), "ResidualTemporalBlock_0", 4),
            ("downs.1.1", res(64, **bf), "ResidualTemporalBlock_3", 64),
            ("downs.0.2", flax_unet.Downsample1d(32, **bf), "Downsample1d_0", 32),
            ("mid0", res(128, **bf), "ResidualTemporalBlock_6", 128),
            ("ups.0.0", res(64, **bf), "ResidualTemporalBlock_8", 256),
            ("ups.0.2", flax_unet.Upsample1d(64, **bf), "Upsample1d_0", 64),
            ("final_block", flax_unet.Conv1dBlock(32, **bf), "Conv1dBlock_0", 32)]


@pytest.mark.parametrize("index", range(len(_blocks())), ids=[b[0] for b in _blocks()])
def test_bf16_block_rounds_as_flax(bf16_case, index):
    """Each kind of block of the bfloat16 twin, fed flax's bfloat16 block's
    input, gives its output bit for bit (BLOCK_FLIP_TOL); the float32
    block, on the same input, does not."""
    name, flax_block, key, c_in = _blocks()[index]
    params = {"params": bf16_case["flax_params"]["params"][key]}
    rng = np.random.default_rng(index)
    c = jnp.asarray(rng.standard_normal((8, 32)), jnp.bfloat16)
    if c_in:
        x = jnp.asarray(rng.standard_normal((8, 16, c_in)), jnp.bfloat16)
        args = (x, c) if name.split(".")[-1] in ("0", "1") or name.startswith("mid") else (x,)
    else:
        args = (jnp.asarray(bf16_case["t"].numpy()),)
    want = np.asarray(flax_block.apply(params, *args).astype(jnp.float32))

    def port(model, dtype):
        block = model.get_submodule(name)
        targs = [torch.tensor(np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                                         else a)) for a in args]
        if c_in:
            targs[0] = targs[0].transpose(1, 2)
        targs = [a.to(dtype) if a.is_floating_point() else a for a in targs]
        with torch.no_grad():
            out = block(*targs).float()
        return (out.transpose(1, 2) if c_in else out).numpy()

    got = port(bf16_model(bf16_case["model"]).net, torch.bfloat16)
    f32 = port(bf16_case["model"], torch.float32)
    assert got.shape == want.shape
    flips = float((got != want).mean())
    print(f"{name}: share of elements off flax's bf16 block {flips:.2e} (f32 block "
          f"{float((f32 != want).mean()):.2f})")
    assert flips <= BLOCK_FLIP_TOL
    assert (f32 != want).mean() > 0.5


def test_bf16_twin_is_shared_and_leaves_the_f32_model_alone(bf16_case):
    model = bf16_case["model"]
    with torch.no_grad():
        before = model(bf16_case["x"], bf16_case["t"])
        twin = bf16_model(model)
        after = model(bf16_case["x"], bf16_case["t"])
    assert bf16_model(model) is twin
    assert all(p.dtype == torch.float32 for p in model.parameters())
    norms = [(n, m) for n, m in twin.net.named_modules() if isinstance(m, torch.nn.GroupNorm)]
    assert norms and all(m.weight.dtype == torch.float32 for _, m in norms)
    for n, m in norms:  # flax's float32 GroupNorm parameters, not rounded through bfloat16
        own = model.get_submodule(n)
        assert torch.equal(m.weight, own.weight) and torch.equal(m.bias, own.bias)
    assert {p.dtype for n, p in twin.named_parameters() if ".norm." not in n} == {torch.bfloat16}
    assert torch.equal(before, after)
    np.testing.assert_allclose(after.numpy(), bf16_case["flax_f32"], rtol=0, atol=ATOL)
