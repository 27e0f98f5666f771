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

from mmd_tpu.models.temporal_unet import TemporalUnet as FlaxUnet, Upsample1d
from mmd_torch.io.msgpack import load_msgpack
from mmd_torch.models.temporal_unet import TemporalUnet, _conv_t, convert_flax_params
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
