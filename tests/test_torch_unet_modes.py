"""The TemporalUnet's optional modes in the port, against the flax model.

Each of self_attention off and on x conditioning_type '', 'concatenate',
'attention' and 'default' at a small width (16 x (1, 2), H = 32): JAX's
`init_unet` parameters go through `convert_flax_params`, and the port's
forward must agree with flax's within the float32 tolerance of
tests/test_torch_unet.py (ATOL = 5e-5; measured ~3e-6: the convolutions'
summation order, GroupNorm's and LayerNorm's variance formulas). The
parameter trees round-trip exactly. The bfloat16 twin refuses the modes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmd_tpu.models.temporal_unet import init_unet as flax_init_unet
from mmd_torch.models.temporal_unet import (
    Bf16Forward,
    Bf16Unet,
    TemporalUnet,
    bf16_model,
    convert_flax_params,
    init_unet,
    to_flax_params,
)

torch.set_num_threads(1)

ATOL = 5e-5
B, H, D, E = 3, 32, 4, 16
MODES = [(attn, cond) for attn in (False, True)
         for cond in ("", "concatenate", "attention", "default")]


def _ids(mode):
    attn, cond = mode
    return f"{'attn' if attn else 'noattn'}-{cond or 'none'}"


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, D)).astype(np.float32)
    t = np.array([0, 7, 24], np.int32)
    ctx = rng.standard_normal((B, E)).astype(np.float32)
    return x, t, ctx


def _flax(mode, seed=0):
    attn, cond = mode
    return flax_init_unet(jax.random.PRNGKey(seed), horizon=H, state_dim=D, unet_input_dim=16,
                          dim_mults=(1, 2), conditioning_type=cond, context_dim=E,
                          self_attention=attn)


def _port(mode):
    attn, cond = mode
    return TemporalUnet(state_dim=D, unet_input_dim=16, dim_mults=(1, 2), self_attention=attn,
                        conditioning_type=cond, context_dim=E)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("mode", MODES, ids=_ids)
def test_converted_forward_matches_flax(mode):
    model, params = _flax(mode, seed=len(_ids(mode)))
    x, t, ctx = _inputs(len(_ids(mode)))
    extra = (ctx,) if mode[1] else ()
    want = np.asarray(model.apply(params, jnp.asarray(x), jnp.asarray(t),
                                  *map(jnp.asarray, extra)))
    net = _port(mode)
    sd = convert_flax_params(_np_tree(params), n_levels=2)
    assert set(sd) == set(net.state_dict())
    net.load_state_dict(sd)
    with torch.no_grad():
        got = net(torch.from_numpy(x), torch.from_numpy(t), *map(torch.from_numpy, extra))
    assert got.shape == want.shape == (B, H, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("mode", MODES, ids=_ids)
def test_parameter_trees_round_trip_exactly(mode):
    _, params = _flax(mode)
    tree = _np_tree(params)
    back = to_flax_params(convert_flax_params(tree, n_levels=2), n_levels=2)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("mode", MODES, ids=_ids)
def test_init_unet_gives_flax_tree_and_initializers(mode):
    """The port's init draws a tree of flax's shapes, LayerNorms at scale 1
    and bias 0, biases 0, and kernels of variance 1 / fan_in."""
    attn, cond = mode
    _, params = _flax(mode)
    net = init_unet(torch.Generator().manual_seed(0), state_dim=D, unet_input_dim=16,
                    dim_mults=(1, 2), device="cpu", self_attention=attn,
                    conditioning_type=cond, context_dim=E)
    tree = to_flax_params(net.state_dict(), n_levels=2)
    shapes = jax.tree_util.tree_map(lambda a: a.shape, _np_tree(params))
    assert jax.tree_util.tree_map(lambda a: a.shape, tree) == shapes
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    for path, leaf in flat:
        keys = [p.key for p in path]
        if "LayerNorm_0" in keys:
            assert np.all(leaf == (1.0 if keys[-1] == "scale" else 0.0)), keys
        elif keys[-1] == "bias":
            assert np.all(leaf == 0.0), keys
    for name in ("LinearAttention_0", "ContextCrossBlock_0"):
        if name in tree["params"]:
            k = (tree["params"][name]["Conv_0"]["kernel"] if name.startswith("Linear")
                 else tree["params"][name]["CrossAttention_0"]["Dense_0"]["kernel"])
            fan_in = int(np.prod(k.shape[:-1]))
            assert abs(k.std() * np.sqrt(fan_in) - 1.0) < 0.1


@pytest.mark.parametrize("cond", ["concatenate", "attention", "default"])
def test_output_depends_on_the_context(cond):
    """The port's mirror of tests/test_diffusion.py::
    test_unet_context_conditioning_modes: a (B, E) context changes the
    output, and the unconditional model keeps its parameter tree."""
    model, params = _flax((False, cond))
    net = _port((False, cond))
    net.load_state_dict(convert_flax_params(_np_tree(params), n_levels=2))
    x = torch.linspace(-1, 1, B * H * D).reshape(B, H, D)
    t = torch.zeros(B, dtype=torch.int64)
    with torch.no_grad():
        y0 = net(x, t, torch.zeros(B, E))
        y1 = net(x, t, torch.ones(B, E))
    assert y0.shape == (B, H, D) and not torch.allclose(y0, y1)
    with pytest.raises(ValueError, match="needs a context"):
        net(x, t)
    plain = TemporalUnet(state_dim=D, unet_input_dim=16, dim_mults=(1, 2))
    _, flax_plain = flax_init_unet(jax.random.PRNGKey(0), horizon=H, state_dim=D,
                                   unet_input_dim=16, dim_mults=(1, 2))
    assert set(plain.state_dict()) == set(convert_flax_params(_np_tree(flax_plain),
                                                              n_levels=2))
    assert not any(k.startswith(("self_attn", "cross_attn", "state_embed"))
                   for k in plain.state_dict())


@pytest.mark.parametrize("mode", MODES[1:], ids=_ids)
def test_bf16_twin_refuses_the_optional_modes(mode):
    """flax computes the attention submodules in float32 on bfloat16
    activations; the twin refuses rather than round elsewhere."""
    net = _port(mode)
    for make in (Bf16Unet, bf16_model, Bf16Forward):
        with pytest.raises(ValueError, match="bfloat16 UNet's attention and context modes"):
            make(net)
