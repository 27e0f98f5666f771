"""Temporal 1D-conv UNet denoiser, and the converter from flax parameters.

Twin of `TemporalUnet` in `mmd_tpu/models/temporal_unet.py` without
attention or context, which no checkpoint uses (reference:
mmd/models/diffusion_models/temporal_unet.py:23-174, layers.py). The public
forward keeps the JAX layout: x (B, H, D), t (B,) -> (B, H, D). Inside, the
convolutions run in torch's (B, C, H) layout.

`convert_flax_params` maps a flax parameter tree (nested dicts of numpy
arrays, as `mmd_torch.io.msgpack` reads them) onto this module's
state_dict, and `to_flax_params` maps it back:
- Conv kernels are (k, in, out) in flax and (out, in, k) in torch; Dense
  kernels are (in, out) in flax and (out, in) in torch.
- flax GroupNorm uses eps 1e-6 (torch's default is 1e-5).
- `Upsample1d` is flax `ConvTranspose(k=4, s=2, padding="SAME")` with
  `transpose_kernel=False`: a plain correlation of the 2x-dilated input
  padded by (2, 2). torch's `ConvTranspose1d(k=4, s=2, padding=1)` computes
  the same with the kernel flipped along k, and gives the same 2H outputs.

`bf16_model` gives the forward in bfloat16, as flax's `dtype=bfloat16`
computes it (`mmd_tpu/models/temporal_unet.py:216-220`), rounding where
flax's ops round:
- convolutions and dense layers multiply in bfloat16 on bfloat16 copies of
  the float32 parameters, and add the bias after the product, each result
  rounded to bfloat16 (flax's `nn.Conv`/`nn.Dense` add it as a second op);
- GroupNorm runs in float32 with the float32 parameters themselves, and
  its output is rounded to bfloat16;
- Mish's softplus is jax.nn.softplus's op sequence, max(x, 0) +
  log1p(exp(-|x|)), each op rounded to bfloat16;
- the sinusoidal embedding is float32, and the result is handed back in
  the caller's dtype.
`Bf16Forward` runs that forward over the float32 model's own parameters,
for training.

`init_unet` draws flax's default initializers.
"""
from __future__ import annotations

import copy
import math
import weakref
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

GROUPNORM_EPS = 1e-6  # flax nn.GroupNorm default


def mish(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.bfloat16:  # flax's bfloat16 softplus (module docstring)
        return x * torch.tanh(torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs())))
    return x * torch.tanh(F.softplus(x))


class SinusoidalPosEmb(nn.Module):
    """reference: layers.py:246-258."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t: torch.Tensor) -> torch.Tensor:  # (B,) -> (B, dim)
        half = self.dim // 2
        freq = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                         * (-math.log(10000.0) / (half - 1)))
        ang = t.to(torch.float32)[:, None] * freq[None, :]
        return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class TimeEncoder(nn.Module):
    """Sin(dim) -> Linear(4 dim) -> Mish -> Linear(out) (layers.py:232-243)."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.pos = SinusoidalPosEmb(dim)
        self.dense0 = nn.Linear(dim, dim * 4)
        self.dense1 = nn.Linear(dim * 4, dim_out)

    def forward(self, t):
        # The embedding is float32; a bfloat16 twin's dense layers take it
        # in their own dtype.
        h = self.pos(t).to(self.dense0.weight.dtype)
        return self.dense1(mish(self.dense0(h)))


class Conv1dBlock(nn.Module):
    """Conv1d -> GroupNorm -> Mish (layers.py:279-296), on (B, C, H)."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int = 5, n_groups: int = 8):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, kernel_size, padding=kernel_size // 2)
        self.norm = nn.GroupNorm(n_groups, c_out, eps=GROUPNORM_EPS)

    def forward(self, x):
        h = self.conv(x)
        # GroupNorm runs in its parameters' dtype (float32 in the bfloat16
        # twin too, as flax's statistics do), then rounds back to h's.
        return mish(self.norm(h.to(self.norm.weight.dtype)).to(h.dtype))


class ResidualTemporalBlock(nn.Module):
    """Two conv blocks + FiLM time-add + 1x1 residual (layers.py:326-359)."""

    def __init__(self, c_in: int, c_out: int, emb_dim: int, kernel_size: int = 5):
        super().__init__()
        self.block0 = Conv1dBlock(c_in, c_out, kernel_size)
        self.block1 = Conv1dBlock(c_out, c_out, kernel_size)
        self.time = nn.Linear(emb_dim, c_out)
        self.res = nn.Conv1d(c_in, c_out, 1) if c_in != c_out else None

    def forward(self, x, c):  # x (B, C, H), c (B, E)
        h = self.block0(x) + self.time(mish(c))[:, :, None]
        h = self.block1(h)
        return h + (self.res(x) if self.res is not None else x)


class TemporalUnet(nn.Module):
    """Denoiser: x (B, H, D), t (B,) -> epsilon (B, H, D)."""

    def __init__(self, state_dim: int = 4, unet_input_dim: int = 32,
                 dim_mults: Tuple[int, ...] = (1, 2, 4), time_emb_dim: int = 32):
        super().__init__()
        self.state_dim = state_dim
        self.unet_input_dim = unet_input_dim
        self.dim_mults = tuple(dim_mults)
        self.time_mlp = TimeEncoder(32, time_emb_dim)
        dims = [state_dim] + [unet_input_dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        E = time_emb_dim

        self.downs = nn.ModuleList()
        for ind, (d_in, d_out) in enumerate(in_out):
            is_last = ind >= len(in_out) - 1
            self.downs.append(nn.ModuleList([
                ResidualTemporalBlock(d_in, d_out, E),
                ResidualTemporalBlock(d_out, d_out, E),
                nn.Identity() if is_last else nn.Conv1d(d_out, d_out, 3, stride=2, padding=1),
            ]))
        mid = dims[-1]
        self.mid0 = ResidualTemporalBlock(mid, mid, E)
        self.mid1 = ResidualTemporalBlock(mid, mid, E)
        self.ups = nn.ModuleList()
        for d_in, d_out in reversed(in_out[1:]):
            self.ups.append(nn.ModuleList([
                ResidualTemporalBlock(d_out * 2, d_in, E),
                ResidualTemporalBlock(d_in, d_in, E),
                nn.ConvTranspose1d(d_in, d_in, 4, stride=2, padding=1),
            ]))
        self.final_block = Conv1dBlock(unet_input_dim, unet_input_dim)
        self.final_conv = nn.Conv1d(unet_input_dim, state_dim, 1)

    def forward(self, x: torch.Tensor, time: torch.Tensor) -> torch.Tensor:
        c = self.time_mlp(time)
        x = x.transpose(1, 2)  # (B, D, H)
        h_stack = []
        for res0, res1, down in self.downs:
            x = res1(res0(x, c), c)
            h_stack.append(x)
            x = down(x)
        x = self.mid1(self.mid0(x, c), c)
        for res0, res1, up in self.ups:
            x = torch.cat([x, h_stack.pop()], dim=1)
            x = up(res1(res0(x, c), c))
        x = self.final_conv(self.final_block(x))
        return x.transpose(1, 2)


class _BiasAfter(nn.Module):
    """A conv or dense layer that adds its bias after the product, as a
    separate op."""

    def __init__(self, layer: nn.Module):
        super().__init__()
        self.layer = layer

    @property
    def weight(self) -> torch.Tensor:
        return self.layer.weight

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = self.layer
        if isinstance(m, nn.Linear):
            return F.linear(x, m.weight) + m.bias
        if isinstance(m, nn.ConvTranspose1d):
            y = F.conv_transpose1d(x, m.weight, None, m.stride, m.padding, m.output_padding,
                                   m.groups, m.dilation)
        else:
            y = F.conv1d(x, m.weight, None, m.stride, m.padding, m.dilation, m.groups)
        return y + m.bias[:, None]


class Bf16Unet(nn.Module):
    """A TemporalUnet's forward in bfloat16 (module docstring); the output
    is in the input's dtype."""

    def __init__(self, model: TemporalUnet):
        super().__init__()
        self.net = copy.deepcopy(model)
        for m in list(self.net.modules()):
            if not isinstance(m, nn.GroupNorm):
                for p in m.parameters(recurse=False):
                    p.data = p.data.to(torch.bfloat16)
            for name, child in m.named_children():
                if isinstance(child, (nn.Conv1d, nn.ConvTranspose1d, nn.Linear)):
                    setattr(m, name, _BiasAfter(child))

    def forward(self, x: torch.Tensor, time: torch.Tensor) -> torch.Tensor:
        return self.net(x.to(torch.bfloat16), time).to(x.dtype)


_BF16_TWINS: "weakref.WeakKeyDictionary[nn.Module, Bf16Unet]" = weakref.WeakKeyDictionary()


def bf16_model(model: TemporalUnet) -> Bf16Unet:
    """The bfloat16 twin of `model`, made once per model, so that planners
    sharing a model share its twin (and stay batchable)."""
    if model not in _BF16_TWINS:
        _BF16_TWINS[model] = Bf16Unet(model).eval()
    return _BF16_TWINS[model]


class Bf16Forward:
    """The bfloat16-compute forward over a float32 TemporalUnet's own
    parameters, for training: JAX's `model.clone(dtype=bfloat16).apply(
    params_f32)` (`mmd_tpu/train/trainer.py:213-214`). Each call casts the
    float32 parameters to what `Bf16Unet` holds (bfloat16, GroupNorm's kept
    float32) and runs `Bf16Unet`'s forward on them by
    `torch.func.functional_call`, so it rounds where the inference twin
    rounds, and the gradients come back float32 through the casts to the
    model's own parameters."""

    def __init__(self, model: TemporalUnet):
        self.model = model
        self.twin = Bf16Unet(model)
        own = list(model.named_parameters())
        twin = list(self.twin.named_parameters())
        if [p.shape for _, p in own] != [p.shape for _, p in twin]:
            raise ValueError("the bfloat16 twin's parameters do not follow the model's")
        self._names = [(t_name, m_name, t.dtype)
                       for (t_name, t), (m_name, _) in zip(twin, own)]

    def __call__(self, x: torch.Tensor, time: torch.Tensor) -> torch.Tensor:
        own = dict(self.model.named_parameters())
        cast = {t_name: own[m_name].to(dtype) for t_name, m_name, dtype in self._names}
        return torch.func.functional_call(self.twin, cast, (x, time))


# ------------------------------------------------------------- conversion
# A flax TemporalUnet's parameter tree and this module's state_dict hold the
# same leaves. Flax names submodules by creation order:
# ResidualTemporalBlock_0.. run down (two per level), mid (two), then up
# (two per level above the bottom); Downsample1d_i and Upsample1d_i in order.
# A residual block has a 1x1 `Conv_0` only where its channels change.
def _param_map(n_levels: int, has_res: Callable[[int, str], bool]
               ) -> List[Tuple[Tuple[str, ...], str, str]]:
    """[(flax path under "params", state_dict name, layout)], layout one of
    "conv" ((k, in, out) <-> (out, in, k)), "conv_t" (the transposed conv,
    flipped in k), "dense" ((in, out) <-> (out, in)) and "same"."""
    out = []

    def layer(path, name, layout):
        out.append((path + ("kernel",), f"{name}.weight", layout))
        out.append((path + ("bias",), f"{name}.bias", "same"))

    def conv_block(path, prefix):
        layer(path + ("Conv_0",), f"{prefix}.conv", "conv")
        out.append((path + ("GroupNorm_0", "scale"), f"{prefix}.norm.weight", "same"))
        out.append((path + ("GroupNorm_0", "bias"), f"{prefix}.norm.bias", "same"))

    def res_block(r, prefix):
        path = (f"ResidualTemporalBlock_{r}",)
        conv_block(path + ("Conv1dBlock_0",), f"{prefix}.block0")
        conv_block(path + ("Conv1dBlock_1",), f"{prefix}.block1")
        layer(path + ("Dense_0",), f"{prefix}.time", "dense")
        if has_res(r, prefix):
            layer(path + ("Conv_0",), f"{prefix}.res", "conv")

    for i in range(2):
        layer(("TimeEncoder_0", f"Dense_{i}"), f"time_mlp.dense{i}", "dense")
    r = 0
    for lvl in range(n_levels):
        for k in range(2):
            res_block(r, f"downs.{lvl}.{k}")
            r += 1
        if lvl < n_levels - 1:
            layer((f"Downsample1d_{lvl}", "Conv_0"), f"downs.{lvl}.2", "conv")
    for k in range(2):
        res_block(r, f"mid{k}")
        r += 1
    for lvl in range(n_levels - 1):
        for k in range(2):
            res_block(r, f"ups.{lvl}.{k}")
            r += 1
        layer((f"Upsample1d_{lvl}", "ConvTranspose_0"), f"ups.{lvl}.2", "conv_t")
    conv_block(("Conv1dBlock_0",), "final_block")
    layer(("Conv_0",), "final_conv", "conv")
    return out


def _conv(w: np.ndarray) -> np.ndarray:      # (k, in, out) <-> (out, in, k)
    return np.ascontiguousarray(w.transpose(2, 1, 0))


def _conv_t(w: np.ndarray) -> np.ndarray:    # (k, in, out) -> (in, out, k), flipped in k
    return np.ascontiguousarray(w.transpose(1, 2, 0)[:, :, ::-1])


def _conv_t_inverse(w: np.ndarray) -> np.ndarray:  # (in, out, k) flipped -> (k, in, out)
    return np.ascontiguousarray(w[:, :, ::-1].transpose(2, 0, 1))


def _dense(w: np.ndarray) -> np.ndarray:     # (in, out) <-> (out, in)
    return np.ascontiguousarray(w.T)


_TO_TORCH = {"conv": _conv, "conv_t": _conv_t, "dense": _dense, "same": np.asarray}
_TO_FLAX = {"conv": _conv, "conv_t": _conv_t_inverse, "dense": _dense, "same": np.asarray}


def _get(tree: Dict, path: Tuple[str, ...]):
    for key in path:
        tree = tree[key]
    return tree


def convert_flax_params(tree: Dict, n_levels: int = 3) -> Dict[str, torch.Tensor]:
    """Flax TemporalUnet parameters -> a state_dict of `TemporalUnet`.

    `tree` is the restored msgpack ({"params": {...}} or the inner dict).
    """
    p = tree.get("params", tree)
    has_res = lambda r, prefix: "Conv_0" in p[f"ResidualTemporalBlock_{r}"]  # noqa: E731
    return {name: torch.from_numpy(np.array(_TO_TORCH[layout](_get(p, path)), np.float32))
            for path, name, layout in _param_map(n_levels, has_res)}


def _sorted_tree(tree: Dict) -> Dict:
    """Keys in sorted order at every level, as flax's checkpoints hold them."""
    return {k: _sorted_tree(v) if isinstance(v, dict) else v
            for k, v in sorted(tree.items())}


def to_flax_params(state_dict: Dict[str, torch.Tensor], n_levels: int = 3) -> Dict:
    """The inverse of `convert_flax_params`: a state_dict of `TemporalUnet`
    -> flax's parameter tree {"params": {...}} of float32 numpy arrays."""
    has_res = lambda r, prefix: f"{prefix}.res.weight" in state_dict  # noqa: E731
    tree: Dict = {}
    for path, name, layout in _param_map(n_levels, has_res):
        leaf = tree
        for key in path[:-1]:
            leaf = leaf.setdefault(key, {})
        value = state_dict[name].detach().to("cpu", torch.float32).numpy()
        leaf[path[-1]] = np.array(_TO_FLAX[layout](value), np.float32)
    return {"params": _sorted_tree(tree)}


# ---------------------------------------------------------- initialization
_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def truncated_normal(shape, std: float, generator: torch.Generator) -> torch.Tensor:
    """Normal draws truncated to [-2 std', 2 std'], std' = std / 0.8796, so
    that their std is `std`: flax's `lecun_normal` draw (variance_scaling,
    "truncated_normal"), by the inverse CDF on the generator's uniforms."""
    lo, hi = (0.5 * (1.0 + math.erf(v / math.sqrt(2.0))) for v in (-2.0, 2.0))
    u = torch.rand(shape, generator=generator, dtype=torch.float64) * (hi - lo) + lo
    x = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    return (torch.clamp(x, -2.0, 2.0) * (std / _TRUNC_STD)).to(torch.float32)


def flax_default_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Flax's default initializers on every layer of `module`, in place:
    each Linear, Conv1d and ConvTranspose1d weight `lecun_normal` (a
    truncated normal of variance 1 / fan_in, fan_in = kernel size x input
    channels, as flax counts it on its (k, in, out) kernel), biases zero,
    GroupNorm scale 1 and bias 0. Drawn on the host from `generator` (a CPU
    generator), layer by layer in module order."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv1d, nn.ConvTranspose1d)):
                w = m.weight
                if isinstance(m, nn.Linear):
                    fan_in = w.shape[1]
                elif isinstance(m, nn.ConvTranspose1d):
                    fan_in = w.shape[0] * w.shape[2]
                else:
                    fan_in = w.shape[1] * w.shape[2]
                w.copy_(truncated_normal(w.shape, math.sqrt(1.0 / fan_in), generator))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
    return module


def init_unet(generator: torch.Generator, state_dim: int = 4, unet_input_dim: int = 32,
              dim_mults: Tuple[int, ...] = (1, 2, 4), device="cuda") -> TemporalUnet:
    """A TemporalUnet with flax's default initializers, as the JAX model
    gets them (`mmd_tpu/models/temporal_unet.py:291-302` sets none; torch's
    own default, kaiming_uniform, would train along another curve)."""
    model = TemporalUnet(state_dim=state_dim, unet_input_dim=unet_input_dim,
                         dim_mults=dim_mults)
    return flax_default_init_(model, generator).to(device)
