"""Multi-tile diffusion ensemble: per-tile denoising in one batched forward,
with cross-conditioned seams.

Twin of `mmd_tpu/models/ensemble.py` (reference: mmd/models/
diffusion_models/diffusion_ensemble.py:37-313, apply_cross_conditioning in
sample_functions.py:17-31).

Order of a reverse step, as in JAX (not the reference's): every tile steps
from the same x, and the seams are synchronized once per step, after all
tiles (Jacobi). The reference denoises the tiles one after the other within
a step and re-applies the seams after each tile (Gauss-Seidel); JAX's
module docstring says why the two agree in practice.

The denoiser is one batched forward over the stacked per-tile parameters
(`stack_params`: `torch.func.stack_module_state` and
`torch.func.vmap(functional_call)`), as JAX's vmap over stacked parameters
is, so a step of T tiles costs one forward's launches, not T forwards'.

Seam semantics (exact, sample_functions.py:17-31): for chain tiles m, m+1
with relative translation rel = T[m+1] - T[m] (zero-padded to the state
dim) and boundary = rel / ||rel|| with zeros -> 1e6:
    x[m][:, H-1] = min(x[m+1][:, 0] + rel, boundary)
    x[m+1][:, 0] = max(x[m][:, H-1] - rel, -boundary)
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call, stack_module_state, vmap

from mmd_torch.config import DiffusionConfig
from mmd_torch.costs.guide import GuideConfig, GuideData
from mmd_torch.models.diffusion import (
    HardConds,
    SamplerNoise,
    _guide_and_noise,
    predict_start_from_noise,
    q_posterior_mean,
)
from mmd_torch.models.schedules import DiffusionSchedule
from mmd_torch.parallel.sharding import (
    axis_rows,
    gather_leading_axis,
    shard_axes,
    shard_leading_axis,
)


@dataclasses.dataclass(frozen=True)
class CrossConds:
    """Chain seam data of an n_tiles ensemble."""

    rel: torch.Tensor       # (n_tiles-1, D) T[m+1] - T[m], velocity dims zero
    boundary: torch.Tensor  # (n_tiles-1, D) rel / ||rel||, zeros -> 1e6

    @staticmethod
    def from_transforms(transforms, state_dim: int = 4, device="cuda") -> "CrossConds":
        """transforms: (n_tiles, 2) world translations of the tiles."""
        t = np.asarray(transforms, np.float32)
        rel = np.zeros((t.shape[0] - 1, state_dim), np.float32)
        rel[:, :2] = t[1:] - t[:-1]
        norm = np.linalg.norm(rel, axis=-1, keepdims=True)
        boundary = rel / np.where(norm < 1e-12, 1.0, norm)
        boundary = np.where(boundary == 0.0, 1e6, boundary).astype(np.float32)
        return CrossConds(rel=torch.as_tensor(rel, device=device),
                          boundary=torch.as_tensor(boundary, device=device))


def apply_cross_conditioning(x: torch.Tensor, cc: CrossConds) -> torch.Tensor:
    """x (n_tiles, B, H, D) -> x with every seam set (one pass; the seams
    write disjoint entries, so their order does not matter)."""
    if x.shape[0] < 2:
        return x
    rel, bound = cc.rel[:, None, :], cc.boundary[:, None, :]
    end_new = torch.minimum(x[1:, :, 0, :] + rel, bound)       # (n-1, B, D)
    start_new = torch.maximum(end_new - rel, -bound)
    x = x.clone()
    x[:-1, :, -1, :] = end_new
    x[1:, :, 0, :] = start_new
    return x


def seam_residual(x: torch.Tensor, cc: CrossConds) -> torch.Tensor:
    """How far a normalized batch x (n_tiles, B, H, D) is from its seam
    equations: max |x[m+1][:, 0] - max(x[m][:, H-1] - rel, -boundary)|, 0
    right after `apply_cross_conditioning` (a scalar tensor)."""
    if x.shape[0] < 2:
        return torch.zeros((), dtype=x.dtype, device=x.device)
    want = torch.maximum(x[:-1, :, -1, :] - cc.rel[:, None, :], -cc.boundary[:, None, :])
    return (x[1:, :, 0, :] - want).abs().max()


class StackedUnet:
    """T denoisers of one architecture as one batched forward:
    x (T, B, H, D), t (B,) -> epsilon (T, B, H, D), tile m by denoiser m
    (the twin of JAX's `stack_params` and its vmapped apply)."""

    def __init__(self, models: Sequence[nn.Module]):
        self.models = list(models)
        self.params, self.buffers = stack_module_state(self.models)
        # The architecture alone; the parameters come from the stack.
        self._skeleton = copy.deepcopy(self.models[0]).to("meta")

    @property
    def n_tiles(self) -> int:
        return len(self.models)

    def tiles(self, rows: slice) -> "StackedUnet":
        """The stack of the denoisers of tiles `rows`."""
        return StackedUnet(self.models[rows])

    def __call__(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        def one(params, buffers, x_m):
            return functional_call(self._skeleton, (params, buffers), (x_m, t))

        return vmap(one)(self.params, self.buffers, x)


def stack_params(models: Sequence[nn.Module]) -> StackedUnet:
    """Per-tile denoisers as one batched forward over their stacked
    parameters (the "mixture of skills" as one forward)."""
    return StackedUnet(models)


def _ensemble_mean(model: StackedUnet, schedule: DiffusionSchedule, x: torch.Tensor,
                   i: int) -> torch.Tensor:
    """A step's first half for every tile: the posterior mean from the
    batched forward's epsilon."""
    T, B = x.shape[:2]
    tb = torch.full((B,), max(i, 0), dtype=torch.int64, device=x.device)
    eps = model(x, tb).flatten(0, 1)
    xf, tf = x.flatten(0, 1), tb.repeat(T)
    x0 = torch.clamp(predict_start_from_noise(schedule, xf, tf, eps), -1.0, 1.0)
    return q_posterior_mean(schedule, x0, xf, tf).view_as(x)


def tile_rows(mesh, n_tiles: int) -> Optional[slice]:
    """This rank's tiles under a mesh with a 'tile' axis, which n_tiles
    must divide; None without a mesh or a 'tile' axis."""
    if mesh is None or "tile" not in mesh.axis_names:
        return None
    return axis_rows(n_tiles, mesh, "tile")


def shard_tiles(mesh, rows: slice, model: StackedUnet, hard: HardConds, noise: SamplerNoise,
                gds: Optional[GuideData]):
    """A loop's per-tile inputs cut to this rank's tiles `rows` of the
    mesh's 'tile' axis (each rank's share of JAX's 'tile'-sharded stacked
    parameters, dry run section 3): the denoisers, the hard conditions,
    the step draws (x_T stays whole: the loop starts from every tile) and
    the stacked guide data."""
    mask, values = shard_leading_axis((hard.mask, hard.values), mesh, "tile")
    hard = HardConds(mask=mask, values=values)
    noise = SamplerNoise(x_T=noise.x_T, steps=shard_axes(noise.steps, mesh, (None, "tile")))
    if gds is not None:
        gds = gds.tiles(rows)
    return model.tiles(rows), hard, noise, gds


@torch.no_grad()
def ensemble_p_sample_loop(
    model: StackedUnet,
    schedule: DiffusionSchedule,
    hard: HardConds,            # mask (T, 1, H, 1), values (T, 1 or B, H, D)
    cc: CrossConds,
    cfg: DiffusionConfig,
    noise: SamplerNoise,        # x_T (T, B, H, D), steps (n, T, B, H, D)
    gds: Optional[GuideData] = None,   # stacked over tiles
    guide_cfg: Optional[GuideConfig] = None,
    n_diffusion_steps: Optional[int] = None,
    warm_start: Optional[torch.Tensor] = None,  # (T, B, H, D) normalized
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reverse process of all tiles, from noise.x_T or, if given,
    `warm_start` (ensemble.py:80-144). Each step: the batched forward, each
    tile's guide iterations and noise under its own hard conditions and
    guide data (one guide call covers every tile), then the seams. Returns
    (x (T, B, H, D), chain (S+1, T, B, H, D)), normalized per tile.

    Under a `parallel.sharding` mesh with a 'tile' axis (the JAX dry run's
    tile-sharded stack, `__graft_entry__.py:148-177`) each rank holds its
    tiles' share of the stack and steps only its tiles (`shard_tiles`);
    `ensemble_step` gathers every step's x over 'tile' before the seams,
    so every rank returns the whole x and chain."""
    steps = cfg.step_indices(n_diffusion_steps)
    if noise.steps.shape[0] != len(steps):
        raise ValueError(f"need {len(steps)} step draws, got {noise.steps.shape[0]}")
    x = apply_cross_conditioning(hard.apply(noise.x_T if warm_start is None else warm_start),
                                 cc)
    rows = tile_rows(mesh, model.n_tiles)
    if rows is not None:
        model, hard, noise, gds = shard_tiles(mesh, rows, model, hard, noise, gds)
    chain = [x]
    for n, i in enumerate(steps):
        x = ensemble_step(model, schedule, x, i, noise.steps[n], hard, cc, gds, cfg, guide_cfg,
                          mesh)
        chain.append(x)
    return x, torch.stack(chain)


def ensemble_step(model: StackedUnet, schedule: DiffusionSchedule, x: torch.Tensor, i: int,
                  noise: torch.Tensor, hard: HardConds, cc: CrossConds,
                  gds: Optional[GuideData], cfg: DiffusionConfig,
                  guide_cfg: Optional[GuideConfig], mesh=None) -> torch.Tensor:
    """One reverse step of every tile at index i, then the seams; guided
    while i < t_start_guide (as each tile's `_ddpm_step` in JAX's vmap).
    Under a mesh with a 'tile' axis, x holds every tile, the model, noise,
    hard conditions and guide data are this rank's tiles' (`shard_tiles`):
    the rank steps its tiles, and x is gathered over 'tile' before the
    seams, which join neighbouring tiles."""
    rows = tile_rows(mesh, x.shape[0])
    xs = x if rows is None else shard_leading_axis(x, mesh, "tile")
    guided = gds is not None and i < cfg.t_start_guide
    xs = _guide_and_noise(schedule, _ensemble_mean(model, schedule, xs, i), i, noise, hard,
                          gds, cfg, guide_cfg, guided)
    if rows is not None:
        xs = gather_leading_axis(xs, mesh, "tile")
    return apply_cross_conditioning(xs, cc)
