"""Checkpoints and train states, in the JAX package's layout.

A checkpoint directory holds `args.yaml` (model and schedule settings, and
the training normalizer's limits), `model.msgpack` and `ema_model.msgpack`
(flax parameter trees {"params": {...}}), as `mmd_tpu/train/trainer.py:
309-357` writes and reads them. `save_checkpoint` writes them with the
port's own writers, `load_checkpoint` reads and converts them. A multi-tile
skeleton's checkpoints load as one stack (`load_tile_checkpoints`): their
parameters stacked per tile, as JAX's `stack_params` stacks the flax trees,
and their normalizers likewise.

`train_state.msgpack` holds JAX's TrainState as flax serializes it:
{params, ema_params, opt_state: {0: {}, 1: {0: {count, mu, nu}, 1: {}}},
step}, the clip's and the scale's empty states beside Adam's. So weights
and optimizer state cross between the two packages both ways.
"""
from __future__ import annotations

import os
from typing import TYPE_CHECKING, Dict, List, Sequence, Tuple

import numpy as np
import torch

from mmd_torch.datasets.normalization import LimitsNormalizer
from mmd_torch.io.flat_yaml import load_flat_yaml, save_flat_yaml
from mmd_torch.io.msgpack import load_msgpack, save_msgpack
from mmd_torch.models.ensemble import StackedUnet, stack_params
from mmd_torch.models.schedules import DiffusionSchedule, make_schedule
from mmd_torch.models.temporal_unet import TemporalUnet, convert_flax_params, to_flax_params
from mmd_torch.utils.profiling import span

if TYPE_CHECKING:
    from mmd_torch.datasets.trajectories import TrajectoryDataset
    from mmd_torch.train.trainer import TrainConfig, TrainState


def load_checkpoint(model_dir: str, device="cuda", use_ema: bool = True
                    ) -> Tuple[TemporalUnet, DiffusionSchedule, Dict]:
    """Returns (model in eval mode on `device`, schedule, info from
    args.yaml); the EMA weights unless use_ema is False."""
    with span("checkpoint.load"):
        info = load_flat_yaml(os.path.join(model_dir, "args.yaml"))
        model = TemporalUnet(state_dim=info["state_dim"],
                             unet_input_dim=info["unet_input_dim"],
                             dim_mults=tuple(info["dim_mults"]))
        name = "ema_model.msgpack" if use_ema else "model.msgpack"
        tree = load_msgpack(os.path.join(model_dir, name))
        model.load_state_dict(convert_flax_params(tree, n_levels=len(info["dim_mults"])))
        model = model.to(device).eval().requires_grad_(False)
        schedule = make_schedule(info["variance_schedule"], info["n_diffusion_steps"],
                                 device=device)
    return model, schedule, info


def load_tile_checkpoints(model_dirs: Sequence[str], device="cuda"
                          ) -> Tuple[StackedUnet, DiffusionSchedule, LimitsNormalizer,
                                     List[Dict]]:
    """One checkpoint per tile -> (the models as one stacked forward, the
    schedule they share, their training normalizers stacked per tile
    (limits (T, 1, 1, D)), each args.yaml). Refuses checkpoints whose
    schedules differ: the tiles step together."""
    loaded = [load_checkpoint(d, device=device) for d in model_dirs]
    infos = [info for _, _, info in loaded]
    keys = {(i["variance_schedule"], i["n_diffusion_steps"]) for i in infos}
    if len(keys) != 1:
        raise ValueError(f"the tiles' schedules differ: {sorted(keys)}")
    normalizer = LimitsNormalizer.stack([
        LimitsNormalizer.from_limits(i["normalizer_mins"], i["normalizer_maxs"], device=device)
        for i in infos])
    return stack_params([m for m, _, _ in loaded]), loaded[0][1], normalizer, infos


def _flax_tree(model: TemporalUnet, tensors=None) -> Dict:
    """The flax tree of `model`'s parameters, or of per-parameter tensors
    (Adam's moments) in `model.parameters()` order."""
    if tensors is None:
        sd = model.state_dict()
    else:
        sd = {name: t for (name, _), t in zip(model.named_parameters(), tensors)}
    return to_flax_params(sd, n_levels=len(model.dim_mults))


def save_checkpoint(model_dir: str, state: "TrainState", dataset: "TrajectoryDataset",
                    cfg: "TrainConfig", suffix: str = ""):
    """model{suffix}.msgpack, ema_model{suffix}.msgpack and args.yaml, as
    `mmd_tpu/train/trainer.py:309-335` writes them; the unsuffixed pair is
    the one a planner loads."""
    os.makedirs(model_dir, exist_ok=True)
    model = state.model
    save_msgpack(os.path.join(model_dir, f"model{suffix}.msgpack"), _flax_tree(model))
    save_msgpack(os.path.join(model_dir, f"ema_model{suffix}.msgpack"), _flax_tree(state.ema))
    save_flat_yaml(os.path.join(model_dir, "args.yaml"), {
        "env_name": dataset.env_name,
        "horizon": int(dataset.n_support_points),
        "state_dim": int(dataset.state_dim),
        "unet_input_dim": int(model.unet_input_dim),
        "dim_mults": list(model.dim_mults),
        "n_diffusion_steps": int(cfg.n_diffusion_steps),
        "variance_schedule": cfg.variance_schedule,
        "step": int(state.step),
        "normalizer_mins": dataset.normalizer.mins.cpu().tolist(),
        "normalizer_maxs": dataset.normalizer.maxs.cpu().tolist(),
    })


def save_train_state(model_dir: str, state: "TrainState", name: str = "train_state.msgpack"):
    """The whole resume state (parameters, EMA, Adam's state, step) in JAX's
    TrainState layout (module docstring)."""
    os.makedirs(model_dir, exist_ok=True)
    adam = {"count": np.asarray(state.count, np.int32),
            "mu": _flax_tree(state.model, state.mu),
            "nu": _flax_tree(state.model, state.nu)}
    save_msgpack(os.path.join(model_dir, name), {
        "params": _flax_tree(state.model),
        "ema_params": _flax_tree(state.ema),
        "opt_state": {"0": {}, "1": {"0": adam, "1": {}}},
        "step": np.asarray(state.step, np.int32)})


def load_train_state(model_dir: str, state: "TrainState",
                     name: str = "train_state.msgpack") -> "TrainState":
    """Read a train state written by either package into `state` (whose
    model fixes the architecture), in place; returns it."""
    tree = load_msgpack(os.path.join(model_dir, name))
    n_levels = len(state.model.dim_mults)
    names = [n for n, _ in state.model.named_parameters()]

    def tensors(t: Dict) -> List[torch.Tensor]:
        sd = convert_flax_params(t, n_levels=n_levels)
        return [sd[n] for n in names]

    adam = tree["opt_state"]["1"]["0"]
    with torch.no_grad():
        for dst, src in ((state.model, tree["params"]), (state.ema, tree["ema_params"])):
            dst.load_state_dict(convert_flax_params(src, n_levels=n_levels))
        for dst, src in ((state.mu, adam["mu"]), (state.nu, adam["nu"])):
            for d, s in zip(dst, tensors(src)):
                d.copy_(s)
    state.count = int(adam["count"])
    state.step = int(tree["step"])
    return state
