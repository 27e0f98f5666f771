"""Load a trained checkpoint of the repository into the port.

A checkpoint directory holds `args.yaml` (model and schedule settings, and
the training normalizer's limits) and `ema_model.msgpack` (flax EMA
parameters), as `mmd_tpu/train/trainer.py:338-357` reads them. Both are read
with the port's own readers and converted at load time; nothing converted
is written to disk. A multi-tile skeleton's checkpoints load as one stack
(`load_tile_checkpoints`): their parameters stacked per tile, as JAX's
`stack_params` stacks the flax trees, and their normalizers likewise.
"""
from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

from mmd_torch.datasets.normalization import LimitsNormalizer
from mmd_torch.io.flat_yaml import load_flat_yaml
from mmd_torch.io.msgpack import load_msgpack
from mmd_torch.models.ensemble import StackedUnet, stack_params
from mmd_torch.models.schedules import DiffusionSchedule, make_schedule
from mmd_torch.models.temporal_unet import TemporalUnet, convert_flax_params


def load_checkpoint(model_dir: str, device="cuda"
                    ) -> Tuple[TemporalUnet, DiffusionSchedule, Dict]:
    """Returns (model in eval mode on `device`, schedule, info from args.yaml)."""
    info = load_flat_yaml(os.path.join(model_dir, "args.yaml"))
    model = TemporalUnet(state_dim=info["state_dim"],
                         unet_input_dim=info["unet_input_dim"],
                         dim_mults=tuple(info["dim_mults"]))
    tree = load_msgpack(os.path.join(model_dir, "ema_model.msgpack"))
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
