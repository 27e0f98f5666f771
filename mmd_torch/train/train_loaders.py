"""Factories by name over the reference's loaders.

Twin of `mmd_tpu/train/train_loaders.py` (reference:
mmd/trainer/train_loaders.py:14-90): `get_model`, `get_loss` and
`get_dataset` by string name. A torch module owns its parameters, so
`get_model` returns the module itself: restored from a checkpoint, or built
with flax's default initializers from `generator`.
"""
from __future__ import annotations

from typing import Optional

import torch

from mmd_torch.datasets.trajectories import TrajectoryDataset
from mmd_torch.models.generic import MLPModel, NoModel, PointUnet
from mmd_torch.models.temporal_unet import TemporalUnet, flax_default_init_
from mmd_torch.train.losses import GaussianDiffusionLoss

MODELS = {"TemporalUnet": TemporalUnet, "MLPModel": MLPModel, "NoModel": NoModel,
          "PointUnet": PointUnet}


def get_model(model_class: str = "TemporalUnet", checkpoint_dir: Optional[str] = None,
              generator: Optional[torch.Generator] = None, device="cuda", **kwargs):
    """A model by class name (train_loaders.py:14-50): a checkpoint's EMA
    model if `checkpoint_dir` is given, else a new one on `device`."""
    if checkpoint_dir is not None:
        from mmd_torch.train.checkpoint import load_checkpoint

        model, _, _ = load_checkpoint(checkpoint_dir, device=device)
        return model
    model = MODELS[model_class](**kwargs)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    return flax_default_init_(model, gen).to(device)


def get_loss(loss_class: str = "GaussianDiffusionLoss"):
    """train_loaders.py:52-57."""
    return {"GaussianDiffusionLoss": GaussianDiffusionLoss}[loss_class]


def get_dataset(dataset_class: str = "TrajectoryDataset",
                dataset_subdir: Optional[str] = None,
                trajectories_dir: str = "data_trajectories",
                device="cuda") -> TrajectoryDataset:
    """train_loaders.py:59-82 (the 95/5 split is made in `train`)."""
    if dataset_class != "TrajectoryDataset":
        raise ValueError(f"unknown dataset class {dataset_class!r}")
    return TrajectoryDataset.load_trajectories(trajectories_dir, dataset_subdir, device=device)
