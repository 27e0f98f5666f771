"""Training: Adam + global-norm clip + EMA, with the JAX package's recipe.

Twin of `mmd_tpu/train/trainer.py:36-287` (reference:
mmd/trainer/trainer.py:119-335). One train step (`train_step`, JAX's
`_update`, :99-124) takes the loss and its gradients, clips them to global
norm 1.0 as optax does (g / ||g|| * max_norm when ||g|| >= max_norm, no
epsilon), applies optax's Adam (bias corrections and eps outside the square
root, eps_root 0), then updates the EMA: every 10 steps after the
increment, a copy of the parameters while step < 1000 and a 0.995 blend
from then on. The optimizer runs as multi-tensor (`torch._foreach_*`) ops
over the parameter list.

`train` keeps the normalized trajectories on the device and draws batch
indices, t and noise from a generator on the device; a step reads nothing
back. Losses reach the host only at a log, validation, summary or
checkpoint step: the steps between two such points run as one chunk
(`train_chunk`, JAX's scanned chunk), whose mean loss is what is logged,
as JAX logs it. With bfloat16 compute (`TrainConfig.bf16`) the forward and
backward run through `Bf16Forward` on the float32 master parameters;
validation runs float32. `train_step_dp` is the step data-parallel over
a `parallel.sharding` mesh; `train` itself takes no mesh, as JAX's does
not.
"""
from __future__ import annotations

import copy
import dataclasses
import os
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from mmd_torch.datasets.trajectories import TrajectoryDataset
from mmd_torch.models.diffusion import HardConds, diffusion_loss, draw_loss_noise
from mmd_torch.models.schedules import DiffusionSchedule, make_schedule
from mmd_torch.models.temporal_unet import Bf16Forward, TemporalUnet, init_unet
from mmd_torch.parallel.sharding import all_reduce_mean, shard_leading_axis

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4                    # launch_train_01.py recipe
    clip_grad_max_norm: float = 1.0     # trainer.py:289
    ema_decay: float = 0.995            # trainer.py:128
    step_start_ema: int = 1000          # trainer.py:128
    update_ema_every: int = 10          # trainer.py:128
    batch_size: int = 128
    n_diffusion_steps: int = 25
    variance_schedule: str = "exponential"
    # bfloat16 compute: forward and backward in bf16, master parameters,
    # optimizer state, EMA and loss float32 (no loss scaling: bf16 has
    # float32's exponent range).
    bf16: bool = False


class EarlyStopper:
    """Patience-based early stopping on the validation loss
    (trainer.py:48-67)."""

    def __init__(self, patience: int = 10, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.counter = 0
        self.min_validation_loss = float("inf")

    def early_stop(self, validation_loss: float) -> bool:
        if validation_loss < self.min_validation_loss:
            self.min_validation_loss = validation_loss
            self.counter = 0
        elif validation_loss > self.min_validation_loss + self.min_delta:
            self.counter += 1
            if self.counter >= self.patience:
                return True
        return False


@dataclasses.dataclass
class TrainState:
    """JAX's TrainState: the float32 parameters (held by `model`), their
    EMA (`ema`, a copy of the model), Adam's moments (one tensor per
    parameter, in `model.parameters()` order) and count, and the step."""

    model: TemporalUnet
    ema: TemporalUnet
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    count: int
    step: int

    @staticmethod
    def create(model: TemporalUnet) -> "TrainState":
        params = list(model.parameters())
        return TrainState(model=model, ema=copy.deepcopy(model).requires_grad_(False),
                          mu=[torch.zeros_like(p) for p in params],
                          nu=[torch.zeros_like(p) for p in params], count=0, step=0)

    @property
    def params(self) -> List[torch.Tensor]:
        return list(self.model.parameters())


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: g unchanged while ||g|| < max_norm, else
    (g / ||g||) * max_norm; the choice is made on the device."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    one = torch.ones_like(norm)
    out = torch._foreach_div(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(out, torch.where(keep, one, torch.full_like(norm, max_norm)))
    return out


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay**count in float32, as optax computes it."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


@torch.no_grad()
def apply_gradients(state: TrainState, grads: List[torch.Tensor], cfg: TrainConfig):
    """Clip, Adam, then the EMA, in place on `state` (JAX's `_update` after
    the gradients)."""
    params = state.params
    g = clip_by_global_norm(list(grads), cfg.clip_grad_max_norm)
    # optax's moments: (1 - b) * g**order + b * moment.
    torch._foreach_mul_(state.mu, ADAM_B1)
    torch._foreach_add_(state.mu, torch._foreach_mul(g, 1.0 - ADAM_B1))
    g2 = torch._foreach_mul(g, g)
    torch._foreach_mul_(state.nu, ADAM_B2)
    torch._foreach_add_(state.nu, torch._foreach_mul(g2, 1.0 - ADAM_B2))
    state.count += 1
    mu_hat = torch._foreach_div(state.mu, _bias_correction(ADAM_B1, state.count))
    denom = torch._foreach_div(state.nu, _bias_correction(ADAM_B2, state.count))
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, ADAM_EPS)
    updates = torch._foreach_div(mu_hat, denom)
    torch._foreach_mul_(updates, -cfg.lr)
    torch._foreach_add_(params, updates)
    state.step += 1
    if state.step % cfg.update_ema_every == 0:
        ema = list(state.ema.parameters())
        if state.step < cfg.step_start_ema:
            torch._foreach_copy_(ema, params)
        else:
            torch._foreach_mul_(ema, cfg.ema_decay)
            torch._foreach_add_(ema, torch._foreach_mul(params, 1.0 - cfg.ema_decay))


def train_step(state: TrainState, forward: Callable, schedule: DiffusionSchedule,
               cfg: TrainConfig, batch: torch.Tensor, hard: HardConds, t: torch.Tensor,
               noise: torch.Tensor) -> torch.Tensor:
    """One optimizer step on given draws; returns the loss, on the device.
    `forward` is `state.model` or its `Bf16Forward`."""
    loss = diffusion_loss(forward, schedule, batch, hard, t, noise)
    grads = torch.autograd.grad(loss, state.params)
    apply_gradients(state, grads, cfg)
    return loss.detach()


def train_step_dp(state: TrainState, forward: Callable, schedule: DiffusionSchedule,
                  cfg: TrainConfig, batch: torch.Tensor, hard: HardConds, t: torch.Tensor,
                  noise: torch.Tensor, mesh) -> torch.Tensor:
    """`train_step` data-parallel over the mesh's 'dp' axis (the JAX dry run's
    step with the batch on 'dp' and the parameters replicated,
    `__graft_entry__.py:98-113`): batch, hard values, t and noise are the
    global step's, drawn whole on every rank; this rank takes its shard of
    their rows, and the gradients and the loss are all-reduced to their
    mean over the axis, which is the global batch's mean when the shards
    are equal. Every rank then runs the same clip, Adam and EMA. Returns
    the global loss, on the device."""
    batch, values, t, noise = shard_leading_axis((batch, hard.values, t, noise), mesh, "dp")
    loss = diffusion_loss(forward, schedule, batch, HardConds(mask=hard.mask, values=values),
                          t, noise)
    grads = torch.autograd.grad(loss, state.params)
    *grads, loss = all_reduce_mean([*grads, loss.detach()], mesh, "dp")
    apply_gradients(state, grads, cfg)
    return loss


class StepDrawer:
    """A step's draws from the device-resident dataset: a batch from
    [n_val, N), its hard conditions, t and noise, all from one generator
    on the data's device."""

    def __init__(self, dataset: TrajectoryDataset, cfg: TrainConfig, n_val: int,
                 generator: torch.Generator):
        self.dataset, self.cfg, self.n_val, self.generator = dataset, cfg, n_val, generator

    def __call__(self):
        batch, hard = self.dataset.sample_batch(self.generator, self.cfg.batch_size,
                                                start_idx=self.n_val)
        t, noise = draw_loss_noise(self.generator, batch, self.cfg.n_diffusion_steps)
        return batch, hard, t, noise


def train_chunk(state: TrainState, forward: Callable, schedule: DiffusionSchedule,
                cfg: TrainConfig, draw: StepDrawer, n_steps: int) -> torch.Tensor:
    """n_steps train steps with no read to the host; their mean loss, on
    the device (JAX's `make_train_chunk`)."""
    total = None
    for _ in range(n_steps):
        loss = train_step(state, forward, schedule, cfg, *draw())
        total = loss if total is None else total + loss
    return total / n_steps


def chunk_size(num_train_steps: int, cadences) -> int:
    """JAX's chunk: the smallest cadence when it divides every cadence and
    the step count, else 1 (`mmd_tpu/train/trainer.py:235-243`)."""
    cadences = [c for c in (*cadences, num_train_steps) if c]
    chunk = max(1, min(cadences))
    if chunk > 1 and num_train_steps % chunk == 0 and all(c % chunk == 0 for c in cadences):
        return chunk
    return 1


def validation_loss(state: TrainState, schedule: DiffusionSchedule, val_batch: torch.Tensor,
                    mask: torch.Tensor, generator: torch.Generator,
                    n_diffusion_steps: int) -> float:
    """The float32 loss of the current parameters on the held-out prefix."""
    t, noise = draw_loss_noise(generator, val_batch, n_diffusion_steps)
    with torch.no_grad():
        loss = diffusion_loss(state.model, schedule, val_batch,
                              HardConds(mask=mask, values=val_batch), t, noise)
    return float(loss)


def train(dataset: TrajectoryDataset,
          cfg: TrainConfig = TrainConfig(),
          num_train_steps: int = 5000,
          seed: int = 18,
          unet_dim: int = 32,
          dim_mults=(1, 2, 4),
          model_dir: Optional[str] = None,
          log_every: int = 500,
          steps_til_checkpoint: Optional[int] = None,
          log_fn: Optional[Callable] = None,
          val_fraction: float = 0.05,
          validate_every: Optional[int] = None,
          early_stop_patience: Optional[int] = None,
          summary_every: Optional[int] = None,
          resume: bool = False):
    """Train a TemporalUnet diffusion model on `dataset`, on its device.

    As JAX's `train` (trainer.py:119-335): init from `seed`, a 95/5 split
    whose validation prefix is never sampled, validation with optional
    early stopping, sampling summaries, checkpoints (`_step_{i:07d}`
    suffixes), `train_losses.npy` and `val_losses.npy`, and resume from
    `train_state.msgpack`, where the step count continues. Returns (model,
    final TrainState, schedule, logged losses [(step, loss)]).
    """
    from mmd_torch.train.checkpoint import load_train_state, save_checkpoint, save_train_state

    log = log_fn or print
    device = dataset.device
    model = init_unet(torch.Generator().manual_seed(seed), state_dim=dataset.state_dim,
                      unet_input_dim=unet_dim, dim_mults=tuple(dim_mults), device=device)
    schedule = make_schedule(cfg.variance_schedule, cfg.n_diffusion_steps, device=device)
    state = TrainState.create(model)
    if resume and model_dir and os.path.exists(os.path.join(model_dir, "train_state.msgpack")):
        load_train_state(model_dir, state)
        log(f"resumed from step {state.step}")
    forward = Bf16Forward(model) if cfg.bf16 else model
    generator = torch.Generator(device=device).manual_seed(seed)

    n_val = max(1, int(dataset.n_trajs * val_fraction)) if validate_every else 0
    val_batch = dataset.trajs_normalized[:n_val] if n_val else None
    stopper = EarlyStopper(patience=early_stop_patience) if early_stop_patience else None
    draw = StepDrawer(dataset, cfg, n_val, generator)
    chunk = chunk_size(num_train_steps,
                       (log_every, validate_every, summary_every, steps_til_checkpoint))

    losses, val_losses = [], []
    t0 = time.perf_counter()
    for i in range(chunk - 1, num_train_steps, chunk):
        loss = train_chunk(state, forward, schedule, cfg, draw, chunk)
        if (i + 1) % log_every == 0 or i + 1 == chunk:
            lv = float(loss)
            losses.append((i + 1, lv))
            log(f"step {i + 1}/{num_train_steps} loss {lv:.5f} "
                f"({time.perf_counter() - t0:.1f}s)")
        if validate_every and (i + 1) % validate_every == 0:
            vl = validation_loss(state, schedule, val_batch, dataset.train_mask, generator,
                                 cfg.n_diffusion_steps)
            val_losses.append((i + 1, vl))
            log(f"step {i + 1} val_loss {vl:.5f}")
            if stopper and stopper.early_stop(vl):
                log(f"early stopped at step {i + 1}")
                break
        if summary_every and (i + 1) % summary_every == 0 and model_dir:
            from mmd_torch.train.summary import summary_trajectory_generation

            stats = summary_trajectory_generation(
                state.ema, schedule, dataset, generator, step=i + 1,
                save_dir=os.path.join(model_dir, "summaries"))
            log(f"summary {stats}")
        if model_dir and steps_til_checkpoint and (i + 1) % steps_til_checkpoint == 0:
            save_checkpoint(model_dir, state, dataset, cfg, suffix=f"_step_{i + 1:07d}")

    if model_dir:
        save_checkpoint(model_dir, state, dataset, cfg)
        save_train_state(model_dir, state)
        # Loss-history dumps (trainer.py:43 save_losses_to_disk).
        np.save(os.path.join(model_dir, "train_losses.npy"), np.asarray(losses))
        if val_losses:
            np.save(os.path.join(model_dir, "val_losses.npy"), np.asarray(val_losses))
    return model, state, schedule, losses
