"""Faults planted in the program underneath a run, for the tests that see
`correct` come out false. `patch` sets the attribute: pytest's
monkeypatch.setattr, so that the fault is undone after the test."""
from __future__ import annotations

import dataclasses

import torch


def stuck_step(patch):
    """Each diffusion step runs (its UNet forward included) and returns
    the state it was given."""
    from mmd_torch.models import diffusion

    step = diffusion._ddpm_step

    def stuck(model, schedule, x, *args, **kwargs):
        step(model, schedule, x, *args, **kwargs)
        return x

    patch(diffusion, "_ddpm_step", stuck)


def half_batch(patch):
    """The UNet computes the first half of its rows and gives the rest the
    mean of that half's outputs."""
    from mmd_torch.models.temporal_unet import TemporalUnet

    forward = TemporalUnet.forward

    def half(self, x, time, context=None):
        n = max(1, x.shape[0] // 2)
        out = forward(self, x[:n], time[:n])
        rest = out.mean(dim=0, keepdim=True).expand(x.shape[0] - n, *out.shape[1:])
        return torch.cat([out, rest])

    patch(TemporalUnet, "forward", half)


def altered_choice(patch):
    """A batched call's best index moved to the next sample."""
    from mmd_torch.planners.single_agent.mpd import MPD

    plan = MPD.plan_fresh_batch

    def altered(self, *args, **kwargs):
        res = plan(self, *args, **kwargs)
        return dataclasses.replace(res, idx_best=(res.idx_best + 1) % res.free_mask.shape[-1])

    patch(MPD, "plan_fresh_batch", altered)
