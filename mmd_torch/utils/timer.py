"""Device-accurate timing, the twin of `mmd_tpu/utils/timer.py` (reference:
torch_robotics torch_utils/torch_timer.py:7-109, TimerCUDA).

CUDA launches are asynchronous: the timer synchronizes the card on entry
(optional) and on exit, around `time.perf_counter()`, so that the interval
covers all device work queued inside the block. The device is explicit; a
CPU device needs no synchronize. `mmd_torch.bench` and
`tools.train_bench` time their measured regions with it. JAX's `block`
(`block_until_ready` over a tree) has no twin: nothing in the port calls it.
"""
from __future__ import annotations

import time

import torch


def synchronize(device) -> None:
    """Wait for `device`'s queued work; nothing to wait for on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class TimerCuda:
    """Context manager: `with TimerCuda() as t: ...; t.elapsed` (seconds)."""

    def __init__(self, sync_on_enter: bool = True, device="cuda"):
        self.sync_on_enter = sync_on_enter
        self.device = torch.device(device)
        self.elapsed = 0.0

    def __enter__(self):
        if self.sync_on_enter:
            synchronize(self.device)
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        synchronize(self.device)
        self.elapsed = time.perf_counter() - self._start
        return False

