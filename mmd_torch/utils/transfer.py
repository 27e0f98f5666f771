"""Host arrays to the device without waiting for it.

`torch.as_tensor(array, device="cuda")` copies from pageable host memory,
and that copy waits for the card to finish its queue: in a planner loop the
host then stalls once per copy. `to_device` stages the array in pinned
memory and copies it on the current stream without a wait; the caching
host allocator keeps the staging buffer until the copy has run.
"""
from __future__ import annotations

import numpy as np
import torch


def to_device(array, device, dtype=None) -> torch.Tensor:
    """`array` (numpy, a list or a number) as a tensor on `device`."""
    t = torch.as_tensor(np.asarray(array), dtype=dtype)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
