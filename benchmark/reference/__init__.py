"""The benchmark's plain float32 reference of what the timed path computes.

Written in plain PyTorch and NumPy, independent of the program: it imports
nothing of `mmd_torch` and takes nothing that the program has made. It
reads the same raw files (the flax checkpoint, its `args.yaml`) and works
out again what the program derives from them: the UNet's parameters, the
diffusion schedule, the normalizer, the map's SDF grid and the
Savitzky-Golay matrix. Its pieces:

- `checkpoint`: a frozen msgpack reader and the checkpoint's settings;
- `unet`: the TemporalUnet forward (Janner et al.'s temporal UNet as the
  MMD checkpoints hold it) over the flax parameter tree;
- `scene`: the map's SDF grid from its boxes and the floor-cell lookup;
- `sampler`: the DDPM posterior step and the guide's 20 iterations;
- `finalize`: classification, scores, the best free trajectory and the
  smoothing of a finished sampler call.

Every function computes in float32 with TF32 off (`no_tf32`), on the
device of its inputs.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def no_tf32():
    """Float32 matmuls and convolutions in float32, not TF32, inside the
    block; the previous settings are restored after it."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
