"""Experience records for XCBS warm starts.

Twin of `mmd_tpu/common/experiences.py` (reference:
mmd/common/experiences.py:34-51): a PathBatchExperience carries the
(B, H, D) batch of an earlier plan, which local inference noises a few
steps and denoises again under new constraints.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class PathBatchExperience:
    path_b: torch.Tensor  # (B, H, D), unnormalized, on the planner's device
