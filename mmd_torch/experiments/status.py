"""Trial success status enum.

Twin of `mmd_tpu/experiments/status.py` (reference:
mmd/common/experiments/experiments.py:168-177): truthy iff SUCCESS.
"""
from __future__ import annotations

import enum


class TrialSuccessStatus(enum.Enum):
    UNKNOWN = -1
    SUCCESS = 0
    FAIL_RUNTIME_LIMIT = 1
    FAIL_COLLISION_AGENTS = 2
    FAIL_NO_SOLUTION = 3

    def __bool__(self) -> bool:
        return self == TrialSuccessStatus.SUCCESS

    def __str__(self) -> str:
        return self.name
