"""Start/goal layouts for multi-robot problems.

Twin of `get_start_goal_pos_circle` in `mmd_tpu/common/multi_agent_utils.py`
(reference: mmd/common/multi_agent_utils.py:146-155).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def get_start_goal_pos_circle(num_agents: int, radius: float = 0.8
                              ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Antipodal points on a circle: agent i starts at angle 2 pi i / n and
    goes to the opposite point."""
    starts, goals = [], []
    for i in range(num_agents):
        a = 2 * np.pi * i / num_agents
        starts.append(np.array([radius * np.cos(a), radius * np.sin(a)], np.float32))
        goals.append(np.array([radius * np.cos(a + np.pi), radius * np.sin(a + np.pi)],
                              np.float32))
    return starts, goals
