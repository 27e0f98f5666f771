"""Conflict -> per-agent constraint conversion.

Twin of `mmd_tpu/common/conflict_conversion.py` (reference:
mmd/common/conflict_conversion.py:32-82): a PointConflict becomes one
MultiPointConstraint per involved agent, centered at the conflict's
midpoint, its t-range padded by t_pad steps on each side; a vertex or edge
conflict becomes the typed constraint of the same name.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from mmd_torch.common.conflicts import EdgeConflict, PointConflict, VertexConflict
from mmd_torch.common.constraints import EdgeConstraint, MultiPointConstraint, VertexConstraint
from mmd_torch.config import params as default_params


def convert_conflicts_to_constraints(conflict, t_pad: int = 2,
                                     radius: Optional[float] = None) -> Dict[int, object]:
    """{agent_id: constraint} for every agent in the conflict."""
    radius = radius if radius is not None else default_params.vertex_constraint_radius
    out = {}
    if isinstance(conflict, PointConflict):
        t0, t1 = conflict.get_t_range()
        for agent_id, q in zip(conflict.agent_ids, conflict.q_l):
            out[agent_id] = MultiPointConstraint(q_l=[np.asarray(q, np.float32)],
                                                 t_range_l=[(t0 - t_pad, t1 + t_pad)],
                                                 radius_l=[radius])
    elif isinstance(conflict, VertexConflict):
        for agent_id in conflict.agent_ids:
            out[agent_id] = VertexConstraint(q=conflict.q_map[agent_id], t=conflict.t)
    elif isinstance(conflict, EdgeConflict):
        for agent_id in conflict.agent_ids:
            out[agent_id] = EdgeConstraint(q_from=conflict.q_from_map[agent_id],
                                           q_to=conflict.q_to_map[agent_id],
                                           t_from=conflict.t_from, t_to=conflict.t_to)
    else:
        raise TypeError(type(conflict))
    return out
