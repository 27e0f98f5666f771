"""Box SDF primitives as functions of torch tensors.

Twin of `mmd_tpu/envs/primitives.py` for the fields the five maps use.
Conventions (reference: torch_robotics/environments/primitives.py):
- box:    max_d(|x - c|_d - h_d), min boxes (primitives.py:223-226)
`amax`/`amin` and `torch.minimum` split the gradient evenly on ties, as
JAX's `max`/`min` reductions and `jnp.minimum` do, so gradient grids built
by autograd agree with the JAX-built ones on tie lines.
"""
from __future__ import annotations

import dataclasses

import torch

BIG = 1e6  # SDF of "no objects"


@dataclasses.dataclass(frozen=True)
class BoxField:
    centers: torch.Tensor     # (n, dim)
    half_sizes: torch.Tensor  # (n, dim)

    def sdf(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., dim) -> (...,) min over boxes (max-coordinate box SDF)."""
        if self.centers.shape[0] == 0:
            return torch.full(x.shape[:-1], BIG, dtype=x.dtype, device=x.device)
        d = torch.abs(x[..., None, :] - self.centers) - self.half_sizes
        return d.amax(dim=-1).amin(dim=-1)


def union_sdf(fields, x: torch.Tensor) -> torch.Tensor:
    """min over a list of primitive fields (env_base.py:152-168)."""
    if not fields:
        return torch.full(x.shape[:-1], BIG, dtype=x.dtype, device=x.device)
    out = fields[0].sdf(x)
    for f in fields[1:]:
        out = torch.minimum(out, f.sdf(x))
    return out
