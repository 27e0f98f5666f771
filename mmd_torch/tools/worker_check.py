"""A run function for `Launcher` that uses the card in its worker.

`lookup_on_card` builds (or loads) the kernels in the calling process,
launches `grid_sdf_lookup` once on random points of a map's grids and
holds it against the plain version: what a spawned pool worker must be
able to do after its parent has used CUDA. It lives at module level so
that a spawned worker can import it by name.
"""
from __future__ import annotations

import os
from typing import Dict


def lookup_on_card(seed: int = 0, results_dir: str = ".", env_name: str = "EnvConveyor2D",
                   n_points: int = 4096) -> Dict:
    """{"pid", "launches", "max_abs_err"} of one kernel launch in this
    process; raises if the kernel and the plain version differ."""
    import torch

    from mmd_torch.envs.envs import make_env
    from mmd_torch.ops.build import load_kernels
    from mmd_torch.ops.sdf_kernel import grid_lookup, grid_lookup_plain

    load_kernels()
    scene = make_env(env_name, "cuda").scene
    tables = [(scene.grid.values, scene.grid.grads),
              (scene.extra_grid.values, scene.extra_grid.grads)]
    box = (scene.grid.lower, scene.grid.upper)
    gen = torch.Generator().manual_seed(seed)
    pts = (torch.rand((n_points, 2), generator=gen) * 2.2 - 1.1).to("cuda")
    before = grid_lookup.launches
    got = grid_lookup(pts, tables, *box)
    launches = grid_lookup.launches - before
    want = grid_lookup_plain(pts, tables, *box)
    torch.cuda.synchronize()
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    if launches != 1 or not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise RuntimeError(f"worker {os.getpid()}: {launches} launches, max abs err {err}")
    return {"pid": os.getpid(), "launches": launches, "max_abs_err": err}
