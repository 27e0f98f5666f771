"""Micro-benchmark: the grid-SDF lookup kernel against its plain version.

Twin of `scripts/bench_kernels.py`. On EnvConveyor2D's grids, at 4096 and
65536 points uniform in [-1, 1]^2 (numpy seed 0), it times the CUDA kernel
(`grid_lookup_cuda`) and its plain torch version (`grid_lookup_plain`),
each with CUDA events over 50 calls after a warm-up, and prints
whether the two agree exactly:

    python -m mmd_torch.tools.bench_kernels

A machine without a CUDA card exits 2.
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Sequence

import numpy as np
import torch

SIZES = (4096, 65536)


def _ms(fn, n_iter: int) -> float:
    for _ in range(5):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n_iter):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_iter


def bench(sizes: Sequence[int] = SIZES, n_iter: int = 50, seed: int = 0) -> List[Dict]:
    """One row per size: points, the kernel's and the plain version's us a
    call, and whether their values and gradients are equal."""
    from mmd_torch.envs.envs import make_env
    from mmd_torch.ops.sdf_kernel import grid_lookup_cuda, grid_lookup_plain

    scene = make_env("EnvConveyor2D", "cuda").scene
    tables = ((scene.grid.values, scene.grid.grads),
              (scene.extra_grid.values, scene.extra_grid.grads))
    box = (scene.grid.lower, scene.grid.upper)
    rng = np.random.default_rng(seed)
    rows = []
    for n in sizes:
        pts = torch.from_numpy(rng.uniform(-1, 1, (n, 2)).astype(np.float32)).cuda()
        kernel = grid_lookup_cuda(pts, tables, *box)
        plain = grid_lookup_plain(pts, tables, *box)
        match = all(torch.equal(a, b) for a, b in zip(kernel, plain))
        rows.append({"points": n,
                     "kernel_us": 1e3 * _ms(lambda: grid_lookup_cuda(pts, tables, *box), n_iter),
                     "plain_us": 1e3 * _ms(lambda: grid_lookup_plain(pts, tables, *box), n_iter),
                     "match": match})
    return rows


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_kernels: no CUDA device; this benchmark needs one NVIDIA card",
              file=sys.stderr)
        return 2
    from mmd_torch.ops.build import load_kernels

    load_kernels()
    print(f"card: {torch.cuda.get_device_name(0)}")
    for row in bench():
        print(f"n={row['points']}: plain {row['plain_us']:.1f}us  "
              f"kernel {row['kernel_us']:.1f}us  match={row['match']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
