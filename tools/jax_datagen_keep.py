"""The JAX package's keep rates of data generation, on the CPU.

    JAX_PLATFORMS=cpu python tools/jax_datagen_keep.py

Runs `mmd_tpu.datagen.generate.generate_context_trajectories` (20
trajectories a context, H = 64, 300 GPMP2 iterations, the native RRT
where g++ builds it) for 2 contexts of EnvConveyor2D and of EnvHighways2D,
each map's contexts drawn from `np.random.default_rng(0)` in turn, as
`chip_smoke.py`'s datagen phase draws the port's. It prints one JSON line
per context: the map, the context's index, the free trajectories kept of
the 20 planned, the RRT used and the host seconds. The native RRT is built
with -march=native, so another CPU may round its paths otherwise.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--maps", nargs="+", default=["EnvConveyor2D", "EnvHighways2D"])
    ap.add_argument("--contexts", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    from mmd_tpu.datagen.generate import generate_context_trajectories
    from mmd_tpu.datagen.native_rrt import native_available

    for env_name in args.maps:
        rng = np.random.default_rng(args.seed)
        for i in range(args.contexts):
            t0 = time.perf_counter()
            trajs = generate_context_trajectories(env_name, rng, n_trajectories=20,
                                                  gpmp_opt_iters=300)
            print(json.dumps({"env": env_name, "context": i, "kept": int(len(trajs)),
                              "planned": 20, "native": native_available(),
                              "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
