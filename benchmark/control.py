"""Readings of a cell's compared numbers over several seeds, for setting
their limits: the program as the configuration states it (float32), or
with --control its bfloat16 UNet, the precision below the configuration's
and the program's own lower-precision path. The benchmark's runs never run
the control.

    python -m benchmark.control --workload <name> --seeds 11 12 13 --seconds 5 [--control]

Prints one JSON line a seed: the seed, whether the run came out correct
under the limits in the traffic file, and each compared number.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark.harness.common import cell


def readings(workload: str, seeds, seconds: float, control: bool):
    """[(seed, correct, {name: reading}, end-to-end values, attempted,
    failed)], one a seed, each a run of its own on the card."""
    from benchmark.run import runner

    c = cell(workload)
    run = runner(c["traffic"]["kind"])
    out = []
    for seed in seeds:
        r = run(c, seed, seconds, False, bf16=control, t_start=time.perf_counter())
        vals = {k: v for k, (v, _) in r["checks"].items()}
        ok = all(v <= lim for v, lim in r["checks"].values())
        out.append((seed, ok, vals, r["e2e"], r["attempted"], r["failed"]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("benchmark.control: needs a CUDA card", file=sys.stderr)
        return 1
    for seed, ok, vals, e2e, attempted, failed in readings(args.workload, args.seeds,
                                                           args.seconds, args.control):
        print(json.dumps({"seed": seed, "control": args.control, "correct": ok,
                          "readings": vals, "e2e": e2e, "attempted": attempted,
                          "failed": failed}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
