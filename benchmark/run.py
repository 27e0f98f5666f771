"""Run one cell of the benchmark once and print its result line.

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is an entry of `workloads` in
BENCHMARK.json: a configuration (`benchmark/configs/<name>.json`) under a
traffic mix (`benchmark/traffic/<name>.json`), whose `kind` names the
general runner of its kind, `benchmark/kinds/<kind>.py`. With --trace 0
the line's metrics are the cell's end-to-end metrics; with --trace 1 its
per-layer metrics, each read by `benchmark/metrics/<name>.py` (or the
reader of the part of the name before its first dot), which returns
nothing where it finds nothing to read.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device (and breakdown with --trace 1), and last the
numbers compared with the reference, each beside its limit, under
`checks`; the same numbers are the last lines on standard error. The run
exits 1 and prints no result without a CUDA card, with fewer cards than
the cell asks for, or if JAX or the JAX package is loaded once the window
has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Dict, Optional  # noqa: E402

from benchmark.harness.common import (BENCH_DIR, card_limit, cell,  # noqa: E402
                                      forbidden_loaded, load)


def reader(name: str):
    """The per-layer metric's reader: metrics/<name>.py, else the file of
    the name's part before its first dot."""
    for stem in (name, name.split(".")[0]):
        if os.path.isfile(os.path.join(BENCH_DIR, "metrics", stem + ".py")):
            return load("metrics", stem).read
    raise FileNotFoundError(f"no reader for the per-layer metric {name!r}")


def runner(kind: str):
    """The traffic kind's runner: `run` of benchmark/kinds/<kind>.py."""
    return load("kinds", kind).run


def metrics(c: Dict, out: Dict, traced: bool) -> Dict:
    if not traced:
        return {m["name"]: {"value": out["e2e"][m["name"]], "unit": m["unit"]}
                for m in c["end_to_end"]}
    found = {}
    for m in c["per_layer"]:
        v = reader(m["name"])(m["name"], out["layer"])
        if v is not None:
            found[m["name"]] = {"value": v, "unit": m["unit"]}
    return found


def _finite(v: float) -> Optional[float]:
    """A number JSON can hold: None for a reading that never came (inf)."""
    return v if math.isfinite(v) else None


def result_line(c: Dict, out: Dict, traced: bool, device: Dict) -> Dict:
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics(c, out, traced), "device": device}
    if traced:
        line["breakdown"] = out["breakdown"]
    line["checks"] = {k: {"value": _finite(v), "limit": lim}
                      for k, (v, lim) in out["checks"].items()}
    return line


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    c = cell(args.workload)
    chips = c["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark.run: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    traced = bool(args.trace)
    out = runner(c["traffic"]["kind"])(c, args.seed, args.seconds, traced,
                                       t_start=T_START)
    bad = forbidden_loaded()
    if bad:
        print(f"benchmark.run: JAX or the JAX package is loaded: {bad}",
              file=sys.stderr)
        return 1
    out["correct"] = all(v <= lim for v, lim in out["checks"].values())
    out["layer"]["device_name"] = torch.cuda.get_device_name(0)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": out["memory_peak_bytes"], "power": card_limit()}
    if traced:
        device["busy_s"] = out["busy_s"]
        device["window_s"] = out["traced_window_s"]
    line = result_line(c, out, traced, device)
    print(f"memory: peak {out['memory_peak_bytes']} B; a call's before the checked "
          f"calls' recordings {out.get('call_peak_bytes')} B", file=sys.stderr)
    for k, (v, lim) in out["checks"].items():
        print(f"check {k}: {v!r} (limit {lim!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
