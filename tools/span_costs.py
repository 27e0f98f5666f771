"""What the program's span recorder costs, how its clock lines up with the
device trace's, and what its spans read beside the trace, on one CUDA card:

    python3 tools/span_costs.py --seed 1 --seconds 20 --pairs 3 --out span_costs.json

from the root of a checkout. It runs the benchmark's `mpd-conveyor2d.batch100`
cell in process (`benchmark.kinds.batch.run`) and prints one JSON object:

- `span_off_ns`: host ns of `span()` with no recording open, and of an
  empty `with span(...)` block, each over a million calls;
- `clock`: one traced run, the process's first, its set-up timed from the
  process's start as `benchmark.run` times it, with the program's
  recording open from the run's start until the trace closes; for each
  traced UNet forward, the device start of the opening marker the
  benchmark puts before it minus the host start of its `unet` span, both
  on the trace window's clock (seconds); the run's `setup_s`, its
  per-layer metrics, and the spans' readings (`tools/span_split.py`: the
  idle time by the work the card waited for, set-up by span); with --out,
  also the device's busy intervals, the brackets and the spans on the
  window's clock;
- `pairs`: `plans_per_s` of untraced runs with a recording open and
  closed (no profiler), in alternating order, one seed a pair.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from unittest import mock  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CELL = "mpd-conveyor2d.batch100"


def off_cost(n: int = 1_000_000) -> dict:
    from mmd_torch.utils.profiling import span

    t = time.perf_counter_ns()
    for _ in range(n):
        span("unet")
    call = (time.perf_counter_ns() - t) / n
    t = time.perf_counter_ns()
    for _ in range(n):
        with span("unet"):
            pass
    block = (time.perf_counter_ns() - t) / n
    t = time.perf_counter_ns()
    for _ in range(n):
        pass
    loop = (time.perf_counter_ns() - t) / n
    return {"call": call - loop, "with_block": block - loop, "loop": loop}


def traced_run(c: dict, seed: int, seconds: float):
    """One traced run of the cell with the program's recording open from
    its start until the trace closes: the run's result and what
    `span_split` reads (the trace summary, the spans, the counters, `t0`).

    The window's `t0` is the clock's anchor, so the marker kernel's first
    launch in the process (its module loads, ~0.5 ms on an H100) and the
    profiler's first recorded launch (~0.1 ms more than later ones) are
    paid before it, lest they delay the window's marker."""
    import torch

    from benchmark.harness import trace
    from benchmark.kinds.batch import run
    from mmd_torch.utils.profiling import recording

    held = contextlib.ExitStack()
    windows = []

    class Window(trace.Traced):
        def __init__(self, model=None):
            trace.marker()
            torch.cuda.synchronize()
            super().__init__(model)
            windows.append(self)

        def open(self):
            torch.zeros(1, device="cuda")
            torch.cuda.synchronize()
            super().open()

        def close(self):
            super().close()
            held.close()

    with held, mock.patch.object(trace, "Traced", Window):
        rec = held.enter_context(recording())
        out = run(c, seed, seconds, True, t_start=T_START)
    ctx = {"trace": out["layer"]["trace"], "t0": windows[0].t0,
           "spans": [tuple(s) for s in rec.spans], "counters": dict(rec.counters)}
    return out, ctx


def clock(c: dict, seed: int, seconds: float) -> dict:
    import torch

    from benchmark.run import reader
    from tools import span_split

    out, ctx = traced_run(c, seed, seconds)
    layer = out["layer"]
    brackets = ctx["trace"]["brackets"]
    unet = sorted(s for s in span_split.window_spans(ctx, "unet") if s[0] >= 0.0)
    lead = [b[0] - u[0] for b, u in zip(brackets, unet)]
    layer["device_name"] = torch.cuda.get_device_name(0)
    metrics = {m["name"]: reader(m["name"])(m["name"], layer) for m in c["per_layer"]}
    raw = {"busy": ctx["trace"]["spans"], "brackets": brackets,
           "window_s": ctx["trace"]["window_s"],
           "spans": [(n, s * 1e-9 - ctx["t0"], e * 1e-9 - ctx["t0"], p, k)
                     for n, s, e, p, k in ctx["spans"] if e is not None]}
    return {"forwards": len(unet), "brackets": len(brackets), "lead_s": lead, "raw": raw,
            "lead_min_s": min(lead), "lead_first_s": lead[0], "lead_max_s": max(lead),
            "setup_s": out["e2e"]["setup_s"], "metrics": metrics,
            "spans": span_split.readings(ctx)}


def pairs(c: dict, seed: int, seconds: float, n: int) -> list:
    from benchmark.kinds.batch import run
    from mmd_torch.utils.profiling import recording

    rows = []
    for k in range(n):
        row = {"seed": seed + k}
        for on in ((False, True) if k % 2 == 0 else (True, False)):
            with recording() if on else contextlib.nullcontext():
                out = run(c, seed + k, seconds, False)
            row["open" if on else "closed"] = out["e2e"]["plans_per_s"]
        rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    from benchmark.harness.common import card_limit, cell

    if not torch.cuda.is_available():
        print("span_costs: needs a CUDA card", file=sys.stderr)
        return 1
    c = cell(CELL)
    res = {"device": card_limit(), "clock": clock(c, args.seed, args.seconds),
           "span_off_ns": off_cost(),
           "pairs": pairs(c, args.seed + 1, args.seconds, args.pairs)}
    text = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    short = dict(res, clock={k: v for k, v in res["clock"].items() if k not in ("lead_s", "raw")})
    print(json.dumps(short))
    return 0


if __name__ == "__main__":
    sys.exit(main())
