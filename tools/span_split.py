"""The program's spans read beside the benchmark's device trace: the card's
idle time split by the work it waited for, and set-up split by span.

`tools/span_costs.py` makes the readings from a traced run of the
benchmark's batch cell with the program's recording open
(`mmd_torch.utils.profiling.recording`). What they read is one dict:

- `trace`: the benchmark's trace summary (`benchmark.harness.trace`):
  `window_s`, the merged device `spans` and the forwards' `brackets`, on
  the window's clock (0 at the window marker's start);
- `spans`: the recording's spans, (name, start ns, end ns, parent index,
  sampler call id) on the host's `perf_counter_ns` clock, the clock of
  `time.perf_counter()`;
- `t0`: the trace window's `t0`, a `perf_counter()` reading taken just
  before the window's marker kernel is launched on an idle card, so that
  a span's times minus `t0` are on the device trace's clock, to within the
  marker's launch latency;
- `counters`: the recording's counters.

`idle_split` gives each idle instant of the traced window to the span
whose work the card was waiting for: a UNet forward (`unet`), the rest of
a sampler call (`sampler.call`), or no program span (the caller). The
three parts sum to the window's idle time. The host runs ahead of the
card (by up to ~50 ms at the end of a batch100 call), and the card idles
a few microseconds between kernels it already holds, so the host's span
at an idle instant is the work waited for only where the host has not
run ahead. Hence, with the benchmark's brackets around each forward
(`trace.Bracket`, the k-th bracket the k-th `unet` span of the window):

- an instant inside a bracket goes to `unet`: the card waits for that
  forward's next kernel, whether the host is still launching it or not;
- an instant between brackets, after the host has opened the next
  forward's span, goes to the sampler call: the card waits on the
  sampler's queued work between forwards;
- any other instant goes to the host's innermost span: the card waits
  on the host there.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from benchmark.harness.trace import merge

UNET, CALL = "unet", "sampler.call"
LOADS = ("checkpoint.load", "dataset.load", "planner.init")
Intervals = List[Tuple[float, float]]


def window_spans(ctx: Dict, name: Optional[str] = None) -> Intervals:
    """The closed spans called `name` (every span if None), in seconds on
    the window's clock."""
    t0 = ctx["t0"]
    return [(s * 1e-9 - t0, e * 1e-9 - t0) for n, s, e, _, _ in ctx["spans"]
            if name in (None, n) and e is not None]


def idle(busy: Intervals, lo: float, hi: float) -> Intervals:
    """The gaps of [lo, hi] between the merged busy intervals."""
    out, t = [], lo
    for s, e in merge(busy):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


def intersect(a: Intervals, b: Intervals) -> Intervals:
    """The intersection of two lists of sorted disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def length(x: Iterable[Tuple[float, float]]) -> float:
    return sum(e - s for s, e in x)


def subtract(a: Intervals, b: Intervals) -> Intervals:
    """a less b, both lists of sorted disjoint intervals."""
    out, j = [], 0
    for lo, hi in a:
        while j < len(b) and b[j][1] <= lo:
            j += 1
        k = j
        while k < len(b) and b[k][0] < hi:
            if b[k][0] > lo:
                out.append((lo, b[k][0]))
            lo = max(lo, b[k][1])
            k += 1
        if hi > lo:
            out.append((lo, hi))
    return out


def idle_split(ctx: Dict) -> Optional[Dict[str, float]]:
    """Idle seconds of the traced window by the span whose work the card
    waited for (module docstring): "unet", "sampler" (a sampler call
    outside a forward) or "caller" (no span). None without a trace, or
    unless its brackets pair one to one with the window's `unet` spans."""
    t = ctx.get("trace")
    if not t or t.get("window_s", 0) <= 0 or ctx.get("spans") is None or ctx.get("t0") is None:
        return None
    w = t["window_s"]
    unet = sorted(s for s in window_spans(ctx, UNET) if 0.0 <= s[0] <= w)
    brackets = sorted(t.get("brackets") or [])
    if not unet or len(unet) != len(brackets):
        return None
    gaps = idle(t["spans"], 0.0, w)
    inside = merge(brackets)
    between = subtract(gaps, inside)
    ahead = merge([(u[0], b[0]) for u, b in zip(unet, brackets) if b[0] > u[0]])
    waiting = subtract(between, ahead)          # the card waits on the host
    host_unet = merge(window_spans(ctx, UNET))
    host_call = merge(window_spans(ctx, CALL))
    host_any = merge(window_spans(ctx))
    return {"unet": length(intersect(gaps, inside)) + length(intersect(waiting, host_unet)),
            "sampler": length(intersect(between, ahead))
            + length(subtract(intersect(waiting, host_call), host_unet)),
            "caller": length(subtract(waiting, host_any))}


def setup_s(ctx: Dict, names: Tuple[str, ...]) -> Optional[float]:
    """Seconds of the spans called one of `names` that ended before the
    window opened (set-up); None where there are none."""
    if ctx.get("spans") is None or ctx.get("t0") is None:
        return None
    t0_ns = ctx["t0"] * 1e9
    found = [e - s for n, s, e, _, _ in ctx["spans"]
             if n in names and e is not None and e <= t0_ns]
    return 1e-9 * sum(found) if found else None


def first_call_s(ctx: Dict) -> Optional[float]:
    """Host seconds of the recording's first sampler call."""
    calls = [(s, e) for n, s, e, _, _ in ctx.get("spans") or () if n == CALL and e is not None]
    if not calls:
        return None
    s, e = min(calls)
    return 1e-9 * (e - s)


def readings(ctx: Dict) -> Dict[str, Optional[float]]:
    """Every reading of one traced run, None where there is nothing to
    read: the idle parts in percent of the traced window, set-up seconds
    by span, the first sampler call's seconds and the libraries built."""
    split = idle_split(ctx)
    w = (ctx.get("trace") or {}).get("window_s")
    counters = ctx.get("counters")
    out = {f"idle_{part}_pct": None if split is None else 100.0 * split[part] / w
           for part in ("unet", "sampler", "caller")}
    out.update(setup_kernels_s=setup_s(ctx, ("kernels.load",)), setup_load_s=setup_s(ctx, LOADS),
               setup_first_call_s=first_call_s(ctx),
               kernel_builds=None if counters is None else counters.get("kernels.built", 0))
    return out
