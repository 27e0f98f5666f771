"""Reading the device from torch.profiler's CUDA activity.

The traced window runs under `Traced`: the profiler records the device's
activity alone (kernels, copies, sets), so a window of many thousands of
launches stays cheap to record and to read. Markers tie the device's
timeline to the host's:

- one marker kernel right after the window opens, with the card idle, so
  that its start is the window's start on the device's clock;
- given the model, a marker before and after each UNet forward
  (`Bracket`), so that the kernels between a pair are that forward's.

A marker is `torch.cuda._sleep(0)`, PyTorch's spin kernel, which nothing
else on the timed path launches. `summarize` turns the events into what the
per-layer readers read: the merged busy intervals, kernels by name and the
forwards' device seconds; `idle_gaps` labels each idle gap by what the
host was in (a UNet forward, or the rest of the call).
"""
from __future__ import annotations

import bisect
import time
from typing import Dict, List, Tuple

import torch

MARKER = "spin_kernel"
NOT_KERNELS = ("Memcpy", "Memset", "memcpy", "memset")


def marker():
    torch.cuda._sleep(0)


class Bracket:
    """Forward hooks that put a marker kernel around each forward."""

    def __init__(self, model):
        self.handles = [model.register_forward_pre_hook(lambda m, a: marker()),
                        model.register_forward_hook(lambda m, a, o: marker())]

    def remove(self):
        for h in self.handles:
            h.remove()


class Traced:
    """The device trace of a window: `Traced(model)` starts the profiler
    (its start-up is set-up, not window), `open()` marks the window's
    start, `close()` ends it; `summary()` afterwards. The window should
    start and end with the card idle (open and close synchronize)."""

    def __init__(self, model=None):
        from torch.profiler import ProfilerActivity, profile

        self.model = model
        self.bracket = None
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()

    def open(self):
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        marker()
        if self.model is not None:
            self.bracket = Bracket(self.model)

    def close(self):
        if self.bracket is not None:
            self.bracket.remove()
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)

    def events(self) -> List[Tuple[str, float, float]]:
        """(name, start s, end s) of every device event, on the window's
        clock (0 at the window marker's start), in start order."""
        dev = [(e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
               for e in self.prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        dev.sort(key=lambda e: e[1])
        first = next((s for n, s, _ in dev if MARKER in n), None)
        if first is None:
            return []
        return [(n, s - first, e - first) for n, s, e in dev if s >= first]

    def summary(self) -> Dict:
        return summarize(self.events(), self.window_s, self.model is not None)


def merge(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of [start, end) intervals, as sorted disjoint intervals."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def busy_s(spans: List[Tuple[float, float]], lo: float = float("-inf"),
           hi: float = float("inf")) -> float:
    """Seconds of [lo, hi] covered by the union of the spans."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in merge(spans))


def summarize(events: List[Tuple[str, float, float]], window_s: float,
              bracketed: bool) -> Dict:
    """What the readers take from one process's traced window: the merged
    device spans (markers left out), the kernel count, [seconds, count] by
    name, each bracketed forward's kernel seconds and the brackets' spans."""
    spans, by_name, forwards, brackets = [], {}, [], []
    n_kernels, inside, acc, opened, markers = 0, False, 0.0, 0.0, 0
    for name, s, e in events:
        if MARKER in name:
            markers += 1
            if markers == 1 or not bracketed:
                continue
            if not inside:
                inside, acc, opened = True, 0.0, s
            else:
                inside = False
                forwards.append(acc)
                brackets.append((opened, e))
            continue
        spans.append((s, e))
        tot = by_name.setdefault(name, [0.0, 0])
        tot[0] += e - s
        tot[1] += 1
        if not any(t in name for t in NOT_KERNELS):
            n_kernels += 1
        if inside:
            acc += e - s
    return {"window_s": window_s, "spans": merge(spans), "kernels": n_kernels,
            "by_name": by_name, "forward_s": forwards, "brackets": brackets}


def breakdown(by_name: Dict[str, list], gaps: List[list]) -> Dict:
    """The ten device operations that took most time; the idle seconds by
    the host's span, then the longest single gaps, ten entries in all."""
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    totals: Dict[str, float] = {}
    for label, sec in gaps:
        totals[label] = totals.get(label, 0.0) + sec
    summed = [[f"all gaps in: {k}", v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])]
    longest = sorted(gaps, key=lambda g: -g[1])[:10 - len(summed)]
    return {"device_ops": [[n[:120], v[0]] for n, v in ops], "idle_gaps": summed + longest}


def idle_gaps(spans: List[Tuple[float, float]], brackets: List[Tuple[float, float]],
              lo: float, hi: float, outside: str) -> List[list]:
    """The idle gaps of [lo, hi] between the spans, each labelled by the
    host's span it fell in: a UNet forward, or `outside`."""
    starts = [a for a, _ in brackets]
    gaps, t = [], lo
    for s, e in merge(spans) + [(hi, hi)]:
        if s > t:
            mid = 0.5 * (t + min(s, hi))
            k = bisect.bisect_right(starts, mid) - 1
            in_fwd = k >= 0 and brackets[k][1] >= mid
            gaps.append(["unet forward (host launches)" if in_fwd else outside,
                         min(s, hi) - t])
        t = max(t, e)
        if t >= hi:
            break
    return gaps
