"""Profiling helpers, the twin of `mmd_tpu/utils/profiling.py`:

    with profiler_trace("build/trace"): # a torch.profiler Chrome trace
        planner()
    with compile_time_monitor() as acc: # seconds spent building kernels
        team.plan()
    with recording() as rec:            # the program's spans and counters
        planner.plan_fresh_batch(...)
    rec.spans, rec.counters

A recording keeps, in memory, the spans and counters that the program
marks where its work happens (`span`, `count`): the sampler call
(`sampler.call`), each UNet forward (`unet`), set-up (`kernels.load`,
`checkpoint.load`, `dataset.load`, `planner.init`) and the kernel
libraries nvcc built (`kernels.built`). A span is its name, start and end
in `time.perf_counter_ns()`, the index of the span open around it and the
id of the sampler call it belongs to (None outside a call). Nothing is
written out: the caller reads the recording once its block has ended.
With no recording open, `span()` checks one module global and returns a
shared no-op context manager, and `count()` returns at once: no clock is
read and nothing is allocated (on an H100 machine's host, 20-45 ns a
`span()` call and 180-380 ns an empty `with span(...)` block).

`perf_counter_ns` runs on the clock of `time.perf_counter()`, so a span's
times minus a `perf_counter()` reading taken just before a marker kernel
is launched on an idle card are on the device trace's clock from that
marker's start, to within the marker's launch latency: a few microseconds
on an H100 once the marker's kernel and the profiler have each launched
a kernel before, 0.3-0.5 ms more for the first of either.

`gpu_peak_flops` is the denominator of every MFU number the port reports:
the card's dense bfloat16 tensor-core peak (`tpu_peak_flops`'s twin).
JAX's `trace_region` has no twin: nothing in the port calls it, and
`utils.timer.TimerCuda` times a synchronized region.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch

_TRACE_IDS = itertools.count()
SAMPLER_CALL = "sampler.call"


class Span(NamedTuple):
    """One recorded span: its times in `perf_counter_ns`, the index in the
    recording of the span open around it (-1: none) and the id of the
    sampler call it belongs to (None outside a call)."""

    name: str
    start_ns: int
    end_ns: Optional[int]  # None while the span is open
    parent: int
    call: Optional[int]


class Recording:
    """The spans of one `recording()` block, in the order they opened, and
    its counters by name."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self._open = -1
        self._call: Optional[int] = None
        self._n_calls = 0

    def _span(self, name: str):
        # A sampler call inside another is that call: each has one span.
        if name == SAMPLER_CALL and self._call is not None:
            return _NO_SPAN
        return _OpenSpan(self, name)


class _OpenSpan:
    """A recorded span's context manager; it also enters
    `torch.profiler.record_function(name)`, so that a profiler's trace
    shows the span beside the kernels it launched."""

    __slots__ = ("rec", "name", "index", "outer", "annotation")

    def __init__(self, rec: Recording, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        if self.name == SAMPLER_CALL:
            rec._call = rec._n_calls
            rec._n_calls += 1
        self.index, self.outer = len(rec.spans), rec._open
        rec._open = self.index
        self.annotation = torch.profiler.record_function(self.name)
        self.annotation.__enter__()
        rec.spans.append(Span(self.name, time.perf_counter_ns(), None, self.outer, rec._call))
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        rec = self.rec
        self.annotation.__exit__(*exc)
        rec.spans[self.index] = rec.spans[self.index]._replace(end_ns=end)
        rec._open = self.outer
        if self.name == SAMPLER_CALL:
            rec._call = None
        return False


_NO_SPAN = contextlib.nullcontext()
_RECORDING: Optional[Recording] = None


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Record the program's spans and counters over the block (module
    docstring) and yield the `Recording`. Inside an open recording this
    yields that one and leaves it open."""
    global _RECORDING
    if _RECORDING is not None:
        yield _RECORDING
        return
    _RECORDING = rec = Recording()
    try:
        yield rec
    finally:
        _RECORDING = None


def span(name: str):
    """A context manager that records the span `name` over its block in
    the open recording; with none open, a shared no-op."""
    if _RECORDING is None:
        return _NO_SPAN
    return _RECORDING._span(name)


def count(name: str, n: int = 1) -> None:
    """Add n to the open recording's counter `name`; nothing without one."""
    rec = _RECORDING
    if rec is None:
        return
    rec.counters[name] = rec.counters.get(name, 0) + n


@contextlib.contextmanager
def profiler_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """`torch.profiler` over the block, CPU activity and, where a card is
    present, CUDA activity, written as a Chrome trace (viewable in Perfetto
    or chrome://tracing) into `log_dir`; yields the profile, whose
    `trace_path` names the file once the block has ended. A recording is
    open over the block (joining one already open), so the program's spans
    appear in the trace by name beside the kernels they launched."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.trace_path = os.path.join(log_dir, f"trace-{os.getpid()}-{next(_TRACE_IDS)}.json")
    with prof, recording():
        yield prof
    prof.export_chrome_trace(prof.trace_path)


@contextlib.contextmanager
def compile_time_monitor(out: Optional[dict] = None) -> Iterator[dict]:
    """Accumulate, as out["compile_s"], the seconds that `mmd_torch.ops.
    build` spends compiling kernels with nvcc inside the block: the port's
    only compile (it jit-compiles no program). A kernel library already
    built adds nothing. Planners leave these seconds out of their runtime
    limit, as the JAX package leaves XLA's compiles out."""
    from mmd_torch.ops import build

    acc = out if out is not None else {}
    acc.setdefault("compile_s", 0.0)

    def listener(seconds: float) -> None:
        acc["compile_s"] += seconds

    build.COMPILE_LISTENERS.append(listener)
    try:
        yield acc
    finally:
        build.COMPILE_LISTENERS.remove(listener)


# Dense (no sparsity) bfloat16 tensor-core peak FLOP/s by card name, from
# NVIDIA's public datasheets (the sparse figure halved). MFU numbers are
# quoted against it for float32 programs too, as the JAX package quotes its
# float32 programs against the TPU's bf16 peak: one denominator a card.
_GPU_PEAK_BF16 = {
    "H100 80GB HBM3": 989.4e12,  # H100 SXM5 (1979 TFLOP/s with sparsity)
}


def gpu_peak_flops(device=None) -> Optional[float]:
    """Dense bfloat16 peak FLOP/s of the CUDA `device` (default: the
    current card), or None for the CPU or a card this table lacks."""
    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device)
    for sub, peak in _GPU_PEAK_BF16.items():
        if sub in name:
            return peak
    return None
