"""Profiling helpers, the twin of `mmd_tpu/utils/profiling.py`:

    with profiler_trace("build/trace"): # a torch.profiler Chrome trace
        planner()
    with compile_time_monitor() as acc: # seconds spent building kernels
        team.plan()

`gpu_peak_flops` is the denominator of every MFU number the port reports:
the card's dense bfloat16 tensor-core peak (`tpu_peak_flops`'s twin).
JAX's `trace_region` has no twin: nothing in the port calls it, and
`utils.timer.TimerCuda` times a synchronized region.
"""
from __future__ import annotations

import contextlib
import itertools
import os
from typing import Iterator, Optional

import torch

_TRACE_IDS = itertools.count()


@contextlib.contextmanager
def profiler_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """`torch.profiler` over the block, CPU activity and, where a card is
    present, CUDA activity, written as a Chrome trace (viewable in Perfetto
    or chrome://tracing) into `log_dir`; yields the profile, whose
    `trace_path` names the file once the block has ended."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.trace_path = os.path.join(log_dir, f"trace-{os.getpid()}-{next(_TRACE_IDS)}.json")
    with prof:
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
