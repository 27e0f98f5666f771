"""Traffic kind `batch`: one caller in a closed loop, each call one
`MPD.plan_fresh_batch` of `problems_per_call` independent single-robot
problems on the configuration's map.

Set-up loads the checkpoint through the program, builds its kernels,
draws every call's problems from the seed with the traffic's generator
(`benchmark/problems/<problems>.py`; a pool of `max_calls_per_s` x seconds
distinct calls, which a longer window reuses in order) and runs one
warm-up call of the same shapes. The window then calls back to back until
its seconds have passed; the call in progress finishes. Each call's
sampler draws are made on the device as the call starts, from a generator
seeded derive(seed, "noise", call), so that the card holds no more than
the call in flight; each call ends with the host reading its answer (each
problem's best trajectory and whether it is free). A plan is one
problem's samples, finalized; one with no free sample counts as failed.

With --trace 1 the first `trace_calls` calls of the window run under the
device trace, a marker around each UNet forward. The checked calls,
`check_calls` of them drawn from the seed among the first
`check_within_calls` after the traced ones, record their UNet forwards;
after the window the reference follows them step by step
(`harness.checks`), from the same draws made again from their seeds.
"""
from __future__ import annotations

import math
import time
from typing import Dict, Optional

import numpy as np
import torch

from benchmark.harness import checks, counts, program, trace
from benchmark.harness.common import derive, load, program_paths


class Recorder:
    """A forward hook that keeps each forward's (input, step, output) while
    `active`."""

    def __init__(self, model):
        self.active = False
        self.rows = []
        self.handle = model.register_forward_hook(self._hook)

    def _hook(self, module, args, out):
        if self.active:
            self.rows.append((args[0].detach().clone(), args[1].detach().clone(),
                              out.detach().clone()))

    def take(self):
        rows, self.rows = self.rows, []
        return rows


def run(cell: Dict, seed: int, seconds: float, traced: bool, device: str = "cuda",
        bf16: bool = False, t_start: Optional[float] = None) -> Dict:
    """One run of the cell: its result before printing (`benchmark.run`).
    `bf16` runs the program's bfloat16 UNet, the control (`benchmark.control`)."""
    t_start = time.perf_counter() if t_start is None else t_start
    from mmd_torch.costs.constraints import empty_constraint_set
    from mmd_torch.costs.guide import GuideData
    from mmd_torch.models.diffusion import SamplerNoise

    cfg, tr = cell["config"], cell["traffic"]
    dev = torch.device(device)
    N, B, H, D = tr["problems_per_call"], cfg["n_samples"], cfg["horizon"], cfg["state_dim"]
    n_steps = cfg["n_diffusion_steps"] + cfg["n_diffusion_steps_without_noise"]
    pool = max(1, math.ceil(seconds * tr["max_calls_per_s"]))
    rng = np.random.default_rng(derive(seed, "problems"))
    starts, goals = load("problems", tr["problems"]).draw(rng, (pool + 1) * N, cfg, tr)
    starts, goals = starts.reshape(pool + 1, N, 2), goals.reshape(pool + 1, N, 2)
    paths = program_paths(cfg)
    planner = program.planner(cfg, program.load(cfg, device), starts[0, 0], goals[0, 0],
                              derive(seed, "planner"), bf16)
    norm = planner.dataset.normalizer
    gd = GuideData(scene=planner.scene, normalizer=norm,
                   constraints=empty_constraint_set(1, 1, device=device), soft_paths=None)

    # Every call's hard conditions: the problems' starts and goals at zero
    # velocity, normalized by the program's normalizer.
    st = torch.as_tensor(starts, device=dev)
    go = torch.as_tensor(goals, device=dev)
    zeros = torch.zeros_like(st)
    hard = torch.zeros((pool + 1, N, H, D), device=dev)
    hard[:, :, 0] = norm.normalize(torch.cat([st, zeros], -1))
    hard[:, :, H - 1] = norm.normalize(torch.cat([go, zeros], -1))
    rows = torch.arange(N, device=dev)

    def draws(c: int):
        """Call c's sampler draws: x_T (N, B, H, D), steps (S, N, B, H, D)."""
        gen = torch.Generator(device=dev).manual_seed(derive(seed, "noise", c))
        x_T = torch.randn((N, B, H, D), generator=gen, device=dev)
        return x_T, torch.randn((n_steps, N, B, H, D), generator=gen, device=dev)

    def call(c: int):
        x_T, steps = draws(c)
        noise = [SamplerNoise(x_T=x_T[n], steps=steps[:, n]) for n in range(N)]
        res = planner.plan_fresh_batch(gd, noise, hard[c])
        best = res.trajs_final[rows, res.idx_best]
        answer = torch.cat([best.reshape(N, -1), res.free_mask.any(-1)[:, None].float()], 1)
        return res, answer.cpu()

    call(pool)  # warm-up: the window's shapes, an input of its own
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    # The program's own peak (one call, its inputs), before the checked
    # calls' recordings add theirs.
    call_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    n_trace = tr["trace_calls"] if traced else 0
    rng = np.random.default_rng(derive(seed, "checked calls"))
    later = rng.choice(np.arange(n_trace + 1, n_trace + tr["check_within_calls"]),
                       size=tr["check_calls"] - 1, replace=False)
    check_at = {n_trace, *map(int, later)}
    rec = Recorder(planner.model)
    tracer = trace.Traced(planner.model) if n_trace else None
    kept = {}
    calls = failed = 0
    t0 = time.perf_counter()
    while True:
        c = calls % pool
        if calls == 0 and tracer is not None:
            tracer.open()
        rec.active = calls in check_at
        res, answer = call(c)
        failed += int((answer[:, -1] == 0).sum())
        if calls in check_at:
            kept[calls] = {"result": res, "forwards": rec.take(), "call": c}
        calls += 1
        if tracer is not None and calls == n_trace:
            tracer.close()
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    if tracer is not None and calls < n_trace:
        tracer.close()
    rec.handle.remove()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    out = {"attempted": calls * N, "failed": failed, "memory_peak_bytes": int(peak),
           "call_peak_bytes": int(call_peak),
           "e2e": {"plans_per_s": calls * N / window_s, "setup_s": setup_s}}
    # The window has closed: free the program's inputs and state, then
    # compare what the checked calls produced with the reference.
    del hard, planner, gd, res
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = checks.Reference(cfg, paths["model_dir"], device)
    cells, gaps = [], []
    limits = tr["limits"]
    for k in sorted(kept):
        one = kept.pop(k)
        c = one.pop("call")
        one["x_T"], one["steps"] = draws(c)
        one.update(starts=starts[c], goals=goals[c], tie=limits["final_gap"])
        gaps.append(checks.check_call(ref, one, cells))
    out["checks"] = checks.verdict(gaps, limits)
    out["checked_calls"] = len(gaps)

    flops_call = counts.unet_flops(cfg, N * B) * n_steps
    out["layer"] = {"calls": calls, "window_s": window_s,
                    "model_flops": flops_call * calls, "precision": cfg["precision"],
                    "loop_cells": cells, "loop_shape": (N, B, H), "n_guide": cfg["n_guide_steps"],
                    "hard_values": N * H * D}
    if tracer is not None:
        s = tracer.summary()
        s["calls"] = min(calls, n_trace)
        out["layer"]["trace"] = s
        out["busy_s"] = s["busy_s"] = trace.busy_s(s["spans"], 0.0, s["window_s"])
        out["traced_window_s"] = s["window_s"]
        out["breakdown"] = trace.breakdown(
            s["by_name"], trace.idle_gaps(s["spans"], s["brackets"], 0.0, s["window_s"],
                                          "sampler call outside the UNet"))
    return out
