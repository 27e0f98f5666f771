"""Where one MPD plan's time goes on the card.

    python -m mmd_torch.tools.profile_plan

Plans EnvEmptyNoWait2D pair 0 of the 10-agent circle at full width (B=64,
H=64, 25+1 steps, 14 guided steps x 20 guide iterations) after one warm-up
plan, then prints one JSON line:
- plan_s: host-clock seconds of 3 plans (each ends in a device sync)
- busy_s, kernels: the device's busy time (union of kernel intervals) over
  one plan traced with torch.profiler, and the number of kernels it ran
- idle_share: 1 - busy_s / the median untraced plan_s, the share of a plan
  the device sits idle; idle_share_traced divides by the traced plan's wall
  time instead, which the profiler itself lengthens
- part_ms: CUDA-event times of the plan's parts alone: one UNet forward, one
  guide_gradient, one grid lookup, one finalize
- top: the 8 kernels with the most device time in the traced plan
Needs a CUDA card.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch

from mmd_torch.common.multi_agent_utils import get_start_goal_pos_circle
from mmd_torch.costs.guide import GuideData, guide_gradient
from mmd_torch.ops.sdf_kernel import grid_lookup
from mmd_torch.planners.single_agent.mpd import _finalize_plan, load_planner

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _event_ms(fn, n: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _busy_us(events) -> float:
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + (cur_e - cur_s if cur_e is not None else 0.0)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_plan: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()
    starts, goals = get_start_goal_pos_circle(10)
    planner = load_planner(os.path.join(ROOT, "data_trained_models"),
                           os.path.join(ROOT, "data_trajectories"), "EnvEmptyNoWait2D",
                           starts[0], goals[0], "cuda")
    planner()  # warm-up
    plan_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        planner()
        plan_s.append(time.perf_counter() - t0)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        planner()
        traced_s = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = _busy_us(kernels) * 1e-6 if kernels else None  # None: not measured
    per_name = {}
    for e in kernels:
        per_name[e.name] = per_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]

    cfg, B = planner.cfg, planner.cfg.n_samples
    x = planner.draw_noise().x_T
    tb = torch.full((B,), 12, dtype=torch.int64, device="cuda")
    gd = GuideData(scene=planner.scene, normalizer=planner.dataset.normalizer,
                   constraints=planner._pack(None))
    chain = torch.stack([x] * (len(cfg.step_indices()) + 1))
    q = x[:, 1:, :2].contiguous()
    tables = [(planner.scene.grid.values, planner.scene.grid.grads),
              (planner.scene.extra_grid.values, planner.scene.extra_grid.grads)]
    with torch.no_grad():
        part_ms = {
            "unet_forward": _event_ms(lambda: planner.model(x, tb), 26),
            "guide_gradient": _event_ms(lambda: guide_gradient(x, gd, planner.guide_cfg), 50),
            "grid_lookup": _event_ms(lambda: grid_lookup(q, tables, planner.scene.grid.lower,
                                                         planner.scene.grid.upper), 200),
            "finalize": _event_ms(lambda: _finalize_plan(
                chain, gd.normalizer, planner.scene, planner.robot.radius,
                planner.robot.q_min, planner.robot.q_max, planner._savgol), 10),
        }
    print(card)
    print(json.dumps({
        "plan_s": plan_s, "traced_plan_s": traced_s, "busy_s": busy_s,
        "idle_share": None if busy_s is None else 1.0 - busy_s / statistics.median(plan_s),
        "idle_share_traced": None if busy_s is None else 1.0 - busy_s / traced_s,
        "kernels": len(kernels),
        "part_ms": part_ms,
        "per_plan": {"unet_forwards": len(cfg.step_indices()),
                     "guide_gradients": cfg.n_guided_steps() * cfg.n_guide_steps},
        "top": [[name[:60], round(us / 1e3, 3)] for name, us in top],
        "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
