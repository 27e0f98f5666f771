"""Benchmark: a team plan of the robot circle on one card, the twin of the
repository's `bench.py` for the PyTorch port.

    python -m mmd_torch.bench

Reads the same environment variables as `bench.py`:
- MMD_BENCH_AGENTS: team size (default 10), the circle of EnvEmptyNoWait2D
- MMD_BENCH_PLANNER: PP, CBS, ECBS, XCBS, XECBS (default), XCBS-R or
  XECBS-R (XCBS and XECBS with MMD_BENCH_REPAIR root repair rounds,
  default 1, bench.py:85-96)
- MMD_BENCH_BF16: the UNet's forward in bfloat16 (default 1)
- MMD_BENCH_SAMPLER: ddpm (default) or ddim (fresh plans run the DDIM
  fast mode; XCBS's local replans stay DDPM)
- MMD_BENCH_GUIDE_STEPS: guide iterations a guided step, a probe of
  their share of the time (default 0: the reference's 20; bench.py:39-43)
- MMD_BENCH_TRACE=<dir>: a torch.profiler Chrome trace of the timed
  search alone, written into <dir> (`trace` in the line names the file)
- MMD_BENCH_DECOMPOSE: also time the team root alone after a warm run,
  `decompose_root_alone_s` (the ECBS sequential soft root for ECBS and
  XECBS without repair rounds, the fresh team's batched root otherwise),
  beside `decompose_search_root_s`, the timed search's own root (its
  agents' CUDA-event seconds, `timing["root_agent_s"]`), since the wall of
  one search varies more than the root's share of it
- MMD_BENCH_TIMEOUT: seconds (default 2700) after which a watchdog prints
  bench.py's error line (value null, an `error`) and exits with status 3

The line always carries the FLOP accounting (bench.py:130-140, 193-214):
`unet_evals` (the timed search's UNet forwards, each over the B = 64 rows
of a problem), `model_gflops` (unet_evals times one forward's FLOPs at
B = 64, `utils.flops.unet_forward_flops`) and `mfu_pct` = 100 * model
FLOPs / wall / `gpu_peak_flops()`, the card's dense bfloat16 peak (float32
runs are quoted against it too). The denominator is the wall seconds of
the timed search, the whole step, and not `device_s`, which in the port is
the host's seconds waiting on the card and not the card's busy time.
Guide, lookup and selection FLOPs are left out: the numerator is model
math. A card the peak table lacks prints `mfu_pct` null. Unlike bench.py,
which can switch it off (MMD_BENCH_FLOPS) because its count changes the
timed program, the port counts one forward after the timed search has
ended, so there is nothing to switch.

The planners are built as `bench.py:45-74` builds them: the flagship
checkpoint, its training normalizer, planner i seeded seed * 1000 + i, all
sharing one model. One warm-up search runs first; then a search on fresh
search state is timed, and one JSON line is printed with `bench.py`'s keys:
metric, value (wall seconds), unit, success, collision_free,
ct_expansions, device_s (host seconds waiting on the card), host_s,
device_calls, device_<phase>_s, unet_evals, model_gflops, mfu_pct,
`sampler` when it is not ddpm and `n_guide_steps` when set (as
bench.py:177-180), and `device` (the card's name and power limit from
nvidia-smi). It leaves out `vs_baseline`, a TPU target. It needs a CUDA
card and exits with status 2 without one.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import threading

import torch

from mmd_torch.utils.timer import TimerCuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLANNERS = {"CBS": (False, False), "ECBS": (True, False), "XCBS": (False, True),
            "XECBS": (True, True), "XCBS-R": (False, True), "XECBS-R": (True, True)}


def settings(env=os.environ) -> dict:
    """The run's settings from the environment; ValueError for an unknown
    planner or sampler."""
    planner = env.get("MMD_BENCH_PLANNER", "XECBS")
    sampler = env.get("MMD_BENCH_SAMPLER", "ddpm")
    if planner != "PP" and planner not in PLANNERS:
        raise ValueError(f"unknown MMD_BENCH_PLANNER {planner!r}")
    if sampler not in ("ddpm", "ddim"):
        raise ValueError(f"unknown MMD_BENCH_SAMPLER {sampler!r}")
    return {"agents": int(env.get("MMD_BENCH_AGENTS", "10")), "planner": planner,
            "bf16": env.get("MMD_BENCH_BF16", "1") not in ("0", "", "false"),
            "sampler": sampler, "repair": int(env.get("MMD_BENCH_REPAIR", "1")),
            "guide_steps": int(env.get("MMD_BENCH_GUIDE_STEPS", "0")),
            "trace": env.get("MMD_BENCH_TRACE") or None,
            "decompose": bool(env.get("MMD_BENCH_DECOMPOSE")),
            "timeout": float(env.get("MMD_BENCH_TIMEOUT", "2700"))}


def metric_name(s: dict) -> str:
    return f"{s['agents']}_robot_plan_wall_clock_{s['planner']}"


def watchdog_line(s: dict) -> dict:
    """bench.py's error line (bench.py:110-115)."""
    return {"metric": metric_name(s), "value": None, "unit": "s", "vs_baseline": None,
            "error": f"watchdog: no result within {s['timeout']:.0f}s (card unreachable?)"}


def arm_watchdog(s: dict, exit_fn=os._exit) -> threading.Timer:
    """A daemon timer that prints `watchdog_line` and exits with status 3
    after s["timeout"] seconds, unless cancelled (bench.py:102-121)."""
    def fire():
        print(json.dumps(watchdog_line(s)), flush=True)
        exit_fn(3)

    t = threading.Timer(s["timeout"], fire)
    t.daemon = True
    t.start()
    return t


def flop_fields(unet_evals: int, forward_flops: int, wall: float, peak) -> dict:
    """unet_evals, model_gflops and mfu_pct of a timed search (module
    docstring); mfu_pct is None without a peak."""
    from mmd_torch.utils.flops import mfu_pct

    flops = unet_evals * forward_flops
    return {"unet_evals": int(unet_evals), "model_gflops": flops / 1e9,
            "mfu_pct": mfu_pct(unet_evals, forward_flops, wall, peak)}


def root_alone_s(s: dict, team_planner, planners) -> float:
    """Seconds of the team root alone, timed after a warm run: the ECBS
    sequential soft root, or the fresh team's batched root (bench.py:
    215-237)."""
    from mmd_torch.parallel.team import (
        PrioritizedTeam,
        plan_fresh_team,
        plan_sequential_root_soft,
    )

    team = PrioritizedTeam.of(planners, team_planner.margin)
    ecbs = s["planner"] in ("ECBS", "XECBS")

    def once():
        if ecbs:
            out = plan_sequential_root_soft(team, team_planner._team_noise(),
                                            team_planner._team_noise(), bool)
        else:
            out = plan_fresh_team(team, team_planner._team_noise())
        return out

    once()  # warm
    with TimerCuda() as t:
        once()
    return t.elapsed


def build_planners(s: dict, seed: int = 0, device: str = "cuda"):
    """The team's planners, starts and goals (bench.py:45-78)."""
    import dataclasses

    from mmd_torch.common.multi_agent_utils import get_start_goal_pos_circle
    from mmd_torch.planners.single_agent.mpd import load_planners

    starts, goals = get_start_goal_pos_circle(s["agents"])
    planners = load_planners(os.path.join(ROOT, "data_trained_models"),
                             os.path.join(ROOT, "data_trajectories"), "EnvEmptyNoWait2D",
                             starts, goals, seeds=[seed * 1000 + i for i in range(len(starts))],
                             device=device, bf16=s["bf16"], sampler=s["sampler"])
    if s["guide_steps"] > 0:
        for p in planners:
            p.cfg = dataclasses.replace(p.cfg, n_guide_steps=s["guide_steps"])
    return planners, starts, goals


def make_team_planner(s: dict, planners, starts, goals):
    from mmd_torch.planners.multi_agent.cbs import CBS
    from mmd_torch.planners.multi_agent.prioritized_planning import PrioritizedPlanning

    if s["planner"] == "PP":
        return PrioritizedPlanning(planners, starts, goals)
    is_ecbs, is_xcbs = PLANNERS[s["planner"]]
    repair = s["repair"] if s["planner"].endswith("-R") else 0
    return CBS(planners, starts, goals, is_ecbs=is_ecbs, is_xcbs=is_xcbs,
               root_repair_rounds=repair)


def card() -> str:
    return subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()


def main() -> int:
    s = settings()
    if not torch.cuda.is_available():
        print("mmd_torch.bench: needs a CUDA card", file=sys.stderr)
        return 2
    from mmd_torch.experiments.status import TrialSuccessStatus
    from mmd_torch.ops.build import load_kernels
    from mmd_torch.planners.multi_agent.conflict_detection import count_conflicts
    from mmd_torch.utils.flops import unet_forward_flops
    from mmd_torch.utils.profiling import gpu_peak_flops, profiler_trace

    watchdog = arm_watchdog(s)
    load_kernels()  # before any timed search
    planners, starts, goals = build_planners(s)
    make_team_planner(s, planners, starts, goals).plan(runtime_limit=600)  # warm-up
    team = make_team_planner(s, planners, starts, goals)
    trace = profiler_trace(s["trace"]) if s["trace"] else contextlib.nullcontext()
    with trace as prof, TimerCuda() as timer:
        paths, n_exp, status, _ = team.plan(runtime_limit=600)
    wall = timer.elapsed
    timing = team.timing
    result = {
        "metric": metric_name(s),
        "value": wall, "unit": "s",
        "success": bool(status == TrialSuccessStatus.SUCCESS),
        "collision_free": count_conflicts(paths, planners[0].robot.rr_margin) == 0,
        "ct_expansions": int(n_exp),
        "device_s": timing["device_s"], "host_s": wall - timing["device_s"],
        "device_calls": int(timing["device_calls"]),
        **{k: v for k, v in sorted(timing.items())
           if k.startswith("device_") and k.endswith("_s") and k != "device_s"},
        "unet_evals": int(timing["unet_forwards"]),
        "plans_fresh": int(timing["plans_fresh"]), "plans_local": int(timing["plans_local"]),
        "sampler_calls": int(timing["sampler_calls"]),
        "sampler_calls_local": int(timing["sampler_calls_local"]),
        "bf16": s["bf16"],
        **({"sampler": s["sampler"]} if s["sampler"] != "ddpm" else {}),
        **({"n_guide_steps": s["guide_steps"]} if s["guide_steps"] > 0 else {}),
        "device": card(),
    }
    if s["trace"]:
        result["trace"] = prof.trace_path
    cfg = planners[0].cfg
    forward = unet_forward_flops(planners[0].model, cfg.n_samples, cfg.horizon, cfg.state_dim)
    result.update(flop_fields(timing["unet_forwards"], forward, wall, gpu_peak_flops()))
    if s["decompose"]:
        if "root_agent_s" in timing:
            result["decompose_search_root_s"] = sum(timing["root_agent_s"])
        result["decompose_root_alone_s"] = root_alone_s(s, team, planners)
    watchdog.cancel()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
