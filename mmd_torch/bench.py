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

The planners are built as `bench.py:45-74` builds them: the flagship
checkpoint, its training normalizer, planner i seeded seed * 1000 + i, all
sharing one model. One warm-up search runs first; then a search on fresh
search state is timed, and one JSON line is printed with `bench.py`'s keys:
metric, value (wall seconds), unit, success, collision_free,
ct_expansions, device_s (host seconds waiting on the card), host_s,
device_calls, device_<phase>_s, unet_evals, `sampler` when it is not
ddpm and `n_guide_steps` when set (as bench.py:177-180), and `device`
(the card's name and power limit from nvidia-smi). It leaves out
`vs_baseline`, a TPU target, and `mfu_pct`, a TPU peak. It needs a CUDA
card and exits with status 2 without one.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

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
            "guide_steps": int(env.get("MMD_BENCH_GUIDE_STEPS", "0"))}


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

    load_kernels()  # before any timed search
    planners, starts, goals = build_planners(s)
    make_team_planner(s, planners, starts, goals).plan(runtime_limit=600)  # warm-up
    team = make_team_planner(s, planners, starts, goals)
    t0 = time.perf_counter()
    paths, n_exp, status, _ = team.plan(runtime_limit=600)
    wall = time.perf_counter() - t0
    timing = team.timing
    result = {
        "metric": f"{s['agents']}_robot_plan_wall_clock_{s['planner']}",
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
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
