"""Where one MPD plan's time, or one team plan's, goes on the card.

    python -m mmd_torch.tools.profile_plan                            # one robot
    python -m mmd_torch.tools.profile_plan --team                     # 10-robot PP
    python -m mmd_torch.tools.profile_plan --team --planner XECBS     # 10-robot XECBS
    python -m mmd_torch.tools.profile_plan --instance EnvTestTwoByTwoRobotPlanarDiskRandom

Plans EnvEmptyNoWait2D pair 0 of the 10-agent circle at full width (B=64,
H=64, 25+1 steps, 14 guided steps x 20 guide iterations) after one warm-up
plan of each path, then prints the card's name and power limit and one JSON
line. Two paths are measured in turns: "kernel", the port as it runs (one
guide-loop launch a guided step), and "per_iteration", the same plan with
each guided step's 20 guide iterations run one `guide_gradient` (with its
collision-guide kernel) and `hard.apply` at a time, as the port ran them
before the guide-loop kernel, for that plan only.
- plan_s: host-clock seconds of 8 plans in the order per_iteration,
  kernel, kernel, per_iteration, twice (each ends in a device sync), by
  path
- paths[path]: one plan traced with torch.profiler: busy_s (union of
  kernel intervals), kernels (device events) per plan, kernels per guided
  step's guide loop (one traced alone), idle_share = 1 - busy_s / the
  path's median untraced plan_s, and idle_share_traced, which divides by
  the traced plan's wall time instead (the profiler lengthens it)
- port_kernels: each port kernel's launches and device time by kernel name
  in each path's traced plan
- part_ms: CUDA-event times of the plan's parts alone (wrappers included):
  one UNet forward, a guided step's guide loop by the kernel, by its plain
  version and by the per-iteration loop, one guide_gradient, one
  collision-guide call and its plain version, one grid lookup at the
  finalize's shape, one finalize
- top: the 8 kernels with the most device time in the kernel path's plan
- build_s: host seconds to build the three CUDA sources into empty
  directories, one nvcc after the other ("serial") and all started
  together ("parallel", as chip_smoke.py builds them), in turns, twice each

With --team it plans the 10-robot circle of EnvEmptyNoWait2D with
`PrioritizedPlanning` (or, with --planner XECBS, the XECBS search of
bench.py's main path, its UNet in bfloat16) at the same width (planners
seeded 0-9 sharing one model) after one warm-up team plan, and prints the
card and one JSON line:
- plan_s: host seconds of 3 team plans (`timing["plan_s"]`), agent_s: each
  agent's seconds in them (CUDA events between the agents; for XECBS, the
  root's agents), and for XECBS each search's expansions, plans by kind
  and host waits
- busy_s, idle_share, idle_share_traced, kernels_per_plan: as above, for
  one team plan traced with torch.profiler (device activity only), and
  traced_plans, its fresh plans and local replans; for XECBS also
  unet_forward: one forward at B=64 in bfloat16 and in float32 (CUDA-event
  ms over 50 calls, kernels in one traced call)
- port_kernels: each port kernel's launches and device time in that plan

With --instance EnvTestTwoByTwoRobotPlanarDiskRandom it profiles the
multi-tile search of that instance (seed 0, 4 agents, stagger dt 10,
`MPDEnsemble` agents of 3 tiles, float32, B=64) with --planner XECBS (the
default here) or PP, after one warm-up search, and prints the card and one
JSON line:
- plan_s, expansions, plans by kind and host waits of 3 searches
- busy_s, idle_share, idle_share_traced, kernels_per_plan, port_kernels,
  traced_plans: as above, for one traced search
- part_ms: CUDA-event ms of agent 0's parts: the UNet step batched over its
  3 tiles (one forward over the stacked parameters, (3, 64, 64, 4)) and
  per tile (3 forwards one after the other), one guide_gradient over the 3
  tiles, one collision-guide call at (3, 64, 64, 4), one guide-loop call
  (20 iterations) at (3, 64, 64, 4), one guided step (forward, the guide
  loop, noise, seams); part_kernels: kernels in one traced call of each
  but the two kernels; agent0_plan_s: its fresh and local plans, 4 each
  in turns (host clock)
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import torch

from mmd_torch.common.multi_agent_utils import get_start_goal_pos_circle
from mmd_torch.costs import guide
from mmd_torch.costs.guide import GuideData, collision_guide_plain, guide_gradient, \
    guide_iterations, guide_loop, guide_loop_plain
from mmd_torch.ops import collision_guide as cg
from mmd_torch.ops import guide_loop as gl
from mmd_torch.ops import sdf_kernel
from mmd_torch.ops.build import BUILD_DIR, build_shared_libraries, load_kernels
from mmd_torch.ops.sdf_kernel import grid_lookup
from mmd_torch.planners.single_agent.mpd import _finalize_plan, load_planner
from mmd_torch.utils.interp import interpolate_traj_via_points

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TEAM_AGENTS = 10  # the 10-robot circle of bench.py
# Port kernels by the name the profiler gives their device events.
PORT_KERNELS = {"guide_loop": "guide_loop_kernel",
                "collision_guide": "collision_guide_kernel",
                "grid_sdf_lookup": "grid_sdf_lookup_kernel"}


@contextlib.contextmanager
def per_iteration():
    """Route the sampler's guide loops on the card to `guide_iterations`
    (one `guide_gradient`, its collision terms by the collision-guide
    kernel, and `hard.apply` an iteration)."""
    guide.guide_loop_cuda = guide_iterations
    try:
        yield
    finally:
        guide.guide_loop_cuda = gl.guide_loop_cuda


def build_seconds() -> dict:
    """The sources built into empty directories, serially and together, in
    the order serial, parallel, parallel, serial."""
    sources = [sdf_kernel.SOURCE, cg.SOURCE, gl.SOURCE]
    out, root = {"serial": [], "parallel": []}, BUILD_DIR / f"profile-{os.getpid()}"
    try:
        for n, how in enumerate(("serial", "parallel", "parallel", "serial")):
            t0 = time.perf_counter()
            if how == "serial":
                for source in sources:
                    build_shared_libraries([source], root / str(n))
            else:
                build_shared_libraries(sources, root / str(n))
            out[how].append(time.perf_counter() - t0)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


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


def _traced(fn, host: bool = True):
    """Run fn under torch.profiler, tracing host ops too unless host is
    False: (host seconds, the device events)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU] * host + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]


def _port_kernels(events) -> dict:
    port = {}
    for kernel, tag in PORT_KERNELS.items():
        hits = [e.time_range.elapsed_us() for e in events if tag in e.name]
        port[kernel] = {"launches": len(hits), "device_us": sum(hits),
                        "device_us_per_launch": sum(hits) / len(hits) if hits else None}
    return port


def profile_team(card: str, planner: str) -> dict:
    """A team plan's numbers (module docstring, --team)."""
    from mmd_torch.planners.multi_agent.cbs import CBS
    from mmd_torch.planners.multi_agent.prioritized_planning import PrioritizedPlanning
    from mmd_torch.planners.single_agent.mpd import load_planners

    starts, goals = get_start_goal_pos_circle(TEAM_AGENTS)
    xecbs = planner == "XECBS"
    planners = load_planners(os.path.join(ROOT, "data_trained_models"),
                             os.path.join(ROOT, "data_trajectories"), "EnvEmptyNoWait2D",
                             starts, goals, device="cuda", bf16=xecbs)

    def team():
        if xecbs:
            return CBS(planners, starts, goals, is_ecbs=True, is_xcbs=True)
        return PrioritizedPlanning(planners, starts, goals)

    load_kernels()
    team().plan()  # warm-up
    plan_s, agent_s, outcome = [], [], []
    for _ in range(3):
        tp = team()
        _, n_exp, status, n_conflicts = tp.plan()
        t = tp.timing
        plan_s.append(t["plan_s"])
        agent_s.append(t.get("root_agent_s" if xecbs else "agent_s"))
        outcome.append([str(status), n_conflicts, n_exp, t["plans_fresh"], t["plans_local"],
                        {k: v for k, v in t.items() if k.startswith("device_")}]
                       if xecbs else [str(status), n_conflicts, tp.used_scan])
    unet = _unet_forwards(planners[0]) if xecbs else None
    traced = team()
    traced_s, events = _traced(traced.plan, host=False)
    busy_s = _busy_us(events) * 1e-6 if events else None  # None: not measured
    untraced = statistics.median(plan_s)
    return {"team": {
        "planner": planner, "agents": TEAM_AGENTS, "plan_s": plan_s, "agent_s": agent_s,
        "outcome": outcome, "traced_plans": [traced.timing["plans_fresh"],
                                             traced.timing["plans_local"]],
        "busy_s": busy_s, "traced_plan_s": traced_s, "kernels_per_plan": len(events),
        "idle_share": None if busy_s is None else 1.0 - busy_s / untraced,
        "idle_share_traced": None if busy_s is None else 1.0 - busy_s / traced_s,
        "port_kernels": _port_kernels(events), "unet_forward": unet},
        "device": torch.cuda.get_device_name(0), "card": card}


def _unet_forwards(planner) -> dict:
    """One UNet forward at the plan's batch, in the planner's bfloat16 and
    in float32: CUDA-event ms over 50 calls, and kernels in one traced call."""
    from mmd_torch.train.checkpoint import load_checkpoint

    f32, _, _ = load_checkpoint(os.path.join(ROOT, "data_trained_models",
                                             "EnvEmptyNoWait2D-RobotPlanarDisk"), "cuda")
    x = planner.draw_noise().x_T
    t = torch.full((x.shape[0],), 7, dtype=torch.int64, device=x.device)
    out = {}
    with torch.no_grad():
        for name, model in (("f32", f32), ("bf16", planner.model)):
            _, events = _traced(lambda: model(x, t), host=False)
            out[name] = {"ms": _event_ms(lambda: model(x, t), 50), "kernels": len(events)}
    return out


TILES_INSTANCE = "EnvTestTwoByTwoRobotPlanarDiskRandom"


def profile_tiles(card: str, planner: str) -> dict:
    """The multi-tile search's numbers (module docstring, --instance)."""
    from mmd_torch.common.experiences import PathBatchExperience
    from mmd_torch.experiments.problems import get_planning_problem
    from mmd_torch.models.ensemble import ensemble_step
    from mmd_torch.experiments.trial import (
        ModelRegistry,
        build_multi_agent_trial,
        make_team_planner,
    )

    registry = ModelRegistry(os.path.join(ROOT, "data_trained_models"),
                             os.path.join(ROOT, "data_trajectories"), device="cuda")
    s, g, ids, sk = get_planning_problem(TILES_INSTANCE, 4, seed=0)
    trial = build_multi_agent_trial(planner, s, g, ids, sk, registry, stagger_dt=10)
    p0 = trial.planners[0]

    def team():
        return make_team_planner(planner, trial.planners, trial.start_l, trial.goal_l,
                                 start_time_l=trial.start_time_l,
                                 reference_task=trial.team.reference_task)

    load_kernels()
    team().plan(runtime_limit=600)  # warm-up
    plan_s, outcome = [], []
    for _ in range(3):
        tp = team()
        _, n_exp, status, n_conflicts = tp.plan(runtime_limit=600)
        t = tp.timing
        plan_s.append(t["plan_s"])
        outcome.append([str(status), n_conflicts, n_exp, t["plans_fresh"], t["plans_local"],
                        {k: v for k, v in t.items() if k.startswith("device_")}])
    traced = team()
    traced_s, events = _traced(lambda: traced.plan(runtime_limit=600), host=False)
    busy_s = _busy_us(events) * 1e-6 if events else None  # None: not measured

    # Agent 0's parts.
    noise = p0.draw_noise()
    x = noise.x_T
    n_guide = p0.cfg.n_guide_steps
    tb = torch.full((x.shape[1],), 7, dtype=torch.int64, device="cuda")
    gds = p0._guide_data(*p0._route_constraints(None))
    u = p0.normalizer.unnormalize(x)

    def per_tile():
        return [m(x[k], tb) for k, m in enumerate(p0.model.models)]

    def guided_step():  # t = 5: a guided step with noise
        return ensemble_step(p0.model, p0.schedule, x, 5, noise.steps[0], p0.hard_conds,
                             p0.cc, gds, p0.cfg, p0.guide_cfg)

    with torch.no_grad():
        part_ms = {
            "unet_step_batched": _event_ms(lambda: p0.model(x, tb), 26),
            "unet_step_per_tile": _event_ms(per_tile, 26),
            "guide_gradient": _event_ms(lambda: guide_gradient(x, gds, p0.guide_cfg), 50),
            "collision_guide": _event_ms(lambda: cg.collision_guide(u, p0.scene, p0.guide_cfg),
                                         200),
            "guide_loop": _event_ms(lambda: gl.guide_loop_cuda(
                x, gds, p0.hard_conds, p0.guide_cfg, n_guide), 200),
            "guided_step": _event_ms(guided_step, 5),
        }
        kernels = {"unet_step_batched": len(_traced(lambda: p0.model(x, tb), host=False)[1]),
                   "unet_step_per_tile": len(_traced(per_tile, host=False)[1]),
                   "guide_gradient": len(_traced(
                       lambda: guide_gradient(x, gds, p0.guide_cfg), host=False)[1]),
                   "guided_step": len(_traced(guided_step, host=False)[1])}
    plans = {"fresh": [], "local": []}
    kept = p0().trajs_final
    for kind in ("fresh", "local", "local", "fresh") * 2:
        t0 = time.perf_counter()
        p0(experience=PathBatchExperience(kept) if kind == "local" else None)
        plans[kind].append(time.perf_counter() - t0)
    untraced = statistics.median(plan_s)
    return {"tiles": {
        "instance": TILES_INSTANCE, "planner": planner, "agents": 4, "stagger_dt": 10,
        "tiles_per_agent": p0.n_tiles, "plan_s": plan_s, "outcome": outcome,
        "traced_plans": [traced.timing["plans_fresh"], traced.timing["plans_local"]],
        "busy_s": busy_s, "traced_plan_s": traced_s, "kernels_per_plan": len(events),
        "idle_share": None if busy_s is None else 1.0 - busy_s / untraced,
        "idle_share_traced": None if busy_s is None else 1.0 - busy_s / traced_s,
        "port_kernels": _port_kernels(events), "part_ms": part_ms, "part_kernels": kernels,
        "agent0_plan_s": plans},
        "device": torch.cuda.get_device_name(0), "card": card}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--team", action="store_true",
                        help="profile the 10-robot team plan instead of one robot's")
    parser.add_argument("--planner", choices=("PP", "XECBS"), default=None,
                        help="the team planner of --team (default PP) or --instance "
                             "(default XECBS)")
    parser.add_argument("--instance", choices=(TILES_INSTANCE,), default=None,
                        help="profile the multi-tile search of this instance")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_plan: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()
    if args.instance:
        print(card)
        print(json.dumps(profile_tiles(card, args.planner or "XECBS")))
        return 0
    if args.team:
        print(card)
        print(json.dumps(profile_team(card, args.planner or "PP")))
        return 0
    build_s = build_seconds()
    starts, goals = get_start_goal_pos_circle(10)
    planner = load_planner(os.path.join(ROOT, "data_trained_models"),
                           os.path.join(ROOT, "data_trajectories"), "EnvEmptyNoWait2D",
                           starts[0], goals[0], "cuda")
    paths = {"kernel": contextlib.nullcontext, "per_iteration": per_iteration}
    for path in paths.values():
        with path():
            planner()  # warm-up
    plan_s = {"kernel": [], "per_iteration": []}
    for name in ("per_iteration", "kernel", "kernel", "per_iteration") * 2:
        with paths[name]():
            t0 = time.perf_counter()
            planner()
            plan_s[name].append(time.perf_counter() - t0)

    cfg, B = planner.cfg, planner.cfg.n_samples
    x = planner.draw_noise().x_T
    gd = GuideData(scene=planner.scene, normalizer=planner.dataset.normalizer,
                   constraints=planner._pack(None)[0])
    hard, gcfg, n_guide = planner.hard_conds, planner.guide_cfg, cfg.n_guide_steps
    report, events = {}, {}
    for name, path in paths.items():
        with path():
            traced_s, plan_events = _traced(planner)
            _, guide_events = _traced(lambda: guide_loop(x, gd, hard, gcfg, n_guide))
        busy_s = _busy_us(plan_events) * 1e-6 if plan_events else None  # None: not measured
        untraced = statistics.median(plan_s[name])
        report[name] = {
            "busy_s": busy_s, "traced_plan_s": traced_s,
            "kernels_per_plan": len(plan_events),
            "kernels_per_guided_step_loop": len(guide_events),
            "port_kernels": _port_kernels(plan_events),
            "idle_share": None if busy_s is None else 1.0 - busy_s / untraced,
            "idle_share_traced": None if busy_s is None else 1.0 - busy_s / traced_s,
        }
        events[name] = plan_events

    per_name = {}
    for e in events["kernel"]:
        per_name[e.name] = per_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
    port = _port_kernels(events["kernel"])

    tb = torch.full((B,), 12, dtype=torch.int64, device="cuda")
    chain = torch.stack([x] * (len(cfg.step_indices()) + 1))
    u = gd.normalizer.unnormalize(x)
    q = interpolate_traj_via_points(u[..., :2], 5)  # the finalize's points
    tables = [(planner.scene.grid.values, planner.scene.grid.grads),
              (planner.scene.extra_grid.values, planner.scene.extra_grid.grads)]

    with torch.no_grad():
        part_ms = {
            "unet_forward": _event_ms(lambda: planner.model(x, tb), 26),
            "guide_loop": _event_ms(lambda: gl.guide_loop_cuda(x, gd, hard, gcfg, n_guide), 200),
            "guide_loop_plain": _event_ms(lambda: guide_loop_plain(x, gd, hard, gcfg, n_guide),
                                          5),
            "guide_loop_per_iteration": _event_ms(
                lambda: guide_iterations(x, gd, hard, gcfg, n_guide), 5),
            "guide_gradient": _event_ms(lambda: guide_gradient(x, gd, planner.guide_cfg), 50),
            "collision_guide": _event_ms(
                lambda: cg.collision_guide(u, planner.scene, planner.guide_cfg), 200),
            "collision_guide_plain": _event_ms(
                lambda: collision_guide_plain(u, planner.scene, planner.guide_cfg), 200),
            "grid_lookup_finalize_shape": _event_ms(
                lambda: grid_lookup(q, tables, planner.scene.grid.lower,
                                    planner.scene.grid.upper), 200),
            "finalize": _event_ms(lambda: _finalize_plan(
                chain, gd.normalizer, planner.scene, planner.robot.radius,
                planner.robot.q_min, planner.robot.q_max, planner._savgol), 10),
        }
    print(card)
    print(json.dumps({
        "plan_s": plan_s, "paths": report, "port_kernels": port, "part_ms": part_ms,
        "build_s": build_s,
        "per_plan": {"unet_forwards": len(cfg.step_indices()),
                     "guide_loops": cfg.n_guided_steps(),
                     "guide_iterations": cfg.n_guided_steps() * cfg.n_guide_steps},
        "top": [[name[:60], round(us / 1e3, 3)] for name, us in top],
        "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
