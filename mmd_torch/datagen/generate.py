"""Data generation for the obstacle maps.

Twin of `mmd_tpu/datagen/generate.py` (reference: scripts/generate_data/
generate_trajectories.py:30-289). A context rejection-samples a valid
(start, goal) on the host, picks one of the map's skills, plans
RRT*(start -> skill_0) + the skill + RRT*(skill_-1 -> goal) (one
RRT-Connect on a map without skills) for every trajectory, resamples each
by a spline, polishes the batch with GPMP2 on the device, classifies it
there and keeps the free trajectories. The numpy generator is threaded as
the JAX package threads it, so one seed gives the same starts, goals,
skills and RRT seeds, and so the same GPMP2 input.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from mmd_torch.datagen.gpmp2 import GPMP2Config
from mmd_torch.datagen.host_collision import HostCollisionChecker
from mmd_torch.datagen.hybrid import hybrid_plan
from mmd_torch.datagen.native_rrt import NativeRRTConnect, NativeRRTStar, native_available
from mmd_torch.datagen.rrt import IdentityPlanner, RRTConnect, RRTStar
from mmd_torch.datasets.trajectories import TrajectoryDataset
from mmd_torch.tasks.task import make_task

# The reference env hooks' values (env_conveyor_2d.py:79-86).
RRT_PARAMS = dict(n_iters=10000, step_size=0.01, n_radius=0.05, max_time=50.0)


class NoStartGoal(RuntimeError):
    """No valid (start, goal) pair within the context's tries."""


@dataclasses.dataclass
class Context:
    """One context's free trajectories (n_free, H, 4) on the host, which
    RRT ran ('native' or 'python'), how many trajectories were planned,
    and the host seconds of the whole context and of its segment planning
    and spline resampling."""

    trajs: np.ndarray
    planner: str
    n_planned: int
    seconds: float
    segments_s: float


def _choose_native(native: Optional[bool]) -> bool:
    """The native RRT where it builds, as the JAX package chooses; True
    requires it, False takes the Python planners."""
    if native is None:
        return native_available()
    if native and not native_available():
        raise RuntimeError("the native RRT was required but could not be built")
    return bool(native)


def generate_context_trajectories(env_name: str, rng: np.random.Generator,
                                  n_trajectories: int = 20, horizon: int = 64,
                                  duration: float = 5.0,
                                  threshold_start_goal_pos: float = 0.5,
                                  gpmp_opt_iters: int = 500, max_sample_tries: int = 1000,
                                  device="cuda", native: Optional[bool] = None) -> Context:
    """One context (generate.py:29-91); `Context.trajs` may be empty."""
    t0 = time.perf_counter()
    task = make_task(env_name, device)
    env = task.env
    checker = HostCollisionChecker(env, task.robot.radius)

    # Start/goal rejection sampling (reference :594-601 and the env's gate).
    start = goal = None
    for _ in range(max_sample_tries):
        qs = checker.sample_free(rng, 2)
        s, g = qs[0], qs[1]
        if not env.is_start_goal_valid_for_data_gen(s, g):
            continue
        if np.linalg.norm(s - g) > threshold_start_goal_pos:
            start, goal = s, g
            break
    if start is None:
        raise NoStartGoal("no valid start/goal found")

    skills = env.get_skill_pos_seq_l(start_pos=start, goal_pos=goal, rng=rng)
    use_native = _choose_native(native)
    rrt_params = {k: v for k, v in RRT_PARAMS.items() if not (use_native and k == "max_time")}

    def connect(a, b):
        if use_native:
            return NativeRRTConnect(checker, a, b, seed=int(rng.integers(2**31)), **rrt_params)
        return RRTConnect(checker, a, b, rng=np.random.default_rng(rng.integers(2**31)),
                          **rrt_params)

    def star(a, b):
        if use_native:
            return NativeRRTStar(checker, a, b, seed=int(rng.integers(2**31)), **rrt_params)
        return RRTStar(checker, a, b, rng=np.random.default_rng(rng.integers(2**31)),
                       **rrt_params)

    if not skills:
        factories = [lambda: connect(start, goal)]
    else:
        skill = skills[int(rng.integers(0, len(skills)))]
        factories = [lambda: star(start, skill[0]), lambda: IdentityPlanner(skill),
                     lambda: star(skill[-1], goal)]

    cfg = GPMP2Config(n_support_points=horizon, dt=duration / horizon,
                      opt_iters=gpmp_opt_iters,
                      collision_margin=1.1 * task.robot.radius + 0.03)
    timing = {}
    trajs = hybrid_plan(task.scene, factories, n_trajectories, start, goal, cfg, timing)
    free, _ = task.get_trajs_collision_and_free(trajs)
    kept = trajs[free].cpu().numpy()  # waits for GPMP2 and the classification
    return Context(trajs=kept, planner="native" if use_native else "python",
                   n_planned=n_trajectories, seconds=time.perf_counter() - t0,
                   segments_s=timing["segments_s"])


def generate_dataset(env_name: str, n_contexts: int = 100,
                     n_trajectories_per_context: int = 20, horizon: int = 64,
                     duration: float = 5.0, seed: int = 0, gpmp_opt_iters: int = 300,
                     verbose: bool = True, device="cuda",
                     native: Optional[bool] = None) -> TrajectoryDataset:
    """A map's dataset (generate.py:94-128; reference scale 500 contexts x
    20, launch_generate_trajectories.py:15-42), on `device`."""
    rng = np.random.default_rng(seed)
    all_trajs = []
    t0 = time.time()
    for i in range(n_contexts):
        try:
            ctx = generate_context_trajectories(
                env_name, rng, n_trajectories=n_trajectories_per_context, horizon=horizon,
                duration=duration, gpmp_opt_iters=gpmp_opt_iters, device=device,
                native=native)
        except NoStartGoal:
            continue
        if len(ctx.trajs):
            all_trajs.append(ctx.trajs)
        if verbose and (i + 1) % 10 == 0:
            n = sum(len(t) for t in all_trajs)
            print(f"[datagen {env_name}] context {i + 1}/{n_contexts}: {n} free trajs "
                  f"({time.time() - t0:.0f}s, {ctx.planner} RRT)")
    if not all_trajs:
        raise RuntimeError(f"no free trajectories generated for {env_name}")
    return TrajectoryDataset.from_trajs(np.concatenate(all_trajs), env_name,
                                        duration=duration, device=device)
