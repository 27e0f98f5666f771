"""Planning-problem registry: instance name -> (starts, goals, tile grid,
agent skeletons).

Twin of `mmd_tpu/experiments/problems.py` (reference: mmd/config/
mmd_experiment_configs.py:36-280): single-tile Circle/Boundary/Random
problems per environment and the canned 2x2 / 3x3 multi-tile instances
with their skeleton tables. Starts and goals are in the local frame of an
agent's first and last tile. Random problems clear their candidates
against the map's grid on the CPU.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np

from mmd_torch.common.multi_agent_utils import (
    get_start_goal_pos_boundary,
    get_start_goal_pos_circle,
    get_start_goal_pos_random_in_env,
)
from mmd_torch.tasks.task import make_task

Problem = Tuple[List[np.ndarray], List[np.ndarray], List[List[str]],
                List[List[List[int]]]]


def _single_tile(mid: str, num_agents: int, starts, goals) -> Problem:
    return starts, goals, [[mid]], [[[0, 0]]] * num_agents


@functools.lru_cache(maxsize=None)
def _cached_task(env_name: str):
    # The map's grid is built once per env; problems are drawn on the host.
    return make_task(env_name, device="cpu")


def _random_in_env(env_name: str, num_agents: int, margin=0.15,
                   obstacle_margin=0.16, seed: Optional[int] = None):
    task = _cached_task(env_name)
    rng = np.random.default_rng(seed)
    return get_start_goal_pos_random_in_env(num_agents, task, rng=rng,
                                            margin=margin,
                                            obstacle_margin=obstacle_margin)


class EnvEmpty2DRobotPlanarDiskCircle:
    def get_planning_problem(self, num_agents, seed=None):
        s, g = get_start_goal_pos_circle(num_agents, radius=0.8)
        return _single_tile("EnvEmpty2D-RobotPlanarDisk", num_agents, s, g)


class EnvEmpty2DRobotPlanarDiskBoundary:
    def get_planning_problem(self, num_agents, seed=None):
        s, g = get_start_goal_pos_boundary(num_agents, dist=0.87)
        return _single_tile("EnvEmpty2D-RobotPlanarDisk", num_agents, s, g)


class EnvEmpty2DRobotPlanarDiskRandom:
    def get_planning_problem(self, num_agents, seed=None):
        s, g = _random_in_env("EnvEmpty2D", num_agents, seed=seed)
        return _single_tile("EnvEmpty2D-RobotPlanarDisk", num_agents, s, g)


class EnvEmptyNoWait2DRobotPlanarDiskCircle:
    def get_planning_problem(self, num_agents, seed=None):
        s, g = get_start_goal_pos_circle(num_agents, radius=0.8)
        return _single_tile("EnvEmptyNoWait2D-RobotPlanarDisk", num_agents, s, g)


class EnvConveyor2DRobotPlanarDiskBoundary:
    def get_planning_problem(self, num_agents, seed=None):
        s, g = get_start_goal_pos_boundary(num_agents, dist=0.87)
        return _single_tile("EnvConveyor2D-RobotPlanarDisk", num_agents, s, g)


class EnvConveyor2DRobotPlanarDiskRandom:
    def get_planning_problem(self, num_agents, seed=None):
        s, g = _random_in_env("EnvConveyor2D", num_agents, seed=seed)
        return _single_tile("EnvConveyor2D-RobotPlanarDisk", num_agents, s, g)


class EnvHighways2DRobotPlanarDiskRandom:
    def get_planning_problem(self, num_agents, seed=None):
        s, g = _random_in_env("EnvHighways2D", num_agents, seed=seed)
        return _single_tile("EnvHighways2D-RobotPlanarDisk", num_agents, s, g)


class EnvHighways2DRobotPlanarDiskSmallCircle:
    """reference :142-158: up to 10 agents on radius 0.45, rest on 0.65."""

    def get_planning_problem(self, num_agents, seed=None):
        s, g = get_start_goal_pos_circle(min(num_agents, 10), radius=0.45)
        if num_agents > 10:
            s2, g2 = get_start_goal_pos_circle(num_agents - 10, radius=0.65)
            s, g = s + s2, g + g2
        return _single_tile("EnvHighways2D-RobotPlanarDisk", num_agents, s, g)


class EnvDropRegion2DRobotPlanarDiskBoundary:
    def get_planning_problem(self, num_agents, seed=None):
        s, g = get_start_goal_pos_boundary(num_agents)
        return _single_tile("EnvDropRegion2D-RobotPlanarDisk", num_agents, s, g)


class EnvDropRegion2DRobotPlanarDiskRandom:
    def get_planning_problem(self, num_agents, seed=None):
        s, g = _random_in_env("EnvDropRegion2D", num_agents, seed=seed)
        return _single_tile("EnvDropRegion2D-RobotPlanarDisk", num_agents, s, g)


# 29 canned 3-tile skeletons over a 2x2 grid (reference :181-208).
_TWO_BY_TWO_SKELETONS = [
    [[0, 0], [0, 1], [1, 1]], [[0, 0], [1, 0], [1, 1]], [[1, 0], [0, 0], [1, 0]],
    [[0, 0], [0, 1], [1, 1]], [[0, 0], [0, 1], [0, 0]], [[1, 1], [0, 1], [0, 0]],
    [[1, 1], [0, 1], [0, 0]], [[1, 0], [1, 1], [1, 0]], [[1, 1], [1, 0], [0, 0]],
    [[0, 0], [1, 0], [0, 0]], [[1, 0], [0, 0], [1, 0]], [[1, 1], [0, 1], [1, 1]],
    [[1, 1], [1, 0], [1, 1]], [[0, 0], [1, 0], [1, 1]], [[1, 0], [1, 1], [1, 0]],
    [[0, 0], [0, 1], [1, 1]], [[1, 0], [0, 0], [0, 1]], [[1, 0], [1, 1], [1, 0]],
    [[1, 1], [1, 0], [0, 0]], [[1, 1], [0, 1], [1, 1]], [[1, 1], [1, 0], [1, 1]],
    [[1, 0], [1, 1], [0, 1]], [[1, 0], [0, 0], [1, 0]], [[1, 1], [1, 0], [0, 0]],
    [[1, 1], [0, 1], [0, 0]], [[0, 0], [1, 0], [1, 1]], [[0, 0], [0, 1], [0, 0]],
    [[1, 0], [1, 1], [1, 0]], [[1, 0], [1, 1], [1, 0]],
]


class EnvTestTwoByTwoRobotPlanarDiskRandom:
    """reference :170-222."""

    GLOBAL_MODEL_IDS = [
        ["EnvEmptyNoWait2D-RobotPlanarDisk", "EnvConveyor2D-RobotPlanarDisk"],
        ["EnvHighways2D-RobotPlanarDisk", "EnvHighways2D-RobotPlanarDisk"],
    ]

    def get_planning_problem(self, num_agents, seed=None):
        s, g = _random_in_env("EnvHighways2D", num_agents, margin=0.2,
                              obstacle_margin=0.2, seed=seed)
        skeletons = [_TWO_BY_TWO_SKELETONS[i % len(_TWO_BY_TWO_SKELETONS)]
                     for i in range(num_agents)]
        return s, g, self.GLOBAL_MODEL_IDS, skeletons


_THREE_BY_THREE_SKELETONS = [
    [[1, 1], [2, 1], [2, 2]], [[1, 2], [1, 1], [1, 2]], [[1, 1], [1, 2], [1, 1]],
    [[2, 2], [1, 2], [1, 1]], [[1, 0], [1, 1], [1, 2]], [[1, 1], [2, 1], [1, 1]],
    [[1, 0], [2, 0], [1, 0]], [[1, 1], [1, 0], [0, 0]], [[1, 1], [1, 2], [2, 2]],
    [[1, 2], [2, 2], [1, 2]], [[2, 2], [2, 1], [2, 2]], [[2, 2], [2, 1], [1, 1]],
    [[1, 2], [1, 1], [1, 0]], [[0, 0], [1, 0], [1, 1]], [[0, 0], [0, 1], [1, 1]],
    [[1, 0], [1, 1], [1, 0]], [[2, 2], [1, 2], [2, 2]], [[1, 1], [0, 1], [1, 1]],
    [[1, 1], [1, 0], [1, 1]], [[0, 0], [0, 1], [0, 0]], [[1, 2], [0, 2], [1, 2]],
    [[1, 0], [0, 0], [1, 0]], [[0, 0], [1, 0], [0, 0]], [[1, 1], [0, 1], [0, 0]],
]


class EnvTestThreeByThreeRobotPlanarDiskRandom:
    """reference :224-280."""

    GLOBAL_MODEL_IDS = [
        ["EnvEmptyNoWait2D-RobotPlanarDisk", "EnvConveyor2D-RobotPlanarDisk",
         "EnvDropRegion2D-RobotPlanarDisk"],
        ["EnvHighways2D-RobotPlanarDisk", "EnvHighways2D-RobotPlanarDisk",
         "EnvHighways2D-RobotPlanarDisk"],
        ["EnvConveyor2D-RobotPlanarDisk", "EnvDropRegion2D-RobotPlanarDisk",
         "EnvEmptyNoWait2D-RobotPlanarDisk"],
    ]

    def get_planning_problem(self, num_agents, seed=None):
        s, g = _random_in_env("EnvHighways2D", num_agents, margin=0.2,
                              obstacle_margin=0.2, seed=seed)
        skeletons = [_THREE_BY_THREE_SKELETONS[i % len(_THREE_BY_THREE_SKELETONS)]
                     for i in range(num_agents)]
        return s, g, self.GLOBAL_MODEL_IDS, skeletons


PROBLEM_REGISTRY = {c.__name__: c for c in [
    EnvEmpty2DRobotPlanarDiskCircle, EnvEmpty2DRobotPlanarDiskBoundary,
    EnvEmpty2DRobotPlanarDiskRandom, EnvEmptyNoWait2DRobotPlanarDiskCircle,
    EnvConveyor2DRobotPlanarDiskBoundary, EnvConveyor2DRobotPlanarDiskRandom,
    EnvHighways2DRobotPlanarDiskRandom, EnvHighways2DRobotPlanarDiskSmallCircle,
    EnvDropRegion2DRobotPlanarDiskBoundary, EnvDropRegion2DRobotPlanarDiskRandom,
    EnvTestTwoByTwoRobotPlanarDiskRandom, EnvTestThreeByThreeRobotPlanarDiskRandom,
]}


def get_planning_problem(name: str, num_agents: int, seed: Optional[int] = None) -> Problem:
    """reference: mmd_experiment_configs.py:36-41."""
    return PROBLEM_REGISTRY[name]().get_planning_problem(num_agents, seed=seed)
