"""RRT-Connect and RRT* for data generation (host-side numpy).

Twin of `mmd_tpu/datagen/rrt.py`, the same code: given the same
`np.random.Generator` they return the same path as the JAX package's
(reference: mp_baselines/planners/rrt_base.py:9, rrt_connect.py:93,
rrt_star.py:84): a pre-sampled buffer of free configurations, linspace
extend and collision checks, bidirectional connect with path retrace, and
rewiring for RRT*. They feed the hybrid data-generation planner; the
reference runs them on CPU workers too.
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

from mmd_torch.datagen.host_collision import HostCollisionChecker


class _Tree:
    def __init__(self, root: np.ndarray):
        self.nodes = [np.asarray(root, np.float32)]
        self.parents = [-1]

    def add(self, q: np.ndarray, parent: int) -> int:
        self.nodes.append(np.asarray(q, np.float32))
        self.parents.append(parent)
        return len(self.nodes) - 1

    def nearest(self, q: np.ndarray) -> int:
        arr = np.stack(self.nodes)
        return int(np.argmin(np.linalg.norm(arr - q, axis=-1)))

    def path_to(self, idx: int) -> List[np.ndarray]:
        path = []
        while idx != -1:
            path.append(self.nodes[idx])
            idx = self.parents[idx]
        return path[::-1]


class RRTConnect:
    """Bidirectional RRT (reference: rrt_connect.py:93-205)."""

    def __init__(self, checker: HostCollisionChecker,
                 start_state_pos, goal_state_pos,
                 n_iters: int = 10000, step_size: float = 0.01,
                 n_radius: float = 0.05, n_pre_samples: int = 50000,
                 max_time: float = 50.0, rng: Optional[np.random.Generator] = None):
        self.checker = checker
        self.start = np.asarray(start_state_pos, np.float32)[:2]
        self.goal = np.asarray(goal_state_pos, np.float32)[:2]
        self.n_iters = n_iters
        self.step_size = step_size
        self.n_radius = n_radius
        self.max_time = max_time
        self.rng = rng or np.random.default_rng(0)
        self.pre_samples = checker.sample_free(self.rng, min(n_pre_samples, 4096))
        self._sample_idx = 0

    def _sample(self) -> np.ndarray:
        if self._sample_idx >= len(self.pre_samples):
            self.pre_samples = self.checker.sample_free(self.rng, 4096)
            self._sample_idx = 0
        q = self.pre_samples[self._sample_idx]
        self._sample_idx += 1
        return q

    def _steer(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        d = b - a
        dist = np.linalg.norm(d)
        if dist <= self.n_radius:
            return b
        return a + d / dist * self.n_radius

    def _extend(self, tree: _Tree, q_target: np.ndarray) -> Optional[int]:
        near = tree.nearest(q_target)
        q_new = self._steer(tree.nodes[near], q_target)
        if self.checker.in_collision(q_new[None])[0]:
            return None
        if not self.checker.segment_free(tree.nodes[near], q_new, self.step_size):
            return None
        return tree.add(q_new, near)

    def optimize(self, **kwargs) -> Optional[np.ndarray]:
        if self.checker.in_collision(self.start[None])[0] or \
           self.checker.in_collision(self.goal[None])[0]:
            return None
        if self.checker.segment_free(self.start, self.goal, self.step_size):
            return np.stack([self.start, self.goal])
        t0 = time.time()
        ta, tb = _Tree(self.start), _Tree(self.goal)
        swapped = False
        for _ in range(self.n_iters):
            if time.time() - t0 > self.max_time:
                break
            q_rand = self._sample()
            idx_new = self._extend(ta, q_rand)
            if idx_new is not None:
                q_new = ta.nodes[idx_new]
                idx_b = self._connect(tb, q_new)
                if idx_b is not None:
                    path_a = ta.path_to(idx_new)
                    path_b = tb.path_to(idx_b)[::-1]
                    path = path_a + path_b
                    if swapped:
                        path = path[::-1]
                    return _dedupe(np.stack(path))
            ta, tb = tb, ta
            swapped = not swapped
        return None

    def _connect(self, tree: _Tree, q_target: np.ndarray) -> Optional[int]:
        last = None
        while True:
            idx = self._extend(tree, q_target)
            if idx is None:
                return last if last is not None and _close(tree.nodes[last], q_target, self.n_radius) else None
            last = idx
            if _close(tree.nodes[idx], q_target, 1e-6):
                return idx


class RRTStar(RRTConnect):
    """Single-tree RRT* with rewiring (reference: rrt_star.py:84-276)."""

    informed = False  # InfRRTStar flips this (reference rrt_star.py:103,273)

    def __init__(self, *args, rewire_radius: float = 0.2, **kwargs):
        super().__init__(*args, **kwargs)
        self.rewire_radius = rewire_radius

    def optimize(self, **kwargs) -> Optional[np.ndarray]:
        if self.checker.in_collision(self.start[None])[0] or \
           self.checker.in_collision(self.goal[None])[0]:
            return None
        t0 = time.time()
        tree = _Tree(self.start)
        costs = [0.0]
        goal_idx = None
        for it in range(self.n_iters):
            if time.time() - t0 > self.max_time:
                break
            # Goal bias.
            q_rand = self.goal if self.rng.random() < 0.1 else self._sample()
            if (self.informed and goal_idx is not None
                    and np.linalg.norm(self.start - q_rand)
                    + np.linalg.norm(q_rand - self.goal) >= costs[goal_idx]):
                # Informed rejection: only samples inside the prolate
                # hyperspheroid can improve the incumbent
                # (reference rrt_star.py:197).
                continue
            near = tree.nearest(q_rand)
            q_new = self._steer(tree.nodes[near], q_rand)
            if self.checker.in_collision(q_new[None])[0]:
                continue
            if not self.checker.segment_free(tree.nodes[near], q_new, self.step_size):
                continue
            # Choose best parent within the rewire radius.
            arr = np.stack(tree.nodes)
            d = np.linalg.norm(arr - q_new, axis=-1)
            neighbors = np.nonzero(d < self.rewire_radius)[0]
            best_parent, best_cost = near, costs[near] + d[near]
            for j in neighbors:
                c = costs[j] + d[j]
                if c < best_cost and self.checker.segment_free(tree.nodes[j], q_new, self.step_size):
                    best_parent, best_cost = int(j), c
            idx = tree.add(q_new, best_parent)
            costs.append(best_cost)
            # Rewire neighbors through the new node.
            for j in neighbors:
                c = best_cost + d[j]
                if c < costs[j] and self.checker.segment_free(q_new, tree.nodes[j], self.step_size):
                    tree.parents[j] = idx
                    costs[j] = c
            # Try to connect to goal.
            if _close(q_new, self.goal, self.n_radius) and \
               self.checker.segment_free(q_new, self.goal, self.step_size):
                c_goal = best_cost + np.linalg.norm(self.goal - q_new)
                if goal_idx is None or c_goal < costs[goal_idx]:
                    goal_idx = tree.add(self.goal, idx)
                    costs.append(c_goal)
                if not self.informed:
                    break  # first-solution semantics (datagen fast path)
        if goal_idx is None:
            return None
        return _dedupe(np.stack(tree.path_to(goal_idx)))


class InfRRTStar(RRTStar):
    """Informed RRT* (reference: rrt_star.py:273-276): anytime refinement —
    after the first solution, sampling is restricted to the prolate
    hyperspheroid of states that can shorten the incumbent, and better
    goal connections replace it until the iteration/time budget ends."""

    informed = True


class IdentityPlanner:
    """Returns a fixed skill waypoint sequence
    (reference: identity_planner.py:31-58)."""

    def __init__(self, skill_pos_seq: np.ndarray):
        self.skill = np.asarray(skill_pos_seq, np.float32)
        self.start_state_pos = self.skill[0]
        self.goal_state_pos = self.skill[-1]

    def optimize(self, **kwargs) -> np.ndarray:
        return self.skill.copy()


def _close(a, b, tol):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))) <= tol


def _dedupe(path: np.ndarray) -> np.ndarray:
    keep = [0]
    for i in range(1, len(path)):
        if np.linalg.norm(path[i] - path[keep[-1]]) > 1e-9:
            keep.append(i)
    return path[keep]
