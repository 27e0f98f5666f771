"""ctypes bindings to the repository's native C++ RRT planners
(`native/rrt.cpp`), the twin of `mmd_tpu/datagen/native_rrt.py`.

The library is built with g++ at first use into `build/native/` at the
repository root (gitignored), written to a temporary name and renamed into
place, so that a concurrent process never loads a partial file. Where g++ is
missing or fails, `native_available()` is False and data generation takes
the Python planners (`mmd_torch/datagen/rrt.py`), as the JAX package does.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

from mmd_torch.ops.build import BUILD_DIR, REPO_ROOT

SOURCE = REPO_ROOT / "native" / "rrt.cpp"
LIBRARY = BUILD_DIR / "native" / "librrt.so"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def _build() -> bool:
    LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_name(f"{LIBRARY.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, LIBRARY)
        return True
    except (OSError, subprocess.SubprocessError):
        if tmp.exists():
            tmp.unlink()
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if missing or older than its
    source; None where it cannot be built or loaded."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    if not LIBRARY.exists() or LIBRARY.stat().st_mtime < SOURCE.stat().st_mtime:
        if not _build():
            _lib_failed = True
            return None
    try:
        lib = ctypes.CDLL(str(LIBRARY))
    except OSError:
        _lib_failed = True
        return None
    dp = ctypes.POINTER(ctypes.c_double)
    lib.rrt_connect_plan.restype = ctypes.c_int
    lib.rrt_connect_plan.argtypes = [
        dp, dp, ctypes.c_int, dp, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_int, ctypes.c_uint64, dp, dp, dp, ctypes.c_int]
    lib.rrt_star_plan.restype = ctypes.c_int
    lib.rrt_star_plan.argtypes = [
        dp, dp, ctypes.c_int, dp, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_uint64,
        dp, dp, dp, ctypes.c_int]
    _lib = lib
    return _lib


def native_available() -> bool:
    return get_lib() is not None


def _as_dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class _NativePlannerBase:
    """The `.optimize()` protocol of the Python planners."""

    MAX_PTS = 8192

    def __init__(self, checker, start_state_pos, goal_state_pos,
                 n_iters: int = 10000, step_size: float = 0.01,
                 n_radius: float = 0.05, seed: int = 0, max_time=None,
                 rewire_radius: float = 0.2, **_):
        self.boxes = np.ascontiguousarray(checker.centers, np.float64)
        self.half_sizes = np.ascontiguousarray(checker.half_sizes, np.float64)
        self.qlim = np.ascontiguousarray(
            np.concatenate([checker.q_min, checker.q_max]), np.float64)
        self.margin = float(checker.margin)
        self.start_state_pos = np.asarray(start_state_pos, np.float64)[:2].copy()
        self.goal_state_pos = np.asarray(goal_state_pos, np.float64)[:2].copy()
        self.n_iters = n_iters
        self.step_size = step_size
        self.n_radius = n_radius
        self.rewire_radius = rewire_radius
        self.seed = int(seed)

    def _lib(self) -> ctypes.CDLL:
        lib = get_lib()
        if lib is None:
            raise RuntimeError(f"the native RRT library ({SOURCE}) could not be built")
        return lib


class NativeRRTConnect(_NativePlannerBase):
    def optimize(self, **_) -> Optional[np.ndarray]:
        out = np.zeros((self.MAX_PTS, 2), np.float64)
        n = self._lib().rrt_connect_plan(
            _as_dp(self.boxes), _as_dp(self.half_sizes), len(self.boxes),
            _as_dp(self.qlim), self.margin, self.step_size, self.n_radius,
            self.n_iters, self.seed, _as_dp(self.start_state_pos),
            _as_dp(self.goal_state_pos), _as_dp(out), self.MAX_PTS)
        return out[:n].astype(np.float32) if n > 0 else None


class NativeRRTStar(_NativePlannerBase):
    def optimize(self, **_) -> Optional[np.ndarray]:
        out = np.zeros((self.MAX_PTS, 2), np.float64)
        n = self._lib().rrt_star_plan(
            _as_dp(self.boxes), _as_dp(self.half_sizes), len(self.boxes),
            _as_dp(self.qlim), self.margin, self.step_size, self.n_radius,
            self.rewire_radius, self.n_iters, self.seed,
            _as_dp(self.start_state_pos), _as_dp(self.goal_state_pos),
            _as_dp(out), self.MAX_PTS)
        return out[:n].astype(np.float32) if n > 0 else None
