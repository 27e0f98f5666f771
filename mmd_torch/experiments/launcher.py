"""Experiment fan-out: local runs, sequential or in a process pool, or
SLURM batch scripts.

Twin of `mmd_tpu/experiments/launcher.py` (reference:
deps/experiment_launcher/experiment_launcher/launcher.py:16-296):
accumulate parameter dicts, then run each for `n_seeds` seeds locally or
write one SLURM array script per dict. Each run gets its own directory
with its scalar and list arguments saved as args.yaml.

Two differences from the JAX package, both forced by the card:
- The pool starts its workers with "spawn", not the default "fork": a
  forked child of a process that has used CUDA cannot use the card. So
  `exp_fn` must be importable by name (defined at module level), and each
  worker starts a fresh interpreter.
- args.yaml is written by `mmd_torch.io.flat_yaml`, as `yaml.safe_dump`
  writes it, since the card's machine has no PyYAML. A parameter that file
  cannot hold (an empty or a nested list) raises `ValueError` before the
  run starts.
"""
from __future__ import annotations

import multiprocessing
import os
import subprocess
import sys
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import Callable, Dict, List, Optional

from mmd_torch.io.flat_yaml import save_flat_yaml


def run_args(params: Dict, seed: int, run_dir: str) -> Dict:
    """What args.yaml holds: the scalar and list parameters, the seed and
    the run's directory."""
    return {**{k: v for k, v in params.items() if isinstance(v, (int, float, str, bool, list))},
            "seed": seed, "results_dir": run_dir}


def _run_one(payload):
    fn, params, results_dir, seed = payload
    run_dir = os.path.join(results_dir, str(seed))
    Path(run_dir).mkdir(parents=True, exist_ok=True)
    save_flat_yaml(os.path.join(run_dir, "args.yaml"), run_args(params, seed, run_dir))
    try:
        return fn(seed=seed, results_dir=run_dir, **params)
    except Exception as e:  # noqa: BLE001 - a sweep goes on past a failed run
        with open(os.path.join(run_dir, "error.txt"), "w") as f:
            f.write(repr(e))
        return e


class Launcher:
    """reference: launcher.py:16-296."""

    def __init__(self, exp_name: str, exp_fn: Optional[Callable] = None,
                 exp_file: Optional[str] = None, n_seeds: int = 1,
                 n_exps_in_parallel: int = 1,
                 base_dir: str = "./logs",
                 partition: Optional[str] = None, gres: Optional[str] = None,
                 memory_per_core: int = 2000, hours: int = 24):
        self.exp_name = exp_name
        self.exp_fn = exp_fn
        self.exp_file = exp_file
        self.n_seeds = n_seeds
        self.n_exps_in_parallel = n_exps_in_parallel
        self.base_dir = base_dir
        self.partition = partition
        self.gres = gres
        self.memory_per_core = memory_per_core
        self.hours = hours
        self._experiments: List[Dict] = []

    def add_experiment(self, **params):
        """reference: launcher.py:96-98."""
        self._experiments.append(params)

    def run(self, local: bool = True, test: bool = False):
        """reference: launcher.py:99-109. test=True dry-runs (prints only)."""
        if test:
            for params in self._experiments:
                for seed in range(self.n_seeds):
                    print(f"[dry-run] {self.exp_name} seed={seed} params={params}")
            return []
        if local:
            return self._run_local()
        return self._run_slurm()

    def _results_dir(self, params: Dict) -> str:
        tag = "_".join(f"{k}_{v}" for k, v in params.items()
                       if isinstance(v, (int, float, str, bool)))[:128]
        return os.path.join(self.base_dir, self.exp_name, tag or "default")

    def _run_local(self):
        """joblib-Parallel equivalent (reference: launcher.py:242-265), its
        workers spawned (module docstring)."""
        payloads = [(self.exp_fn, params, self._results_dir(params), seed)
                    for params in self._experiments
                    for seed in range(self.n_seeds)]
        if self.n_exps_in_parallel <= 1:
            return [_run_one(p) for p in payloads]
        with ProcessPoolExecutor(max_workers=self.n_exps_in_parallel,
                                 mp_context=multiprocessing.get_context("spawn")) as ex:
            return list(ex.map(_run_one, payloads))

    def generate_slurm(self, params: Dict) -> str:
        """reference: launcher.py:111-211."""
        results_dir = self._results_dir(params)
        Path(results_dir).mkdir(parents=True, exist_ok=True)
        lines = [
            "#!/bin/bash",
            f"#SBATCH --job-name={self.exp_name}",
            f"#SBATCH --array=0-{self.n_seeds - 1}",
            f"#SBATCH --time={self.hours}:00:00",
            f"#SBATCH --mem-per-cpu={self.memory_per_core}",
            f"#SBATCH --output={results_dir}/%a/slurm.out",
        ]
        if self.partition:
            lines.append(f"#SBATCH --partition={self.partition}")
        if self.gres:
            lines.append(f"#SBATCH --gres={self.gres}")
        arg_str = " ".join(f"--{k} {v}" for k, v in params.items())
        lines.append(f"{sys.executable} {self.exp_file} {arg_str} "
                     f"--seed $SLURM_ARRAY_TASK_ID --results_dir {results_dir}/$SLURM_ARRAY_TASK_ID")
        script_path = os.path.join(results_dir, "slurm.sh")
        with open(script_path, "w") as f:
            f.write("\n".join(lines) + "\n")
        return script_path

    def _run_slurm(self):
        paths = [self.generate_slurm(params) for params in self._experiments]
        for p in paths:
            subprocess.run(["sbatch", p], check=False)
        return paths
