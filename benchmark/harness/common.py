"""What every cell shares: the manifest and the files it names, seeds, the
import guard and the device's description."""
from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import subprocess
import sys
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
# Whole top-level module names that a run may not load: JAX, its libraries
# and the JAX package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mmd_tpu")


def read_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> Dict:
    return read_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell(name: str) -> Dict:
    """The workload `name` with its configuration, traffic and metrics:
    {"workload", "config", "traffic", "end_to_end", "per_layer"}."""
    m = manifest()
    work = {w["name"]: w for w in m["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in m["configs"]}[w["config"]]

    def mine(metric):
        return name in metric.get("workloads", [name])

    return {"workload": w,
            "config": read_json(os.path.join(ROOT, conf["file"])),
            "traffic": read_json(os.path.join(BENCH_DIR, "traffic", w["traffic"] + ".json")),
            "end_to_end": [e for e in m["end_to_end"] if mine(e)],
            "per_layer": [p for p in m["per_layer"] if mine(p)]}


def load(folder: str, name: str):
    """The module `benchmark/<folder>/<name>.py`: a traffic kind's runner
    (`kinds`), a start and goal generator (`problems`) or a per-layer
    metric's reader (`metrics`), found by the name a file or the manifest
    gives."""
    path = os.path.join(BENCH_DIR, folder, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no benchmark/{folder}/{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def derive(seed: int, *keys) -> int:
    """A 63-bit seed for one use of the run's seed, e.g. derive(seed,
    "noise", call): the same arguments give the same seed."""
    digest = hashlib.sha256(repr((int(seed),) + keys).encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def forbidden_loaded() -> List[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def card_limit() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reads them, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out or None


def program_paths(cfg: Dict) -> Dict[str, str]:
    """The checkpoint and dataset directories the configuration names,
    under the checkout's root."""
    return {"models": os.path.join(ROOT, cfg["models_dir"]),
            "trajectories": os.path.join(ROOT, cfg["trajectories_dir"]),
            "model_dir": os.path.join(ROOT, cfg["models_dir"], cfg["model_id"])}
