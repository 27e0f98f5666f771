"""The port's sweep beside the JAX package's, cell by cell and trial by trial.

    python -m mmd_torch.tools.pair_sweeps <port results/<time_str>> [--jax <JAX results/<time_str>>]

For each (instance, agents, planner) cell of the port's sweep: the success
rate with its binomial standard error at n trials, the collisions over all
trials and the success-conditioned adherence, beside JAX's (read from its
`analyzed_results__<instance>.txt` as text, no JAX class unpickled); each
trial's status beside JAX's status of the same problem (its
results.txt, as text); the cell's mean CT expansions and root seconds (the
sum of `team_timing`'s `root_agent_s`), its plans and sampler calls, fresh
and local, and the local sampler calls an expansion; and the kernel
launches the cell's trials made, by their own counts of their sampler
calls (`expected_launches`).
"""
from __future__ import annotations

import argparse
import ast
import glob
import math
import os
import sys
from typing import Dict, List, Optional

from mmd_torch.config import DiffusionConfig
from mmd_torch.experiments.experiments import load_trial_result

PLANNER_DIR = "single_agent_planner___"


def text_status(path: str) -> Optional[str]:
    """The success_status line of a results.txt; None where it is missing."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        for line in f:
            if line.strip().startswith("success_status:"):
                return line.split(":", 1)[1].strip()
    return None


def text_aggregate(path: str) -> Dict:
    """{(agents, planner): analyzed dict} from an analyzed_results .txt."""
    out = {}
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            head, _, body = line.partition(": ")
            n, planner = (part.split("=", 1)[1] for part in head.split())
            out[(int(n), planner)] = ast.literal_eval(body)
    return out


def expected_launches(trials, grid_tiles: int, cfg: DiffusionConfig = DiffusionConfig()) -> Dict:
    """The kernel launches that the trials' plans make on the card, by the
    plan and sampler-call counts each trial saved (`team_timing`): the
    guide loop once a guided step of a sampler call (14 a fresh call and 4
    a local one at the default schedule, whatever its number of problems),
    no collision guide (its work runs inside the guide loop), the lookup
    once a tile a sampler call (the finalize), and once a grid tile for
    each of the team's two checks of its starts and goals."""
    per_fresh, per_local = cfg.n_guided_steps(), cfg.n_guided_steps(3)
    out = {"plans_fresh": 0, "plans_local": 0, "sampler_calls": 0, "guide_loop": 0,
           "collision_guide": 0, "grid_sdf_lookup": 0}
    for r in trials:
        t = r.team_timing
        fresh, local = t["plans_fresh"], t["plans_local"]
        calls, calls_local = t["sampler_calls"], t["sampler_calls_local"]
        n_tiles = {len(skeleton) for skeleton in r.agent_skeleton_l}
        if len(n_tiles) != 1:
            raise ValueError(f"skeletons of several lengths {n_tiles}: a plan's lookups "
                             f"are not one number")
        out["plans_fresh"] += fresh
        out["plans_local"] += local
        out["sampler_calls"] += calls
        out["guide_loop"] += per_fresh * (calls - calls_local) + per_local * calls_local
        out["grid_sdf_lookup"] += n_tiles.pop() * calls + 2 * grid_tiles
    return out


def trial_dirs(cell: str) -> List[str]:
    """A cell's trial directories, by trial number."""
    (sub,) = glob.glob(os.path.join(cell, PLANNER_DIR + "*"))
    return sorted(glob.glob(os.path.join(sub, "[0-9]*")), key=lambda d: int(os.path.basename(d)))


def pair(port_dir: str, jax_dir: Optional[str]) -> str:
    lines = []
    for agg in sorted(glob.glob(os.path.join(port_dir, "analyzed_results__*.txt"))):
        instance = os.path.basename(agg)[len("analyzed_results__"):-len(".txt")]
        ours = text_aggregate(agg)
        theirs = text_aggregate(os.path.join(jax_dir, os.path.basename(agg))) if jax_dir else {}
        lines += [f"### {instance}", "",
                  "| agents | planner | success (port +- se; JAX) | collisions, all trials "
                  "| adherence | expansions, mean | root s, mean | plans fresh / local | "
                  "sampler calls fresh / local | local calls an expansion | "
                  "launches guide loop / lookup | trials, port / JAX |",
                  "|---|---|---|---|---|---|---|---|---|---|---|---|"]
        for (n, planner), d in ours.items():
            rel = os.path.join(f"instance_name___{instance}", f"num_agents___{n}",
                               f"planner___{planner}")
            dirs = trial_dirs(os.path.join(port_dir, rel))
            trials = [load_trial_result(os.path.join(t, "results.pkl")) for t in dirs]
            ids = trials[0].global_model_ids
            k = expected_launches(trials, len(ids) * len(ids[0]))
            jd = theirs.get((n, planner), {})

            def beside(key, fmt):
                return f"{d[key]:{fmt}}; " + (f"{jd[key]:{fmt}}" if key in jd else "-")

            pairs = []
            for t in dirs:
                jt = glob.glob(os.path.join(jax_dir, rel, PLANNER_DIR + "*", os.path.basename(t),
                                            "results.txt")) if jax_dir else []
                jax_status = (text_status(jt[0]) if jt else None) or "-"
                pairs.append(f"{text_status(os.path.join(t, 'results.txt'))[:9]}/"
                             f"{jax_status[:9]}")
            n_exp = sum(r.num_ct_expansions for r in trials)
            root_s = sum(sum(r.team_timing.get("root_agent_s") or [0.0]) for r in trials)
            calls_local = sum(r.team_timing["sampler_calls_local"] for r in trials)
            per_exp = f"{calls_local / n_exp:.2f}" if n_exp else "-"
            se = math.sqrt(d["success_rate"] * (1 - d["success_rate"]) / d["num_trials"])
            success = beside("success_rate", ".2f").replace(";", f" +- {se:.2f};", 1)
            lines.append(f"| {n} | {planner} | {success} | "
                         f"{beside('avg_collisions_all_trials', '.2f')} | "
                         f"{beside('avg_data_adherence', '.4f')} | "
                         f"{n_exp / len(trials):.1f} | {root_s / len(trials):.2f} | "
                         f"{k['plans_fresh']} / {k['plans_local']} | "
                         f"{k['sampler_calls'] - calls_local} / {calls_local} | {per_exp} | "
                         f"{k['guide_loop']} / {k['grid_sdf_lookup']} | "
                         + ", ".join(pairs) + " |")
        lines.append("")
    return "\n".join(lines)


def parser() -> argparse.ArgumentParser:
    """The command's flags."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("port_dir", help="the port's results/<time_str>")
    ap.add_argument("--jax", default=None, help="the JAX package's results/<time_str>")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    print(pair(args.port_dir, args.jax))
    return 0


if __name__ == "__main__":
    sys.exit(main())
