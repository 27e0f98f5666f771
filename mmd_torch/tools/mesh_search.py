"""A CBS-family search on one device against the same search over n ranks.

Runs the 8-robot circle team's XECBS (`shard_cases.team_planners`,
float32) twice in this process without a mesh, then twice on each of n
spawned ranks (`parallel.sharding.spawn`) on an n-rank 'agent' mesh, all
from the same seeds. The first search of a process pays its cold start (the first
launch of each kernel, cuDNN's choice of algorithms); the second is warm.
For each of the two runs it prints the expansions, status, wall seconds
(`plan_s`) and the root's seconds waiting on the device (`device_root_s`)
of the unsharded search and of each rank, and whether every rank's paths
are bitwise equal to rank 0's and to the unsharded search's; then, on
the card, its name and power limit, and last one JSON line of those
numbers. It exits non-zero if a search fails or the ranks' paths differ.

    python -m mmd_torch.tools.mesh_search --n 4 --backend nccl --device cuda
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from mmd_torch.parallel.sharding import spawn
from mmd_torch.tools import shard_cases

RUNS = 2  # cold, then warm
NUM_AGENTS = 8


def compare(n: int, backend: str, device, team: dict) -> list:
    """Per run, the unsharded search's and the ranks' numbers (module
    docstring); `team` is `team_planners`'s keywords."""
    run = {"team": team, "search": {"is_ecbs": True, "is_xcbs": True}}
    alone = shard_cases.searches(torch.device(device), [run] * RUNS)
    ranks = spawn(shard_cases.search_case, n, backend, device,
                  [dict(run, mesh=[n], axes=("agent",))] * RUNS)
    rows = []
    for k in range(RUNS):
        ref, got = alone[k], [r[k] for r in ranks]
        keys = ("n_exp", "status", "plan_s", "root_wait_s")
        rows.append({"run": ("cold", "warm")[k],
                     "unsharded": {key: ref[key] for key in keys},
                     "ranks": [{key: g[key] for key in keys} for g in got],
                     "ranks_bitwise_equal": all(torch.equal(g["paths"], got[0]["paths"])
                                                for g in got),
                     "bitwise_equal_to_unsharded": torch.equal(got[0]["paths"], ref["paths"])})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="a search on one device against n ranks")
    ap.add_argument("--n", type=int, required=True, help="ranks")
    ap.add_argument("--backend", required=True, choices=["nccl", "gloo"])
    ap.add_argument("--device", required=True, help="cuda or cpu")
    args = ap.parse_args(argv)
    rows = compare(args.n, args.backend, args.device, {"n_agents": NUM_AGENTS})
    for row in rows:
        print(f"{row['run']}: unsharded {row['unsharded']}; ranks {row['ranks']}; ranks "
              f"bitwise equal {row['ranks_bitwise_equal']}, to the unsharded search "
              f"{row['bitwise_equal_to_unsharded']}")
    if torch.device(args.device).type == "cuda":
        print(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip())
    print(json.dumps({"n": args.n, "backend": args.backend, "num_agents": NUM_AGENTS,
                      "runs": rows}))
    ok = all(row["ranks_bitwise_equal"] and row["unsharded"]["status"] == "SUCCESS"
             and all(r["status"] == "SUCCESS" for r in row["ranks"]) for row in rows)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
