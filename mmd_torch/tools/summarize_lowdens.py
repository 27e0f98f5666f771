"""Warm-time summary of a sweep directory.

    python -m mmd_torch.tools.summarize_lowdens [results/lowdens-r5-EnvHighways2D]

The twin of `scripts/summarize_lowdens.py`: for each (num_agents, planner)
cell of the results.pkl files under the directory, one line with the
success rate, the mean and median warm planning seconds (planning_time -
jit_compile_time: kernel builds left out) and the mean CT expansions. It
reads the port's result pickles (`experiments.load_trial_result`, which
refuses a pickle of the JAX package's classes).
"""
from __future__ import annotations

import glob
import os
import sys
from typing import List

import numpy as np


def summary_lines(root: str) -> List[str]:
    from mmd_torch.experiments.experiments import load_trial_result

    rows = {}
    for f in glob.glob(os.path.join(root, "**", "results.pkl"), recursive=True):
        r = load_trial_result(f)
        tc = r.trial_config
        rows.setdefault((tc.num_agents, tc.multi_agent_planner_class), []).append(r)
    lines = []
    for key in sorted(rows):
        rs = rows[key]
        warm = [x.planning_time - x.jit_compile_time for x in rs]
        succ = np.mean([str(x.success_status).endswith("SUCCESS") for x in rs])
        lines.append(f"n={key[0]:2d} {key[1]:6s} trials={len(rs)} success={succ:.2f} "
                     f"warm_mean={np.mean(warm):.2f}s warm_med={np.median(warm):.2f}s "
                     f"exp={np.mean([x.num_ct_expansions for x in rs]):.1f}")
    return lines


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    for line in summary_lines(argv[0] if argv else "results/lowdens-r5-EnvHighways2D"):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
