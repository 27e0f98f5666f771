"""Render sweeps' analyzed_results*.pkl as markdown tables.

    python -m mmd_torch.tools.results_to_markdown results/<time_str> [--out table.md]

The twin of `scripts/results_to_markdown.py`: for the same .pkl the same
text (success rate, CT expansions, planning time and adherence per
agents x planner cell), for the JAX package's sweeps and the port's alike,
since both pickle plain dicts.
"""
from __future__ import annotations

import argparse
import glob
import os
import pickle
import sys


def render_dir(path: str) -> str:
    """Render every analyzed_results*.pkl in a sweep directory."""
    pkls = sorted(glob.glob(os.path.join(path, "analyzed_results*.pkl")))
    if not pkls:
        raise FileNotFoundError(f"no analyzed_results*.pkl in {path}")
    return "\n".join(render(p) for p in pkls)


def render(pkl_path: str) -> str:
    with open(pkl_path, "rb") as f:
        analyzed = pickle.load(f)
    planners = list(next(iter(analyzed.values())).keys())
    name = os.path.basename(pkl_path)[len("analyzed_results"):-len(".pkl")]
    name = name.strip("_") or os.path.basename(os.path.dirname(os.path.abspath(pkl_path)))
    lines = [f"### {name}", ""]
    lines += [
        "succ = success rate; exp = avg CT expansions; t = avg planning",
        "time (s); adh = avg data adherence (success-conditioned).", "",
        "| agents | " + " | ".join(planners) + " |",
        "|" + "---|" * (len(planners) + 1),
    ]
    for n, per in sorted(analyzed.items()):
        cells = []
        for p in planners:
            d = per[p]
            if not d["num_trials"]:
                cells.append("—")
                continue
            cells.append(
                f"succ {d['success_rate']:.2f}, exp {d['avg_ct_expansions']:.1f}, "
                f"t {d['avg_planning_time']:.1f}s, adh {d['avg_data_adherence']:.2f}")
        lines.append(f"| {n} | " + " | ".join(cells) + " |")
    lines.append("")
    return "\n".join(lines)


def parser() -> argparse.ArgumentParser:
    """The command's flags: the JAX script's, with its defaults, and the port's own."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("results_dirs", nargs="+",
                    help="results/<time_str> dirs holding analyzed_results*.pkl")
    ap.add_argument("--out", default=None)
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    text = "\n".join(render_dir(d) for d in args.results_dirs)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
