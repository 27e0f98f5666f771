"""A run function for the launcher tests that reports on its worker.

`worker_info` returns its process id, its arguments and `MARK`, which a
forked worker inherits from its parent (where a test sets it) and a
spawned one reads as imported. It lives at module level so that a
spawned worker can import it by name.
"""
import os

MARK = "imported"


def worker_info(seed=0, results_dir=".", **params):
    return {"pid": os.getpid(), "mark": MARK, "seed": seed, "results_dir": results_dir,
            **params}
