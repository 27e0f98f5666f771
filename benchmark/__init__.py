"""The benchmark of the PyTorch and CUDA port, `mmd_torch`, on one H100.

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

See `benchmark/run.py`."""
