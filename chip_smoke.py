#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (`mmd_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Takes no arguments and reads no environment variables; paths resolve from
this file. Phases, one short line each:

1. card: name and power limit (nvidia-smi), torch and CUDA versions
2. build: the grid-SDF CUDA kernel, built with nvcc into build/
3. kernel: the kernel against its plain torch version on the EnvConveyor2D
   and EnvEmptyNoWait2D grids (out-of-range points, points on cell edges,
   ragged counts, and the guide's strided view of a (64, 64, 4) batch),
   which must agree exactly; both timed with CUDA events
4. slice: full-width MPD plans (B=64, H=64, 25+1 DDPM steps, guided steps
   x 20 guide iterations) on the EnvEmptyNoWait2D checkpoint for 3
   antipodal pairs of the 10-agent circle, and one EnvConveyor2D plan; each
   must grow the kernel's launch count by the expected amount, and every
   NoWait plan must succeed
5. replay: the first NoWait plan again on the CPU with the same noise,
   whose trajs_final must agree within CPU_TOL; the EnvConveyor2D plan again
   on the card with the lookup routed to its plain torch version, which must
   agree exactly; and the EnvConveyor2D plan on the CPU, reported beside the
   CPU's own change under a 1e-7 relative change of the initial noise
6. one JSON line of kernel numbers, then the contract line
   {"ok": true, "device": {...}}

Any failure raises and exits non-zero; a self-imposed deadline of
DEADLINE_S seconds does the same. Without a CUDA device it exits non-zero
and prints no result.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DEADLINE_S = 300
# Card against CPU on the NoWait plan: the map has no obstacles, so the
# sampler has no SDF cell edges to amplify a rounding difference; only the
# float32 summation orders of cuDNN and the CPU convolutions differ. Run on
# the CPU against JAX, the same plan agrees to ~1e-5. 1e-3 is 2% of the
# robot's radius (0.05), far below anything that changes a classification.
# On EnvConveyor2D a waypoint that a rounding difference moves across a cell
# edge reads another cell's gradient, and the guide amplifies that: the
# CPU's own plan moves by more than 1e-3 when its initial noise changes by
# 1e-7 relative. So there the lookup is held on the card, against its plain
# version in the same plan, exactly.
CPU_TOL = 1e-3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
KERNEL_SHAPE = (64, 63)    # guide points per grid: B=64 x 63 waypoints
NOWAIT_PAIRS = (0, 3, 6)   # of the 10-agent circle (multi_agent_utils.py:82-90)
CONVEYOR_TASK = ((-0.8, 0.0), (0.8, 0.0))  # straight through the centre box

_phase = ["start"]


def _on_deadline(signum, frame):
    print(f"chip_smoke: deadline of {DEADLINE_S} s passed in phase "
          f"'{_phase[0]}'", flush=True)
    raise TimeoutError(f"deadline passed in phase {_phase[0]}")


def phase(name: str):
    _phase[0] = name


def load_planner(env_name: str, start, goal, device: str):
    """The repository's checkpoint and dataset metadata as an MPD."""
    from mmd_torch.planners.single_agent.mpd import load_planner as load

    return load(os.path.join(ROOT, "data_trained_models"),
                os.path.join(ROOT, "data_trajectories"), env_name, start, goal, device)


def kernel_points(n: int, grid, seed: int):
    """n query points: uniform over [-1.2, 1.2]^2 (so some fall outside the
    grid), points exactly on cell edges, and the box corners and far points."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.2, 1.2, (n, 2)).astype(np.float32)
    lo = np.asarray(grid.lower, np.float32)
    span = np.asarray(grid.upper, np.float32) - lo
    k = rng.integers(0, grid.shape[0] + 1, (n // 4, 2)).astype(np.float32)
    pts[: n // 4] = lo + k / np.float32(grid.shape[0]) * span  # cell edges
    extra = np.array([[-1, -1], [1, 1], [-1, 1], [10, -10], [-10, 10]], np.float32)
    pts[n // 4: n // 4 + len(extra)] = extra
    return pts


def cuda_ms(fn, n_iter: int = 200, n_warm: int = 20) -> float:
    import torch

    for _ in range(n_warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n_iter):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_iter


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one NVIDIA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    signal.signal(signal.SIGALRM, _on_deadline)
    signal.alarm(DEADLINE_S)
    t_start = time.perf_counter()

    import numpy as np

    from mmd_torch.common.multi_agent_utils import get_start_goal_pos_circle
    from mmd_torch.envs.envs import make_env
    from mmd_torch.ops import sdf_kernel
    from mmd_torch.ops.build import find_nvcc
    from mmd_torch.ops.sdf_kernel import grid_lookup, grid_lookup_cuda, grid_lookup_plain

    # The port is compared against its CPU run: keep float32 convolutions
    # and matmuls out of TF32 on the card.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = "cuda"

    phase("card")
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    print(smi)
    print(f"card: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    phase("build")
    t0 = time.perf_counter()
    sdf_kernel.load_library()
    print(f"build: grid_sdf.cu with {find_nvcc()} in {time.perf_counter() - t0:.2f} s")

    phase("kernel")
    max_err = 0.0
    for env_name in ("EnvConveyor2D", "EnvEmptyNoWait2D"):
        scene = make_env(env_name, dev).scene
        tables = [(scene.grid.values, scene.grid.grads),
                  (scene.extra_grid.values, scene.extra_grid.grads)]
        batch = torch.from_numpy(kernel_points(64 * 64 * 2, scene.grid, 3)).to(dev)
        cases = {n: torch.from_numpy(kernel_points(n, scene.grid, n)).to(dev)
                 for n in (KERNEL_SHAPE[0] * KERNEL_SHAPE[1], 65536, 999)}
        cases["guide view"] = batch.reshape(64, 64, 4)[:, 1:, :2]  # as guide.py passes it
        for case, pts in cases.items():
            got = grid_lookup_cuda(pts, tables, scene.grid.lower, scene.grid.upper)
            want = grid_lookup_plain(pts, tables, scene.grid.lower, scene.grid.upper)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                err = float((g - w).abs().max())
                if not torch.equal(g, w):
                    raise RuntimeError(f"kernel != plain on {env_name}, {case}: "
                                       f"max abs err {err}")
                max_err = max(max_err, err)
        print(f"kernel: {env_name} equal to plain at 4032/65536/999 points and "
              f"the guide's (64, 63, 2) view of a (64, 64, 4) batch")

    scene = make_env("EnvConveyor2D", dev).scene
    tables = [(scene.grid.values, scene.grid.grads),
              (scene.extra_grid.values, scene.extra_grid.grads)]
    pts = torch.from_numpy(kernel_points(KERNEL_SHAPE[0] * KERNEL_SHAPE[1],
                                         scene.grid, 7)).to(dev).reshape(*KERNEL_SHAPE, 2)
    box = (scene.grid.lower, scene.grid.upper)
    k_ms = cuda_ms(lambda: grid_lookup_cuda(pts, tables, *box))
    p_ms = cuda_ms(lambda: grid_lookup_plain(pts, tables, *box))
    # Least bytes: each point read once, each distinct cell read once from
    # both grids (value 4 B + gradient 8 B), both outputs written once.
    i, j = sdf_kernel.cell_index(pts, scene.grid.shape, *box)
    n_pts = pts.numel() // 2
    n_cells = int(torch.unique(i * scene.grid.shape[1] + j).numel())
    bound_bytes = n_pts * 8 + len(tables) * 12 * (n_cells + n_pts)
    bound_ms = bound_bytes / HBM_BYTES_PER_S * 1e3
    print(f"kernel: {n_pts} pts x 2 grids: kernel {k_ms:.5f} ms, plain {p_ms:.5f} ms, "
          f"bound {bound_ms:.6f} ms ({bound_bytes} B)")

    phase("slice")
    starts, goals = get_start_goal_pos_circle(10)
    pairs = list(zip(starts, goals))
    nowait = [load_planner("EnvEmptyNoWait2D", *pairs[k], dev) for k in NOWAIT_PAIRS]
    conveyor = load_planner("EnvConveyor2D", *CONVEYOR_TASK, dev)
    cfg = nowait[0].cfg
    per_plan = cfg.n_guided_steps() * cfg.n_guide_steps + 1  # guide + finalize
    t0 = time.perf_counter()
    nowait[0]()  # warm-up
    print(f"slice: warm-up plan {time.perf_counter() - t0:.3f} s; expecting "
          f"{per_plan} launches a plan ({cfg.n_guided_steps()} guided steps x "
          f"{cfg.n_guide_steps} + 1 finalize)")
    # Noise of the plans that phase 5 replays on the CPU.
    replay = {0: nowait[0].draw_noise(), len(NOWAIT_PAIRS): conveyor.draw_noise()}
    grid_lookup.launches = 0  # main path starts
    runs = [(f"EnvEmptyNoWait2D pair {k}", p) for k, p in zip(NOWAIT_PAIRS, nowait)]
    runs.append(("EnvConveyor2D", conveyor))
    outs, plan_s = [], []
    for n, (label, planner) in enumerate(runs):
        before = grid_lookup.launches
        out = planner(noise=replay.get(n))
        grew = grid_lookup.launches - before
        outs.append(out)
        plan_s.append(out.t_total)
        print(f"slice: {label}: {out.t_total:.3f} s, success {out.success_free_trajs}, "
              f"fraction_free {out.fraction_free_trajs:.3f}, launches +{grew}")
        if grew != per_plan:
            raise RuntimeError(f"{label}: kernel launched {grew} times, expected {per_plan}")
        if not torch.isfinite(out.trajs_final).all() or out.trajs_final.shape != (
                cfg.n_samples, cfg.horizon, cfg.state_dim):
            raise RuntimeError(f"{label}: trajs_final not finite of the expected shape")
        if label.startswith("EnvEmptyNoWait2D") and out.success_free_trajs != 1:
            raise RuntimeError(f"{label}: no collision-free trajectory")
    main_launches = grid_lookup.launches  # main path ends

    phase("replay")

    def max_diff(a, b) -> float:
        return float((a.trajs_final.cpu() - b.trajs_final.cpu()).abs().max())

    def on_cpu(noise, scale=1.0):
        return type(noise)(x_T=noise.x_T.cpu() * scale, steps=noise.steps.cpu())

    cpu_out = load_planner("EnvEmptyNoWait2D", *pairs[NOWAIT_PAIRS[0]], "cpu")(
        noise=on_cpu(replay[0]))
    diff = max_diff(outs[0], cpu_out)
    print(f"replay: {runs[0][0]} on the CPU in {cpu_out.t_total:.3f} s, "
          f"max |trajs_final card - cpu| {diff:.3e} (tolerance {CPU_TOL})")
    if not diff <= CPU_TOL:
        raise RuntimeError(f"card and CPU plans differ by {diff} > {CPU_TOL}")

    n = len(NOWAIT_PAIRS)  # the EnvConveyor2D plan
    sdf_kernel.grid_lookup_cuda = grid_lookup_plain  # this replay only
    try:
        plain_out = conveyor(noise=replay[n])
    finally:
        sdf_kernel.grid_lookup_cuda = grid_lookup_cuda
    diff = max_diff(outs[n], plain_out)
    print(f"replay: {runs[n][0]} on the card with the plain lookup, "
          f"max |trajs_final kernel - plain| {diff:.3e} (tolerance 0)")
    if diff != 0.0:
        raise RuntimeError(f"the kernel's and the plain lookup's plans differ by {diff}")
    cpu_conveyor = load_planner("EnvConveyor2D", *CONVEYOR_TASK, "cpu")
    cpu_out = cpu_conveyor(noise=on_cpu(replay[n]))
    nudged = cpu_conveyor(noise=on_cpu(replay[n], 1.0 + 1e-7))
    print(f"replay: {runs[n][0]} max |trajs_final card - cpu| "
          f"{max_diff(outs[n], cpu_out):.3e}; cpu under a 1e-7 relative change "
          f"of x_T {max_diff(cpu_out, nudged):.3e} (reported, not held)")

    phase("report")
    kernels = [{
        "name": "grid_sdf_lookup", "route": "cuda", "source": "mmd_torch/csrc/grid_sdf.cu",
        "replaces": sdf_kernel.REPLACES, "launches": main_launches,
        "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
        "bound_by": "bytes", "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels, "plan_s": plan_s,
                      "total_s": round(time.perf_counter() - t_start, 3)}))
    signal.alarm(0)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
