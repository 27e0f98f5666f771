"""Training throughput of the port on one card, with the reference recipe.

    python -m mmd_torch.tools.train_bench [--steps 500] [--chunk 100] [--out FILE]

Twin of `scripts/train_bench.py`: the same synthetic data (numpy
`default_rng(1)`, uniform in [-1, 1], 10000 x 64 x 4, taken as normalized
through the fixed [-1, 1] limits, no held-out prefix) and recipe (batch 128, UNet 32 x (1, 2, 4), 25
exponential steps, Adam 3e-4 + global-norm clip 1.0 + EMA 0.995), in
float32 and in bfloat16 compute. For each it prints steps a second and the
wall seconds of `--steps` steps run as `mmd_torch.train.trainer.
train_chunk` chunks of `--chunk` (after a warm-up chunk), ms a step by CUDA
events, the mean loss of the last chunk, FLOPs a step as
`torch.utils.flop_counter.FlopCounterMode` counts one step (the
convolutions and matmuls of forward and backward), kernels a step from a
`torch.profiler` trace of 5 steps (with its device busy time), and where a
step's time goes: the loss (forward), the gradients (backward) and the
update (clip, Adam, EMA), by CUDA events between them over 50 steps, and
`mfu_pct` = 100 * FLOPs a step * steps a second / the card's dense
bfloat16 peak (`peak_bf16_tflops`, `utils.profiling.gpu_peak_flops`; the
float32 row is quoted against it too, as scripts/train_bench.py:125-150
quotes both against the TPU's bf16 peak; null for a card the table lacks).
The JSON goes to stdout, and to `--out` if given. It needs a CUDA card: the
numbers are the card's. TF32 stays off.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from mmd_torch.datasets.trajectories import TrajectoryDataset
from mmd_torch.models.diffusion import diffusion_loss
from mmd_torch.models.schedules import make_schedule
from mmd_torch.models.temporal_unet import Bf16Forward, init_unet
from mmd_torch.tools.profile_plan import _busy_us, _traced
from mmd_torch.train import trainer
from mmd_torch.train.trainer import TrainConfig, TrainState, train_chunk
from mmd_torch.utils.flops import mfu_pct
from mmd_torch.utils.profiling import gpu_peak_flops
from mmd_torch.utils.timer import TimerCuda

# scripts/train_bench.py's synthetic data: default_rng(1), uniform in [-1, 1].
N_TRAJS, HORIZON, STATE_DIM = 10000, 64, 4


def traced_steps(step, n: int = 5):
    """n calls of `step` under the profiler: (wall s, the device events,
    the kernels among them: every event but copies and memsets)."""
    traced_s, events = _traced(lambda: [step() for _ in range(n)], host=False)
    kernels = [e for e in events if e.name and not e.name.startswith(("Memcpy", "Memset"))]
    return traced_s, events, kernels


def _parts_ms(state, forward, schedule, cfg, draw, n: int) -> dict:
    """Mean ms of a step's loss, gradients and update, by CUDA events."""
    marks = [[torch.cuda.Event(enable_timing=True) for _ in range(4)] for _ in range(n)]
    for ev in marks:
        batch, hard, t, noise = draw()
        ev[0].record()
        loss = diffusion_loss(forward, schedule, batch, hard, t, noise)
        ev[1].record()
        grads = torch.autograd.grad(loss, state.params)
        ev[2].record()
        trainer.apply_gradients(state, grads, cfg)
        ev[3].record()
    torch.cuda.synchronize()
    names = ("forward", "backward", "update")
    return {k: sum(ev[i].elapsed_time(ev[i + 1]) for ev in marks) / n
            for i, k in enumerate(names)}


def measure(bf16: bool, n_steps: int, chunk: int) -> dict:
    device = "cuda"
    cfg = TrainConfig(bf16=bf16)
    model = init_unet(torch.Generator().manual_seed(0), state_dim=STATE_DIM, device=device)
    schedule = make_schedule(cfg.variance_schedule, cfg.n_diffusion_steps, device=device)
    state = TrainState.create(model)
    forward = Bf16Forward(model) if bf16 else model
    data = np.random.default_rng(1).uniform(-1, 1, (N_TRAJS, HORIZON, STATE_DIM))
    dataset = TrajectoryDataset.from_trajs(data.astype(np.float32), "EnvEmptyNoWait2D",
                                           normalizer="FixedLimitsNormalizer", device=device)
    draw = trainer.StepDrawer(dataset, cfg, 0, torch.Generator(device=device).manual_seed(0))

    def step():
        trainer.train_step(state, forward, schedule, cfg, *draw())

    with FlopCounterMode(display=False) as counter:
        step()
    flops = counter.get_total_flops()
    train_chunk(state, forward, schedule, cfg, draw, chunk)  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    n_calls = max(1, n_steps // chunk)
    with TimerCuda() as timer:
        start.record()
        for _ in range(n_calls):
            loss = train_chunk(state, forward, schedule, cfg, draw, chunk)
        end.record()
    wall = timer.elapsed
    steps = n_calls * chunk
    traced_s, events, kernels = traced_steps(step)
    return {
        "steps_measured": steps, "wall_s": wall, "steps_per_sec": steps / wall,
        "ms_per_step": start.elapsed_time(end) / steps,
        "final_loss": float(loss), "loss_window": chunk,
        "train_step_flops": flops, "train_step_gflops": flops / 1e9,
        "kernels_per_step": len(kernels) / 5, "device_events_per_step": len(events) / 5,
        "busy_ms_per_step": _busy_us(events) / 1e3 / 5, "traced_wall_s_5_steps": traced_s,
        "parts_ms": _parts_ms(state, forward, schedule, cfg, draw, 50),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--chunk", type=int, default=100)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("train_bench: no CUDA device; the numbers are a card's")
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()
    peak = gpu_peak_flops()
    result = {"card": card, "device": torch.cuda.get_device_name(0),
              "peak_bf16_tflops": peak / 1e12 if peak else None,
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "recipe": {"batch_size": TrainConfig.batch_size, "horizon": HORIZON,
                         "state_dim": STATE_DIM,
                         "unet_input_dim": 32, "dim_mults": [1, 2, 4],
                         "n_diffusion_steps": 25,
                         "optimizer": "adam(3e-4) + global-norm clip 1.0 + EMA(0.995)",
                         "chunk": args.chunk, "data": f"default_rng(1) uniform [-1, 1], "
                                                       f"{N_TRAJS} x {HORIZON} x {STATE_DIM}"}}
    for bf16 in (False, True):
        row = measure(bf16, args.steps, args.chunk)
        row["mfu_pct"] = mfu_pct(row["steps_per_sec"], row["train_step_flops"], 1.0, peak)
        result["bf16" if bf16 else "f32"] = row
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
