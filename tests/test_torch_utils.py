"""The port's `utils` (timer, profiling, FLOP accounting) and the bench's
new settings, against the JAX package's
`mmd_tpu/utils/*` where they compute the same thing."""
import io
import json
import os
import stat
from contextlib import redirect_stdout

import pytest
import torch

from mmd_tpu.config import DiffusionConfig as JaxDiffusionConfig
from mmd_tpu.utils import baked
from mmd_torch import bench
from mmd_torch.config import DiffusionConfig, params as default_params
from mmd_torch.models.temporal_unet import init_unet
from mmd_torch.ops import build
from mmd_torch.utils import flops, profiling
from mmd_torch.utils.timer import TimerCuda

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("kw", [{}, {"sampler": "ddim"}, {"sampler": "ddim", "ddim_substeps": 8},
                                {"n_diffusion_steps": 10, "n_diffusion_steps_without_noise": 2}],
                         ids=["ddpm", "ddim", "ddim8", "short"])
@pytest.mark.parametrize("local", [False, True])
def test_loop_unet_evals_matches_jax_and_the_search_count(kw, local):
    n_local = default_params.n_local_inference_denoising_steps
    got = flops.loop_unet_evals(DiffusionConfig(**kw), local, n_local)
    # The port's count is the config's, which a search adds to
    # timing["unet_forwards"] (cbs.py _count_plans), the twin of
    # baked.UNET_EVALS.
    assert got == baked.loop_unet_evals(JaxDiffusionConfig(**kw), local, n_local)


def test_unet_forward_flops_counts_convolutions_and_matmuls():
    net = init_unet(torch.Generator().manual_seed(0), unet_input_dim=8, dim_mults=(1, 2),
                    device="cpu")
    f4 = flops.unet_forward_flops(net, 4, 32, 4)
    assert f4 > 0 and flops.unet_forward_flops(net, 8, 32, 4) == 2 * f4
    # The final 1x1 conv alone: 2 * B * H * C_in * C_out.
    assert f4 > 2 * 4 * 32 * 8 * 4
    ctx_net = init_unet(torch.Generator().manual_seed(0), unet_input_dim=8, dim_mults=(1, 2),
                        device="cpu", conditioning_type="attention", context_dim=6)
    assert flops.unet_forward_flops(ctx_net, 4, 32, 4, context_dim=6) > f4


def test_mfu_arithmetic_and_the_bench_fields():
    # 3640 forwards of 2.3357 GFLOP in 1.5 s on a 989.4 TFLOP/s card.
    pct = flops.mfu_pct(3640, 2.3357e9, 1.5, 989.4e12)
    assert pct == pytest.approx(100 * 3640 * 2.3357e9 / 1.5 / 989.4e12)
    assert flops.mfu_pct(3640, 2.3357e9, 1.5, None) is None
    assert flops.mfu_pct(3640, 2.3357e9, 0.0, 989.4e12) is None
    out = bench.flop_fields(3640, 2_335_703_040, 1.5, 989.4e12)
    assert out["unet_evals"] == 3640 and out["mfu_pct"] == pytest.approx(pct, rel=1e-4)
    assert out["model_gflops"] == pytest.approx(3640 * 2.33570304)
    assert bench.flop_fields(10, 1, 1.0, None)["mfu_pct"] is None


def test_bench_settings_and_watchdog_line():
    s = bench.settings({})
    assert (s["trace"], s["decompose"], s["timeout"]) == (None, False, 2700.0)
    s = bench.settings({"MMD_BENCH_TRACE": "/tmp/t",
                        "MMD_BENCH_DECOMPOSE": "1", "MMD_BENCH_TIMEOUT": "0.05",
                        "MMD_BENCH_PLANNER": "PP"})
    assert (s["trace"], s["decompose"], s["timeout"]) == ("/tmp/t", True, 0.05)
    exits, buf = [], io.StringIO()
    with redirect_stdout(buf):
        timer = bench.arm_watchdog(s, exit_fn=exits.append)
        timer.join(5.0)
    line = json.loads(buf.getvalue())
    # bench.py:110-115's keys, value null.
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "error"}
    assert line["metric"] == "10_robot_plan_wall_clock_PP" and line["value"] is None
    assert "watchdog: no result within 0s" in line["error"] and exits == [3]
    cancelled = bench.arm_watchdog(bench.settings({"MMD_BENCH_TIMEOUT": "60"}), exits.append)
    cancelled.cancel()
    assert exits == [3]


def test_bench_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the bench would run")
    assert bench.main() == 2
    assert "needs a CUDA card" in capsys.readouterr().err


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with profiling.profiler_trace(str(tmp_path / "trace")) as prof:
        (x @ x).sum()
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert os.path.dirname(prof.trace_path) == str(tmp_path / "trace")
    assert any("mm" in e.get("name", "") for e in events)


def _stub_nvcc(path, seconds):
    """An executable that sleeps, then writes the file after -o."""
    path.write_text("#!/bin/sh\n"
                    f"sleep {seconds}\n"
                    'while [ $# -gt 0 ]; do if [ "$1" = -o ]; then shift; : > "$1"; fi; '
                    "shift; done\n")
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return str(path)


def test_compile_time_monitor_counts_builds_that_run(tmp_path, monkeypatch):
    nvcc = _stub_nvcc(tmp_path / "nvcc", 0.2)
    monkeypatch.setattr(build, "find_nvcc", lambda: nvcc)
    src = tmp_path / "k.cu"
    src.write_text("// a source")
    with profiling.compile_time_monitor() as acc:
        (lib,) = build.build_shared_libraries([src], tmp_path / "out")
    assert lib.exists() and acc["compile_s"] >= 0.2
    kept = {"compile_s": 1.0}
    with profiling.compile_time_monitor(kept):
        build.build_shared_libraries([src], tmp_path / "out")  # built: no nvcc
    assert kept["compile_s"] == 1.0 and build.COMPILE_LISTENERS == []
    build.build_shared_libraries([src], tmp_path / "other")  # no monitor, no error


def test_timer_on_the_cpu():
    x = torch.randn(32, 32)
    with TimerCuda(device="cpu") as t:
        x @ x
    assert t.elapsed > 0
    with TimerCuda(sync_on_enter=False, device="cpu") as t2:
        pass
    assert t2.elapsed >= 0


def test_gpu_peak_flops(monkeypatch):
    assert profiling.gpu_peak_flops("cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    assert profiling.gpu_peak_flops() == 989.4e12
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "Another Card")
    assert profiling.gpu_peak_flops() is None

