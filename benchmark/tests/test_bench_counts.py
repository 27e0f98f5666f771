"""The benchmark's own arithmetic: FLOPs from shapes against PyTorch's
FlopCounterMode, the guide loop's bytes and operations, the busy and idle
arithmetic, the trace summary and the per-layer readers."""
import pytest
import torch

from benchmark.harness import counts, trace
from benchmark.harness.common import ROOT, cell
from benchmark.run import reader

@pytest.mark.parametrize("batch", [1, 3, 64])
def test_unet_flops_match_flop_counter(batch, workload="mpd-conveyor2d.batch100"):
    from mmd_torch.train.checkpoint import load_checkpoint
    from mmd_torch.utils.flops import unet_forward_flops

    cfg = cell(workload)["config"]
    model, _, _ = load_checkpoint(f"{ROOT}/{cfg['models_dir']}/{cfg['model_id']}", device="cpu")
    assert counts.unet_flops(cfg, batch) == unet_forward_flops(model, batch, cfg["horizon"],
                                                              cfg["state_dim"])


def test_guide_loop_work_by_hand():
    w = counts.guide_loop_work(G=2, B=3, H=5, n_iters=4, n_cells=7, hard_values=40)
    assert w["bytes"] == 4 * (2 * 2 * 3 * 5 * 4 + 5 + 40 + 8) + 24 * 7
    assert w["operations"] == 4 * (28 * 2 * 3 * 5 + 150 * 2 * 3 * 3)
    peak = counts.peaks("NVIDIA H100 80GB HBM3")
    assert counts.bound_s(w, peak, "float32") == max(w["bytes"] / 3.35e12,
                                                     w["operations"] / 67e12)
    assert counts.peaks("some other card") is None


def test_merge_and_busy():
    spans = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert trace.merge(spans) == [(0.0, 2.0), (3.0, 4.0)]
    assert trace.busy_s(spans) == pytest.approx(3.0)
    assert trace.busy_s(spans, 1.0, 3.5) == pytest.approx(1.5)


def _events():
    # window marker, then a bracketed forward of two kernels, a guide
    # loop, another forward, a copy.
    return [("spin_kernel", 0.0, 0.1), ("spin_kernel", 1.0, 1.1), ("conv", 1.2, 2.0),
            ("gn", 2.5, 3.0), ("spin_kernel", 3.1, 3.2), ("guide_loop_kernel(a)", 4.0, 5.0),
            ("spin_kernel", 6.0, 6.1), ("conv", 6.2, 7.2), ("spin_kernel", 7.3, 7.4),
            ("Memcpy DtoH", 8.0, 8.5)]


def test_summarize_brackets_and_counts():
    s = trace.summarize(_events(), 10.0, bracketed=True)
    assert s["kernels"] == 4
    assert s["forward_s"] == pytest.approx([1.3, 1.0])
    assert s["brackets"] == [(1.0, 3.2), (6.0, 7.4)]
    assert s["by_name"]["conv"] == [pytest.approx(1.8), 2]
    gaps = trace.idle_gaps(s["spans"], s["brackets"], 0.0, 10.0, "outside")
    assert sum(g for _, g in gaps) == pytest.approx(10.0 - trace.busy_s(s["spans"]))
    labels = {round(g, 6): label for label, g in gaps}
    assert labels[0.5] == "unet forward (host launches)"     # 2.0 .. 2.5
    b = trace.breakdown(s["by_name"], gaps)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    assert b["device_ops"][0][0] == "conv"


def test_readers_on_a_summary():
    s = trace.summarize(_events(), 10.0, bracketed=True)
    s["calls"], s["busy_s"] = 2, trace.busy_s(s["spans"], 0.0, 10.0)
    ctx = {"trace": s, "window_s": 2.0, "model_flops": 67e12, "precision": "float32",
           "device_name": "NVIDIA H100 80GB HBM3", "loop_cells": [10, 20],
           "loop_shape": (1, 2, 8), "n_guide": 20, "hard_values": 32}
    assert reader("kernels_per_call.batch")("kernels_per_call.batch", ctx) == 2.0
    assert reader("unet_ms.batch")("unet_ms.batch", ctx) == pytest.approx(1150.0)
    assert reader("guide_loop_us.batch")("guide_loop_us.batch", ctx) == pytest.approx(1e6)
    assert reader("mfu_pct.batch")("mfu_pct.batch", ctx) == pytest.approx(50.0)
    assert reader("device_idle_pct.batch")("device_idle_pct.batch", ctx) == pytest.approx(
        100 * (1 - s["busy_s"] / 10.0))
    roof = reader("guide_loop_roofline.batch")("guide_loop_roofline.batch", ctx)
    w = [counts.guide_loop_work(1, 2, 8, 20, c, 32) for c in (10, 20)]
    bound = sum(counts.bound_s(x, counts.PEAKS["H100"], "float32") for x in w) / 2
    assert roof == pytest.approx(100 * bound / 1.0)


def test_readers_find_nothing():
    empty = {"window_s": 1.0, "model_flops": 0, "precision": "float32", "device_name": "cpu"}
    for name in ("kernels_per_call.batch", "unet_ms.batch", "guide_loop_us.batch",
                 "guide_loop_roofline.batch", "mfu_pct.batch", "device_idle_pct.batch"):
        assert reader(name)(name, empty) is None, name


def test_no_tf32_restores():
    from benchmark.reference import no_tf32

    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    with no_tf32():
        assert not torch.backends.cudnn.allow_tf32
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == before
