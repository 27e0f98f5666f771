"""The port's span recorder (`mmd_torch.utils.profiling.recording`, `span`,
`count`) and the spans and counters the program marks: off by default,
nesting and sampler-call ids, one `sampler.call` with its `unet` forwards
for a batched call on the committed checkpoint (CPU, B = 2, two guide
iterations), the set-up spans, and `kernels.built` for a build that ran
nvcc; and what `tools/span_split.py` reads from spans beside a device
trace."""
import contextlib
import dataclasses
import os

import pytest
import torch

from benchmark.harness import trace
from mmd_torch.costs.constraints import empty_constraint_set
from mmd_torch.costs.guide import GuideData
from mmd_torch.ops import build
from mmd_torch.planners.single_agent.mpd import load_planners
from mmd_torch.utils import profiling
from test_torch_utils import _stub_nvcc
from tools import span_split

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_nothing_is_recorded_without_a_recording():
    assert profiling._RECORDING is None
    off = profiling.span("unet")
    assert off is profiling.span(profiling.SAMPLER_CALL)
    assert isinstance(off, contextlib.nullcontext)
    assert profiling.count("kernels.built") is None
    with profiling.recording() as rec:
        pass
    with profiling.span("unet"):
        profiling.count("kernels.built")
    assert rec.spans == [] and rec.counters == {} and profiling._RECORDING is None


def test_parents_call_ids_and_nested_calls():
    with profiling.recording() as rec:
        with profiling.span("kernels.load"):
            profiling.count("kernels.built", 2)
        for _ in range(2):
            with profiling.span(profiling.SAMPLER_CALL):
                with profiling.span("unet"):
                    pass
                with profiling.span(profiling.SAMPLER_CALL):  # the same call
                    with profiling.span("unet"):
                        pass
        with profiling.recording() as inner:             # joins the open one
            profiling.count("kernels.built")
    assert inner is rec and profiling._RECORDING is None
    got = [(s.name, s.parent, s.call) for s in rec.spans]
    assert got == [("kernels.load", -1, None),
                   ("sampler.call", -1, 0), ("unet", 1, 0), ("unet", 1, 0),
                   ("sampler.call", -1, 1), ("unet", 4, 1), ("unet", 4, 1)]
    assert rec.counters == {"kernels.built": 3}
    for s in rec.spans:
        outer = rec.spans[s.parent] if s.parent >= 0 else None
        assert s.start_ns <= s.end_ns
        assert outer is None or outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns


def test_a_batched_call_and_set_up_spans():
    starts, goals = [(-0.8, -0.8), (0.8, -0.8)], [(0.8, 0.8), (-0.8, 0.8)]
    with profiling.recording() as rec:
        planners = load_planners(os.path.join(ROOT, "data_trained_models"),
                                 os.path.join(ROOT, "data_trajectories"), "EnvEmptyNoWait2D",
                                 starts, goals, device="cpu")
        p0 = planners[0]
        p0.cfg = dataclasses.replace(p0.cfg, n_samples=2, n_guide_steps=2)
        gd = GuideData(scene=p0.scene, normalizer=p0.dataset.normalizer,
                       constraints=empty_constraint_set(1, 1, device="cpu"), soft_paths=None)
        n_setup = len(rec.spans)
        res = p0.plan_fresh_batch(gd, [p0.draw_noise(), p0.draw_noise()],
                                  torch.stack([p.hard_conds.values for p in planners]))
    assert res.trajs_final.shape[:2] == (2, 2)
    setup = rec.spans[:n_setup]
    assert sorted(s.name for s in setup) == ["checkpoint.load", "dataset.load",
                                             "planner.init", "planner.init"]
    assert all(s.call is None for s in setup)
    calls = [i for i, s in enumerate(rec.spans) if s.name == profiling.SAMPLER_CALL]
    assert len(calls) == 1
    unets = [s for s in rec.spans if s.name == "unet"]
    assert len(unets) == p0.cfg.n_unet_forwards()
    assert all(s.parent == calls[0] and s.call == rec.spans[calls[0]].call for s in unets)


def test_kernels_built_counts_the_libraries_nvcc_built(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "find_nvcc", lambda: _stub_nvcc(tmp_path / "nvcc", 0.0))
    srcs = [tmp_path / "a.cu", tmp_path / "b.cu"]
    for i, src in enumerate(srcs):
        src.write_text(f"// source {i}")
    with profiling.recording() as rec:
        build.build_shared_libraries(srcs, tmp_path / "out")
        build.build_shared_libraries(srcs, tmp_path / "out")  # built: no nvcc
    assert rec.counters == {"kernels.built": 2}


def _span_ctx(t0=100.0):
    """A 10 s window with two bracketed forwards, [1.2, 3.2] and [4.5, 6],
    6.8 s idle, and the program's spans: set-up, a warm-up call, then one
    sampler call over [0.5, 8] of the window whose UNet spans are [1, 2.5]
    and [3, 6.2] (the host stays in the second after its bracket closes)."""
    ns = lambda t: int(round(t * 1e9))
    rows = [("kernels.load", 90.0, 92.0, -1, None), ("checkpoint.load", 92.0, 93.0, -1, None),
            ("dataset.load", 93.0, 93.25, -1, None), ("planner.init", 93.25, 93.5, -1, None),
            ("sampler.call", 94.0, 99.0, -1, 0), ("unet", 94.5, 95.0, 4, 0),
            ("sampler.call", 100.5, 108.0, -1, 1), ("unet", 101.0, 102.5, 6, 1),
            ("unet", 103.0, 106.2, 6, 1)]
    s = trace.summarize([("spin_kernel", 0.0, 0.0), ("spin_kernel", 1.2, 1.25), ("conv", 1.3, 2.0),
                         ("gn", 2.6, 3.0), ("spin_kernel", 3.15, 3.2), ("guide", 3.5, 4.2),
                         ("spin_kernel", 4.5, 4.6), ("conv", 4.6, 5.5), ("spin_kernel", 5.9, 6.0),
                         ("copy", 7.0, 7.5)], 10.0, bracketed=True)
    s["busy_s"] = trace.busy_s(s["spans"], 0.0, 10.0)
    return {"trace": s, "t0": t0, "counters": {"kernels.built": 3},
            "spans": [(n, ns(a), ns(b), p, c) for n, a, b, p, c in rows]}


@pytest.mark.parametrize("t0, unet, sampler, caller", [(100.0, 1.7, 2.6, 2.5),
                                                       (100.5, 1.5, 2.8, 2.5)],
                         ids=["t0", "t0_later"])
def test_idle_split_partitions_the_idle_time(t0, unet, sampler, caller):
    # At t0 = 100. Inside the brackets, 1.5 s: the UNet's. Between them the
    # host is ahead over [1, 1.2] and [3, 4.5] (it opened the next forward
    # first), 0.8 s of idle: the sampler's. Elsewhere the host's own span:
    # the second UNet span over [6, 6.2], the call over [0.5, 1], [6.2, 7]
    # and [7.5, 8], the caller over [0, 0.5] and [8, 10]. Half a second
    # later every span sits half a second earlier in the window.
    ctx = _span_ctx(t0)
    got = span_split.readings(ctx)
    assert got["idle_unet_pct"] == pytest.approx(10 * unet)
    assert got["idle_sampler_pct"] == pytest.approx(10 * sampler)
    assert got["idle_caller_pct"] == pytest.approx(10 * caller)
    idle = 100.0 * (1.0 - ctx["trace"]["busy_s"] / ctx["trace"]["window_s"])
    parts = [got[f"idle_{p}_pct"] for p in ("unet", "sampler", "caller")]
    assert sum(parts) == pytest.approx(idle) and idle == pytest.approx(68.0)


def test_interval_arithmetic_splits_at_edges():
    assert span_split.idle([(0.0, 1.0), (2.0, 4.0)], 0.0, 5.0) == [(1.0, 2.0), (4.0, 5.0)]
    assert span_split.intersect([(1.0, 2.0), (4.0, 6.0)], [(1.5, 5.0)]) == [
        (1.5, 2.0), (4.0, 5.0)]
    assert span_split.subtract([(0.0, 10.0), (12.0, 15.0)], [(1.0, 2.0), (9.0, 13.0)]) == [
        (0.0, 1.0), (2.0, 9.0), (13.0, 15.0)]


def test_set_up_by_span():
    ctx = _span_ctx()
    got = span_split.readings(ctx)
    assert got["setup_kernels_s"] == pytest.approx(2.0)
    assert got["setup_load_s"] == pytest.approx(1.5)
    assert got["setup_first_call_s"] == pytest.approx(5.0)
    assert got["kernel_builds"] == 3
    ctx["counters"] = {}
    assert span_split.readings(ctx)["kernel_builds"] == 0


@pytest.mark.parametrize("ctx", [{}, {"trace": _span_ctx()["trace"]},
                                 {"spans": [], "counters": None, "t0": 0.0}],
                         ids=["nothing", "trace_no_recording", "empty_recording"])
def test_span_readings_find_nothing(ctx):
    assert set(span_split.readings(ctx).values()) == {None}


def test_idle_split_needs_the_forwards_paired():
    ctx = _span_ctx()
    ctx["spans"] = ctx["spans"][:-1]       # a bracket without its UNet span
    assert span_split.idle_split(ctx) is None
    ctx["spans"] = ctx["spans"][:6]        # set-up and the warm-up call alone
    assert span_split.idle_split(ctx) is None
