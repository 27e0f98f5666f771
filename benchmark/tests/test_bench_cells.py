"""The cell driven end to end on the CPU at a tiny size, through the
program's plain kernels: a sound run comes out correct; the bfloat16
control and each planted fault come out not correct. Also the command's
refusal without a card, and the import guard."""
import subprocess
import sys

import pytest

from benchmark.harness.common import FORBIDDEN, ROOT, cell, forbidden_loaded
from benchmark.run import runner
from benchmark.tests import faults

BATCH = "mpd-conveyor2d.batch100"
BATCH_SIZES = {"traffic": {"problems_per_call": 2, "check_calls": 2, "check_within_calls": 3,
                           "max_calls_per_s": 2},
               "config": {"n_samples": 8}}


def _correct(out):
    return all(v <= lim for v, lim in out["checks"].values())


def _small(workload, sizes):
    """The cell with a tiny size for the CPU: its config and traffic
    updated by `sizes`."""
    c = cell(workload)
    for part in ("config", "traffic"):
        c[part] = {**c[part], **sizes[part]}
    return c


def _batch(seed, **kw):
    c = _small(BATCH, BATCH_SIZES)
    return runner(c["traffic"]["kind"])(c, seed, 0.5, False, device="cpu", **kw)


def test_batch_cell_runs_correct():
    out = _batch(2 ** 40 + 17)
    assert _correct(out), out["checks"]
    assert out["attempted"] >= 2 and out["checked_calls"] >= 1
    assert out["e2e"]["plans_per_s"] > 0 and out["e2e"]["setup_s"] > 0
    assert out["layer"]["loop_cells"] and out["layer"]["model_flops"] > 0
    assert not forbidden_loaded()


def test_bf16_control_is_not_correct():
    out = _batch(99, bf16=True)
    assert not _correct(out)
    assert out["checks"]["unet_gap"][0] > out["checks"]["unet_gap"][1]


@pytest.mark.parametrize("fault, caught", [(faults.stuck_step, "step_gap"),
                                           (faults.half_batch, "unet_gap"),
                                           (faults.altered_choice, "final_gap")])
def test_batch_faults_are_not_correct(fault, caught, monkeypatch):
    fault(monkeypatch.setattr)
    out = _batch(12345)
    assert not _correct(out)
    assert out["checks"][caught][0] > out["checks"][caught][1], out["checks"]


def test_command_refuses_without_a_card_and_loads_no_jax():
    if __import__("torch").cuda.is_available():
        pytest.skip("this machine has a card: the refusal is for machines without one")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", BATCH,
                        "--seed", str(2 ** 33 + 1), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    code = ("import sys, benchmark.run, benchmark.harness.program, benchmark.control; "
            "benchmark.run.runner('batch'); "
            "import mmd_torch.planners.single_agent.mpd; "
            f"print([m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}])")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "mmd_tpu_lookalike", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "mmd_tpu.ops", sys)
    assert forbidden_loaded() == ["mmd_tpu.ops"]


@pytest.mark.gpu
def test_bf16_control_on_the_card_at_the_cells_size():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's own size")
    from benchmark.control import readings

    for seed, ok, vals, *_ in readings(BATCH, [101, 102, 103], 3.0, True):
        assert not ok, (seed, vals)
