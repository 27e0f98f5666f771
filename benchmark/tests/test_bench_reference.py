"""The plain reference against the program on the CPU: the same raw
files and inputs give the same numbers, and the reference loads nothing
of the program."""
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.harness.checks import Reference
from benchmark.harness.common import ROOT, cell, program_paths
from benchmark.reference import finalize as ref_finalize
from benchmark.reference import sampler as rs

BATCH = "mpd-conveyor2d.batch100"


@pytest.fixture(scope="module")
def both():
    from mmd_torch.envs.envs import make_env
    from mmd_torch.train.checkpoint import load_checkpoint

    cfg = cell(BATCH)["config"]
    model, sch, info = load_checkpoint(program_paths(cfg)["model_dir"], device="cpu")
    return cfg, Reference(cfg, program_paths(cfg)["model_dir"], "cpu"), model, sch, \
        make_env(cfg["env"], "cpu")


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, benchmark.reference.unet, benchmark.reference.sampler, "
            "benchmark.reference.finalize, "
            "benchmark.reference.checkpoint; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('mmd_torch', 'mmd_tpu', 'jax', 'jaxlib', 'flax', 'optax')]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"


def test_unet_bitwise(both):
    cfg, ref, model, _, _ = both
    g = torch.Generator().manual_seed(3)
    x = torch.randn(96, cfg["horizon"], cfg["state_dim"], generator=g)
    t = torch.randint(0, 25, (96,), generator=g)
    with torch.no_grad():
        assert torch.equal(ref.unet(x, t), model(x, t))


def test_grid_schedule_and_normalizer(both):
    cfg, ref, _, sch, env = both
    assert torch.equal(ref.scene.values, env.grid.values)
    assert torch.equal(ref.scene.grads, env.grid.grads)
    for mine, theirs in [("sqrt_recip_ac", "sqrt_recip_alphas_cumprod"),
                         ("sqrt_recipm1_ac", "sqrt_recipm1_alphas_cumprod"),
                         ("log_var", "posterior_log_variance_clipped"),
                         ("coef1", "posterior_mean_coef1"), ("coef2", "posterior_mean_coef2")]:
        assert torch.equal(ref.sch[mine], getattr(sch, theirs)), mine


def test_guide_loop_matches_the_plain_version(both):
    from mmd_torch.costs.constraints import empty_constraint_set
    from mmd_torch.costs.guide import GuideConfig, GuideData, guide_loop_plain
    from mmd_torch.datasets.normalization import LimitsNormalizer
    from mmd_torch.models.diffusion import HardConds

    cfg, ref, _, _, env = both
    H = cfg["horizon"]
    g = torch.Generator().manual_seed(5)
    x = torch.clamp(torch.randn(3, 8, H, 4, generator=g) * 0.5, -1, 1)
    starts = torch.tensor([[-0.8, 0.0], [0.6, 0.5], [0.1, -0.8]])
    goals = torch.tensor([[0.8, 0.0], [-0.6, -0.5], [0.0, 0.8]])
    values = ref.values(starts, goals)[:, None]
    prog_norm = LimitsNormalizer(mins=ref.norm.mins, maxs=ref.norm.maxs)
    gd = GuideData(scene=env.scene, normalizer=prog_norm,
                   constraints=empty_constraint_set(1, 1, device="cpu"))
    gc = GuideConfig(dt=cfg["trajectory_duration"] / H, robot_radius=cfg["robot_radius"])
    want = guide_loop_plain(x, gd, HardConds(mask=ref.mask, values=values), gc, 20)
    got = rs.guide_loop(x, ref.norm, ref.scene, ref.mask, values, ref.guide, 20)
    assert torch.equal(got, want)


def test_finalize_matches_the_program(both):
    from mmd_torch.planners.single_agent.mpd import _finalize_plan
    from mmd_torch.datasets.normalization import LimitsNormalizer
    from mmd_torch.utils.interp import savgol_matrix

    cfg, ref, _, _, env = both
    g = torch.Generator().manual_seed(7)
    chain = torch.clamp(torch.randn(2, 3, 16, cfg["horizon"], 4, generator=g) * 0.3, -1, 1)
    prog = _finalize_plan(chain, LimitsNormalizer(mins=ref.norm.mins, maxs=ref.norm.maxs),
                          env.scene, cfg["robot_radius"], torch.tensor([-1.0, -1.0]),
                          torch.tensor([1.0, 1.0]),
                          torch.as_tensor(np.array(savgol_matrix(cfg["horizon"]))))
    fin = ref_finalize.finalize(ref.norm.unnormalize(chain[-1]), ref.scene, cfg["robot_radius"])
    assert torch.equal(fin["free"], prog.free_mask)
    assert torch.equal(fin["cost"], prog.cost_all)
    assert torch.equal(fin["best"], prog.idx_best)
    assert torch.equal(fin["smoothed"], prog.trajs_final)
