"""The CUDA kernels on the card. Every test here needs a CUDA card (marker
`gpu`) and skips without one. The file imports neither JAX nor the JAX
package, so it also runs on a machine that has only the port's packages:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

(`--noconftest`: the suite's conftest.py configures JAX.) The grid-SDF
kernel must equal its plain torch version exactly: both compute the same
float32 index arithmetic and read the same cells. So must the
collision-guide kernel equal its plain version (the guide's autograd code,
run on the card over the plain torch lookup): it does the same float32 operations in the same order,
the clip's norm summed as (a^2 + b^2) + (c^2 + d^2), as torch's CUDA
reduction sums four channels. So must the guide-loop kernel equal
`guide_loop_plain`, which spells out its float32 operations (and its
fused multiply-adds through float64) one by one; the sampler's paths then
launch it once a guided step and the collision guide not at all.
"""
import dataclasses
import os
import warnings

import numpy as np
import pytest
import torch

from mmd_torch.common.multi_agent_utils import get_start_goal_pos_circle
from mmd_torch.costs import guide as guide_module
from mmd_torch.costs.constraints import empty_constraint_set
from mmd_torch.costs.guide import GuideConfig, GuideData, collision_guide_plain, guide_gradient, \
    guide_loop_plain
from mmd_torch.datasets.normalization import LimitsNormalizer
from mmd_torch.envs.envs import make_env
from mmd_torch.envs.grid_sdf import grid_sdf_pair
from mmd_torch.ops import sdf_kernel
from mmd_torch.ops.build import load_kernels
from mmd_torch.ops.collision_guide import collision_guide
from mmd_torch.ops.guide_loop import guide_loop_cuda, staging_bytes
from mmd_torch.ops.sdf_kernel import grid_lookup, grid_lookup_cuda, grid_lookup_plain
from mmd_torch.parallel.team import PrioritizedTeam, plan_prioritized_scan
from mmd_torch.planners.multi_agent.prioritized_planning import PrioritizedPlanning
from mmd_torch.planners.single_agent.mpd import load_planners
from mmd_torch.tools.guide_cases import HINGE_CUTOFF, LOOP_CASES, loop_case, tied_scene, \
    waypoints
from mmd_torch.tools.row_chunked import RowChunked

pytestmark = pytest.mark.gpu
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _counts():
    """(guide loops, collision guides, lookups) launched so far."""
    return guide_loop_cuda.launches, collision_guide.launches, grid_lookup.launches


def _grew(before):
    return tuple(a - b for a, b in zip(_counts(), before))


def _plain_kernels(monkeypatch):
    """Route every kernel's wrapper to its plain version."""
    monkeypatch.setattr(sdf_kernel, "grid_lookup_cuda", grid_lookup_plain)
    monkeypatch.setattr(guide_module, "collision_guide", collision_guide_plain)
    monkeypatch.setattr(guide_module, "guide_loop_cuda", guide_loop_plain)


def query_points(n: int, grid, seed: int) -> np.ndarray:
    """Uniform over [-1.2, 1.2]^2, a quarter exactly on cell edges, plus the
    corners and far-away points."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.2, 1.2, (n, 2)).astype(np.float32)
    lo = np.asarray(grid.lower, np.float32)
    span = np.asarray(grid.upper, np.float32) - lo
    k = rng.integers(0, grid.shape[0] + 1, (n // 4, 2)).astype(np.float32)
    pts[: n // 4] = lo + k / np.float32(grid.shape[0]) * span
    extra = np.array([[-1, -1], [1, 1], [-1, 1], [10, -10], [-10, 10]], np.float32)
    pts[n // 4: n // 4 + len(extra)] = extra
    return pts


@pytest.mark.parametrize("env_name", ["EnvConveyor2D", "EnvHighways2D", "EnvEmptyNoWait2D"])
@pytest.mark.parametrize("n", [4032, 65536, 999, 7])
def test_kernel_equals_plain(env_name, n):
    _need_card()
    scene = make_env(env_name, "cuda").scene
    tables = [(scene.grid.values, scene.grid.grads),
              (scene.extra_grid.values, scene.extra_grid.grads)]
    pts = torch.from_numpy(query_points(n, scene.grid, n)).cuda()
    got = grid_lookup_cuda(pts, tables, scene.grid.lower, scene.grid.upper)
    want = grid_lookup_plain(pts, tables, scene.grid.lower, scene.grid.upper)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_kernel_counts_its_launches_and_reads_a_strided_view():
    _need_card()
    scene = make_env("EnvConveyor2D", "cuda").scene
    tables = [(scene.grid.values, scene.grid.grads),
              (scene.extra_grid.values, scene.extra_grid.grads)]
    x = torch.from_numpy(query_points(64 * 64 * 2, scene.grid, 3)).cuda().reshape(64, 64, 4)
    views = {
        "guide": x[:, 1:, :2],   # the guide's waypoints 1..H-1, positions only
        "offset": x[:, 1:, 1:3],  # starts 4 bytes into a float2
        # contiguous, but not 8-byte aligned: the wrapper must copy it
        "unaligned": x.reshape(-1)[1:1 + 2 * 999].reshape(999, 2),
    }
    for name, q in views.items():
        before = grid_lookup.launches
        got = grid_lookup(q, tables, scene.grid.lower, scene.grid.upper)
        assert grid_lookup.launches == before + 1, name
        want = grid_lookup_plain(q, tables, scene.grid.lower, scene.grid.upper)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), name


def test_autograd_on_the_card_matches_the_cpu():
    _need_card()
    rng = np.random.default_rng(5)
    pts = rng.uniform(-1.1, 1.1, (64, 63, 2)).astype(np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        scene = make_env("EnvConveyor2D", dev).scene
        x = torch.from_numpy(pts).to(dev).requires_grad_(True)
        a, b = grid_sdf_pair(scene.grid, scene.extra_grid, x)
        torch.minimum(a, b).sum().backward()
        out[dev] = (a.detach().cpu(), x.grad.cpu())
    assert torch.equal(out["cpu"][0], out["cuda"][0])
    assert torch.equal(out["cpu"][1], out["cuda"][1])


def _collision_case(name: str, cutoff: float):
    cfg = GuideConfig(obstacle_cutoff_margin=cutoff)
    scene = make_env("EnvConveyor2D" if name == "tied" else name, "cuda").scene
    if name == "tied":
        scene = tied_scene(scene, cfg.collision_margin)
    return scene, cfg


@pytest.mark.parametrize("cutoff", [0.01, HINGE_CUTOFF], ids=["default", "hinge"])
@pytest.mark.parametrize("shape", [(64, 64, 4), (3, 64, 64, 4), (5, 2, 4)],
                         ids=["64x64", "3x64x64", "H=2"])
@pytest.mark.parametrize("name", ["EnvConveyor2D", "EnvEmptyNoWait2D", "tied"])
def test_collision_guide_matches_plain(name, shape, cutoff, monkeypatch):
    _need_card()
    scene, cfg = _collision_case(name, cutoff)
    u = torch.from_numpy(waypoints(shape, scene, cfg.collision_margin, len(shape))).cuda()
    got = collision_guide(u, scene, cfg)
    # The plain version's lookup in plain torch too: the kernel is held
    # against plain torch only.
    monkeypatch.setattr(sdf_kernel, "grid_lookup_cuda", grid_lookup_plain)
    want = collision_guide_plain(u, scene, cfg)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert torch.equal(got, want)
    assert not got[..., 2:].any()


def test_collision_guide_counts_its_launches_and_refuses_a_strided_view():
    _need_card()
    scene, cfg = _collision_case("EnvConveyor2D", 0.01)
    u = torch.from_numpy(waypoints((64, 64, 4), scene, cfg.collision_margin, 1)).cuda()
    before = collision_guide.launches
    for n in range(1, 4):
        collision_guide(u, scene, cfg)
        assert collision_guide.launches == before + n
    strided = torch.zeros(64, 64, 8, device="cuda")[..., :4]
    with pytest.raises(ValueError):
        collision_guide(strided, scene, cfg)
    assert collision_guide.launches == before + 3


def test_guide_gradient_makes_one_collision_launch_and_no_lookup():
    _need_card()
    scene = make_env("EnvConveyor2D", "cuda").scene
    gd = GuideData(scene=scene,
                   normalizer=LimitsNormalizer.from_limits([-1] * 4, [1] * 4, "cuda"),
                   constraints=empty_constraint_set(1, 1, device="cuda"))
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (64, 64, 4)).astype(np.float32)).cuda()
    lookups, collisions = grid_lookup.launches, collision_guide.launches
    guide_gradient(x, gd, GuideConfig())
    assert collision_guide.launches == collisions + 1
    assert grid_lookup.launches == lookups


def test_pp_team_pass_launches_per_agent_syncs_nothing_and_replays_exactly(monkeypatch):
    """The PP device pass at 3 agents, B=8, 2 guide iterations a step: each
    agent launches the guide loop once per guided step, no collision guide
    and the lookup once, the loop makes no host sync (torch's sync debug
    mode reports none), and with every kernel routed to its plain version
    the pass is equal."""
    _need_card()
    starts, goals = get_start_goal_pos_circle(3)
    planners = load_planners(os.path.join(ROOT, "data_trained_models"),
                             os.path.join(ROOT, "data_trajectories"), "EnvEmptyNoWait2D",
                             starts, goals, device="cuda")
    for p in planners:
        p.cfg = dataclasses.replace(p.cfg, n_samples=8, n_guide_steps=2)
    pp = PrioritizedPlanning(planners, starts, goals)
    team = PrioritizedTeam.of(planners, pp.margin)
    plan_prioritized_scan(team, pp._team_noise())  # builds and warms up
    noise = pp._team_noise()
    before = _counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = plan_prioritized_scan(team, noise)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert not [w for w in caught
                if "called a synchronizing CUDA operation" in str(w.message)]
    assert _grew(before) == (3 * planners[0].cfg.n_guided_steps(), 0, 3)
    assert len(out.clock.seconds()) == 3
    _plain_kernels(monkeypatch)
    plain = plan_prioritized_scan(team, noise)
    assert torch.equal(out.trajs, plain.trajs) and torch.equal(out.ix, plain.ix)


def _sync_warnings(caught):
    return [w for w in caught if "called a synchronizing CUDA operation" in str(w.message)]


def test_xecbs_search_launches_by_plan_kind_syncs_only_to_read_and_replays_exactly(
        monkeypatch):
    """A 3-agent XECBS search on the dense circle (B=8, 2 guide iterations a
    step, the bfloat16 UNet): the guide loop launches once per guided step
    of each sampler call (fresh and local, by the search's own count; a
    chain step's two children are one call), the collision guide never and
    the lookup once per call; every host sync of the search comes from
    `cbs.to_host`; with the generators restored and every kernel routed to
    its plain version the search is equal."""
    _need_card()
    import inspect

    from mmd_torch.planners.multi_agent import cbs as cbs_module
    from mmd_torch.planners.multi_agent.cbs import CBS

    starts, goals = get_start_goal_pos_circle(3, radius=0.3)
    planners = load_planners(os.path.join(ROOT, "data_trained_models"),
                             os.path.join(ROOT, "data_trajectories"), "EnvEmptyNoWait2D",
                             starts, goals, device="cuda", bf16=True)
    for p in planners:
        p.cfg = dataclasses.replace(p.cfg, n_samples=8, n_guide_steps=2)
    load_kernels()
    CBS(planners, starts, goals, is_ecbs=True, is_xcbs=True).plan()  # warm-up
    kept = [p._generator.get_state() for p in planners]
    search = CBS(planners, starts, goals, is_ecbs=True, is_xcbs=True)
    before = _counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            paths, n_exp, status, _ = search.plan()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    lines, first = inspect.getsourcelines(cbs_module.to_host)
    stray = [f"{w.filename}:{w.lineno}" for w in _sync_warnings(caught)
             if not (w.filename == cbs_module.__file__
                     and first <= w.lineno < first + len(lines))]
    assert not stray, stray
    cfg, t = planners[0].cfg, search.timing
    local = t["sampler_calls_local"]
    fresh = t["sampler_calls"] - local
    want = (cfg.n_guided_steps() * fresh + cfg.n_guided_steps(3) * local, 0, fresh + local)
    assert _grew(before) == want
    assert t["plans_fresh"] >= 3 and len(paths) == 3
    final = search.final
    for p, state in zip(planners, kept):
        p._generator.set_state(state)
    _plain_kernels(monkeypatch)
    replay = CBS(planners, starts, goals, is_ecbs=True, is_xcbs=True)
    _, n_exp2, status2, _ = replay.plan()
    assert (n_exp2, status2) == (n_exp, status)
    assert replay.final.ix_best == final.ix_best
    assert torch.equal(replay.final.paths_all, final.paths_all)


def test_greedy_chain_on_the_card_syncs_only_to_read(monkeypatch):
    """One greedy chain on the card (XECBS, 3-agent dense circle, B=8, 2
    guide iterations a step) from the split root: every host sync of the
    call comes from `cbs.to_host`, one flag read a step and the records'
    read; the guide loop launches once per guided step of each step's
    sampler call (both children), the collision guide never and the lookup
    once per call."""
    _need_card()
    import inspect

    from mmd_torch.planners.multi_agent import cbs as cbs_module
    from mmd_torch.planners.multi_agent.cbs import CBS

    starts, goals = get_start_goal_pos_circle(3, radius=0.3)
    planners = load_planners(os.path.join(ROOT, "data_trained_models"),
                             os.path.join(ROOT, "data_trajectories"), "EnvEmptyNoWait2D",
                             starts, goals, device="cuda", bf16=True)
    for p in planners:
        p.cfg = dataclasses.replace(p.cfg, n_samples=8, n_guide_steps=2)
    load_kernels()
    search = CBS(planners, starts, goals, is_ecbs=True, is_xcbs=True)
    search._reset_timing()
    status, root = search._plan_root(lambda: False)
    assert root.has_paths and root.n_conflicts > 0
    search.greedy_audit = []
    before = _counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            accepted = search._expand_greedy(root)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    lines, first = inspect.getsourcelines(cbs_module.to_host)
    stray = [f"{w.filename}:{w.lineno}" for w in _sync_warnings(caught)
             if not (w.filename == cbs_module.__file__
                     and first <= w.lineno < first + len(lines))]
    assert not stray, stray
    t = search.timing
    assert accepted >= 1 and search.greedy_audit[0][0] == "step"
    children, calls = t["plans_local"], t["sampler_calls_local"]
    assert children >= 2 and children == 2 * calls  # a step's two children, one call
    assert t["device_greedy_calls"] <= calls + 1
    cfg = planners[0].cfg
    assert _grew(before) == (cfg.n_guided_steps(3) * calls, 0, calls)


@pytest.mark.parametrize("shape", [(64, 379), (640, 379)], ids=["plan", "batched"])
def test_lookup_equals_plain_at_the_finalize_shapes(shape):
    """The redesigned lookup at a plan's and a 10-problem batched
    finalize's points: exactly the plain version, one launch a call."""
    _need_card()
    scene = make_env("EnvConveyor2D", "cuda").scene
    tables = [(scene.grid.values, scene.grid.grads),
              (scene.extra_grid.values, scene.extra_grid.grads)]
    pts = torch.from_numpy(query_points(shape[0] * shape[1], scene.grid, 11)).cuda()
    pts = pts.reshape(*shape, 2)
    want = grid_lookup_plain(pts, tables, scene.grid.lower, scene.grid.upper)
    before = grid_lookup.launches
    got = grid_lookup_cuda(pts, tables, scene.grid.lower, scene.grid.upper)
    torch.cuda.synchronize()
    assert grid_lookup.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert sdf_kernel.packed_cells(tables) is scene.guide_table.cells


def test_batched_call_launches_once_and_matches_looped_steps():
    """Three agents' fresh plans as one sampler call on the card (B=8, 2
    guide iterations a step): one guide-loop launch a guided step, no
    collision guide and one lookup for all three; each DDPM step of its
    chain, with the UNet
    run 8 rows at a time (cuDNN chooses its convolution algorithm by batch
    size), against the agent's single step fed the same x, within 1e-3."""
    _need_card()
    from mmd_torch.models import diffusion
    from mmd_torch.models.diffusion import HardConds, SamplerNoise

    starts, goals = get_start_goal_pos_circle(3, radius=0.3)
    planners = load_planners(os.path.join(ROOT, "data_trained_models"),
                             os.path.join(ROOT, "data_trajectories"), "EnvEmptyNoWait2D",
                             starts, goals, device="cuda")
    for p in planners:
        p.cfg = dataclasses.replace(p.cfg, n_samples=8, n_guide_steps=2)
    load_kernels()
    team = PrioritizedTeam.of(planners, planners[0].robot.rr_margin)
    p0, cfg = team.p0, planners[0].cfg
    g = torch.Generator(device="cuda").manual_seed(0)
    noise_l = [SamplerNoise.draw(cfg, g, "cuda") for _ in range(3)]
    before = _counts()
    res = team.plan_problems(noise_l)
    assert res.trajs_final.shape[:2] == (3, 8)
    assert _grew(before) == (cfg.n_guided_steps(), 0, 1)
    hard = HardConds(mask=team.hard_team.mask, values=team.hard_team.values[:, None])
    gd = GuideData(scene=p0.scene, normalizer=p0.dataset.normalizer,
                   constraints=team.base_cset)
    noise = SamplerNoise.stack(noise_l)
    _, chain = diffusion.guided_p_sample_loop(RowChunked(p0.model, cfg.n_samples), p0.schedule,
                                              hard, cfg, noise, gd=gd, guide_cfg=p0.guide_cfg)
    for k, i in enumerate(cfg.step_indices()):
        for a in range(3):
            single = diffusion._ddpm_step(
                p0.model, p0.schedule, chain[k, a], i, noise.steps[k, a],
                HardConds(mask=hard.mask, values=team.hard_team.values[a]), gd, cfg,
                p0.guide_cfg, i < cfg.t_start_guide)
            assert float((single - chain[k + 1, a]).abs().max()) <= 1e-3, (i, a)


def test_bf16_forward_on_the_card_is_within_its_tolerance_of_f32():
    """The bfloat16 UNet on the card (cuDNN's bf16 convolutions) against
    the float32 forward at B=64: within BF16_TOL of the largest |eps|, the
    tolerance tests/test_torch_unet.py holds the CPU's bf16 forward to
    against JAX's (measured there: 0.7%)."""
    _need_card()
    from mmd_torch.models.temporal_unet import bf16_model
    from mmd_torch.train.checkpoint import load_checkpoint

    model, _, _ = load_checkpoint(os.path.join(ROOT, "data_trained_models",
                                               "EnvEmptyNoWait2D-RobotPlanarDisk"), device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    x = torch.randn((64, 64, 4), generator=g, device="cuda")
    t = torch.arange(64, device="cuda") % 25
    with torch.no_grad():
        got, want = bf16_model(model)(x, t), model(x, t)
    assert got.dtype == torch.float32
    assert float((got - want).abs().max() / want.abs().max()) <= 2e-2


# ------------------------------------------------------------ multi-tile
STACKED = ("EnvConveyor2D", "EnvHighways2D", "EnvEmptyNoWait2D")


@pytest.mark.parametrize("cutoff", [0.01, HINGE_CUTOFF], ids=["default", "hinge"])
def test_stacked_collision_guide_matches_plain(cutoff, monkeypatch):
    """Three scenes stacked (T = 3) at (3, 64, 64, 4): one launch, equal to
    the plain version tile by tile; T = 1 equals the single-scene call."""
    _need_card()
    from mmd_torch.envs.envs import SceneStack

    cfg = GuideConfig(obstacle_cutoff_margin=cutoff)
    scenes = [make_env(e, "cuda").scene for e in STACKED]
    stack = SceneStack(tuple(scenes))
    u = torch.from_numpy(np.stack([waypoints((64, 64, 4), sc, cfg.collision_margin, 7 + m)
                                   for m, sc in enumerate(scenes)])).cuda()
    before = collision_guide.launches
    got = collision_guide(u, stack, cfg)
    assert collision_guide.launches == before + 1
    one = collision_guide(u[:1].contiguous(), SceneStack((scenes[0],)), cfg)
    single = collision_guide(u[0].contiguous(), scenes[0], cfg)
    monkeypatch.setattr(sdf_kernel, "grid_lookup_cuda", grid_lookup_plain)
    want = collision_guide_plain(u, stack, cfg)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and not got[..., 2:].any()
    assert torch.equal(one[0], single)
    with pytest.raises(ValueError):
        collision_guide(u[:2].contiguous(), stack, cfg)


def _tiles_trial(planner_class: str, n_agents: int = 2):
    from mmd_torch.config import DiffusionConfig
    from mmd_torch.experiments.problems import get_planning_problem
    from mmd_torch.experiments.trial import ModelRegistry, build_multi_agent_trial

    s, g, ids, sk = get_planning_problem("EnvTestTwoByTwoRobotPlanarDiskRandom", n_agents,
                                         seed=0)
    return build_multi_agent_trial(planner_class, s, g, ids, sk, ModelRegistry(device="cuda"),
                                   stagger_dt=10,
                                   diffusion_cfg=DiffusionConfig(n_samples=8, n_guide_steps=2))


def test_ensemble_plan_launches_once_per_guide_call_for_all_tiles():
    """A 3-tile plan, fresh and local: one guide-loop launch per guided step
    for all tiles, no collision guide and one lookup per tile; the seams
    hold."""
    _need_card()
    from mmd_torch.common.experiences import PathBatchExperience
    from mmd_torch.models.ensemble import seam_residual

    p = _tiles_trial("XECBS").planners[0]
    load_kernels()
    cfg = p.cfg
    for local in (False, True):
        exp = PathBatchExperience(p().trajs_final) if local else None
        before = _counts()
        out = p(experience=exp)
        assert _grew(before) == (cfg.n_guided_steps(3 if local else None), 0, p.n_tiles)
        assert out.trajs_final.shape == (8, 3 * 64, 4)
        assert float(seam_residual(p.local_seeds(out.trajs_iters[-1]), p.cc)) <= 1e-6


def test_multi_tile_xecbs_syncs_only_to_read_and_replays_exactly(monkeypatch):
    """A 2-agent staggered XECBS search on the 2x2 instance (B=8, 2 guide
    iterations a step): the launches by the search's own plan count, every
    host sync from `cbs.to_host`, and an exact replay on the plain
    versions."""
    _need_card()
    import inspect

    from mmd_torch.experiments.trial import make_team_planner
    from mmd_torch.planners.multi_agent import cbs as cbs_module

    trial = _tiles_trial("XECBS")
    load_kernels()

    def search():
        return make_team_planner("XECBS", trial.planners, trial.start_l, trial.goal_l,
                                 start_time_l=trial.start_time_l,
                                 reference_task=trial.team.reference_task)

    search().plan()  # warm-up
    kept = [p._generator.get_state() for p in trial.planners]
    team = search()
    before = _counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _, n_exp, status, _ = team.plan()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    lines, first = inspect.getsourcelines(cbs_module.to_host)
    stray = [f"{w.filename}:{w.lineno}" for w in _sync_warnings(caught)
             if not (w.filename == cbs_module.__file__
                     and first <= w.lineno < first + len(lines))]
    assert not stray, stray
    cfg, t = trial.planners[0].cfg, team.timing
    want = (cfg.n_guided_steps() * t["plans_fresh"] + cfg.n_guided_steps(3) * t["plans_local"],
            0, 3 * (t["plans_fresh"] + t["plans_local"]))
    assert _grew(before) == want
    final = team.final
    for p, state in zip(trial.planners, kept):
        p._generator.set_state(state)
    _plain_kernels(monkeypatch)
    replay = search()
    _, n_exp2, status2, _ = replay.plan()
    assert (n_exp2, status2) == (n_exp, status)
    if final is not None:
        assert replay.final.ix_best == final.ix_best
        assert torch.equal(replay.final.paths_all, final.paths_all)


def _train_data(device):
    from mmd_torch.datasets.trajectories import TrajectoryDataset

    return TrajectoryDataset.load_trajectories(os.path.join(ROOT, "data_trajectories"),
                                               "EnvEmptyNoWait2D-RobotPlanarDisk", device=device)


def test_train_steps_on_the_card_match_the_cpu():
    """chip_smoke.py's card-against-CPU train steps at full width (12 f32
    steps across both EMA branches and both sides of the clip, then one
    bf16 loss and its gradients), held to that script's tolerances."""
    _need_card()
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    parity, state, _ = cs.train_parity("cuda", _train_data("cpu"))
    assert max(parity["loss_rel"], parity["param_abs"], parity["ema_abs"]) <= cs.TRAIN_PARITY_TOL
    assert parity["bf16_loss_rel"] <= cs.BF16_PARITY_LOSS_TOL
    assert parity["bf16_grad_cosine"] >= cs.BF16_PARITY_COSINE
    assert state.step == cs.TRAIN_PARITY_STEPS
    assert min(parity["grad_norms"]) < 1.0 <= max(parity["grad_norms"])  # both sides of the clip


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_train_chunk_waits_on_nothing(bf16):
    _need_card()
    from mmd_torch.models.schedules import make_schedule
    from mmd_torch.models.temporal_unet import Bf16Forward, init_unet
    from mmd_torch.train import trainer

    ds = _train_data("cuda")
    cfg = trainer.TrainConfig(bf16=bf16)
    model = init_unet(torch.Generator().manual_seed(0), device="cuda")
    state = trainer.TrainState.create(model)
    forward = Bf16Forward(model) if bf16 else model
    draw = trainer.StepDrawer(ds, cfg, 500, torch.Generator(device="cuda").manual_seed(0))
    schedule = make_schedule("exponential", 25, device="cuda")
    trainer.train_chunk(state, forward, schedule, cfg, draw, 2)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = trainer.train_chunk(state, forward, schedule, cfg, draw, 12)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(loss) and state.step == 14
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_spawned_launcher_workers_launch_the_lookup_after_cuda_init(tmp_path):
    _need_card()
    from mmd_torch.experiments.launcher import Launcher
    from mmd_torch.tools.worker_check import lookup_on_card

    torch.zeros(1, device="cuda").add_(1.0)  # this process has used CUDA
    torch.cuda.synchronize()
    launcher = Launcher("spawn", exp_fn=lookup_on_card, n_seeds=2, n_exps_in_parallel=2,
                        base_dir=str(tmp_path))
    launcher.add_experiment(env_name="EnvHighways2D")
    out = launcher.run(local=True)
    assert all(isinstance(o, dict) for o in out), out
    assert [o["launches"] for o in out] == [1, 1] and [o["max_abs_err"] for o in out] == [0.0, 0.0]
    assert os.getpid() not in {o["pid"] for o in out}


def _plain_lookup(monkeypatch):
    """Route the lookup kernel's wrapper to its plain version."""
    monkeypatch.setattr(sdf_kernel, "grid_lookup_cuda", grid_lookup_plain)


def test_knob_guide_launches_the_lookup_and_no_collision_guide(monkeypatch):
    """With a collision knob the guide takes its autograd code, whose lookup
    is the kernel: one lookup a call and no collision-guide launch, and the
    step equals the one over the plain lookup exactly."""
    _need_card()
    load_kernels()
    scene = make_env("EnvConveyor2D", "cuda").scene
    gd = GuideData(scene=scene,
                   normalizer=LimitsNormalizer.from_limits([-1] * 4, [1] * 4, "cuda"),
                   constraints=empty_constraint_set(1, 1, device="cuda"))
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -1.1, 1.1, (64, 64, 4)).astype(np.float32)).cuda()
    cfg = GuideConfig(interpolate_collision=True, use_extra_objects_only=True,
                      weight_max_velocity=0.02, max_velocity=0.5, weight_chomp_smoothness=0.02,
                      weight_joint_limits=0.02)
    for knobs in (cfg, GuideConfig(interpolate_collision=True)):
        lookups, collisions = grid_lookup.launches, collision_guide.launches
        step = guide_gradient(x, gd, knobs)
        assert (grid_lookup.launches - lookups, collision_guide.launches - collisions) == (1, 0)
        with monkeypatch.context() as m:
            _plain_lookup(m)
            assert torch.equal(guide_gradient(x, gd, knobs), step)


def _line(start, goal, device="cuda"):
    t = torch.linspace(0.0, 1.0, 64, device=device)[:, None]
    pos = (1 - t) * start[:2] + t * goal[:2]
    return torch.cat([pos, torch.gradient(pos, dim=0)[0] / (5.0 / 64.0)], dim=-1)


@pytest.mark.parametrize("name", ["chomp", "stomp", "mppi", "stoch_gpmp"])
def test_classical_optimizers_launch_once_an_iteration_sync_nothing_and_replay(name,
                                                                               monkeypatch):
    _need_card()
    load_kernels()
    from mmd_torch.datagen import classical

    fn, cfg = {"chomp": (classical.chomp_optimize, classical.CHOMPConfig(opt_iters=5)),
               "stomp": (classical.stomp_optimize, classical.STOMPConfig(opt_iters=5)),
               "mppi": (classical.mppi_optimize, classical.MPPIConfig(opt_iters=5)),
               "stoch_gpmp": (classical.stoch_gpmp_optimize,
                              classical.StochGPMPConfig(opt_iters=5))}[name]
    scene = make_env("EnvConveyor2D", "cuda").scene
    start = torch.tensor([-0.8, -0.02, 0.0, 0.0], device="cuda")
    goal = torch.tensor([0.8, -0.02, 0.0, 0.0], device="cuda")
    init = _line(start, goal).expand(8, -1, -1).contiguous()
    gen = torch.Generator(device="cuda").manual_seed(0)
    kw = {} if name == "chomp" else {"generator": gen}
    fn(scene, start, goal, init, cfg, **kw)  # warm-up
    state = gen.get_state()
    before = grid_lookup.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn(scene, start, goal, init, cfg, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert grid_lookup.launches - before == cfg.opt_iters
    gen.set_state(state)
    _plain_lookup(monkeypatch)
    assert torch.equal(fn(scene, start, goal, init, cfg, **kw), out)
    assert torch.isfinite(out).all()


def test_arm_gpmp2_launches_once_an_iteration_syncs_nothing_and_replays(monkeypatch):
    _need_card()
    load_kernels()
    from mmd_torch.robots import kinematics

    scene = make_env("EnvDropRegion2D", "cuda").scene
    tree = kinematics.make_planar_arm(3, link_length=0.2, device="cuda")
    q_start, q_goal = torch.zeros(3, device="cuda"), torch.tensor([np.pi / 2, 0, 0],
                                                                   device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = gen.get_state()
    before = grid_lookup.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        trajs, free = kinematics.plan_arm_gpmp2(tree, scene, q_start, q_goal, generator=gen,
                                                n_particles=8, opt_iters=20)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert grid_lookup.launches - before == 20 + 1
    gen.set_state(state)
    _plain_lookup(monkeypatch)
    again, free_again = kinematics.plan_arm_gpmp2(tree, scene, q_start, q_goal, generator=gen,
                                                  n_particles=8, opt_iters=20)
    assert torch.equal(torch.nan_to_num(again, nan=7.0), torch.nan_to_num(trajs, nan=7.0))
    assert torch.equal(free_again, free)


def test_bench_kernels_matches_at_both_sizes():
    _need_card()
    load_kernels()
    from mmd_torch.tools import bench_kernels

    rows = bench_kernels.bench(n_iter=5)
    assert [r["points"] for r in rows] == [4096, 65536] and all(r["match"] for r in rows)


# ------------------------------------------------------------ guide loop
@pytest.mark.parametrize("name", LOOP_CASES)
def test_guide_loop_equals_plain(name, monkeypatch):
    """The guide-loop kernel against `guide_loop_plain` (its lookup in plain
    torch too) on the card, 20 iterations in one launch: exactly equal, in
    every case of `guide_cases.LOOP_CASES` (both maps, edge waypoints,
    constraints, soft paths, 10 problems, 3 tiles, H = 2, 64, 128)."""
    _need_card()
    load_kernels()
    x, gd, hard, cfg = loop_case(name, "cuda", B=16)
    before = _counts()
    got = guide_loop_cuda(x, gd, hard, cfg, 20)
    assert _grew(before) == (1, 0, 0)
    _plain_kernels(monkeypatch)
    want = guide_loop_plain(x, gd, hard, cfg, 20)
    torch.cuda.synchronize()
    assert got.shape == x.shape and torch.isfinite(got).all()
    assert torch.equal(got, want), float((got - want).abs().max())
    assert float((got - x).abs().max()) > 1e-3


def test_guide_loop_refuses_what_it_does_not_take():
    """A CPU tensor, a non-float32 or strided x and a staging past 227 KB
    raise a ValueError, with no launch."""
    _need_card()
    load_kernels()
    x, gd, hard, cfg = loop_case("soft_paths", "cuda", B=8)
    before = _counts()
    for bad in (x.cpu(), x.double(), torch.zeros(8, 64, 8, device="cuda")[..., :4]):
        with pytest.raises(ValueError):
            guide_loop_cuda(bad, gd, hard, cfg, 20)
    big = dataclasses.replace(gd.soft_paths, points=torch.zeros(400, 64, 2, device="cuda"),
                              mask=torch.ones(400, 64, device="cuda"))
    assert staging_bytes(64, 3, 2, 400) > 232448
    with pytest.raises(ValueError, match="shared memory"):
        guide_loop_cuda(x, dataclasses.replace(gd, soft_paths=big), hard, cfg, 20)
    assert _counts() == before


@pytest.mark.parametrize("sampler", ["ddpm", "ddim"])
def test_mpd_plan_launches_one_guide_loop_a_guided_step_and_one_lookup(sampler, monkeypatch):
    """A full-width MPD plan on EnvConveyor2D: 14 guide loops (DDIM: 3), no
    collision guide, one lookup; the same plan with every kernel routed to
    its plain version is equal."""
    _need_card()
    load_kernels()
    from mmd_torch.planners.single_agent.mpd import load_planner

    planner = load_planner(os.path.join(ROOT, "data_trained_models"),
                           os.path.join(ROOT, "data_trajectories"), "EnvConveyor2D",
                           (-0.8, 0.0), (0.8, 0.0), "cuda")
    planner.cfg = dataclasses.replace(planner.cfg, sampler=sampler)
    noise = planner.draw_noise()
    before = _counts()
    out = planner(noise=noise)
    assert _grew(before) == ({"ddpm": 14, "ddim": 3}[sampler], 0, 1)
    _plain_kernels(monkeypatch)
    assert torch.equal(planner(noise=noise).trajs_final, out.trajs_final)


@pytest.mark.parametrize("name", ["EnvConveyor2D", "EnvEmptyNoWait2D"])
def test_viz_fields_launch_the_lookup_and_equal_plain(name):
    """viz's SDF and gradient fields on the card: one lookup launch each,
    exactly the plain lookup's values and cell gradients."""
    _need_card()
    from mmd_torch.viz.visualizer import field_grid, grad_sdf_field, sdf_field

    load_kernels()
    env = make_env(name, "cuda")
    scene = env.scene
    tables = ((scene.grid.values, scene.grid.grads),
              (scene.extra_grid.values, scene.extra_grid.grads))
    before = _counts()
    sdf = sdf_field(scene, env.limits, 200)
    grad = grad_sdf_field(scene, env.limits, 40)
    assert _grew(before) == (0, 0, 2)
    for n, field, k in ((200, sdf, 0), (40, grad, 1)):
        pts = torch.from_numpy(field_grid(env.limits, n)[2]).cuda()
        plain = grid_lookup_plain(pts, tables, scene.grid.lower, scene.grid.upper)[k][0]
        assert torch.equal(field, plain)


def test_gpu_peak_flops_knows_the_card():
    _need_card()
    from mmd_torch.utils.profiling import gpu_peak_flops

    peak = gpu_peak_flops()
    assert peak is not None and peak > 1e14, torch.cuda.get_device_name(0)
