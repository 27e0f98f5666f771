"""The guide loop of the port: `guide_loop_plain` (the guide-loop kernel's
plain version, what `guide_loop` runs on a CPU tensor) against two
references on the same inputs:

- today's per-iteration loop, x <- hard.apply(x + guide_gradient(x)) with
  the guide's autograd code, one iteration at a time from the plain
  version's own x: atol 1e-6, as tests/test_torch_guide.py holds the guide
  (a step of at most ~0.3: weights 2e-2..2e-1 on gradients clipped to norm
  1; the two differ in the float32 rounding order of the GP prior's and the
  balls' gradients and of the clips' norms);
- JAX's `guide_step` loop (mmd_tpu/models/diffusion.py:105-110), run as a
  Python loop of `guide_gradient` + `hard.apply` on JAX's side, one group
  (problem or tile) at a time, on the JAX-built grids: each iteration from
  JAX's own x at atol 1e-6, and 20 iterations run apart at FREE_RUN_TOL.

Inputs are made with numpy from a seed. The cases: both maps; the
collision guide's edge waypoints (cell edges, the walls' hinge, a tied
scene; `mmd_torch/tools/guide_cases.py`); a constraint set of K = 3, P = 2
with a range that ends at H and an inactive row; a set with no active
constraint; soft paths of R = 3 with masked points; N = 2 problems on one
scene with per-problem sets, soft paths and hard values; T = 2 stacked
tiles with per-tile normalizers; H = 2, 64 and 128; a waypoint exactly on
a constraint's and a soft ball's centre. Then the dispatch's routing and
the kernel wrapper's refusals, which it makes before it needs a card.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmd_tpu.common.constraints import MultiPointConstraint
from mmd_tpu.costs import constraints as jcons
from mmd_tpu.costs.guide import GuideConfig as JGuideConfig, GuideData as JGuideData
from mmd_tpu.costs.guide import guide_gradient as jax_guide_gradient
from mmd_tpu.datasets.normalization import LimitsNormalizer as JNormalizer
from mmd_tpu.envs.envs import make_env as jax_make_env
from mmd_tpu.models.diffusion import HardConds as JHardConds
from mmd_torch.config import DiffusionConfig
from mmd_torch.costs import constraints as tcons
from mmd_torch.costs import guide as guide_module
from mmd_torch.costs.guide import GuideConfig, GuideData, guide_gradient, guide_loop, \
    guide_loop_plain
from mmd_torch.datasets.normalization import LimitsNormalizer
from mmd_torch.envs.envs import SceneData, SceneStack
from mmd_torch.envs.grid_sdf import GridSDF
from mmd_torch.models import diffusion as tdiff
from mmd_torch.models.diffusion import HardConds, SamplerNoise
from mmd_torch.models.schedules import make_schedule
from mmd_torch.ops import guide_loop as gl
from mmd_torch.tools.guide_cases import (
    HINGE_CUTOFF,
    checkpoint_limits,
    loop_constraints,
    loop_hard_values,
    loop_soft_paths,
    loop_trajectories,
    tied_scene,
    waypoints,
)

torch.set_num_threads(1)

ATOL = 1e-6
N_STEPS = 20
# Run apart for 20 iterations, the two loops' x differ by each iteration's
# rounding (~1e-7) carried on, and a waypoint that it moves across a cell
# edge reads the next cell's surrogate gradient, which the clip and the GP
# prior's coupling spread to its neighbours: at most 1.1e-5 over these
# cases (the edge waypoints; CPU, JAX 0.9), 1.6e-4 on other inputs. Held
# at 1e-3, 2% of the robot's radius, the card-against-CPU tolerance of
# chip_smoke.py.
FREE_RUN_TOL = 1e-3
# JAX's guide run op by op, as tests/test_torch_guide.py runs it: jitted,
# XLA contracts and fuses its float32 operations (its step moves by up to
# 1.3e-6 from the eager one's on these inputs).
_jax_grad = jax_guide_gradient


def torch_scene(scene) -> SceneData:
    def grid(g):
        return GridSDF(lower=tuple(np.asarray(g.lower).tolist()),
                       upper=tuple(np.asarray(g.upper).tolist()),
                       values=torch.from_numpy(np.array(g.values)),
                       grads=torch.from_numpy(np.array(g.grads)))
    return SceneData(grid=grid(scene.grid), extra_grid=grid(scene.extra_grid),
                     ws_min=torch.from_numpy(np.array(scene.ws_min)),
                     ws_max=torch.from_numpy(np.array(scene.ws_max)))


def jax_scene(scene: SceneData):
    """A port scene's arrays (the tied scene) as a JAX SceneData."""
    from mmd_tpu.envs.envs import SceneData as JSceneData
    from mmd_tpu.envs.grid_sdf import GridSDF as JGridSDF

    def grid(g):
        return JGridSDF(lower=jnp.asarray(g.lower, jnp.float32),
                        upper=jnp.asarray(g.upper, jnp.float32),
                        values=jnp.asarray(g.values.numpy()), grads=jnp.asarray(g.grads.numpy()))
    return JSceneData(grid=grid(scene.grid), extra_grid=grid(scene.extra_grid),
                      ws_min=jnp.asarray(scene.ws_min.numpy()),
                      ws_max=jnp.asarray(scene.ws_max.numpy()))


def start_goal_mask(H):
    m = np.zeros((H, 1), np.float32)
    m[0] = m[-1] = 1.0
    return m


@dataclasses.dataclass
class Case:
    x: np.ndarray           # (B, H, 4) or (G, B, H, 4), normalized
    gd: GuideData
    hard: HardConds
    cfg: GuideConfig
    jcfg: JGuideConfig
    groups: list            # (JAX GuideData, JAX HardConds) a group


def jax_soft(pts, mask, radius, weight):
    return jcons.SoftPathConstraints(points=jnp.asarray(pts), mask=jnp.asarray(mask),
                                     radius=jnp.asarray(radius, jnp.float32),
                                     weight=jnp.asarray(weight, jnp.float32))


def torch_soft(pts, mask, radius, weight):
    return tcons.SoftPathConstraints(points=torch.from_numpy(pts), mask=torch.from_numpy(mask),
                                     radius=torch.as_tensor(radius, dtype=torch.float32),
                                     weight=torch.as_tensor(weight, dtype=torch.float32))


def single_case(env_name, *, B=4, H=64, cons=None, K=3, P=2, soft_rows=0, seed=0,
                cutoff=None, tied=False, edges=False) -> Case:
    """One problem on one map."""
    rng = np.random.default_rng(seed)
    jscene = jax_make_env(env_name).scene
    scene = torch_scene(jscene)
    cfg_kw = {} if cutoff is None else {"obstacle_cutoff_margin": cutoff}
    if H != 64:
        cfg_kw["dt"] = 5.0 / H
    cfg, jcfg = GuideConfig(**cfg_kw), JGuideConfig(**cfg_kw)
    if tied:
        scene = tied_scene(scene, cfg.collision_margin)
        jscene = jax_scene(scene)
    if edges:
        # The collision guide's edge waypoints as x itself: with limits
        # [-1, 1] on the positions, unnormalize gives back a cell edge
        # (-1 + k / 400 * 2 in float32) exactly.
        mins = np.array([-1.0, -1.0, -2.0, -2.0], np.float32)
        maxs = -mins
        x = waypoints((B, H, 4), scene, cfg.collision_margin, seed)
        x[..., 2:] *= 0.5
    else:
        mins, maxs = checkpoint_limits(env_name)
        x = loop_trajectories(rng, B, H)
    values = loop_hard_values(rng, H, (B,))
    mask = start_goal_mask(H)
    cons = cons or []
    tcset = (tcons.pack_constraint_set(cons, K, P, device="cpu") if cons
             else tcons.empty_constraint_set(K, P, device="cpu"))
    jcset = jcons.pack_constraint_set(cons, K, P) if cons else jcons.empty_constraint_set(K, P)
    tspc = jspc = None
    if soft_rows:
        pts, smask = loop_soft_paths(rng, soft_rows, H)
        tspc, jspc = torch_soft(pts, smask, 0.3, 0.02), jax_soft(pts, smask, 0.3, 0.02)
    gd = GuideData(scene=scene, normalizer=LimitsNormalizer.from_limits(mins, maxs, "cpu"),
                   constraints=tcset, soft_paths=tspc)
    hard = HardConds(mask=torch.from_numpy(mask), values=torch.from_numpy(values))
    jgd = JGuideData(scene=jscene, normalizer=JNormalizer.from_limits(mins, maxs),
                     constraints=jcset, soft_paths=jspc)
    return Case(x, gd, hard, cfg, jcfg,
                [(jgd, JHardConds(mask=jnp.asarray(mask), values=jnp.asarray(values)))])


def problems_case(seed=3, N=2, B=4, H=64, R=3) -> Case:
    """N problems on one scene: problem 0 under two constraints, problem 1
    under none (its rows inactive), each with its soft paths (radius and
    weight a problem) and start and goal."""
    rng = np.random.default_rng(seed)
    jscene = jax_make_env("EnvConveyor2D").scene
    mins, maxs = checkpoint_limits("EnvConveyor2D")
    x = np.stack([loop_trajectories(rng, B, H) for _ in range(N)])
    values = loop_hard_values(rng, H, (N, 1))
    mask = start_goal_mask(H)
    per = [loop_constraints(rng, H), []]
    tcset = tcons.pack_constraint_sets(per, 3, 2, device="cpu")
    soft = [loop_soft_paths(rng, R, H) for _ in range(N)]
    radius, weight = np.array([0.3, 0.25], np.float32), np.array([0.02, 0.2], np.float32)
    tspc = torch_soft(np.stack([p for p, _ in soft]), np.stack([m for _, m in soft]), radius,
                      weight)
    gd = GuideData(scene=torch_scene(jscene),
                   normalizer=LimitsNormalizer.from_limits(mins, maxs, "cpu"),
                   constraints=tcset, soft_paths=tspc)
    hard = HardConds(mask=torch.from_numpy(mask), values=torch.from_numpy(values))
    groups = []
    for n in range(N):
        jcset = (jcons.pack_constraint_set(per[n], 3, 2) if per[n]
                 else jcons.empty_constraint_set(3, 2))
        jgd = JGuideData(scene=jscene, normalizer=JNormalizer.from_limits(mins, maxs),
                         constraints=jcset, soft_paths=jax_soft(*soft[n], radius[n], weight[n]))
        groups.append((jgd, JHardConds(mask=jnp.asarray(mask), values=jnp.asarray(values[n]))))
    return Case(x, gd, hard, GuideConfig(), JGuideConfig(), groups)


def tiles_case(seed=5, B=4, H=64, R=3) -> Case:
    """T = 2 stacked tiles (EnvConveyor2D, EnvHighways2D), each with its own
    normalizer, constraint set, soft paths and hard condition: the start
    on tile 0, the goal on tile 1, as a multi-tile plan's."""
    rng = np.random.default_rng(seed)
    envs = ("EnvConveyor2D", "EnvHighways2D")
    jscenes = [jax_make_env(e).scene for e in envs]
    lims = [checkpoint_limits(e) for e in envs]
    x = np.stack([loop_trajectories(rng, B, H) for _ in envs])
    mask = np.zeros((2, 1, H, 1), np.float32)
    mask[0, 0, 0] = mask[1, 0, H - 1] = 1.0
    values = loop_hard_values(rng, H, (2, 1))
    per = [[], loop_constraints(rng, H)]
    soft = [loop_soft_paths(rng, R, H) for _ in envs]
    gd = GuideData(scene=SceneStack(tuple(torch_scene(s) for s in jscenes)),
                   normalizer=LimitsNormalizer.stack([
                       LimitsNormalizer.from_limits(mn, mx, "cpu") for mn, mx in lims]),
                   constraints=tcons.pack_constraint_sets(per, 3, 2, device="cpu"),
                   soft_paths=torch_soft(np.stack([p for p, _ in soft]),
                                         np.stack([m for _, m in soft]),
                                         np.full(2, 0.3, np.float32),
                                         np.full(2, 0.02, np.float32)))
    hard = HardConds(mask=torch.from_numpy(mask), values=torch.from_numpy(values))
    groups = []
    for m in range(2):
        jcset = (jcons.pack_constraint_set(per[m], 3, 2) if per[m]
                 else jcons.empty_constraint_set(3, 2))
        jgd = JGuideData(scene=jscenes[m], normalizer=JNormalizer.from_limits(*lims[m]),
                         constraints=jcset, soft_paths=jax_soft(*soft[m], 0.3, 0.02))
        groups.append((jgd, JHardConds(mask=jnp.asarray(mask[m, 0]),
                                       values=jnp.asarray(values[m, 0]))))
    return Case(x, gd, hard, GuideConfig(), JGuideConfig(), groups)


CASES = {
    "nowait": lambda: single_case("EnvEmptyNoWait2D", seed=1),
    "conveyor": lambda: single_case("EnvConveyor2D", seed=2),
    "edges": lambda: single_case("EnvConveyor2D", edges=True, seed=3),
    "hinge": lambda: single_case("EnvConveyor2D", edges=True, cutoff=HINGE_CUTOFF, seed=4),
    "tied": lambda: single_case("EnvConveyor2D", edges=True, tied=True, seed=5),
    "constraints": lambda: single_case("EnvConveyor2D", cons=loop_constraints(None, 64), seed=6),
    "inactive_set": lambda: single_case("EnvConveyor2D", seed=7),
    "soft_paths": lambda: single_case("EnvConveyor2D", cons=loop_constraints(None, 64),
                                      soft_rows=3, seed=8),
    "problems": problems_case,
    "tiles": tiles_case,
    "H2": lambda: single_case("EnvConveyor2D", H=2, soft_rows=3, seed=9),
    "H128": lambda: single_case("EnvConveyor2D", H=128, cons=loop_constraints(None, 128),
                                soft_rows=3, seed=10),
}


def groups_of(x: np.ndarray, case: Case):
    return [x] if x.ndim == 3 else list(x)


def jax_step(case: Case, x: np.ndarray) -> np.ndarray:
    """One JAX guide iteration of every group: hard.apply(x + guide(x))."""
    out = []
    for xg, (jgd, jhard) in zip(groups_of(x, case), case.groups):
        xj = jnp.asarray(xg)
        out.append(np.array(jhard.apply(xj + _jax_grad(xj, jgd, case.jcfg))))
    return out[0] if x.ndim == 3 else np.stack(out)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_loop_matches_the_per_iteration_autograd_loop(name):
    """Each of 20 iterations of `guide_loop_plain` against today's
    per-iteration step (`guide_gradient` + `hard.apply`) from the same x."""
    case = CASES[name]()
    x = torch.from_numpy(case.x)
    moved = 0.0
    for _ in range(N_STEPS):
        want = case.hard.apply(x + guide_gradient(x, case.gd, case.cfg))
        got = guide_loop_plain(x, case.gd, case.hard, case.cfg, 1)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL)
        moved = max(moved, float((got - x).abs().max()))
        x = got
    assert moved > 1e-3  # the guide and the hard conditions act
    assert torch.equal(guide_loop_plain(torch.from_numpy(case.x), case.gd, case.hard, case.cfg,
                                        N_STEPS), x)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_loop_matches_jax_guide_step_loop(name):
    """JAX's loop run for 20 iterations; at each, the plain version's one
    iteration from JAX's x against JAX's (atol 1e-6); then the plain
    version's own 20 iterations against JAX's (FREE_RUN_TOL)."""
    case = CASES[name]()
    xj = case.x
    for _ in range(N_STEPS):
        nxt = jax_step(case, xj)
        got = guide_loop_plain(torch.from_numpy(xj), case.gd, case.hard, case.cfg, 1)
        np.testing.assert_allclose(got.numpy(), nxt, rtol=0, atol=ATOL)
        xj = nxt
    assert np.isfinite(xj).all()
    x = guide_loop_plain(torch.from_numpy(case.x), case.gd, case.hard, case.cfg, N_STEPS)
    np.testing.assert_allclose(x.numpy(), xj, rtol=0, atol=FREE_RUN_TOL)


def test_a_waypoint_on_a_centre_takes_the_autograd_loops_zero():
    """A waypoint exactly on a constraint's centre and another on a soft
    ball's centre (distance 0): the plain version adds no gradient of that
    ball there, as today's guide (torch's norm gradient at 0 is 0) does;
    JAX's norm gradient there is NaN, so JAX's step is NaN at exactly those
    waypoints and equal elsewhere."""
    case = single_case("EnvConveyor2D", cons=loop_constraints(None, 64), soft_rows=3, seed=11)
    x = torch.from_numpy(case.x)
    u = case.gd.normalizer.unnormalize(x).numpy()
    (b0, h0), (b1, h1) = (1, 20), (2, 33)
    centre = u[b0, h0, :2].copy()
    cons = [MultiPointConstraint(q_l=[centre], t_range_l=[(0, 64)], radius_l=[0.4])]
    cset = tcons.pack_constraint_set(cons, 1, 1, device="cpu")
    spc = case.gd.soft_paths
    pts, smask = spc.points.clone(), spc.mask.clone()
    pts[0, h1], smask[0, h1] = torch.from_numpy(u[b1, h1, :2]), 1.0
    gd = dataclasses.replace(case.gd, constraints=cset,
                             soft_paths=dataclasses.replace(spc, points=pts, mask=smask))
    got = guide_loop_plain(x, gd, case.hard, case.cfg, 1)
    want = case.hard.apply(x + guide_gradient(x, gd, case.cfg))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL)
    assert torch.isfinite(got).all()

    jgd = JGuideData(scene=case.groups[0][0].scene, normalizer=case.groups[0][0].normalizer,
                     constraints=jcons.pack_constraint_set(cons, 1, 1),
                     soft_paths=jax_soft(pts.numpy(), smask.numpy(), 0.3, 0.02))
    jgot = np.asarray(case.groups[0][1].apply(
        jnp.asarray(case.x) + _jax_grad(jnp.asarray(case.x), jgd, case.jcfg)))
    nan = np.isnan(jgot).any(axis=-1)
    assert nan[b0, h0] and nan[b1, h1] and nan.sum() == 2
    np.testing.assert_allclose(got.numpy()[~nan], jgot[~nan], rtol=0, atol=ATOL)


def test_guide_loop_routes_a_cpu_tensor_to_the_plain_version(monkeypatch):
    case = CASES["soft_paths"]()
    x = torch.from_numpy(case.x)
    want = guide_loop_plain(x, case.gd, case.hard, case.cfg, N_STEPS)
    monkeypatch.setattr(guide_module, "guide_loop_cuda", None)  # never reached on the CPU
    before = gl.guide_loop_cuda.launches
    assert torch.equal(guide_loop(x, case.gd, case.hard, case.cfg, N_STEPS), want)
    assert gl.guide_loop_cuda.launches == before
    assert guide_loop(x, case.gd, case.hard, case.cfg, 0) is x


@pytest.mark.parametrize("knob", [{"interpolate_collision": True},
                                  {"use_extra_objects_only": True},
                                  {"weight_max_velocity": 2e-2, "max_velocity": 0.5},
                                  {"weight_chomp_smoothness": 2e-2},
                                  {"weight_joint_limits": 2e-2}],
                         ids=["interpolated", "extra_objects", "max_velocity", "chomp",
                              "joint_limits"])
def test_guide_loop_keeps_the_per_iteration_loop_for_a_config_the_kernel_does_not_take(
        knob, monkeypatch):
    """A collision knob or a zoo term: the loop of `guide_gradient` calls on
    every device, by the config, exactly; neither the kernel nor its plain
    version runs."""
    case = CASES["constraints"]()
    cfg = dataclasses.replace(case.cfg, **knob)
    assert not cfg.guide_loop_applies and case.cfg.guide_loop_applies
    x = torch.from_numpy(case.x)
    want = x
    for _ in range(3):
        want = case.hard.apply(want + guide_gradient(want, case.gd, cfg))

    def refuse(*args, **kwargs):
        raise AssertionError("the guide-loop kernel's paths ran")

    monkeypatch.setattr(guide_module, "guide_loop_plain", refuse)
    monkeypatch.setattr(guide_module, "guide_loop_cuda", refuse)
    assert torch.equal(guide_loop(x, case.gd, case.hard, cfg, 3), want)


class _ZeroEps(torch.nn.Module):
    def forward(self, x, t):
        return torch.zeros_like(x)


@pytest.mark.parametrize("sampler", ["ddpm", "ddim"])
def test_the_sampler_runs_one_guide_loop_a_guided_step(sampler, monkeypatch):
    """guided_p_sample_loop (DDPM, and DDIM for a fresh loop) hands each
    guided step's n_guide_steps iterations to `guide_loop` as one call."""
    case = CASES["soft_paths"]()
    cfg = DiffusionConfig(n_samples=case.x.shape[0], sampler=sampler)
    calls = []
    real = tdiff.guide_loop

    def counting(x, gd, hard, guide_cfg, n_steps):
        calls.append(n_steps)
        return real(x, gd, hard, guide_cfg, n_steps)

    monkeypatch.setattr(tdiff, "guide_loop", counting)
    schedule = make_schedule("exponential", cfg.n_diffusion_steps, device="cpu")
    noise = SamplerNoise.draw(cfg, torch.Generator().manual_seed(0), "cpu")
    x, _ = tdiff.guided_p_sample_loop(_ZeroEps(), schedule, case.hard, cfg, noise, gd=case.gd,
                                      guide_cfg=case.cfg)
    assert calls == [cfg.n_guide_steps] * cfg.n_guided_steps()
    assert len(calls) == (3 if sampler == "ddim" else 14) and torch.isfinite(x).all()


def test_the_kernel_wrapper_refuses_before_it_needs_a_card():
    """guide_loop_cuda raises a ValueError on a CPU tensor, a non-float32 or
    strided x, a config it does not compute and a staging past 227 KB; none
    launches."""
    case = CASES["soft_paths"]()
    x = torch.from_numpy(case.x)
    before = gl.guide_loop_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        gl.guide_loop_cuda(x, case.gd, case.hard, case.cfg, N_STEPS)
    with pytest.raises(ValueError, match="float32"):
        gl.guide_loop_cuda(x.double(), case.gd, case.hard, case.cfg, N_STEPS)
    with pytest.raises(ValueError, match="contiguous"):
        gl.guide_loop_cuda(torch.zeros(6, 64, 8)[..., :4], case.gd, case.hard, case.cfg, 1)
    with pytest.raises(ValueError, match="per-iteration"):
        gl.guide_loop_cuda(x, case.gd, case.hard,
                           dataclasses.replace(case.cfg, interpolate_collision=True), 1)
    big = tcons.SoftPathConstraints(points=torch.zeros(400, 64, 2), mask=torch.zeros(400, 64),
                                    radius=torch.tensor(0.3), weight=torch.tensor(0.02))
    with pytest.raises(ValueError, match="shared memory"):
        gl.guide_loop_cuda(x, dataclasses.replace(case.gd, soft_paths=big), case.hard,
                           case.cfg, 1)
    assert gl.guide_loop_cuda.launches == before
    # The staging of the ECBS root's 9 and a team's 19 soft rows at H = 64.
    assert gl.staging_bytes(64, 0, 0, 9) == 128 + 4 * 3 * 9 * 64
    assert gl.staging_bytes(64, 0, 0, 19) == 14720
    assert gl.staging_bytes(1024, 4, 4, 0) == 2048 + 4 * (96 + 8)
