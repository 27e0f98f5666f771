"""The guide's collision step of the port against the JAX package.

`collision_guide_plain` (the plain version of the collision-guide kernel,
and what `collision_gradient` runs on a CPU tensor) is held against

    w * _finish(jax.grad(collision_cost_objects))
      + w * _finish(jax.grad(collision_cost_boundaries))

of `mmd_tpu/costs/guide.py` on the same unnormalized waypoints and the
JAX-built grids. The inputs (`mmd_torch/tools/guide_cases.py`) put
waypoints on cell edges, inside objects and the walls' margin, in corners
where walls tie and exactly at a wall's hinge; a synthetic scene with two
equal grids ties every cell and puts a band of cells exactly at the margin.
Tolerance: atol 1e-6, rtol 0, as tests/test_torch_guide.py: the outputs are
at most 0.04 (two terms of weight 0.02, each clipped to norm 1), the cells
and tie rules are the same on both sides, and the two differ only in the
float32 rounding order of the clip's norm. The CUDA kernel's own tests are
in test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmd_tpu.costs.guide import GuideConfig as JGuideConfig
from mmd_tpu.costs.guide import _finish as jax_finish
from mmd_tpu.costs.guide import collision_cost_boundaries as jax_boundaries
from mmd_tpu.costs.guide import collision_cost_objects as jax_objects
from mmd_tpu.envs.envs import SceneData as JSceneData
from mmd_tpu.envs.envs import make_env as jax_make_env
from mmd_tpu.envs.grid_sdf import GridSDF as JGridSDF
from mmd_torch.costs.guide import GuideConfig, collision_gradient, collision_guide_plain
from mmd_torch.envs.envs import WS_BOUNDARY_SCALE, SceneData
from mmd_torch.envs.grid_sdf import GridSDF
from mmd_torch.ops.collision_guide import RECORD, collision_guide
from mmd_torch.ops.sdf_kernel import box_span
from mmd_torch.tools.guide_cases import HINGE_CUTOFF, tied_scene, waypoints

torch.set_num_threads(1)

ATOL = 1e-6
SHAPES = [(64, 64, 4), (3, 64, 64, 4)]
CUTOFFS = {"default": 0.01, "hinge": HINGE_CUTOFF}


def torch_scene(scene) -> SceneData:
    def grid(g):
        return GridSDF(lower=tuple(np.asarray(g.lower).tolist()),
                       upper=tuple(np.asarray(g.upper).tolist()),
                       values=torch.from_numpy(np.array(g.values)),
                       grads=torch.from_numpy(np.array(g.grads)))
    return SceneData(grid=grid(scene.grid), extra_grid=grid(scene.extra_grid),
                     ws_min=torch.from_numpy(np.array(scene.ws_min)),
                     ws_max=torch.from_numpy(np.array(scene.ws_max)))


def jax_scene(scene: SceneData) -> JSceneData:
    """A port scene's arrays as a JAX SceneData."""
    def grid(g):
        return JGridSDF(lower=jnp.asarray(g.lower, jnp.float32),
                        upper=jnp.asarray(g.upper, jnp.float32),
                        values=jnp.asarray(g.values.numpy()),
                        grads=jnp.asarray(g.grads.numpy()))
    return JSceneData(grid=grid(scene.grid), extra_grid=grid(scene.extra_grid),
                      ws_min=jnp.asarray(scene.ws_min.numpy()),
                      ws_max=jnp.asarray(scene.ws_max.numpy()))


def scenes(name: str, margin: float):
    """(port scene, JAX scene) of a map, or the synthetic tied scene."""
    if name == "tied":
        scene = tied_scene(torch_scene(jax_make_env("EnvConveyor2D").scene), margin)
        return scene, jax_scene(scene)
    jscene = jax_make_env(name).scene
    return torch_scene(jscene), jscene


def jax_collision_step(u: np.ndarray, jscene, jcfg) -> np.ndarray:
    def grad(cost):
        return jax.grad(lambda v: cost(v, jscene, jcfg).sum())(jnp.asarray(u))
    out = jcfg.weight_collision * jax_finish(grad(jax_objects), jcfg.max_grad_norm)
    out = out + jcfg.weight_collision * jax_finish(grad(jax_boundaries), jcfg.max_grad_norm)
    return np.asarray(out)


@pytest.mark.parametrize("cutoff", sorted(CUTOFFS))
@pytest.mark.parametrize("shape", SHAPES, ids=["64x64", "3x64x64"])
@pytest.mark.parametrize("name", ["EnvConveyor2D", "EnvEmptyNoWait2D", "tied"])
def test_plain_matches_jax(name, shape, cutoff):
    cfg = GuideConfig(obstacle_cutoff_margin=CUTOFFS[cutoff])
    jcfg = JGuideConfig(obstacle_cutoff_margin=CUTOFFS[cutoff])
    scene, jscene = scenes(name, cfg.collision_margin)
    u = waypoints(shape, scene, cfg.collision_margin, seed=len(name) + len(shape))
    got = collision_guide_plain(torch.from_numpy(u), scene, cfg).numpy()
    want = jax_collision_step(u, jscene, jcfg)
    assert got.shape == u.shape
    assert np.abs(want).max() > 1e-3  # the walls at least are active
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert not got[..., 2:].any()  # velocity channels
    assert not got[..., 0, :].any() and not got[..., -1, :].any()


def test_hinge_corner_and_tie_take_the_documented_gradients():
    """At the hinge relu' is 0.5 and the four zero penalties tie (share
    0.25); in a corner two walls tie (0.5 each); in the tied scene both
    grids share the gradient (0.5 each, summing to one cell gradient)."""
    cfg = GuideConfig(obstacle_cutoff_margin=HINGE_CUTOFF)
    m, w = np.float32(cfg.collision_margin), np.float32(cfg.weight_collision)
    empty = torch_scene(jax_make_env("EnvEmptyNoWait2D").scene)
    t = empty.guide_table
    hi0, hi1 = np.float32(t.wall_hi[0]), np.float32(t.wall_hi[1])
    u = np.zeros((1, 5, 4), np.float32)
    u[0, 1, :2] = [hi0 - m, 0.1]                    # the x-high wall at its hinge
    u[0, 2, :2] = [hi0 - m / 2, hi1 - m / 2]        # x-high and y-high tie
    u[0, 3, :2] = [hi0 - m / 2, 0.0]                # x-high alone
    assert np.float32(m - (hi0 - u[0, 1, 0])) == 0.0
    got = collision_guide_plain(torch.from_numpy(u), empty, cfg).numpy()[0]
    np.testing.assert_array_equal(got[1], [w * np.float32(0.125), 0, 0, 0])
    # The corner's push (0.5, 0.5) has norm < 1: the clip keeps it.
    np.testing.assert_array_equal(got[2], [w * np.float32(0.5), w * np.float32(0.5), 0, 0])
    # The lone wall's push (1, 0) has ||(1, 0, 0, 0) + 1e-6|| > 1: the clip
    # scales it by 1 / that norm, taken over all four channels.
    # Held within two float32 steps of 0.02: the float32 rounding of the
    # norm, the scale and the products.
    scale = 1.0 / np.sqrt((1.0 + 1e-6) ** 2 + 3e-12)
    assert got[3, 0] < w and abs(got[3, 0] - w * scale) <= 2 * np.spacing(w)
    assert not got[3, 1:].any()

    conveyor = torch_scene(jax_make_env("EnvConveyor2D").scene)
    tied = tied_scene(conveyor, float(m))
    one = SceneData(grid=conveyor.grid, extra_grid=empty.grid,
                    ws_min=conveyor.ws_min, ws_max=conveyor.ws_max)
    v = waypoints((8, 64, 4), conveyor, float(m), seed=1)
    # Away from the band at the margin, a tie of two equal cells gives
    # 0.5 g + 0.5 g = g exactly: the output of the grid alone.
    x = v[..., 0]
    v[..., 0] = np.where(np.abs(x) < 0.06, x + 0.2, x)
    a = collision_guide_plain(torch.from_numpy(v), tied, cfg)
    b = collision_guide_plain(torch.from_numpy(v), one, cfg)
    assert torch.equal(a, b) and a.abs().max() > 1e-3


def test_collision_guide_runs_the_plain_version_on_the_cpu():
    cfg = GuideConfig()
    scene = torch_scene(jax_make_env("EnvConveyor2D").scene)
    u = torch.from_numpy(waypoints((4, 64, 4), scene, cfg.collision_margin, seed=2))
    before = collision_guide.launches
    assert torch.equal(collision_gradient(u, scene, cfg), collision_guide_plain(u, scene, cfg))
    assert collision_guide.launches == before  # no kernel launch on the CPU


@pytest.mark.parametrize("name", ["EnvConveyor2D", "EnvEmptyNoWait2D"])
def test_guide_table_packs_the_two_grids_exactly(name):
    scene = torch_scene(jax_make_env(name).scene)
    t = scene.guide_table
    g, e = scene.grid, scene.extra_grid
    assert t.cells.shape == (*g.shape, RECORD) and t.cells.is_contiguous()
    assert torch.equal(t.cells[..., 0], g.values)
    assert torch.equal(t.cells[..., 1:3], g.grads)
    assert torch.equal(t.cells[..., 3], e.values)
    assert torch.equal(t.cells[..., 4:6], e.grads)
    assert not t.cells[..., 6:].any()
    assert t.lower == g.lower and t.span == box_span(g.lower, g.upper)
    # The walls as boundary_signed_distances computes them.
    assert torch.equal(torch.tensor(t.wall_lo), scene.ws_min * WS_BOUNDARY_SCALE)
    assert torch.equal(torch.tensor(t.wall_hi), scene.ws_max * WS_BOUNDARY_SCALE)


def test_cuda_wrapper_refuses_bad_inputs_before_launching():
    cfg = GuideConfig()
    scene = torch_scene(jax_make_env("EnvConveyor2D").scene)
    u = torch.zeros(2, 64, 4)
    bad = {
        "strided": torch.zeros(2, 64, 8)[..., :4],
        "D=3": torch.zeros(2, 64, 3),
        "H=1": torch.zeros(2, 1, 4),
        "float64": u.double(),
        "one dim": torch.zeros(4),
        "unaligned": torch.zeros(2 * 64 * 4 + 1)[1:].view(2, 64, 4),
        "on the CPU": u,
    }
    before = collision_guide.launches
    for case, x in bad.items():
        with pytest.raises(ValueError, match="u must be"):
            collision_guide(x, scene, cfg)
    assert collision_guide.launches == before
