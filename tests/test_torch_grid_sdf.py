"""Grid-SDF lookup of the port against the JAX package.

The lookup is an index computation and a gather, so on the same grids and
points the port must agree exactly (atol 0) with `mmd_tpu.envs.grid_sdf.
_lookup` and with the Pallas kernel run in interpret mode, as
tests/test_ops.py runs it. The grids themselves are built independently on
each side; their float32 linspace points differ by rounding, so values are
held within 2 ulp of 1 and gradients equal off the tie lines of the box
SDF. The CUDA kernel's own tests are in test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmd_tpu.envs.envs import ENV_REGISTRY, make_env as jax_make_env
from mmd_tpu.envs.grid_sdf import _lookup, grid_sdf as jax_grid_sdf
from mmd_tpu.ops.sdf_kernel import grid_lookup_pallas
from mmd_torch.envs.envs import make_env
from mmd_torch.envs.grid_sdf import GridSDF, grid_sdf_pair
from mmd_torch.ops.sdf_kernel import grid_lookup, grid_lookup_cuda, grid_lookup_plain

torch.set_num_threads(1)

ENVS = sorted(ENV_REGISTRY)


def torch_grid(g) -> GridSDF:
    """The JAX grid's arrays as a port GridSDF."""
    return GridSDF(lower=tuple(float(v) for v in np.asarray(g.lower)),
                   upper=tuple(float(v) for v in np.asarray(g.upper)),
                   values=torch.from_numpy(np.array(g.values)),
                   grads=torch.from_numpy(np.array(g.grads)))


def query_points(n: int, grid, seed: int) -> np.ndarray:
    """Uniform over [-1.2, 1.2]^2 (outside the grid too), a quarter exactly
    on cell edges, plus the corners and far-away points."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.2, 1.2, (n, 2)).astype(np.float32)
    lo = np.asarray(grid.lower, np.float32)
    span = np.asarray(grid.upper, np.float32) - lo
    k = rng.integers(0, grid.values.shape[0] + 1, (n // 4, 2)).astype(np.float32)
    pts[: n // 4] = lo + k / np.float32(grid.values.shape[0]) * span
    extra = np.array([[-1, -1], [1, 1], [-1, 1], [10, -10], [-10, 10]], np.float32)
    pts[n // 4: n // 4 + len(extra)] = extra
    return pts


@pytest.mark.parametrize("env_name", ENVS)
def test_plain_lookup_matches_jax_gather_and_pallas(env_name):
    g = jax_make_env(env_name).grid
    pts = query_points(1037, g, seed=len(env_name))  # ragged: not a multiple of 1024
    tg = torch_grid(g)
    empty = torch_grid(jax_make_env("EnvEmptyNoWait2D").grid)
    vals, grads = grid_lookup_plain(torch.from_numpy(pts), ((tg.values, tg.grads),
                                                            (empty.values, empty.grads)),
                                    tg.lower, tg.upper)
    v_ref, g_ref = _lookup(g, jnp.asarray(pts))
    v_pl, g_pl = grid_lookup_pallas(jnp.asarray(pts), g.values, g.grads, g.lower,
                                    g.upper, interpret=True)
    for ref_v, ref_g in ((v_ref, g_ref), (v_pl, g_pl)):
        np.testing.assert_array_equal(vals[0].numpy(), np.asarray(ref_v))
        np.testing.assert_array_equal(grads[0].numpy(), np.asarray(ref_g))


def test_lookup_keeps_batch_shape_and_reads_two_grids():
    g = torch_grid(jax_make_env("EnvConveyor2D").grid)
    e = torch_grid(jax_make_env("EnvEmptyNoWait2D").grid)
    pts = torch.from_numpy(query_points(4 * 7 * 3, g, 0)).reshape(4, 7, 3, 2)
    vals, grads = grid_lookup(pts, ((g.values, g.grads), (e.values, e.grads)),
                              g.lower, g.upper)
    assert vals.shape == (2, 4, 7, 3) and grads.shape == (2, 4, 7, 3, 2)
    swap_v, swap_g = grid_lookup(pts, ((e.values, e.grads), (g.values, g.grads)),
                                 g.lower, g.upper)
    assert torch.equal(swap_v[1], vals[0]) and torch.equal(swap_g[1], grads[0])
    assert torch.equal(swap_v[0], vals[1]) and torch.equal(swap_g[0], grads[1])
    assert float(vals[1].min()) > 100.0 and not grads[1].any()  # empty map


@pytest.mark.parametrize("env_name", ["EnvConveyor2D", "EnvDropRegion2D"])
def test_grid_sdf_forward_and_backward_match_jax(env_name):
    g = jax_make_env(env_name).grid
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1.1, 1.1, (64, 63, 2)).astype(np.float32)
    w = rng.standard_normal((64, 63)).astype(np.float32)

    def jf(x):
        return jnp.sum(jax_grid_sdf(g, x) * w)

    j_val = np.asarray(jax_grid_sdf(g, jnp.asarray(pts)))
    j_grad = np.asarray(jax.grad(jf)(jnp.asarray(pts)))
    x = torch.from_numpy(pts).requires_grad_(True)
    tg = torch_grid(g)
    val, _ = grid_sdf_pair(tg, tg, x)  # only the first grid reaches the loss
    (val * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(val.detach().numpy(), j_val)
    np.testing.assert_array_equal(x.grad.numpy(), j_grad)


def test_pair_of_grids_backward_matches_two_jax_lookups():
    ga = jax_make_env("EnvHighways2D").grid
    gb = jax_make_env("EnvDropRegion2D").grid
    rng = np.random.default_rng(2)
    pts = rng.uniform(-1.1, 1.1, (200, 2)).astype(np.float32)

    def jf(x):
        return jnp.sum(jnp.minimum(jax_grid_sdf(ga, x), jax_grid_sdf(gb, x)))

    x = torch.from_numpy(pts).requires_grad_(True)
    a, b = grid_sdf_pair(torch_grid(ga), torch_grid(gb), x)
    torch.minimum(a, b).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(jax.grad(jf)(jnp.asarray(pts))))


def test_minimum_splits_a_tie_like_jax():
    """jnp.minimum sends half the gradient to each side of a tie; the port
    relies on torch.minimum doing the same (a map's object grid and its empty
    extra grid tie everywhere on an empty map)."""
    a = np.array([1.0, 2.0, 3.0], np.float32)
    b = np.array([1.0, 1.0, 4.0], np.float32)
    ja, jb = jax.grad(lambda p, q: jnp.sum(jnp.minimum(p, q)), argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(b))
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    torch.minimum(ta, tb).sum().backward()
    np.testing.assert_array_equal(ta.grad.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.grad.numpy(), np.asarray(jb))
    assert ta.grad[0] == 0.5 and tb.grad[0] == 0.5


@pytest.mark.parametrize("env_name", ENVS)
def test_built_grids_match_jax_built_grids(env_name):
    j = jax_make_env(env_name).grid
    t = make_env(env_name, "cpu").grid
    assert t.shape == j.values.shape == (400, 400)
    assert t.lower == tuple(np.asarray(j.lower).tolist())
    assert t.upper == tuple(np.asarray(j.upper).tolist())
    np.testing.assert_allclose(t.values.numpy(), np.asarray(j.values), rtol=0, atol=2.4e-7)
    tg, jg = t.grads.numpy(), np.asarray(j.grads)
    differ = np.any(tg != jg, axis=-1)
    assert differ.mean() < 0.005
    if differ.any():
        # Gradients may differ only where two faces of the max-coordinate
        # box SDF tie: there the 1-ulp-apart grid points of the two builds
        # fall on either side of the tie, or exactly on it (a 0.5 split).
        ax = np.linspace(-1.0, 1.0, 400)
        pts = np.stack(np.meshgrid(ax, ax, indexing="ij"), -1)[differ]  # (n, 2)
        field = make_env(env_name, "cpu").box_field
        c = field.centers.double().numpy()
        h = field.half_sizes.double().numpy()
        d = np.abs(pts[:, None, :] - c) - h                      # (n, boxes, 2)
        per_box = d.max(-1)                                      # (n, boxes)
        win = d[np.arange(len(pts)), per_box.argmin(-1)]         # (n, 2)
        axis_tie = np.abs(win[:, 0] - win[:, 1]) < 1e-5
        top2 = np.sort(per_box, axis=-1)[:, :2]
        box_tie = np.abs(top2[:, 1] - top2[:, 0]) < 1e-5
        assert np.all(axis_tie | box_tie)


def test_cuda_wrapper_refuses_bad_inputs_before_launching():
    g = torch_grid(jax_make_env("EnvConveyor2D").grid)
    pair = ((g.values, g.grads), (g.values, g.grads))
    with pytest.raises(ValueError):
        grid_lookup_cuda(torch.zeros(4, 3), pair, g.lower, g.upper)
    with pytest.raises(ValueError):
        grid_lookup_cuda(torch.zeros(4, 2), pair + pair[:1], g.lower, g.upper)
    with pytest.raises(ValueError):
        grid_lookup_cuda(torch.zeros(4, 2), ((g.values, g.grads),
                                             (g.values[:-1], g.grads[:-1])),
                         g.lower, g.upper)
    with pytest.raises(ValueError):
        grid_lookup_cuda(torch.zeros(4, 2, dtype=torch.float64), pair, g.lower, g.upper)
