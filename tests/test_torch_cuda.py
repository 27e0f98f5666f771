"""The CUDA kernel on the card. Every test here needs a CUDA card (marker
`gpu`) and skips without one. The file imports neither JAX nor the JAX
package, so it also runs on a machine that has only the port's packages:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

(`--noconftest`: the suite's conftest.py configures JAX.) The kernel must
equal its plain torch version exactly: both compute the same float32 index
arithmetic and read the same cells.
"""
import numpy as np
import pytest
import torch

from mmd_torch.envs.envs import make_env
from mmd_torch.envs.grid_sdf import grid_sdf_pair
from mmd_torch.ops.sdf_kernel import grid_lookup, grid_lookup_cuda, grid_lookup_plain

pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


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
