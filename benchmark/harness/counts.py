"""Operations and bytes from shapes, and the card's peaks.

`unet_flops` counts one TemporalUnet forward as PyTorch's FlopCounterMode
counts it: 2 x batch x C_out x C_in x k x L for each convolution (L the
output length, the input length of a transposed one) and 2 x batch x in x
out for each dense layer; norms, activations and additions count nothing.

`guide_loop_work` is the least the guide-loop kernel must move and compute
for one launch: x read and written once, the hard mask and values and the
normalizer's limits read once, 24 B for each distinct grid cell that the
iterations' inner waypoints read (value and gradient of the two grids),
and the float32 operations per iteration of LOOP_OPS, counted from the
kernel's source: a waypoint's unnormalize and hard conditions, an inner
waypoint's collision terms (70), GP prior (74) and step (6). The bound is
the larger of bytes over the HBM bandwidth and operations over the peak.
"""
from __future__ import annotations

from typing import Dict, Optional

# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
# at its 700 W limit), by a substring of torch.cuda.get_device_name().
PEAKS = {"H100": {"hbm_bytes_per_s": 3.35e12, "float32": 67e12, "tf32": 494.7e12,
                  "bfloat16": 989.4e12}}
LOOP_OPS = {"waypoint": 28, "inner": 150}
CELL_BYTES = 24


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    for key, p in PEAKS.items():
        if key in device_name:
            return p
    return None


def _conv(batch, c_out, c_in, k, length):
    return 2 * batch * c_out * c_in * k * length


def unet_flops(cfg: Dict, batch: int) -> int:
    """One forward of the configuration's UNet on `batch` rows."""
    H, D, E = cfg["horizon"], cfg["state_dim"], cfg["time_emb_dim"]
    k = cfg["kernel_size"]
    dims = [D] + [cfg["unet_input_dim"] * m for m in cfg["dim_mults"]]
    in_out = list(zip(dims[:-1], dims[1:]))
    flops = 2 * batch * (32 * 4 * 32 + 4 * 32 * E)   # the time MLP

    def res(c_in, c_out, L):
        f = _conv(batch, c_out, c_in, k, L) + _conv(batch, c_out, c_out, k, L)
        f += 2 * batch * E * c_out
        return f + (_conv(batch, c_out, c_in, 1, L) if c_in != c_out else 0)

    L = H
    for i, (c_in, c_out) in enumerate(in_out):
        flops += res(c_in, c_out, L) + res(c_out, c_out, L)
        if i < len(in_out) - 1:
            L = (L + 1) // 2
            flops += _conv(batch, c_out, c_out, 3, L)
    mid = dims[-1]
    flops += 2 * res(mid, mid, L)
    for c_in, c_out in reversed(in_out[1:]):
        flops += res(2 * c_out, c_in, L) + res(c_in, c_in, L)
        flops += _conv(batch, c_in, c_in, 4, L)          # transposed: input length
        L *= 2
    c = cfg["unet_input_dim"]
    flops += _conv(batch, c, c, k, L) + _conv(batch, D, c, 1, L)
    return int(flops)


def guide_loop_work(G: int, B: int, H: int, n_iters: int, n_cells: int,
                    hard_values: int) -> Dict[str, float]:
    """Bytes and operations of one launch on x (G, B, H, 4) with hard
    values of `hard_values` floats and no constraint or soft path."""
    n_bytes = 4 * (2 * G * B * H * 4 + H + hard_values + 8) + CELL_BYTES * n_cells
    ops = n_iters * (LOOP_OPS["waypoint"] * G * B * H + LOOP_OPS["inner"] * G * B * (H - 2))
    return {"bytes": n_bytes, "operations": ops}


def bound_s(work: Dict[str, float], peak: Dict[str, float], precision: str) -> float:
    return max(work["bytes"] / peak["hbm_bytes_per_s"], work["operations"] / peak[precision])
