"""Meshes of ranks: the JAX package's device meshes as explicit SPMD.

Twin of `mmd_tpu/parallel/sharding.py`. JAX places arrays on a mesh of
devices and XLA inserts the collectives. Here every rank of a
`torch.distributed` process group runs the same program; a `Mesh` gives
each rank its coordinates along named axes ('dp', 'agent', 'tile') and a
process group per axis, and the code that shards a computation takes its
rank's slice and reassembles the result with a collective: an all-gather
over one axis (`gather_leading_axis`), a broadcast (`broadcast`) or a
mean (`all_reduce_mean`). So `shard_leading_axis` and `shard_axes`
return this rank's slice; JAX's `replicate` has no twin, since every rank
holds the whole tensor already.

The backend is always explicit: "nccl" needs one GPU per rank (it refuses
two ranks on one card); "gloo" runs on the CPU, or with CUDA tensors on
one card, where each collective is staged through host memory and the
computation stays on the card. A collective that waits longer than
TIMEOUT_S raises in its rank. `spawn` runs a function on n ranks, one
process each, started with the spawn method (a forked child cannot use
CUDA).
"""
from __future__ import annotations

import datetime
import os
import shutil
import tempfile
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
TIMEOUT_S = 120.0


class Mesh:
    """The first prod(shape) ranks of the process group, reshaped
    row-major (JAX's `Mesh`): `devices` holds the ranks, `shape` maps each
    axis to its size, `coords` this rank's coordinates (None for a rank
    outside the mesh). Building one creates a process group for each line
    of ranks along each axis, and one for the whole mesh, in the same order
    on every rank, and runs one collective in each: every rank of the
    process group must build it."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        self.axis_names = tuple(axis_names)
        self.devices = np.arange(int(np.prod(shape))).reshape(tuple(shape))
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.rank = dist.get_rank()
        self.backend = str(dist.get_backend())
        where = np.argwhere(self.devices == self.rank)
        self.coords = dict(zip(self.axis_names, where[0].tolist())) if len(where) else None
        self._groups = {}
        for k, axis in enumerate(self.axis_names):
            for line in np.moveaxis(self.devices, k, -1).reshape(-1, self.devices.shape[k]):
                group = dist.new_group(line.tolist())
                if self.rank in line:
                    self._groups[axis] = group
        group = dist.new_group(self.devices.reshape(-1).tolist())
        if self.coords is not None:
            self._groups[None] = group
        # NCCL sets a group's communicator up at its first collective: do
        # that while the mesh is built, not in the first search on it.
        warm = torch.zeros(1, device=_collective_device(self.backend))
        for group in self._groups.values():
            dist.all_reduce(warm, group=group)

    def _member(self):
        if self.coords is None:
            raise ValueError(f"rank {self.rank} is outside the mesh {self.shape}")

    def group(self, axis: Optional[str] = None):
        """The group of this rank's line along `axis`, or of the whole mesh."""
        self._member()
        return self._groups[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate along `axis`."""
        self._member()
        return self.coords[axis]


def make_mesh(n_devices: Optional[Union[int, Sequence[int]]] = None,
              axis_names: Sequence[str] = ("dp",)) -> Mesh:
    """An N-D mesh over the process group's ranks (JAX's `make_mesh`):
    `n_devices` is the rank count, factored across the axes largest first,
    or an explicit per-axis shape matching `axis_names`. Raises without an
    initialized process group (`init_mesh`, or a rank of `spawn`)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialized process group: call init_mesh, "
                           "or run inside a rank of sharding.spawn")
    world = dist.get_world_size()
    if isinstance(n_devices, (list, tuple)):
        shape = tuple(int(s) for s in n_devices)
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} vs axis_names {tuple(axis_names)}")
    else:
        shape = _factor_mesh(int(n_devices or world), len(axis_names))
    total = int(np.prod(shape))
    if total > world:
        raise ValueError(f"mesh {shape} needs {total} ranks, have {world}")
    return Mesh(shape, axis_names)


def _factor_mesh(n: int, n_axes: int) -> tuple:
    """Factor n into n_axes balanced dims: each leading axis takes the
    largest divisor of the remainder not exceeding the balanced share
    rem**(1/axes_left)."""
    shape = [1] * n_axes
    rem = n
    for i in range(n_axes - 1):
        target = max(1, round(rem ** (1.0 / (n_axes - i))))
        best = 1
        for cand in range(1, rem + 1):
            if rem % cand == 0 and best <= cand <= target:
                best = cand
        shape[i] = best
        rem //= best
    shape[-1] = rem
    return tuple(shape)


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def axis_rows(n: int, mesh: Mesh, axis: str) -> slice:
    """This rank's rows of n along `axis`; n must divide by the axis."""
    k = mesh.shape[axis]
    if n % k:
        raise ValueError(f"{n} rows do not divide the mesh's {axis!r} axis of {k}")
    per = n // k
    i = mesh.index(axis)
    return slice(i * per, (i + 1) * per)


def shard_leading_axis(tree, mesh: Mesh, axis: str = "dp"):
    """Every tensor of the tree cut to this rank's rows of its leading axis."""
    return _tree_map(lambda x: x[axis_rows(x.shape[0], mesh, axis)], tree)


def shard_axes(tree, mesh: Mesh, spec: Sequence[Optional[str]]):
    """Every tensor of the tree cut to this rank's block of an explicit
    spec, one mesh axis or None per leading dim (JAX's PartitionSpec):
    ("agent", "dp") cuts dim 0 over agents and dim 1 over the sample batch
    of an (A, B, H, D) team tensor."""
    def cut(x):
        for d, axis in enumerate(spec):
            if axis is not None:
                rows = axis_rows(x.shape[d], mesh, axis)
                x = x.narrow(d, rows.start, rows.stop - rows.start)
        return x

    return _tree_map(cut, tree)


def _staged(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x as a collective's buffer: bool as uint8, and on a gloo group a
    CUDA tensor staged in host memory."""
    buf = x.detach()
    if buf.dtype == torch.bool:
        buf = buf.to(torch.uint8)
    if mesh.backend == "gloo" and buf.is_cuda:
        buf = buf.cpu()
    return buf.contiguous()


def _unstaged(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return buf.to(device=like.device, dtype=like.dtype)


def gather_leading_axis(tree, mesh: Mesh, axis: str):
    """Every tensor of the tree, this rank's rows along `axis`, as the
    whole: an all-gather over the axis's group, the rows in axis order."""
    group = mesh.group(axis)

    def gather(x):
        buf = _staged(x, mesh)
        parts = [torch.empty_like(buf) for _ in range(mesh.shape[axis])]
        dist.all_gather(parts, buf, group=group)
        return _unstaged(torch.cat(parts), x)

    return _tree_map(gather, tree)


def broadcast(tree, mesh: Mesh, src: int = 0):
    """Every tensor of the tree as rank `src` holds it, over the whole
    mesh; the other ranks give tensors of the same shapes and types."""
    group = mesh.group()

    def bcast(x):
        buf = _staged(x, mesh)
        dist.broadcast(buf, src=src, group=group)
        return _unstaged(buf, x)

    return _tree_map(bcast, tree)


def _collective_device(backend: str) -> torch.device:
    """Where a tensor made for a collective lives: NCCL's on the rank's card."""
    if backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def agree(flag: bool, mesh: Mesh) -> bool:
    """Rank 0's flag, on every rank of the mesh: a decision that must not
    split the ranks (a wall-clock deadline)."""
    flag = torch.tensor([flag], device=_collective_device(mesh.backend))
    return bool(broadcast(flag, mesh)[0])


def all_reduce_mean(tensors: List[torch.Tensor], mesh: Mesh, axis: str) -> List[torch.Tensor]:
    """The tensors' means over the ranks of `axis`, as one flat all-reduce."""
    if not tensors:
        return []
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    buf = _staged(flat, mesh)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group(axis))
    flat = _unstaged(buf, flat) / mesh.shape[axis]
    out, at = [], 0
    for t in tensors:
        out.append(flat[at: at + t.numel()].view_as(t))
        at += t.numel()
    return out


def rank_device(backend: str, device, rank: int, world: int) -> torch.device:
    """The device of `rank` of `world` on `backend`: nccl puts rank r on
    cuda:r and needs a GPU per rank; gloo runs every rank on the CPU or on
    the one current card. Anything else raises, naming the backend and
    the GPU count."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    kind = torch.device(device).type
    if kind == "cpu":
        if backend != "gloo":
            raise ValueError(f"{backend} needs CUDA tensors: on the CPU use gloo")
        return torch.device("cpu")
    if kind != "cuda":
        raise ValueError(f"device {device!r}: cpu or cuda")
    n_gpus = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_gpus == 0:
        raise RuntimeError(f"{backend} on cuda, but this machine has no GPU")
    if backend == "nccl":
        if world > n_gpus:
            raise RuntimeError(f"nccl needs one GPU per rank: {world} ranks, {n_gpus} GPU(s); "
                               "gloo runs ranks on one card")
        return torch.device("cuda", rank)
    return torch.device("cuda", torch.cuda.current_device())


def init_mesh(backend: str, rank: int, world: int, store_path: str) -> None:
    """Join `world` ranks as `rank` on `backend`, meeting at a FileStore at
    store_path (a file no earlier run left); a collective that waits past
    TIMEOUT_S raises."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    dist.init_process_group(backend, init_method=f"file://{store_path}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))


def _on_cpu(tree):
    return _tree_map(lambda x: x.detach().cpu(), tree)


def _rank_main(rank: int, fn: Callable, world: int, backend: str, device, run_dir: str,
               args: tuple):
    torch.set_num_threads(1)
    dev = rank_device(backend, device, rank, world)
    if dev.type == "cuda":
        from mmd_torch.ops.build import load_kernels

        torch.cuda.set_device(dev)
        load_kernels()  # built by the parent: each rank loads them
    init_mesh(backend, rank, world, os.path.join(run_dir, "store"))
    try:
        out = fn(rank, dev, *args)
        torch.save(_on_cpu(out), os.path.join(run_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, backend: str, device, *args,
          run_dir: Optional[str] = None) -> list:
    """fn(rank, device, *args) on `world` ranks, one spawned process each,
    in one process group on `backend` (`rank_device` says where each rank
    computes); returns the ranks' results in rank order, moved to the CPU.
    fn must be importable (it is pickled by name) and its results
    tensors, containers of them and plain Python values. The kernels are
    built here before the ranks start. A rank that raises or a collective
    that times out makes the whole call raise. `run_dir` holds the
    rendezvous file and the results, a new directory under the system's
    temporary directory by default, removed at the end."""
    dev = rank_device(backend, device, 0, world)
    if dev.type == "cuda":
        from mmd_torch.ops.build import load_kernels

        load_kernels()
    run_dir = tempfile.mkdtemp(prefix="mmd_mesh_", dir=run_dir)
    try:
        context = torch.multiprocessing.start_processes(
            _rank_main, args=(fn, world, backend, str(device), run_dir, args), nprocs=world,
            join=False, start_method="spawn")
        try:
            while not context.join():
                pass
        finally:
            # A rank's failure has ended the others already; an exception in
            # this process (a deadline's alarm) must not leave them running.
            for proc in context.processes:
                if proc.is_alive():
                    proc.terminate()
                proc.join()
        # Files the ranks of this call wrote: plain containers and tensors.
        return [torch.load(os.path.join(run_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)

