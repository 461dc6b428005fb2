"""A mesh of ranks on torch.distributed, batch sharding and the collectives.

Port of `d3roma_tpu/parallel/mesh.py`. JAX drives every device of a mesh
from one process; PyTorch runs one process per rank, each making the same
calls (SPMD). A `Mesh` here is the grid of world ranks, laid out as JAX's
`Mesh(np.asarray(devices).reshape(shape), axis_names)` lays out devices
(the last axis fastest), with one process group per line of ranks along
each axis. The data axis shards the batch: each rank keeps its rows
(`slice_process_local`, then `shard_batch`) and the metrics are gathered
across it, where JAX's jit partitions one global array.

`init_distributed()` joins the process group `torchrun` describes and picks
the backend from the layout: NCCL when every rank of a host has a card of
its own, gloo when ranks share one (NCCL refuses two ranks on one device)
or run on the CPU. Gloo passes a CUDA tensor through the host; the
collectives here stage it there themselves.

A mesh of one rank needs no process group: its collectives are identities,
so the same code runs with and without `torchrun`. On the meta device (the
pipeline's call-order replica) a collective returns a tensor of the right
shape and moves no data.

`data_rows(index, count)` makes the draws of `randn_rows` (the pipelines'
initial, step and rgb noise) this data rank's rows of the whole batch's
draw, so that a data-parallel evaluation samples the noise a one-process
run draws for the same rows.

Training differentiates through the collectives (`gather_along`,
`sum_along`, `copy_along`: Megatron's conjugate pairs as autograd
functions; under no_grad they are the plain collectives) and averages
the data ranks' gradients in a few flat fp32 buckets (`mean_gradients`).
A mesh may cover the first ranks of the world only (`build_mesh(...,
allow_idle=True)`): the ranks past it join every process group and get
no mesh.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from d3roma_tpu_torch.device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

DATA_AXIS = "data"


@dataclass(eq=False)
class Mesh:
    """A grid of world ranks: `axis_names` and their sizes `shape`, this
    process's `rank`, its `device`, the `backend` of its process group, and
    `groups`, the process group of this rank's line of ranks along each
    axis of more than one rank (an axis of one rank has none)."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    rank: int = 0
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    backend: Optional[str] = None
    groups: Dict[str, Any] = field(default_factory=dict)
    group: Any = None  # the process group of every rank of the mesh

    def __deepcopy__(self, memo):
        return self  # a handle on process groups: copies of a model share it

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    def coord(self, axis: str) -> int:
        """This rank's index along `axis` (the last axis fastest)."""
        return int(np.unravel_index(self.rank, self.shape)[self.axis_names.index(axis)])


_STATE = threading.local()
_DEVICE: Optional[torch.device] = None
_TIMEOUT: Optional[timedelta] = None  # init_distributed's, for every group made after it
# the bytes a collective of the data ranks' gradient mean or of a gathered state
GRAD_BUCKET_BYTES = 256 * 2**20
# the collectives that moved data: calls, this rank's bytes sent in, and the
# host's wall seconds inside them (each waits for its result)
COLLECTIVES = {"calls": 0, "bytes": 0, "seconds": 0.0}


def _count(x: torch.Tensor, t0: float) -> None:
    COLLECTIVES["calls"] += 1
    COLLECTIVES["bytes"] += x.numel() * x.element_size()
    COLLECTIVES["seconds"] += time.perf_counter() - t0


def pick_backend(device: torch.device, local_world: int) -> str:
    """NCCL when each of a host's `local_world` ranks has a card of its own,
    gloo when they share cards or run on the CPU."""
    if device.type == "cuda" and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def init_distributed(device: DeviceLike = None, timeout_s: float = 600.0) -> torch.device:
    """Join the process group of `torchrun`'s environment (RANK, WORLD_SIZE,
    LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT) and return this
    rank's device: `device`'s type (CUDA unless the caller names the CPU),
    on CUDA the card LOCAL_RANK % the host's cards. Without that environment,
    or with a world of one, it joins nothing. A process group that is
    already up is kept."""
    global _DEVICE, _TIMEOUT
    dev = resolve_device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        torch.empty(1, device=dev)  # a card this rank cannot reach raises here
    if world > 1 and not dist.is_initialized():
        backend = pick_backend(dev, local_world)
        _TIMEOUT = timedelta(seconds=timeout_s)
        dist.init_process_group(backend, timeout=_TIMEOUT)
        logger.info("rank %d of %d on %s: backend %s (%d ranks on this host, %d cards)",
                    dist.get_rank(), world, dev, backend, local_world,
                    torch.cuda.device_count() if dev.type == "cuda" else 0)
    _DEVICE = dev
    return dev


def _world() -> Tuple[int, int, Optional[str]]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), dist.get_backend()
    return 0, 1, None


def _new_group(ranks, world: int):
    if len(ranks) == world:
        return dist.group.WORLD
    return dist.new_group(ranks, timeout=_TIMEOUT) if _TIMEOUT else dist.new_group(ranks)


def build_mesh(shape: Sequence[int], axis_names: Sequence[str],
               device: DeviceLike = None, allow_idle: bool = False) -> Optional[Mesh]:
    """The mesh of `shape` over the world (their product must be the world
    size), or, with `allow_idle`, over its first prod(shape) ranks: the
    ranks past them get None. Every rank must call it, in the same order:
    it makes the process group of every line of ranks along every axis and
    of the whole mesh."""
    rank, world, backend = _world()
    shape = tuple(int(s) for s in shape)
    size = int(np.prod(shape))
    if size != world and not (allow_idle and size < world):
        raise ValueError(f"a mesh of shape {shape} needs {size} ranks; the world has {world}")
    if device is not None:
        dev = resolve_device(device)
    else:
        dev = _DEVICE if _DEVICE is not None else resolve_device(None)
    grid = np.arange(size).reshape(shape)
    groups = {}
    for a, name in enumerate(axis_names):
        if shape[a] == 1:
            continue
        lines = np.moveaxis(grid, a, -1).reshape(-1, shape[a])
        for line in lines:
            ranks = [int(r) for r in line]
            group = _new_group(ranks, world)
            if rank in ranks:
                groups[name] = group
    whole = _new_group(list(range(size)), world) if size > 1 else None
    if rank >= size:
        return None
    return Mesh(tuple(axis_names), shape, rank, dev, backend, groups, whole)


def make_mesh(device: DeviceLike = None, axis: str = DATA_AXIS) -> Mesh:
    """A 1-D mesh over every rank of the world."""
    return build_mesh((_world()[1],), (axis,), device)


# ---------------------------------------------------------------------- #
# collectives along one axis of a mesh
# ---------------------------------------------------------------------- #


def _pinned(shape, dtype) -> torch.Tensor:
    """Page-locked host memory (PyTorch's caching host allocator keeps the
    blocks for the next collective of that size)."""
    return torch.empty(tuple(shape), dtype=dtype, pin_memory=True)


def _through_host(x: torch.Tensor, mesh: Mesh) -> bool:
    return mesh.backend == "gloo" and x.device.type == "cuda"


def _staged(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x where the backend reads it: gloo takes CUDA tensors through the
    host (a page-locked copy: the card's copies run at the link's rate),
    NCCL host tensors through the rank's card."""
    if _through_host(x, mesh):
        host = _pinned(x.shape, x.dtype)
        host.copy_(x)
        return host
    if mesh.backend == "nccl" and x.device.type == "cpu":
        return x.to(mesh.device)
    return x.contiguous()


def all_gather_cat(x: torch.Tensor, mesh: Mesh, axis: str, dim: int,
                   out_device: DeviceLike = None) -> torch.Tensor:
    """The concatenation along `dim` of every rank's x on the line of ranks
    along `axis`, in their order along it, on `out_device` (x's by
    default)."""
    n = mesh.axis_sizes.get(axis, 1)
    if n == 1:
        return x
    if x.device.type == "meta":
        return torch.cat([x] * n, dim=dim)
    t0 = time.perf_counter()
    xs = _staged(x, mesh)
    dev = x.device if out_device is None else torch.device(out_device)
    if _through_host(x, mesh):
        # every rank's part into one page-locked buffer, concatenated where
        # the result lives (on the card: a device copy, not a host one)
        parts = _pinned((n,) + tuple(xs.shape), xs.dtype)
        dist.all_gather(list(parts.unbind(0)), xs, group=mesh.groups[axis])
        out = torch.cat(parts.to(dev).unbind(0), dim=dim)
    else:
        parts = [torch.empty_like(xs) for _ in range(n)]
        dist.all_gather(parts, xs, group=mesh.groups[axis])
        out = torch.cat(parts, dim=dim).to(dev)
    _count(x, t0)
    return out


def all_reduce(x: torch.Tensor, mesh: Mesh, axis: str, op: str = "sum") -> torch.Tensor:
    """The elementwise sum (or "max") of every rank's x along `axis`, as a
    new tensor of x's dtype. The sum is taken in fp32 for narrower floats
    (for two ranks that is their sum rounded once)."""
    n = mesh.axis_sizes.get(axis, 1)
    if n == 1 or x.device.type == "meta":
        return x.clone()
    t0 = time.perf_counter()
    src = x.float() if x.is_floating_point() and x.element_size() < 4 else x
    y = _staged(src, mesh)
    if y.data_ptr() == x.data_ptr():
        y = y.clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                    group=mesh.groups[axis])
    out = y.to(x.device, x.dtype)
    _count(x, t0)
    return out


def broadcast_object(obj, mesh: Mesh):
    """Rank 0's `obj` (picklable) on every rank of the mesh."""
    if mesh.size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.group,
                               device=torch.device("cpu") if mesh.backend == "gloo" else None)
    return box[0]


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every rank of the mesh."""
    if mesh is not None and mesh.size > 1:
        dist.barrier(group=mesh.group)


def replicate_state(state, mesh: Mesh):
    """Broadcast rank 0's values of `state` (a module, or a dict of tensors)
    to every rank of the mesh, in place; returns `state`."""
    if mesh.size == 1:
        return state
    if isinstance(state, torch.nn.Module):
        tensors = list(state.parameters()) + list(state.buffers())
    else:
        tensors = [v for v in state.values() if isinstance(v, torch.Tensor)]
    with torch.no_grad():
        for t in tensors:
            staged = _staged(t, mesh)
            dist.broadcast(staged, src=0, group=mesh.group)
            if staged.data_ptr() != t.data_ptr():
                t.copy_(staged)
    return state


# ---------------------------------------------------------------------- #
# the collectives under autograd
# ---------------------------------------------------------------------- #


class _GatherAlong(torch.autograd.Function):
    """all_gather_cat; backward: this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather_cat(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        n = ctx.mesh.axis_sizes[ctx.axis]
        return g.chunk(n, ctx.dim)[ctx.mesh.coord(ctx.axis)], None, None, None


class _SumAlong(torch.autograd.Function):
    """all_reduce (sum); backward: the gradient as it is (every rank's
    partial product gets the whole output's gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyAlong(torch.autograd.Function):
    """The identity; backward: the sum of every rank's gradient (a
    replicated input feeding a sharded layer, whose rank computes only its
    part of the input's gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axis), None, None


def _traced(x: torch.Tensor, mesh: Mesh, axis: str) -> bool:
    """Whether a collective on x must carry a gradient."""
    return (mesh.axis_sizes.get(axis, 1) > 1 and torch.is_grad_enabled()
            and x.requires_grad)


def gather_along(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """`all_gather_cat` that carries a gradient: each rank's slice of it."""
    if _traced(x, mesh, axis):
        return _GatherAlong.apply(x, mesh, axis, dim)
    return all_gather_cat(x, mesh, axis, dim)


def sum_along(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """`all_reduce` (sum) that carries a gradient: the output's, to every
    rank."""
    if _traced(x, mesh, axis):
        return _SumAlong.apply(x, mesh, axis)
    return all_reduce(x, mesh, axis)


def copy_along(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """x, whose gradient is summed over `axis` in the backward pass; x
    itself where no gradient flows."""
    if _traced(x, mesh, axis):
        return _CopyAlong.apply(x, mesh, axis)
    return x


def mean_gradients(grads: Sequence[torch.Tensor], mesh: Mesh, axis: str = DATA_AXIS) -> list:
    """The mean over `axis` of every rank's gradients, in order: fp32 flat
    buckets of about GRAD_BUCKET_BYTES, one all-reduce each; each gradient
    comes back in its dtype."""
    n = mesh.axis_sizes.get(axis, 1)
    out = list(grads)
    if n == 1:
        return out
    bucket: list = []

    def flush():
        flat = torch.cat([out[i].reshape(-1).float() for i in bucket])
        total = all_reduce(flat, mesh, axis) / n
        offset = 0
        for i in bucket:
            k = out[i].numel()
            out[i] = total[offset:offset + k].view(out[i].shape).to(out[i].dtype)
            offset += k
        bucket.clear()

    size = 0
    for i, g in enumerate(out):
        bucket.append(i)
        size += g.numel() * 4
        if size >= GRAD_BUCKET_BYTES:
            flush()
            size = 0
    if bucket:
        flush()
    return out


# ---------------------------------------------------------------------- #
# batches
# ---------------------------------------------------------------------- #


def shard_batch(batch: Dict, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's rows of a batch (host arrays, already cut by
    `slice_process_local`) as tensors on the mesh's device; lists and
    strings are dropped, as the JAX package drops them."""
    return {k: torch.as_tensor(np.asarray(v)).to(mesh.device) for k, v in batch.items()
            if not isinstance(v, (list, str))}


def slice_process_local(batch: Dict, process_index: Optional[int] = None,
                        process_count: Optional[int] = None) -> Dict:
    """Keep this process's contiguous row-slice of a host-global batch.

    Loaders are seed-identical on every rank, so before `shard_batch` each
    rank keeps only ITS rows. The leading dim must divide process_count
    (pad first with `pad_batch_to_devices`). A data-parallel run passes its
    index along the data axis and that axis's size (the defaults are the
    world rank and size)."""
    rank, world, _ = _world()
    pc = process_count if process_count is not None else world
    if pc <= 1:
        return batch
    pi = process_index if process_index is not None else rank
    rows = next(v.shape[0] for v in batch.values()
                if getattr(v, "ndim", 0) >= 1)
    assert rows % pc == 0, f"batch rows {rows} not divisible by {pc} processes"
    per = rows // pc
    return {
        k: (v[pi * per:(pi + 1) * per]
            if getattr(v, "ndim", 0) >= 1 and v.shape[0] == rows else v)
        for k, v in batch.items()
    }


def pad_batch_to_devices(batch: Dict, n_devices: int) -> Dict:
    """Pad the batch so the leading dim divides the mesh (eval tails).

    Adds a ``sample_valid`` [B] row marking real samples (1.0) vs padded
    duplicates (0.0) so downstream metric accumulation can drop the
    duplicates (the reference de-duplicates this case with Accelerate's
    `gather_for_metrics`)."""
    out = {}
    orig_b = None
    for k, v in batch.items():
        if isinstance(v, (list, str)):
            out[k] = v
            continue
        v = np.asarray(v)
        if v.ndim == 0:
            out[k] = v
            continue
        b = v.shape[0]
        rem = (-b) % n_devices
        if orig_b is None:
            orig_b = b
        if rem:
            pad = np.repeat(v[-1:], rem, axis=0)
            v = np.concatenate([v, pad], axis=0)
        out[k] = v
    if orig_b is not None:
        padded_b = orig_b + ((-orig_b) % n_devices)
        out["sample_valid"] = (np.arange(padded_b) < orig_b).astype(np.float32)
    return out


# ---------------------------------------------------------------------- #
# noise of a data rank
# ---------------------------------------------------------------------- #


@contextlib.contextmanager
def data_rows(index: int, count: int):
    """Within the block, `randn_rows` draws the noise of `count` data ranks'
    rows and returns rank `index`'s (thread-local)."""
    prev = getattr(_STATE, "rows", (0, 1))
    _STATE.rows = (int(index), int(count))
    try:
        yield
    finally:
        _STATE.rows = prev


def randn_rows(shape, generator: Optional[torch.Generator], dtype, device) -> torch.Tensor:
    """torch.randn(shape) from `generator`; inside `data_rows(i, n)`, rows
    i * B .. (i + 1) * B of the draw for n * B rows (B = shape[0])."""
    index, count = getattr(_STATE, "rows", (0, 1))
    shape = tuple(shape)
    if count == 1:
        return torch.randn(shape, generator=generator, dtype=dtype, device=device)
    full = torch.randn((count * shape[0],) + shape[1:], generator=generator, dtype=dtype,
                       device=device)
    return full[index * shape[0]:(index + 1) * shape[0]]
