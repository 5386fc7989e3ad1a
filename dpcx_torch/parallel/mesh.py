"""Meshes of processes, and the collectives the port runs over them (port of
``dpcx/parallel/mesh.py``).

dpcx runs one program over a mesh of jax devices: ``shard_map`` and XLA
insert the collectives. The port runs one process per rank under
``torch.distributed``, each rank on its own device, and calls the
collectives itself. It calls only ``all_reduce`` and ``broadcast``: those
two take CUDA tensors under both NCCL and gloo, so the same code runs with
a card per rank (NCCL) and with ranks that share a card (gloo).

Gradients through a collective follow dpcx's convention, ``shard_map`` with
``check_vma=False``: every value in a rank is a partial whose sum over the
mesh's ranks is the whole. So the cotangent of a replicated output is
divided by the number of ranks where it leaves a function
(``scale_grad``), a sum over ranks in the forward has a sum over ranks in
the backward (``all_sum``), and a replicated input that a rank uses on its
own (its shard, or all of it) takes the sum over ranks of its cotangents
(``sum_grad``). A gather is an ``all_sum`` of a zeroed ``[ranks, ...]``
tensor in which each rank fills its own slot (``gather_slots``): exact,
and its backward is the sum over ranks, then the rank's own slot.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Sequence

import torch
import torch.distributed as dist

from dpcx_torch.config import Config, world_size
from dpcx_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks along dpcx's mesh axes, as this process sees them.

    ``shape`` and ``axes`` are dpcx's (``cfg.mesh_shape`` with ``-1``
    resolved, ``cfg.mesh_axes``); ``size`` is their product, the number of
    slots (batch or point shards). ``index`` is this process's slot, None
    where it holds none. ``members`` are the ranks that join the mesh's
    collectives, over ``group`` (None: the default group); a member without
    a slot holds an empty shard."""

    shape: tuple[int, ...]
    axes: tuple[str, ...]
    rank: int
    index: int | None
    device: torch.device
    members: tuple[int, ...] = (0,)
    group: Any = None

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def world(self) -> int:
        """The processes that join the mesh's collectives."""
        return len(self.members)


def rank() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def mesh_shape(cfg: Config | None, n: int) -> tuple[int, ...]:
    """dpcx's mesh shape for ``n`` ranks: ``cfg.mesh_shape`` with ``-1``
    meaning all of them; raises where a fixed shape does not hold ``n``."""
    want = cfg.mesh_shape if cfg is not None else (-1,)
    shape = tuple(n if s == -1 else s for s in want)
    if math.prod(shape) != n:
        raise ValueError(f"mesh_shape {want} cannot hold {n} ranks")
    return shape


def make_mesh(cfg: Config | None = None, ranks: Sequence[int] | None = None,
              device="cuda", join_all: bool = False) -> Mesh:
    """dpcx's ``make_mesh``: a mesh of ``ranks`` (None: every rank of the
    default group) on this process's ``device``, shaped by ``cfg``.

    Its collectives run over ``ranks`` alone, a new group when they are
    not all of the default group (every rank must then call this, as
    ``dist.new_group`` needs), and a rank outside them must not call them.
    With ``join_all`` every rank of the default group joins them, and those
    outside ``ranks`` hold empty shards."""
    world, me = world_size(), rank()
    ranks = tuple(range(world)) if ranks is None else tuple(ranks)
    if not ranks or len(set(ranks)) != len(ranks) or \
            not all(0 <= r < world for r in ranks):
        raise ValueError(f"ranks {ranks} are not distinct ranks of a world "
                         f"of {world}")
    shape = mesh_shape(cfg, len(ranks))
    axes = tuple(cfg.mesh_axes) if cfg is not None else ("data",)
    if join_all or len(ranks) == world:
        members, group = tuple(range(world)), None
    else:
        members, group = ranks, dist.new_group(list(ranks))
    return Mesh(shape=shape, axes=axes, rank=me,
                index=ranks.index(me) if me in ranks else None,
                device=torch.device(device), members=members, group=group)


def init_from_env(device="cuda") -> torch.device:
    """Join the process group that ``torch.distributed.run`` describes in
    ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``, and
    return this rank's device: ``cuda:<LOCAL_RANK mod device_count>`` for a
    CUDA ``device``, else the CPU. The backend is NCCL where every rank of
    the node has a card of its own and gloo where ranks share one or run on
    the CPU; the choice is printed, and nothing retries with the other.
    Without those variables (a plain process) nothing is joined and
    ``device`` comes back as given; a group already made is kept."""
    device = torch.device(device)
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return device
    me, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError(f"rank {me}: --device {device} but no CUDA "
                               "card is visible")
        device = torch.device("cuda", local % cards)
        torch.cuda.set_device(device)
        backend = "nccl" if local_world <= cards else "gloo"
        why = (f"{local_world} ranks on {cards} card(s) of this node")
    else:
        device, backend, why = torch.device("cpu"), "gloo", "the CPU"
    if not dist.is_initialized():
        dist.init_process_group(backend, rank=me, world_size=world)
        print(f"[dpcx_torch] rank {me} of {world} on {device}: backend "
              f"{backend} ({why})", flush=True)
    return device


def barrier(device) -> None:
    """Wait for every rank of the default group (an ``all_reduce`` of one
    element, which NCCL and gloo both take on ``device``)."""
    if world_size() > 1:
        dist.all_reduce(torch.zeros(1, device=device))


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0,
               group=None) -> None:
    """Rank ``src``'s values into ``tensors`` on every rank of ``group``
    (None: the default group), in place, one ``broadcast`` each. The wire
    carries a contiguous copy: a tensor's strides may differ from rank to
    rank (a loaded Adam moment, a new one like its parameter)."""
    for t in tensors:
        buf = t.contiguous()
        dist.broadcast(buf, src, group=group)
        if buf is not t:
            t.copy_(buf)


def all_mean_(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """The mean over the mesh's ranks of each of ``tensors``, in place,
    through one ``all_reduce`` of their concatenation (dpcx's ``pmean``)."""
    if mesh.world == 1:
        return
    sizes = [t.numel() for t in tensors]
    with span("parallel.all_mean", bytes=4 * sum(sizes)):  # float32
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        dist.all_reduce(flat, group=mesh.group)
        flat /= mesh.world
        for t, part in zip(tensors, flat.split(sizes)):
            t.detach().copy_(part.view_as(t))


class _AllSum(torch.autograd.Function):
    """Sum over the mesh's ranks; the backward sums the cotangents."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=mesh.group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.mesh.group)
        return g, None


class _SumGrad(torch.autograd.Function):
    """Identity; the backward sums the cotangents over the mesh's ranks."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.mesh.group)
        return g, None


class _ScaleGrad(torch.autograd.Function):
    """Identity; the backward divides the cotangent by the mesh's ranks."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.world = mesh.world
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.world, None


def all_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """dpcx's ``psum``: ``x`` summed over the mesh's ranks."""
    return x if mesh.world == 1 else _AllSum.apply(x, mesh)


def sum_grad(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A replicated input that a rank uses on its own: ``x``, whose
    cotangent is summed over the mesh's ranks."""
    return x if mesh.world == 1 else _SumGrad.apply(x, mesh)


def scale_grad(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A replicated output: ``x``, whose cotangent is divided by the mesh's
    ranks (each rank's part of the whole)."""
    return x if mesh.world == 1 else _ScaleGrad.apply(x, mesh)


def gather_slots(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """dpcx's ``all_gather``: ``[mesh.size, *x.shape]``, slot i holding
    the ``x`` of the rank at index i."""
    slots = x.new_zeros((mesh.size,) + tuple(x.shape))
    if mesh.index is not None:
        slots = slots.index_copy(
            0, torch.tensor([mesh.index], device=x.device), x[None])
    return all_sum(slots, mesh)


def shard_bounds(n: int, mesh: Mesh) -> tuple[int, int]:
    """This rank's rows ``[lo, hi)`` of ``n`` split evenly over the mesh's
    slots (empty without a slot); raises unless they divide ``n``."""
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split over {mesh.size} ranks")
    if mesh.index is None:
        return 0, 0
    per = n // mesh.size
    return mesh.index * per, (mesh.index + 1) * per


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """dpcx's ``shard_batch``: this rank's rows of each batch field."""
    if mesh.index is None:
        raise ValueError(f"rank {mesh.rank} holds no slot of the mesh")
    out = {}
    for k, v in batch.items():
        lo, hi = shard_bounds(len(v), mesh)
        out[k] = v[lo:hi]
    return out
