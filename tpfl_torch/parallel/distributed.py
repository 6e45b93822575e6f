"""Multi-process runtime over ``torch.distributed`` — counterpart of
:mod:`tpfl.parallel.distributed` (``distributed.py:40-89``), and the
collectives the port's SPMD planes (ring attention, the pipeline, the
experts) are built from.

One process per device. After :func:`ensure_distributed` the processes
form one ``torch.distributed`` world: ``gloo`` for CPU tensors, ``nccl``
for the card. Environment contract, as the reference's:
``TPFL_COORDINATOR`` (host:port), ``TPFL_NUM_PROCESSES``,
``TPFL_PROCESS_ID``; explicit arguments win. A lone process returns False
and leaves ``torch.distributed`` untouched.

The reference's SPMD code runs inside ``shard_map``, where ``ppermute``,
``all_gather`` and ``all_to_all`` are differentiable and a replicated
loss differentiates to the single-device gradients. Here every rank runs
its own autograd graph, so each collective is a ``torch.autograd.Function``
whose backward is the transpose of its forward, under the rule that the
loss is replicated (every rank computes the same loss from the same
gathered outputs, as ``make_ring_attention``'s ``apply`` returns them):

- :func:`shard` / :func:`gather` — Megatron's scatter-to / gather-from
  region pair: ``shard`` takes this rank's slice of a replicated tensor
  and all-gathers the gradients; ``gather`` all-gathers the slices and
  takes back only this rank's slice of the cotangent (each rank holds the
  whole replicated cotangent, so summing them would give n times the
  gradient);
- :func:`replicate` — a replicated tensor used in rank-local work:
  identity forward, gradients summed over the ranks (the transpose of
  ``shard_map``'s broadcast of an unsharded input);
- :func:`pmean` — the mean over the ranks; its backward divides the
  replicated cotangent by n;
- :func:`shift` — ``ppermute`` by a fixed offset; its backward shifts the
  other way;
- :func:`all_to_all` — ``all_to_all`` over the leading axis; its backward
  is the inverse exchange.

On a one-rank group each is the identity and makes no call, as the
reference's collectives over a one-device axis move nothing: the card's
machine runs every plane at axis size 1, and the multi-rank exchange is
held to the reference on the CPU over ``gloo``.

``global_put`` / ``local_data`` place and read arrays through shardings:
they wait for DTensor placements (``ROADMAP.md`` §1 item 7).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from tpfl_torch import DeviceLike, resolve_device

__all__ = [
    "all_to_all", "ensure_distributed", "gather",
    "is_multiprocess", "pmean", "replicate", "send_recv", "shard", "shift",
]

#: ``torch.distributed``'s default: a hung peer fails the collective after it.
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def ensure_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: DeviceLike = None,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> bool:
    """Join the multi-process world if one is configured; idempotent.

    Each parameter resolves from its argument, then the
    ``TPFL_COORDINATOR`` / ``TPFL_NUM_PROCESSES`` / ``TPFL_PROCESS_ID``
    environment. Returns True iff the process is part of a world of more
    than one process after the call; a lone process (no coordinator, or
    one process) returns False and initialises nothing. ``device``
    (``None`` means ``cuda``) picks the backend: ``nccl`` for the card,
    with this rank's card made current, ``gloo`` for the CPU."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator_address = coordinator_address or os.environ.get("TPFL_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("TPFL_NUM_PROCESSES", "0") or 0)
    if process_id is None:
        process_id = int(os.environ.get("TPFL_PROCESS_ID", "0") or 0)
    if not coordinator_address or int(num_processes) <= 1:
        return False
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(process_id) % torch.cuda.device_count())
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id), timeout=timeout,
    )
    return dist.get_world_size() > 1


def is_multiprocess() -> bool:
    """True when this process is one of several in a ``torch.distributed``
    world."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def send_recv(tensors: Sequence[torch.Tensor], group: dist.ProcessGroup, offset: int = 1,
              wrap: bool = True) -> list[torch.Tensor]:
    """``ppermute`` by ``offset`` without autograd: each tensor goes to the
    rank ``offset`` ahead on the axis and one comes from the rank
    ``offset`` behind, every send and receive posted together
    (``batch_isend_irecv``), so a ring cannot deadlock. Without ``wrap``
    the axis is a line: the last ranks send nothing and the first receive
    zeros, as ``ppermute`` leaves a device no pair names. One rank: the
    tensors as they are."""
    n = dist.get_world_size(group)
    if n == 1:
        return list(tensors)
    my = dist.get_rank(group)
    dst, src = my + offset, my - offset
    if wrap:
        dst, src = dst % n, src % n
    outs = [torch.zeros_like(t) if not 0 <= src < n else torch.empty_like(t) for t in tensors]
    ops = []
    for tag, (t, out) in enumerate(zip(tensors, outs)):
        if 0 <= dst < n:
            ops.append(dist.P2POp(dist.isend, t.contiguous(), dist.get_global_rank(group, dst),
                                  group, tag))
        if 0 <= src < n:
            ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src), group, tag))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return outs


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, offset: int, wrap: bool, *xs: torch.Tensor):
        ctx.group, ctx.offset, ctx.wrap = group, offset, wrap
        return tuple(send_recv(xs, group, offset, wrap))

    @staticmethod
    def backward(ctx, *gs: torch.Tensor):
        return (None, None, None, *send_recv(gs, ctx.group, -ctx.offset, ctx.wrap))


def shift(xs: Sequence[torch.Tensor], group: dist.ProcessGroup, offset: int = 1,
          wrap: bool = True) -> list[torch.Tensor]:
    """Differentiable :func:`send_recv`: the transpose of a shift is the
    shift the other way. The tensors travel in one exchange and one
    autograd node, so their backward exchanges cannot be taken in another
    order on another rank. Every rank of the group must call it at the
    same point of its forward, and each rank's results must reach its
    loss, or the backward exchanges of different ranks would not pair."""
    if dist.get_world_size(group) == 1:
        return list(xs)
    return list(_Shift.apply(group, offset, wrap, *xs))


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _local_slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    size = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(group) * size, size).contiguous()


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim: int, group, *xs: torch.Tensor):
        ctx.dim, ctx.group = dim, group
        return tuple(_local_slice(x, dim, group) for x in xs)

    @staticmethod
    def backward(ctx, *gs: torch.Tensor):
        return (None, None, *(_all_gather(g, ctx.dim, ctx.group) for g in gs))


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int, group) -> torch.Tensor:
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _local_slice(g, ctx.dim, ctx.group), None, None


def shard(xs: Sequence[torch.Tensor], dim: int, group: dist.ProcessGroup) -> list[torch.Tensor]:
    """This rank's slice along ``dim`` of each replicated tensor
    (``shard_map``'s ``in_specs`` for a sharded dim); each ``shape[dim]``
    must divide by the axis size. Backward: the ranks' gradients
    all-gathered, in one autograd node for all the tensors (so every rank
    gathers them in the same order)."""
    n = dist.get_world_size(group)
    for x in xs:
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of size {x.shape[dim]} does not split over "
                             f"{n} ranks")
    if n == 1:
        return list(xs)
    return list(_Shard.apply(dim, group, *xs))


def gather(x: torch.Tensor, dim: int, group: dist.ProcessGroup) -> torch.Tensor:
    """The ranks' slices concatenated along ``dim`` on every rank
    (``out_specs`` of a sharded dim). Backward: this rank's slice of the
    replicated cotangent, and only that."""
    if dist.get_world_size(group) == 1:
        return x
    return _Gather.apply(x, dim, group)


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def replicate(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """A replicated tensor entering rank-local work (router weights, a
    replicated input): identity forward; backward sums the ranks'
    gradients, so every rank holds the whole gradient."""
    if dist.get_world_size(group) == 1:
        return x
    return _Replicate.apply(x, group)


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.n = dist.get_world_size(group)
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out / ctx.n

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g / ctx.n, None


def pmean(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """The mean of ``x`` over the ranks, on every rank (``lax.pmean``).
    Backward: the replicated cotangent over n."""
    if dist.get_world_size(group) == 1:
        return x
    return _PMean.apply(x, group)


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _exchange(g, ctx.group), None


def all_to_all(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_axis=0, concat_axis=0,
    tiled=False)``: ``x [n, ...]``; row ``e`` goes to rank ``e``, and row
    ``i`` of the result came from rank ``i``. The exchange is its own
    inverse, and its backward."""
    n = dist.get_world_size(group)
    if x.shape[0] != n:
        raise ValueError(f"all_to_all: leading dim {x.shape[0]} != axis size {n}")
    if n == 1:
        return x
    return _AllToAll.apply(x, group)
