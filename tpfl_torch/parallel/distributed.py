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

The engine's fold and the FSDP trainer use plain (non-autograd) helpers
of the same module: :func:`all_reduce`, :func:`all_gather`,
:func:`reduce_scatter`, and :func:`fsdp_gather`, whose backward
reduce-scatters the gradients.

**The collective ledger.** Every collective of the port is issued by a
helper of this module, and each helper records ``(kind, bytes)`` while a
:func:`record_collectives` context is open: the reference's kinds
(``all-reduce``, ``all-gather``, ``reduce-scatter``,
``collective-permute``, ``all-to-all``) and the bytes of the tensor the
collective delivers, as ``tpfl/parallel/scaling.py`` counts result
shapes in HLO. A helper records at every group size, a one-rank group
included (where it then makes no call): what the program would ship, not
what the wire happened to carry. :mod:`tpfl_torch.parallel.scaling`
reads it.

:func:`global_put` places a host tree on a mesh as ``DTensor`` s, each
rank keeping only its own slice (every rank holds the same host copy:
the single-controller contract of ``crosshost``); :func:`local_data`
reads a rank's shard back as numpy; :func:`full_tensor` gathers a
``DTensor`` through the ledger's helpers. :func:`send_bytes` /
:func:`recv_bytes` carry pickled headers between two ranks on
:func:`wire_device` (the simulation pool's sharded chunks).
"""

from __future__ import annotations

import contextlib
import datetime
import os
import threading
from typing import Any, Iterator, Optional, Sequence

import torch
import torch.distributed as dist

from tpfl_torch import DeviceLike, resolve_device

__all__ = [
    "COLLECTIVE_KINDS", "CollectiveLedger", "all_gather", "all_reduce", "all_to_all",
    "ensure_distributed", "fsdp_gather", "full_tensor", "gather", "global_put",
    "is_multiprocess", "local_data", "local_slice", "place_like", "pmean", "recv_bytes",
    "record_collectives", "reduce_scatter",
    "replicate", "send_bytes", "send_recv", "shard", "shift", "sync_mean", "wire_device",
]

#: The reference's collective kinds (``tpfl/parallel/scaling.py:31-37``).
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "collective-permute",
                    "all-to-all")


class CollectiveLedger:
    """The collectives recorded while one :func:`record_collectives`
    context was open: ``events`` is the ordered ``(kind, bytes)`` list."""

    def __init__(self) -> None:
        self.events: list[tuple[str, int]] = []

    def by_kind(self) -> dict[str, int]:
        """Bytes per kind, as ``scaling.collective_bytes`` returns them."""
        out: dict[str, int] = {}
        for kind, nbytes in self.events:
            out[kind] = out.get(kind, 0) + nbytes
        return out

    def total(self) -> int:
        return sum(n for _, n in self.events)


# The open ledgers of this process; a stack, so contexts nest (each
# records every collective issued while it is open).
_ledgers: list[CollectiveLedger] = []
_ledger_lock = threading.Lock()


@contextlib.contextmanager
def record_collectives() -> Iterator[CollectiveLedger]:
    """Record every collective this process issues inside the block."""
    ledger = CollectiveLedger()
    with _ledger_lock:
        _ledgers.append(ledger)
    try:
        yield ledger
    finally:
        with _ledger_lock:
            _ledgers.remove(ledger)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _record(kind: str, nbytes: int) -> None:
    if _ledgers:
        for ledger in list(_ledgers):
            ledger.events.append((kind, int(nbytes)))

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


def wire_device() -> torch.device:
    """The device this world's point-to-point tensors travel on: the
    current card under ``nccl``, the host under ``gloo`` (its send and
    receive take CPU tensors, whatever device the ranks compute on)."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def send_bytes(data: bytes, dst: int) -> None:
    """``data`` to global rank ``dst``: its length, then its bytes, on
    :func:`wire_device`. The receiver calls :func:`recv_bytes`."""
    dev = wire_device()
    dist.send(torch.tensor([len(data)], dtype=torch.int64, device=dev), dst)
    dist.send(torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev), dst)


def recv_bytes(src: int, timeout: Optional[datetime.timedelta] = None) -> bytes:
    """The bytes :func:`send_bytes` sent from global rank ``src``. The
    length waits ``timeout`` (None: the group's own); a peer that exits
    fails the wait at once."""
    dev = wire_device()
    n = torch.empty(1, dtype=torch.int64, device=dev)
    work = dist.irecv(n, src)
    if timeout is None:
        work.wait()
    else:
        work.wait(timeout)
    buf = torch.empty(int(n.item()), dtype=torch.uint8, device=dev)
    dist.recv(buf, src)
    return buf.cpu().numpy().tobytes()


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
    _record("collective-permute", sum(_nbytes(t) for t in tensors))
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
    n = dist.get_world_size(group)
    _record("all-gather", n * _nbytes(x))
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def all_gather(x: torch.Tensor, dim: int, group: dist.ProcessGroup) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` on every rank, without
    autograd (``x`` itself on a one-rank group)."""
    return _all_gather(x, dim, group)


def all_reduce(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """The sum of ``x`` over the ranks, on every rank, without autograd
    (``lax.psum``): a new tensor; ``x`` itself on a one-rank group."""
    _record("all-reduce", _nbytes(x))
    if dist.get_world_size(group) == 1:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, group=group)
    return out


_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def reduce_scatter(x: torch.Tensor, dim: int, group: dist.ProcessGroup) -> torch.Tensor:
    """This rank's slice along ``dim`` of the sum of ``x`` over the ranks
    (``lax.psum_scatter(..., tiled=True)``), without autograd."""
    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of size {x.shape[dim]} does not split over {n} ranks")
    _record("reduce-scatter", _nbytes(x) // n)
    if n == 1:
        return x
    moved = x.detach().movedim(dim, 0).contiguous()
    out = moved.new_empty((moved.shape[0] // n, *moved.shape[1:]))
    _reduce_scatter_single(out, moved, group=group)
    return out.movedim(0, dim)


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
        return all_reduce(g, ctx.group), None


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
        return all_reduce(x, group) / ctx.n

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g / ctx.n, None


class _SyncMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group, ctx.n = group, dist.get_world_size(group)
        return all_reduce(x, group) / ctx.n

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return all_reduce(g, ctx.group) / ctx.n, None


def sync_mean(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """The mean of ``x`` over the ranks, when each rank's loss is its own
    (data parallelism: the global loss is the ranks' mean): backward
    all-reduces the ranks' cotangents and divides by n, so the rank-local
    gradients average to the global ones (sync BatchNorm's moments)."""
    if dist.get_world_size(group) == 1:
        return x
    return _SyncMean.apply(x, group)


def pmean(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """The mean of ``x`` over the ranks, on every rank (``lax.pmean``).
    Backward: the replicated cotangent over n."""
    if dist.get_world_size(group) == 1:
        return x
    return _PMean.apply(x, group)


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    _record("all-to-all", _nbytes(x))
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


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int, group) -> torch.Tensor:
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        n = dist.get_world_size(ctx.group)
        return reduce_scatter(g, ctx.dim, ctx.group) / n, None, None


def fsdp_gather(x: torch.Tensor, dim: int, group: dist.ProcessGroup) -> torch.Tensor:
    """ZeRO-3's gather-for-compute: the ranks' slices of a parameter
    all-gathered along ``dim``; backward reduce-scatters the gradient and
    divides by the group size, so each rank's slice gets the mean of the
    ranks' gradients (each rank's loss the mean over its own batch shard,
    the global loss their mean). One rank: ``x``, the identity."""
    if dist.get_world_size(group) == 1:
        return x
    return _FsdpGather.apply(x, dim, group)


# ---- placement over a DeviceMesh ---------------------------------------------------


def _placement_of(sharding: Any) -> tuple[Any, tuple]:
    """``(DeviceMesh, placements)`` from a ``(mesh, placements)`` pair or
    an object carrying ``mesh`` and ``placements``."""
    if isinstance(sharding, tuple) and len(sharding) == 2:
        return sharding[0], tuple(sharding[1])
    return sharding.mesh, tuple(sharding.placements)


def _is_sharding(x: Any) -> bool:
    return (isinstance(x, tuple) and len(x) == 2 and hasattr(x[0], "mesh_dim_names")) or (
        hasattr(x, "mesh") and hasattr(x, "placements"))


def local_slice(x: torch.Tensor, mesh: Any, placements: Sequence[Any]) -> torch.Tensor:
    """This rank's block of a global tensor under ``placements``: each
    ``Shard(d)`` mesh dim, in mesh-dim order, splits dim ``d`` evenly and
    keeps this rank's coordinate (two ``Shard(0)`` dims give contiguous
    runs, the outer dim outermost, as ``DTensor`` lays them out). No
    communication: every rank holds the host copy."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh {mesh}")
    for i, p in enumerate(placements):
        if p.is_shard():
            size = int(mesh.size(i))
            if x.shape[p.dim] % size:
                raise ValueError(f"dimension {p.dim} of size {x.shape[p.dim]} does not split "
                                 f"over mesh dim {mesh.mesh_dim_names[i]!r} of size {size}")
            step = x.shape[p.dim] // size
            x = x.narrow(p.dim, coord[i] * step, step)
    return x


def global_put(tree: Any, shardings: Any) -> Any:
    """Place a host tree on a mesh: every tensor (or array) leaf becomes a
    ``DTensor`` built from this rank's slice of it
    (``tpfl/parallel/distributed.py:91-124``). ``shardings`` is one
    placement for every leaf, or a matching tree of them; a placement is
    a ``(DeviceMesh, [Shard | Replicate, ...])`` pair or an object with
    ``mesh`` and ``placements``. A leaf that is already a ``DTensor`` with
    those placements (a chained window's output) passes through
    untouched. The local slices land on the mesh's device type
    (``cuda`` for an ``nccl`` mesh: this rank's current card)."""
    from torch.distributed.tensor import DTensor

    def put(leaf: Any, sharding: Any) -> Any:
        mesh, placements = _placement_of(sharding)
        if isinstance(leaf, DTensor):
            if leaf.device_mesh == mesh and tuple(leaf.placements) == placements:
                return leaf
            leaf = full_tensor(leaf)
        t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(leaf)
        device = torch.device(mesh.device_type) if mesh.device_type == "cpu" else torch.device(
            "cuda", torch.cuda.current_device())
        local = local_slice(t, mesh, placements).to(device).contiguous()
        return DTensor.from_local(local, mesh, placements, run_check=False,
                                  shape=t.shape, stride=_contiguous_stride(t.shape))

    if _is_sharding(shardings):
        return _map_leaves(lambda leaf: put(leaf, shardings), tree)
    return _map_leaves(put, tree, shardings)


def _contiguous_stride(shape: Sequence[int]) -> tuple[int, ...]:
    stride, acc = [], 1
    for d in reversed(list(shape)):
        stride.append(acc)
        acc *= int(d)
    return tuple(reversed(stride))


def _map_leaves(fn: Any, tree: Any, *rest: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_sharding(tree):
        return type(tree)(_map_leaves(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def place_like(local: torch.Tensor, like: Any) -> Any:
    """``local`` as a ``DTensor`` placed like the ``DTensor`` ``like``
    (same mesh, placements and global shape): an output of a computation
    on ``like``'s local block."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, like.device_mesh, like.placements, run_check=False,
                              shape=like.shape, stride=like.stride())


def full_tensor(x: Any) -> torch.Tensor:
    """The whole global tensor of a ``DTensor`` on every rank, gathered
    through :func:`all_gather` (innermost mesh dim first, so two
    ``Shard(0)`` dims reassemble their contiguous runs); a plain tensor
    as it is. Every rank of the mesh must call it."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    mesh, out = x.device_mesh, x.to_local()
    for i in reversed(range(mesh.ndim)):
        p = x.placements[i]
        if p.is_shard():
            out = all_gather(out, p.dim, mesh.get_group(i))
    return out


def local_data(x: Any) -> "Any":
    """This rank's local shard of ``x`` as numpy (a ``DTensor``'s local
    block; any other tensor or array whole; bf16 as f32, which numpy
    lacks): the multi-process-safe way to digest a global array without a
    collective."""
    import numpy as np
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        x = x.to_local()
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.to(torch.float32).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x)
