"""Federation engine — N nodes' federated rounds on one device, counterpart
of :class:`tpfl.parallel.engine.FederationEngine` (no mesh).

One round (``engine.py:1452-1584`` of the reference):

1. Local training on every node at once: ``epochs × batches`` of
   SGD+momentum over node-stacked params, the momentum trace fresh each
   round. Node ``i``'s loss depends on node ``i``'s params only, so one
   backward of the summed per-node losses gives every node its own
   gradient — the ``vmap`` of the reference, written out.
2. With a :class:`FedBuffSchedule` (the ``fedbuff`` variant), each
   node's fold weight becomes ``w · arrive · (1+τ)^−ASYNC_STALENESS_EXP``.
   With ``attack_scales`` (an ``AttackPlan``'s sign-flip schedule,
   ``AttackPlan.engine_scales``), every node's trained params are
   multiplied by its scale, cast to the leaf's dtype. Then, with
   ``Settings.ENGINE_WIRE_CODEC`` other than "dense", every node's
   trained params pass the wire codec's round trip (params only).
3. The masked FedAvg fold: weights normalised with a uniform-over-valid
   fallback when all are zero; rows with normalised weight 0 are zeroed
   before the f32 weighted sum. Then the broadcast of the aggregate to
   every node — under a schedule to the arriving nodes only: stragglers
   keep their trained params, variates and aux.

The three algorithms and three kinds of the reference (``_kind``,
``engine.py:1080``):

- ``fedavg``; ``fedprox`` adds ``mu/2·||p − p0||²`` to each node's loss
  (``p0`` the node's round-start params);
- the **plain** kind trains with ``train=False`` and threads no state;
- the **aux** kind (``aux`` passed: BatchNorm ``batch_stats``) trains
  with ``train=True`` and threads the new stats, which the fold averages
  with the params' weights (``aux_mode="mean"``) or keeps on each node
  that took part (``"local"``, FedBN);
- the **scaffold** kind (``algorithm="scaffold"``) adds the fixed
  correction ``c_g − c_i`` to every gradient, updates ``c_i`` by option
  II and ``c_g`` by the server rule in the fold.

A window of ``n_rounds`` rounds is a Python loop over rounds where the
reference has a device-side ``fori_loop``. :meth:`FederationEngine.dispatch_window`
enqueues a window's work and returns an :class:`EngineWindow` without a
host sync (a CUDA event marks the window's end); ``run_rounds`` is
``dispatch_window(...).finalize()``. With ``Settings.ENGINE_TELEMETRY``
the window threads the reference's telemetry carry (:data:`TELEMETRY_FIELDS`,
``[n_rounds, padded]`` and ``[n_rounds]`` f32 tensors on the device,
read-only over the model), copies it to pinned host memory behind the
window and replays it at ``finalize`` (:mod:`tpfl_torch.management.engine_obs`).
:meth:`~FederationEngine.attach_membership` drives the node axis from a
:class:`~tpfl_torch.parallel.membership.MembershipView`;
:meth:`~FederationEngine.export_state` / :meth:`~FederationEngine.import_state`
checkpoint the run (``management/checkpoint.py``).

**On a device mesh** (``mesh=`` a ``DeviceMesh`` from
:func:`~tpfl_torch.parallel.mesh.create_mesh`, or ``"auto"``:
:func:`auto_mesh` over the ``SHARD_*`` knobs) the engine is one SPMD
program over the world's ranks, one device a rank, as the reference's
``shard_map`` program is one over its devices (``engine.py:1191-1710``).
Every rank builds the same host inputs; :meth:`~FederationEngine.shard_data`
and the state placement keep each rank's block as a ``DTensor``
(:func:`~tpfl_torch.parallel.distributed.global_put`). Inside a window
the rounds run on the local blocks — the kernels see plain tensors —
and every byte that crosses ranks goes through the helpers of
:mod:`~tpfl_torch.parallel.distributed`:

- **1D** (``nodes``): each rank trains its ``padded / nodes`` rows; the
  fold is each rank's weighted partial sum ``all_reduce``-d over the
  ``nodes`` group, and so are the global sums (the weights' total, the
  uniform fallback's valid count, SCAFFOLD's elected count; pad rows
  never enter the fallback).
- **3D** (``hosts x nodes``): the node axis shards over both, hosts
  outer; the fold runs in two legs, ``nodes`` then ``hosts``. Under
  ``ENGINE_WIRE_CODEC`` each host's params partial makes the wire round
  trip between the legs (variates and aux cross dense), and the
  telemetry carry grows the ``dcn_bytes`` row, ``hosts x`` one model's
  wire bytes.
- **2D** (``nodes x model``): at rest each node's leaves are stored as
  their :class:`~tpfl_torch.parallel.mesh.SpecLayout` shards over
  ``model``; the local step all-gathers them over the ``model`` group and
  the gradients come back to each shard through the gather's transpose
  (FSDP). The fold reduces over ``nodes`` only: each model shard folds
  its own slice. A ``TransformerLM`` whose attention is not pinned
  attends through ``ring_attention`` on the ``model`` group (sequence
  parallelism; a sequence that does not divide the axis takes
  ``blockwise_attention``). A ``model`` axis of 1 runs the 1D window.

The outputs come back as ``DTensor`` s with the inputs' placements.
Every rank must issue the same collectives in the same order, so every
host-side branch of the window is on a global value. Sums taken in
another order make a 4-rank run allclose to a 1-rank run; one topology
and one seed give the same bytes, and a one-rank mesh gives the bytes of
``mesh=None``. Under ``Settings.RANK_CONTRACTS`` every dispatch appends
its receipt (:mod:`~tpfl_torch.parallel.ranksafe`); under
``Settings.TRACE_CONTRACTS`` every cached window program carries the knob
values of its cache key, checked at each dispatch
(:func:`~tpfl_torch.concurrency.check_contract`).

The simulation plane's seams live here too, as in the reference:
:func:`sample_participants` (a seeded per-round cohort, numpy),
:meth:`~FederationEngine.attach_population` (a
:class:`~tpfl_torch.parallel.population.ClientPopulation`, whose state
rides :meth:`~FederationEngine.export_state`) and
:func:`build_masked_local_fit` / :func:`build_batched_fit_program`, the
simulation pool's masked node-stacked local fit over the learner's own
train step. :func:`nodes_mesh_axes` says whether the pool's chunk
shards over the world's ranks (:func:`maybe_nodes_mesh` builds that
mesh); rank 0 leads such a chunk and the other ranks serve its row
shards (:func:`tpfl_torch.simulation.batched_fit.serve_pool_shards`).

**Buffer donation** (``donate=``, default ``Settings.ENGINE_DONATE``,
True in every profile, as the reference's ``donate_argnums=(0, 1, 2, 3)``):
a donating window writes its state — params, SCAFFOLD's ``c_locals`` /
``c_global`` and aux, as padded and placed for the window — in place on
every round and returns those same tensors, so a window holds no staging
copy of the node-stacked state and its outputs take no new memory. A
caller tensor that already is window state (on the engine's device, at
the padded shape, contiguous, not requiring grad, its storage not
another state leaf's; on a mesh a placed ``DTensor`` whose local block
is that) is written; anything else is copied once on entry and the copy
is written, so the caller's original is never touched. A caller that
reads a state tensor after handing it to a donating window must rebind
from the outputs, or pass ``donate=False``: the window then starts from a
copy of its state and the inputs stay intact. Both give the same bytes.
:meth:`FederationEngine.program` is the window callable of one cache key
in the reference's positional order; :func:`donation_analysis` and
:meth:`FederationEngine.donation_report` count the aliasing by storage
identity, in the reference's report schema.
"""

from __future__ import annotations

import functools
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from tpfl_torch import DeviceLike, concurrency, resolve_device
from tpfl_torch.learning import compression, serialization
from tpfl_torch.learning.torch_learner import (
    OptimizerFactory,
    SGDMomentum,
    TrainState,
    cross_entropy_loss,
    default_optimizer,
    make_train_step,
)
from tpfl_torch.management import profiling
from tpfl_torch.models.zoo import Params, apply, init_state, stack_params
from tpfl_torch.parallel import distributed as spmd
from tpfl_torch.parallel import ranksafe
from tpfl_torch.parallel.mesh import (
    HOST_AXIS,
    MODEL_AXIS,
    NODE_AXIS,
    SpecLayout,
    create_mesh,
    federation_sharding,
    global_model_shardings,
    layout_for_module,
    mesh_axis_size,
    node_shard_dims,
    node_shard_size,
    pad_node_axis,
    pad_node_weights,
    padded_node_count,
    replicated,
    round_node_sharding,
    stacked_model_shardings,
    valid_node_mask,
)
from tpfl_torch.settings import Settings
from tpfl_torch.utils.tree import canonical_leaves, tree_leaves, tree_map

_ALGORITHMS = ("fedavg", "fedprox", "scaffold")

#: (codec bits, top-k fraction) of a round without a wire codec.
DENSE = (0, 0.05)

#: The ENGINE_TELEMETRY carry schema (``engine.py:138-155`` of the
#: reference): per-round PER-NODE ``[n_rounds, padded_nodes]`` rows, then
#: per-round ``[n_rounds]`` scalars.
TELEMETRY_NODE_FIELDS = ("loss", "update_norm", "cos_ref")
TELEMETRY_ROUND_FIELDS = (
    "delta_norm", "model_norm", "participation", "weight_mass", "wire_bytes",
)
TELEMETRY_FIELDS = TELEMETRY_NODE_FIELDS + TELEMETRY_ROUND_FIELDS
#: Extra per-node row of a fedbuff window: each arrival's staleness τ,
#: −1 on rounds the node does not arrive.
TELEMETRY_STALENESS_FIELD = "staleness"


def _per_node_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over every axis but the leading node axis: [n, ...] -> [n]
    (``loss_fn(logits, y).mean()`` per node, ``engine.py:1131,2415``)."""
    return x.reshape(x.shape[0], -1).mean(dim=1)


def _rows(sel: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A [n] mask shaped to broadcast over a node-stacked leaf."""
    return sel.reshape((-1,) + (1,) * (like.dim() - 1))


def _to_device(x: Any, device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x`` on ``device`` without a host sync: a host array bound for the
    card goes through pinned memory with ``non_blocking=True`` (a pageable
    copy would synchronize the stream, and with it the window in flight)."""
    t = torch.as_tensor(x) if dtype is None else torch.as_tensor(x, dtype=dtype)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _on(tree: Any, device: torch.device) -> Any:
    """Each host leaf of a tree on ``device`` (placed leaves untouched)."""
    return tree_map(lambda t: t if isinstance(t, DTensor) else _to_device(t, device), tree)


def _tensors(tree: Any) -> list[torch.Tensor]:
    """The tensors of a tree of dicts, lists and tuples, in order."""
    found: list[torch.Tensor] = []
    _map_tensors(found.append, tree)
    return found


def _storage(x: Any) -> Optional[int]:
    """The address of the memory ``x`` lives in: a tensor's storage (a
    ``DTensor``'s local block's), a numpy array's data; None otherwise.
    Views of one storage share it."""
    if isinstance(x, DTensor):
        x = x.to_local()
    if isinstance(x, torch.Tensor):
        return x.untyped_storage().data_ptr()
    if isinstance(x, np.ndarray):
        return x.__array_interface__["data"][0]
    return None


def _map_tensors(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """``fn`` over the tensors of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


# --- auto mesh resolution (Settings.SHARD_* knobs) ---------------------------

# (ranks, model, hosts, device type) -> (the world's default group, mesh):
# a mesh is kept while the world that built it lives.
_auto_meshes: dict[tuple, tuple[Any, DeviceMesh]] = {}


def _world() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def shard_device_count() -> int:
    """Ranks (one device each) the ``SHARD_*`` knobs allow the engine to
    spread over: 0 (the default) = the whole ``torch.distributed`` world,
    else ``min(SHARD_DEVICES, world)`` (``engine.py:168-174``)."""
    n = _world()
    cap = int(Settings.SHARD_DEVICES)
    return n if cap <= 0 else min(cap, n)


def resolve_shard_hosts() -> int:
    """The ``hosts`` axis size ``SHARD_HOSTS`` selects: 1 = off, 0 = one
    slot per process (the world size: 1 for a lone process), H > 1 =
    forced, valid at any world it divides (``engine.py:177-187``)."""
    h = int(Settings.SHARD_HOSTS)
    if h == 0:
        h = _world()
    return max(1, h)


def auto_mesh_axes() -> Optional[dict[str, int]]:
    """The axes of the mesh the ``SHARD_NODES`` knobs select
    (``engine.py:190-223``): the allowed ranks on one ``nodes`` axis
    (``SHARD_MODEL`` 1), the 2D ``nodes x model`` mesh when
    ``SHARD_MODEL`` = M > 1 (M must divide), and the 3D ``hosts x nodes
    [x model]`` mesh, hosts first, when ``SHARD_HOSTS`` resolves above 1.
    None when sharding is off or there is one rank. Builds no group."""
    if not Settings.SHARD_NODES:
        return None
    d = shard_device_count()
    if d <= 1:
        return None
    m = max(1, int(Settings.SHARD_MODEL))
    h = resolve_shard_hosts()
    if d % (m * h) != 0:
        raise ValueError(
            f"SHARD_MODEL={m} x SHARD_HOSTS={h} does not divide the {d} allowed devices")
    axes = {}
    if h > 1:
        axes[HOST_AXIS] = h
    axes[NODE_AXIS] = d // (m * h)
    if m > 1:
        axes[MODEL_AXIS] = m
    return axes


def auto_mesh(device: DeviceLike = None) -> Optional[DeviceMesh]:
    """The mesh of :func:`auto_mesh_axes` over the first ranks of the
    world, or None. Every rank of the world must call it together (a new
    mesh creates its groups)."""
    axes = auto_mesh_axes()
    if axes is None:
        return None
    dev = resolve_device(device)
    key = (tuple(axes.items()), dev.type)
    world_group = dist.group.WORLD
    hit = _auto_meshes.get(key)
    if hit is not None and hit[0] is world_group:
        return hit[1]
    mesh = create_mesh(axes, device=dev, ranks=int(np.prod(list(axes.values()))))
    _auto_meshes[key] = (world_group, mesh)
    return mesh


def nodes_mesh_axes(width: int) -> Optional[dict[str, int]]:
    """The axes of the mesh a batched node axis of ``width`` rows would
    shard over (the simulation pool's chunk): :func:`auto_mesh_axes` when
    ``width`` divides its node shards, else None (``engine.py:226-237``).
    Builds no group, so one rank may ask alone."""
    axes = auto_mesh_axes()
    if axes is None or width % (axes.get(HOST_AXIS, 1) * axes[NODE_AXIS]) != 0:
        return None
    return axes


def maybe_nodes_mesh(width: int, device: DeviceLike = None) -> Optional[DeviceMesh]:
    """The mesh of :func:`nodes_mesh_axes`, or None."""
    return None if nodes_mesh_axes(width) is None else auto_mesh(device)


def _with_attention(module: Any, attention_fn: Callable) -> Any:
    """A shallow copy of a ``TransformerLM`` whose blocks attend through
    ``attention_fn`` (flax's ``module.clone(attention_fn=...)``)."""
    import copy

    clone = copy.copy(module)
    clone.attention_fn = attention_fn
    blocks = []
    for block in module.blocks:
        b = copy.copy(block)
        b.attention_fn = attention_fn
        blocks.append(b)
    clone.blocks = blocks
    return clone


def _sequence_parallel_module(module: Any, mesh: DeviceMesh) -> Any:
    """``module`` attending through ring attention over the mesh's
    ``model`` axis (``engine.py:551-586``): each model rank holds one
    sequence block and K/V rotate the ring
    (:func:`~tpfl_torch.parallel.ring_attention.ring_attention`; the
    kernels' ``flash_block_fwd`` / ``flash_block_bwd`` on CUDA tensors,
    the einsum inner on CPU tensors). Modules without an unset
    ``attention_fn`` seam (MLP, CNN, ResNet, or a transformer whose
    attention is pinned) pass through. A sequence length that does not
    divide the axis takes ``blockwise_attention``, the reference's own
    branch."""
    if getattr(module, "attention_fn", False) is not None or not hasattr(module, "blocks"):
        return module
    from tpfl_torch.parallel.ring_attention import blockwise_attention, ring_attention

    group = mesh.get_group(MODEL_AXIS)
    msize = mesh_axis_size(mesh, MODEL_AXIS)

    def model_ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             causal: bool = True) -> torch.Tensor:
        if q.shape[1] % msize != 0:
            return blockwise_attention(q, k, v, causal=causal)
        local = spmd.shard([q, k, v], 1, group)
        return spmd.gather(ring_attention(*local, group, causal=causal), 1, group)

    return _with_attention(module, model_ring_attention)


class _MeshWindow:
    """One window's view of the mesh: the fold's legs (the ``nodes``
    group, then ``hosts``), the DCN codec between them, the ``model``
    group and which dim of each state leaf it splits, this rank's valid
    rows, and the placed inputs whose placements the outputs take."""

    __slots__ = ("legs", "hosts", "host_leg", "model_group", "split", "like", "valid",
                 "dcn_codec")

    def __init__(self, engine: "FederationEngine", placed: tuple) -> None:
        mesh = engine.mesh
        dims = node_shard_dims(mesh)
        self.legs = [mesh.get_group(a) for a in reversed(dims)]
        self.hosts = mesh_axis_size(mesh, HOST_AXIS)
        # The reference lowers the hosts leg (codec, dcn_bytes) on 1D /
        # 3D meshes only; its 2D program is GSPMD's.
        self.host_leg = self.hosts > 1 and engine.model_axes <= 1
        self.dcn_codec: Optional[Callable] = None
        self.model_group = mesh.get_group(MODEL_AXIS) if engine.model_axes > 1 else None
        self.like = placed
        model_dim = (mesh.mesh_dim_names.index(MODEL_AXIS)
                     if MODEL_AXIS in mesh.mesh_dim_names else None)

        def split_dim(t: Any) -> Optional[int]:
            if model_dim is None or self.model_group is None:
                return None
            p = t.placements[model_dim]
            return p.dim if p.is_shard() else None

        # Per state tree (params, c_locals, c_global, aux): the leaf's
        # model-split dim, or None when no leaf is split.
        self.split = tuple(_tree_or_none(tree_map(split_dim, tree)) for tree in placed)
        self.valid = spmd.local_slice(engine.valid, mesh, federation_sharding(mesh).placements)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the node shards."""
        for g in self.legs:
            x = spmd.all_reduce(x, g)
        return x

    def gather(self, tree: Any, split: Any, grad: bool = False) -> Any:
        """Each split leaf whole (all-gathered over ``model``); with
        ``grad``, differentiable: the gradient returns to this rank's
        shard (the slice of the replicated cotangent)."""
        if split is None:
            return tree
        g = self.model_group
        op = spmd.gather if grad else spmd.all_gather
        return tree_map(lambda t, d: t if d is None else op(t, d, g), tree, split)

    def slice(self, tree: Any, split: Any) -> Any:
        """This rank's shard of each split leaf of a whole tree."""
        if split is None:
            return tree
        g = self.model_group
        return tree_map(lambda t, d: t if d is None else spmd.shard([t], d, g)[0], tree, split)


def _psum(mw: Optional[_MeshWindow], x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the node shards (``x`` without a mesh)."""
    return x if mw is None else mw.psum(x)


def _tree_or_none(tree: Any) -> Any:
    """``tree`` if any leaf is not None, else None."""
    return tree if any(d is not None for d in tree_leaves(tree)) else None


def _is_dtensor_tree(tree: Any) -> bool:
    return any(isinstance(t, DTensor) for t in tree_leaves(tree))


def sample_participants(population: int, k: int, seed: int, round: int) -> np.ndarray:
    """Deterministic per-round participant sample: ``k`` distinct client
    indices out of ``population`` registered clients, seeded by ``(seed,
    round)`` — the reference's numpy draw, so the ids are the same."""
    if k > population:
        raise ValueError(f"cannot sample {k} of {population} clients")
    rng = np.random.default_rng(np.random.SeedSequence([seed, round]))
    return np.sort(rng.choice(population, size=k, replace=False))


class FedBuffSchedule:
    """A per-round arrival / staleness schedule for the engine's
    ``fedbuff`` variant — the host-side lowering of a speed plan to
    per-round masks (``engine.py:255-360`` of the reference).

    ``arrivals`` ``[n_rounds, n_nodes]`` is the 0/1 arrival mask: a 1 at
    ``(r, i)`` means node ``i``'s buffered contribution reaches the fold
    at round ``r`` (staleness-weighted, and it takes the broadcast); a 0
    means the node is still in flight and keeps training locally.
    ``taus`` carries each arrival's staleness ordinal τ, zero on
    non-arrival rounds. Every round must have at least one arrival.
    Host numpy only: same plan, same window, the same masks."""

    def __init__(self, arrivals: Any, taus: Any) -> None:
        arrivals = np.asarray(arrivals, np.float32)
        taus = np.asarray(taus, np.float32)
        if arrivals.ndim != 2 or arrivals.shape != taus.shape:
            raise ValueError(
                f"arrivals/taus must be matching [n_rounds, n_nodes] "
                f"arrays, got {arrivals.shape} vs {taus.shape}"
            )
        if not (arrivals.sum(axis=1) > 0).all():
            empty = int(np.flatnonzero(arrivals.sum(axis=1) == 0)[0])
            raise ValueError(
                f"round {empty} of the schedule has no arrivals — every "
                f"fedbuff round needs at least one folding node"
            )
        self.arrivals = arrivals
        self.taus = taus
        self.n_rounds, self.n_nodes = int(arrivals.shape[0]), int(arrivals.shape[1])

    @classmethod
    def from_periods(cls, periods: Any, n_rounds: int, start_round: int = 0) -> "FedBuffSchedule":
        """Node ``i`` arrives every ``periods[i]`` rounds, first at global
        round ``periods[i] − 1``, always with ``τ = periods[i] − 1``;
        ``start_round`` continues one global schedule across windows."""
        periods = np.asarray(periods, np.int64)
        if periods.ndim != 1 or (periods < 1).any():
            raise ValueError(f"periods must be [n] ints >= 1: {periods}")
        g = start_round + np.arange(int(n_rounds), dtype=np.int64)[:, None]
        arrive = ((g + 1) % periods[None, :]) == 0
        taus = np.where(arrive, periods[None, :] - 1, 0)
        return cls(arrive.astype(np.float32), taus.astype(np.float32))

    @classmethod
    def from_plan(cls, plan: Any, addrs: Sequence[str], n_rounds: int, start_round: int = 0,
                  tick: Optional[float] = None) -> "FedBuffSchedule":
        """Lower a ``TrainerSpeedPlan``: each node's delay quantized to
        round ticks (``tick`` defaults to the fastest positive delay, so
        the fastest nodes arrive every round) gives its period."""
        delays = np.asarray([max(float(plan.delay_for(a)), 0.0) for a in addrs], np.float64)
        if tick is None:
            positive = delays[delays > 0]
            tick = float(positive.min()) if positive.size else 1.0
        periods = np.maximum(1, np.round(delays / max(float(tick), 1e-12)).astype(np.int64))
        return cls.from_periods(periods, int(n_rounds), int(start_round))

    def window(self, start: int, n_rounds: int) -> "FedBuffSchedule":
        """The ``[start, start + n_rounds)`` rows as their own schedule."""
        if start < 0 or start + n_rounds > self.n_rounds:
            raise ValueError(
                f"window [{start}, {start + n_rounds}) outside the "
                f"schedule's {self.n_rounds} rounds"
            )
        return FedBuffSchedule(self.arrivals[start:start + n_rounds],
                               self.taus[start:start + n_rounds])


class HostCopy:
    """A device→host copy of a tree's tensors in flight: each card tensor
    is copied into pinned host memory with ``non_blocking=True`` behind
    the work already queued on its stream, and a CUDA event marks the
    copies' end. :meth:`wait` synchronizes on that event and returns the
    host tree. CPU tensors are cloned at once."""

    __slots__ = ("_tree", "_event")

    def __init__(self, tree: Any) -> None:
        self._event: Optional[torch.cuda.Event] = None
        devices: set = set()

        def copy(t: torch.Tensor) -> torch.Tensor:
            t = t.detach()
            if t.device.type == "cpu":
                return t.clone()
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            devices.add(t.device)
            return host

        self._tree = _map_tensors(copy, tree)
        for dev in devices:  # one card in practice
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(dev))

    def ready(self) -> bool:
        return self._event is None or self._event.query()

    def wait(self) -> Any:
        """The host tree, once every copy has landed."""
        if self._event is not None:
            self._event.synchronize()
        return self._tree


def start_host_copy(tree: Any) -> HostCopy:
    """Begin a non-blocking device→host copy of every tensor of ``tree``
    (the reference's ``copy_to_host_async`` leg): the telemetry carry's
    fetch starts at dispatch and lands while the next window runs."""
    return HostCopy(tree)


class EngineWindow:
    """One dispatched engine window in flight (``engine.py:379-548`` of
    the reference).

    :meth:`FederationEngine.dispatch_window` returns the handle once the
    window's work is enqueued; :attr:`params`, :attr:`aux`,
    :attr:`scaffold_state` and :attr:`losses` are device tensors that
    chain straight into the next dispatch (a donating one writes the
    state tensors in place, so they then hold its outputs). A CUDA event recorded after
    the window's last launch answers :meth:`ready` (``event.query()``)
    and :meth:`wait` (``event.synchronize()``). :meth:`finalize` runs the
    window's host leg — profiler rows and the telemetry fan-out, over the
    carry's pinned host copy — and returns ``run_rounds``' tuple;
    :meth:`abandon` drops the host leg. Both are terminal and
    idempotent."""

    __slots__ = (
        "_engine", "_kind", "_has_aux", "_outs", "_tele", "_n_rounds", "_window_start",
        "_ordinal", "_prof", "_node_tag", "_t0", "_t1", "_event", "_finalized", "_result",
    )

    def __init__(self, engine: "FederationEngine", kind: str, has_aux: bool, outs: tuple,
                 tele: Optional[HostCopy], n_rounds: int, window_start: int, ordinal: int,
                 prof: bool, node_tag: str, t0: float, t1: float,
                 event: Optional[torch.cuda.Event]) -> None:
        self._engine = engine
        self._kind = kind
        self._has_aux = has_aux
        self._outs = outs
        self._tele = tele
        self._n_rounds = int(n_rounds)
        self._window_start = int(window_start)
        self._ordinal = int(ordinal)
        self._prof = bool(prof)
        self._node_tag = node_tag
        self._t0 = t0
        self._t1 = t1
        self._event = event
        self._finalized = False
        self._result: Optional[tuple] = None

    @property
    def params(self) -> Params:
        """Stacked output params (device tensors)."""
        return self._outs[0]

    @property
    def aux(self) -> Params:
        return self._outs[3]

    @property
    def scaffold_state(self) -> tuple[Params, Params]:
        return self._outs[1], self._outs[2]

    @property
    def losses(self) -> torch.Tensor:
        """Last round's per-node losses (padded length)."""
        return self._outs[4]

    @property
    def n_rounds(self) -> int:
        return self._n_rounds

    def telemetry(self) -> Optional[dict]:
        """The window's telemetry carry on the host (numpy arrays, waiting
        for their copy), or None when ``ENGINE_TELEMETRY`` was off."""
        if self._tele is None:
            return None
        return {k: v.numpy() for k, v in self._tele.wait()[0].items()}

    def ready(self) -> bool:
        """True once the window's device work has completed (no block)."""
        return self._event is None or self._event.query()

    def wait(self) -> None:
        """Block until the window's device work completes."""
        if self._event is not None:
            self._event.synchronize()

    def finalize(self) -> Optional[tuple]:
        """Profiler attribution + telemetry fan-out, then ``run_rounds``'
        result tuple (None after :meth:`abandon`)."""
        if self._finalized:
            return self._result
        if self._prof:
            self.wait()
            t2 = time.monotonic()
            profiling.rounds.add(self._node_tag, "dispatch", self._t1 - self._t0,
                                 round=self._ordinal)
            profiling.rounds.add(self._node_tag, "train", t2 - self._t1, round=self._ordinal)
            profiling.rounds.end_round(self._node_tag, self._ordinal)
        mesh = self._engine.mesh
        if self._tele is not None and (mesh is None or mesh.size() == 1):
            # A window over several ranks holds only this rank's node rows:
            # the observatory fan-out is a single-process plane, as the
            # reference's (each rank still reads its carry, telemetry()).
            from tpfl_torch.management import engine_obs

            eng = self._engine
            w = self._tele.wait()[1]
            engine_obs.replay_window(
                self._node_tag, profiling.module_tag(eng.module), self._window_start,
                self.telemetry(), eng.n_nodes, weights=w.numpy(),
                wall_seconds=time.monotonic() - self._t0,
                dispatch_seconds=self._t1 - self._t0, controller=eng.controller,
            )
        self._finalized = True
        self._result = _result(self._kind, self._has_aux, self._outs[:4], self._outs[4])
        return self._result

    def abandon(self) -> None:
        """Drop the window without its host leg: wait for its device work,
        then mark it finalized with no result (``Node.stop``'s and the
        pipeline's interrupt seam). A no-op after :meth:`finalize`."""
        if self._finalized:
            return
        self._finalized = True
        self.wait()
        self._result = None


class FederationEngine:
    """N-node federated training on one device or over a device mesh.

    Args mirror the reference. ``device=None`` means the card; pass
    ``device="cpu"`` for the plain PyTorch path. ``mesh`` is None (one
    device), a ``DeviceMesh`` with a ``nodes`` axis (and optionally
    ``hosts`` and ``model``) of the mesh's device type, or ``"auto"``
    (:func:`auto_mesh`). Node-stacked state rides the padded node axis:
    ``padded_nodes`` rounds ``n_nodes`` up to the node shards
    (``n_nodes`` without a mesh). ``layout`` (a :class:`SpecLayout`, a
    layout name, or None for ``Settings.SHARD_LAYOUT``) splits each
    node's leaves over a ``model`` axis; ``sequence_parallel`` puts an
    unpinned transformer's attention on the ``model`` ring when that axis
    is over 1."""

    def __init__(
        self,
        module: Any,
        n_nodes: int,
        mesh: "DeviceMesh | str | None" = None,
        learning_rate: float = 0.1,
        optimizer_factory: Optional[OptimizerFactory] = None,
        loss_fn: Callable = cross_entropy_loss,
        seed: int = 0,
        aux_mode: str = "mean",
        algorithm: str = "fedavg",
        prox_mu: float = 0.01,
        layout: "SpecLayout | str | None" = None,
        sequence_parallel: bool = True,
        device: DeviceLike = None,
    ) -> None:
        if aux_mode not in ("mean", "local"):
            raise ValueError(f"aux_mode must be 'mean' or 'local', got {aux_mode!r}")
        if algorithm not in _ALGORITHMS:
            raise ValueError(
                f"algorithm must be one of {_ALGORITHMS}, got {algorithm!r}"
            )
        Settings.refuse_unported("engine")
        self.device = resolve_device(device)
        self.mesh = auto_mesh(self.device) if isinstance(mesh, str) and mesh == "auto" else mesh
        if self.mesh is not None:
            names = self.mesh.mesh_dim_names or ()
            if NODE_AXIS not in names:
                raise ValueError(f"the engine's mesh needs a {NODE_AXIS!r} axis, has {names}")
            if self.mesh.device_type != self.device.type:
                raise ValueError(
                    f"a {self.mesh.device_type} mesh for an engine on {self.device}: the "
                    f"mesh's groups must be of the engine's device ('nccl' for the card)")
            if self.mesh.get_coordinate() is None:
                raise ValueError(f"rank {dist.get_rank()} is not in the engine's mesh")
        #: Model-parallel axis size (1 without a ``model`` axis).
        self.model_axes = mesh_axis_size(self.mesh, MODEL_AXIS)
        self.layout = layout if isinstance(layout, SpecLayout) else layout_for_module(
            module, layout or str(Settings.SHARD_LAYOUT))
        if self.model_axes > 1 and sequence_parallel:
            module = _sequence_parallel_module(module, self.mesh)
        self.module = module
        self.n_nodes = int(n_nodes)
        self.learning_rate = float(learning_rate)
        self._opt = (optimizer_factory or default_optimizer)(learning_rate)
        self._loss_fn = loss_fn
        self.seed = seed
        self.aux_mode = aux_mode
        self.algorithm = algorithm
        self.prox_mu = float(prox_mu)
        self.padded_nodes = padded_node_count(self.n_nodes, self.mesh)
        self.valid = valid_node_mask(self.n_nodes, self.padded_nodes, self.device)
        # Window ordinal of the profiler's rows (counts profiled windows,
        # as the reference does) and the cumulative round ordinal: a
        # resumed FedBuffSchedule and the fan-out's rounds index off it.
        self._windows = 0
        self._rounds_done = 0
        #: Optional AsyncController fed by a fedbuff window's staleness
        #: rows at finalize (``engine_obs.replay_window``).
        self.controller: Optional[Any] = None
        #: Optional MembershipView whose capacity tier sets the node axis.
        self.membership: Optional[Any] = None
        #: Optional ClientPopulation whose state rides the checkpoints.
        self.population: Optional[Any] = None
        # The window callable per dispatch key behind the compile
        # observatory (the reference's compiled round programs).
        self._programs: dict[tuple, Callable] = {}
        if Settings.COMPILE_CACHE_DIR:
            profiling.ensure_compile_cache(str(Settings.COMPILE_CACHE_DIR))

    # --- state / data placement ---

    def _shard(self, tree: Any) -> Any:
        """Node-stacked DATA on the mesh: the node axis split over the
        node shards, replicated over ``model`` (every model rank sees its
        node's whole batch)."""
        if self.mesh is None:
            return tree
        return spmd.global_put(tree, federation_sharding(self.mesh))

    def _shard_state(self, tree: Any) -> Any:
        """Node-stacked MODEL STATE (params, variates, aux) on the mesh:
        the node axis over the node shards and, on a 2D mesh, each leaf's
        layout dims over ``model``."""
        if self.mesh is None:
            return tree
        if self.model_axes > 1:
            return spmd.global_put(tree, stacked_model_shardings(self.mesh, tree, self.layout))
        return spmd.global_put(tree, federation_sharding(self.mesh))

    def _shard_global(self, tree: Any) -> Any:
        """An UNSTACKED node-replicated tree (SCAFFOLD's ``c_global``):
        replicated over the node shards, layout-split over ``model``."""
        if self.mesh is None:
            return tree
        if self.model_axes > 1:
            return spmd.global_put(tree, global_model_shardings(self.mesh, tree, self.layout))
        return spmd.global_put(tree, replicated(self.mesh))

    def init_state(self, input_shape: tuple[int, ...]) -> tuple[Params, Params]:
        """(stacked params, stacked aux), identical across nodes — aux is
        ``{}`` for modules without mutable collections. ``input_shape``
        is one sample's: ``(H, W, C)`` for images, ``(S,)`` for a token
        model. On a mesh both come placed (``DTensor`` s)."""
        params, aux = init_state(self.module, input_shape, self.seed, self.device)
        return (self._shard_state(self.broadcast_params(params)),
                self._shard_state(self.broadcast_params(aux)))

    def init_params(self, input_shape: tuple[int, ...]) -> Params:
        """Stacked [padded_nodes, ...] params (aux-free modules)."""
        params, aux = self.init_state(input_shape)
        if aux:
            raise ValueError(
                f"Module has mutable collections {sorted(aux)} — use "
                f"init_state() and pass aux to round()/evaluate()."
            )
        return params

    def init_scaffold_state(self, params: Params) -> tuple[Params, Params]:
        """(c_locals [padded, ...], c_global [...]): zero control
        variates; ``c_global`` is one unstacked tree (on a mesh placed
        like the state: replicated over the node shards)."""
        if self.mesh is not None and _is_dtensor_tree(params):
            c_locals = tree_map(lambda p: spmd.place_like(torch.zeros_like(p.to_local()), p), params)
            return c_locals, self._shard_global(tree_map(
                lambda p: torch.zeros(p.shape[1:], dtype=p.dtype, device=self.device), params))
        c_locals = tree_map(torch.zeros_like, params)
        c_global = tree_map(lambda p: torch.zeros(p.shape[1:], dtype=p.dtype, device=p.device),
                            params)
        return self._shard_state(c_locals), self._shard_global(c_global)

    def broadcast_params(self, tree: Params) -> Params:
        """One model's tree broadcast onto the padded node axis."""
        return stack_params(tree, self.padded_nodes, self.device)

    def pad_stacked(self, tree: Any) -> Any:
        """Pad a node-stacked tree's leading axis to ``padded_nodes`` (clone
        rows; a no-op when already there). A placed leaf of another length
        (a tier move on a mesh) is gathered first."""
        def pad(t: Any) -> Any:
            if isinstance(t, DTensor):
                if t.shape[0] == self.padded_nodes:
                    return t
                t = spmd.full_tensor(t)
            return pad_node_axis(t, self.padded_nodes)

        return tree_map(pad, tree)

    def unpad(self, tree: Any) -> Any:
        """Strip pad rows from a node-stacked tree. On a mesh every leaf is
        gathered whole first (every rank must call it) and comes back as
        a plain tensor."""
        if self.mesh is not None:
            tree = tree_map(spmd.full_tensor, tree)
        if self.padded_nodes == self.n_nodes:
            return tree
        return tree_map(lambda x: x[: self.n_nodes], tree)

    def first_row(self, tree: Any) -> Any:
        """Row 0 of a node-stacked tree as one model's plain tensors — the
        aggregate after a sync fold. On a mesh this rank's first local row,
        gathered over ``model`` where the leaf is split (every rank of the
        model group must call it): every rank holds the aggregate."""
        if self.mesh is None:
            return tree_map(lambda t: t[0], tree)

        def row(t: Any) -> torch.Tensor:
            if not isinstance(t, DTensor):
                return t[0]
            local = t.to_local()[:1]
            names = t.device_mesh.mesh_dim_names
            for i, p in enumerate(t.placements):
                if p.is_shard() and names[i] == MODEL_AXIS:
                    local = spmd.all_gather(local, p.dim, t.device_mesh.get_group(i))
            return local[0]

        return tree_map(row, tree)

    def pad_weights(self, weights: Optional[Any]) -> torch.Tensor:
        """[n] (or per-round [R, n]) weights -> padded f32 on the device;
        None -> uniform full participation."""
        if weights is None:
            return pad_node_weights(torch.ones((self.n_nodes,), dtype=torch.float32,
                                               device=self.device), self.padded_nodes)
        return pad_node_weights(_to_device(weights, self.device, torch.float32),
                                self.padded_nodes)

    def pad_attack_scales(self, scales: Any) -> torch.Tensor:
        """[n] (or per-round [R, n]) per-node attack multipliers -> padded
        f32 on the device, pad entries one (a pad row's params ride
        untouched: its fold weight is already zero)."""
        s = _to_device(scales, self.device, torch.float32)
        if s.shape[-1] != self.n_nodes:
            raise ValueError(
                f"attack_scales last axis is {s.shape[-1]} for {self.n_nodes} nodes")
        extra = self.padded_nodes - self.n_nodes
        if extra == 0:
            return s
        pad = torch.ones(s.shape[:-1] + (extra,), dtype=torch.float32, device=self.device)
        return torch.cat([s, pad], dim=-1)

    def shard_data(self, xs: Any, ys: Any) -> tuple[torch.Tensor, torch.Tensor]:
        """Node-stacked data [N, n_batches, b, ...] on the device (the
        dtype of ``xs`` is kept: feed bf16 to halve its reads; integer
        tokens stay integer), padded and, on a mesh, placed: each rank
        keeps its node rows. Placed data passes through."""
        if not isinstance(xs, DTensor):
            xs = _to_device(xs, self.device)
        if not isinstance(ys, DTensor):
            ys = _to_device(ys, self.device).to(torch.long)
        return self._shard(self.pad_stacked(xs)), self._shard(self.pad_stacked(ys))

    # --- elastic membership ---

    def resize_nodes(self, n_nodes: int) -> None:
        """Move the engine to a new node count (a capacity tier): the
        padded axis and the validity mask follow. The caller re-pads its
        state and data (:meth:`pad_stacked`, :meth:`shard_data`)."""
        self.n_nodes = int(n_nodes)
        self.padded_nodes = padded_node_count(self.n_nodes, self.mesh)
        self.valid = valid_node_mask(self.n_nodes, self.padded_nodes, self.device)

    def attach_membership(self, view: Any) -> None:
        """Drive the node axis from a
        :class:`~tpfl_torch.parallel.membership.MembershipView`: the
        engine follows the view's capacity tier (now and on
        :meth:`sync_membership`); callers take each window's weights from
        ``view.weights()``. Joins, leaves, crashes and quarantine verdicts
        inside a tier are weight edits: the node-stacked state keeps its
        shape and is not reallocated. The view is registered (weakly) with
        the fleet observatory's gauges."""
        self.membership = view
        from tpfl_torch.management import fleetobs

        fleetobs.register_view(view)
        if int(view.capacity) != self.n_nodes:
            self.resize_nodes(int(view.capacity))

    def sync_membership(self) -> bool:
        """Re-align the node axis with the attached view's tier (after a
        promotion at ``join`` or a demotion by ``maybe_resize``, consulted
        with :attr:`controller`). Returns whether the tier moved — the one
        event that resizes the node-stacked state."""
        view = self.membership
        if view is None:
            return False
        view.maybe_resize(self.controller)
        if int(view.capacity) == self.n_nodes:
            return False
        self.resize_nodes(int(view.capacity))
        return True

    def attach_population(self, population: Any) -> None:
        """Drive this engine from a
        :class:`~tpfl_torch.parallel.population.ClientPopulation`: the
        engine's node rows serve as the cross-device tier's edge
        aggregators, each round's cohort comes from
        ``population.begin_round`` (it must fit the node axis), and the
        population's O(touched) state rides :meth:`export_state`. The
        population is registered (weakly) with the fleet observatory's
        gauges."""
        self.population = population
        if population is not None:
            population.bind(self)
            from tpfl_torch.management import fleetobs

            fleetobs.register_population(population)

    # --- checkpoint state ---

    def export_state(self, params: Params, aux: Optional[Params] = None,
                     scaffold_state: Optional[tuple[Params, Params]] = None,
                     quarantine: Optional[Any] = None) -> dict:
        """One checkpointable snapshot (``engine.py:938-1013`` of the
        reference): the UNPADDED logical rows on the host (numpy; a CPU
        tensor for bf16 leaves), owning their bytes, with ``n_nodes``,
        ``rounds_done``, ``windows``, ``seed`` and the attached
        controller's, membership's and ``quarantine``'s exported state.
        A consumption boundary: it waits for the tensors it reads. On a
        mesh every leaf is gathered whole first, so every rank holds the
        logical rows and the snapshot is mesh-agnostic: it imports onto
        any mesh, or none (every rank must call it)."""
        n = self.n_nodes

        def host(tree: Any, rows: bool = True) -> Any:
            tree = tree_map(spmd.full_tensor, tree)
            if rows:
                tree = tree_map(lambda x: x[:n], tree)
            return tree_map(lambda v: v.clone() if isinstance(v, torch.Tensor) else np.array(v),
                            serialization.to_host(tree))

        state: dict = {
            "params": host(params),
            "n_nodes": int(self.n_nodes),
            "rounds_done": int(self._rounds_done),
            "windows": int(self._windows),
            "seed": int(self.seed),
        }
        if aux is not None:
            state["aux"] = host(aux)
        if scaffold_state is not None:
            c_locals, c_global = scaffold_state
            state["c_locals"] = host(c_locals)
            state["c_global"] = host(c_global, rows=False)
        if self.controller is not None:
            state["controller"] = self.controller.state_export()
        if self.membership is not None:
            state["membership"] = self.membership.state_export()
        if self.population is not None:
            # O(touched): only sampled clients' records, never the census.
            state["population"] = self.population.state_export()
        if quarantine is not None:
            state["quarantine"] = quarantine.state_export()
        return state

    def import_state(self, state: dict, quarantine: Optional[Any] = None) -> dict:
        """Restore an :meth:`export_state` snapshot (the reference's, too,
        through ``EngineCheckpointer``): the node axis resizes to the
        checkpoint's count, the rows are padded and placed for this
        engine's device and mesh,
        the schedule position, window ordinal and seed (the checkpoint's
        wins) come back, and the controller, membership and ``quarantine``
        state are imported, and so is a population's (a
        :class:`~tpfl_torch.parallel.population.ClientPopulation` is built
        and bound when none is attached). Returns ``{"params", "aux",
        "scaffold_state"}`` for the next dispatch (absent pieces None)."""
        n = int(state["n_nodes"])
        if n != self.n_nodes:
            self.resize_nodes(n)
        self._rounds_done = int(state.get("rounds_done", 0))
        self._windows = int(state.get("windows", 0))
        self.seed = int(state.get("seed", self.seed))

        def on_device(tree: Any) -> Any:
            return tree_map(lambda a: _to_device(a, self.device).clone(), tree)

        def place(tree: Any) -> Any:
            return self._shard_state(self.pad_stacked(on_device(tree)))

        out: dict = {"params": place(state["params"]), "aux": None, "scaffold_state": None}
        if "aux" in state:
            out["aux"] = place(state["aux"])
        if "c_locals" in state:
            out["scaffold_state"] = (place(state["c_locals"]),
                                     self._shard_global(on_device(state["c_global"])))
        if self.controller is not None and state.get("controller"):
            self.controller.state_import(state["controller"])
        if state.get("membership"):
            if self.membership is None:
                from tpfl_torch.parallel.membership import MembershipView

                self.membership = MembershipView.from_state(state["membership"])
            else:
                self.membership.state_import(state["membership"])
        if state.get("population"):
            if self.population is None:
                from tpfl_torch.parallel.population import ClientPopulation

                self.population = ClientPopulation.from_state(state["population"])
                self.population.bind(self)
            else:
                self.population.state_import(state["population"])
        if quarantine is not None and state.get("quarantine"):
            quarantine.state_import(state["quarantine"])
        return out

    # --- the round ---

    def _kind(self, aux: Optional[Any]) -> str:
        if self.algorithm == "scaffold":
            return "scaffold"
        return "aux" if aux is not None else "plain"

    def _prox(self, p: Params, p0: Params) -> torch.Tensor:
        """FedProx's ``mu/2·||p − p0||²`` per node [n], in f32
        (``engine.py:1084-1101``)."""
        sq = sum(((a.to(torch.float32) - b.to(torch.float32)) ** 2).reshape(a.shape[0], -1).sum(1)
                 for a, b in zip(tree_leaves(p), tree_leaves(p0)))
        return 0.5 * self.prox_mu * sq

    def _local_train(self, kind: str, params: Params, c_i: Params, c_g: Params, aux: Params,
                     xs: torch.Tensor, ys: torch.Tensor, epochs: int,
                     mw: Optional[_MeshWindow] = None) -> tuple[Params, Params, Params, torch.Tensor]:
        """Every node's local fit (``engine.py:1103-1189``): returns
        (trained params, new c_i, new aux, last epoch's mean batch loss
        [n]). ``c_i`` / ``c_g`` / ``aux`` are ``{}`` for kinds that do
        not thread them. On a 2D mesh (``mw``, the window's mesh view) the
        leaves are this rank's model shards: each step gathers them whole
        for the forward, and the gradients, the optimizer and the variates
        stay on the shards."""
        module, loss_fn = self.module, self._loss_fn
        split, split_aux = (None, None) if mw is None else (mw.split[0], mw.split[3])

        def whole(tree: Params, grad: bool = False) -> Params:
            return tree if mw is None else mw.gather(tree, split, grad)

        def run(leaves: Params, a: Params, x: torch.Tensor, train: bool) -> tuple:
            if mw is None or split_aux is None:
                return apply(module, leaves, a, x, train=train)
            logits, new_a = apply(module, leaves, mw.gather(a, split_aux), x, train=train)
            return logits, mw.slice(new_a, split_aux)

        if epochs <= 0:  # aggregation-only round
            with torch.no_grad():
                logits, _ = run(whole(params), aux, xs[:, 0], False)
                return params, c_i, aux, _per_node_mean(loss_fn(logits, ys[:, 0]))
        p0 = params  # round-start weights (FedProx anchor, SCAFFOLD's x)
        train = kind != "plain"
        prox = self.algorithm == "fedprox"
        p0_whole = whole(p0) if prox else None
        corr = {}
        if kind == "scaffold":  # fixed for the round
            corr = tree_map(lambda c, ci: (c - ci).to(c.dtype), c_g, c_i)
        opt = self._opt
        trace = opt.init(params)
        loss = torch.zeros((xs.shape[0],), dtype=torch.float32, device=xs.device)
        for _ in range(epochs):
            losses = []
            for bi in range(xs.shape[1]):
                leaves = tree_map(lambda v: v.detach().requires_grad_(True), params)
                full = whole(leaves, grad=True)
                logits, new_aux = run(full, aux, xs[:, bi], train)
                per_node = _per_node_mean(loss_fn(logits, ys[:, bi]))
                if prox:
                    per_node = per_node + self._prox(full, p0_whole)
                grads_flat = torch.autograd.grad(per_node.sum(), tree_leaves(leaves))
                it = iter(grads_flat)
                grads = tree_map(lambda _v: next(it), leaves)
                if kind == "scaffold":
                    grads = tree_map(lambda g, c: g + c.to(g.dtype), grads, corr)
                params, trace = opt.step(params, grads, trace)
                aux = new_aux
                losses.append(per_node.detach())
            loss = torch.stack(losses).mean(dim=0)
        if kind == "scaffold":
            # Option II: c_i+ = c_i − c + (x − y)/(K·lr), in f32.
            scale = 1.0 / max(epochs * xs.shape[1] * self.learning_rate, 1e-12)
            f32 = torch.float32
            with torch.no_grad():
                c_i = tree_map(
                    lambda ci, cg, x0, y: (ci.to(f32) - cg.to(f32)
                                           + scale * (x0.to(f32) - y.to(f32))).to(ci.dtype),
                    c_i, c_g, p0, params)
        return params, c_i, aux, loss

    @staticmethod
    def _fold_weights(weights: torch.Tensor, valid: torch.Tensor,
                      psum: Optional[Callable] = None) -> torch.Tensor:
        """``weights / Σweights``, uniform over real nodes when all-zero
        (``engine.py:1192-1211``). On a mesh ``psum`` makes both sums
        global (this rank's partial, all-reduced over the node shards)."""
        total, valid_total = weights.sum(), valid.sum()
        if psum is not None:
            total, valid_total = psum(total), psum(valid_total)
        fallback = valid / torch.clamp(valid_total, min=1.0)
        return torch.where(total > 0, weights / torch.clamp(total, min=1e-9), fallback)

    @staticmethod
    def _leaf_mean(wnorm: torch.Tensor, p: torch.Tensor, mw: Optional[_MeshWindow] = None,
                   on_wire: bool = False) -> torch.Tensor:
        """Σ_n wnorm[n]·p[n] in f32, cast back to p's dtype; w=0 rows are
        zeroed BEFORE the sum: 0 · inf would be NaN. On a mesh (``mw``)
        this rank's partial sum is all-reduced over ``nodes``, then over ``hosts``;
        ``on_wire`` (the params) passes the host's partial through the
        DCN codec between the two legs (``engine.py:1214-1258``)."""
        w = wnorm.to(torch.float32)
        clean = torch.where(_rows(w > 0, p), p.to(torch.float32),
                            torch.zeros((), device=p.device))
        agg = torch.tensordot(w, clean, dims=1)
        if mw is not None:
            agg = spmd.all_reduce(agg, mw.legs[0])
            if len(mw.legs) > 1:
                if on_wire and mw.dcn_codec is not None:
                    agg = mw.dcn_codec(agg)
                agg = spmd.all_reduce(agg, mw.legs[1])
        return agg.to(p.dtype)

    def _broadcast(self, dst: Params, src: Params, wnorm: torch.Tensor,
                   mw: Optional[_MeshWindow] = None, got: Optional[torch.Tensor] = None,
                   on_wire: bool = False) -> None:
        """The weighted mean of every ``src`` leaf written to every row of
        the ``dst`` leaf in place; under a schedule (``got``, the arrivals)
        the other rows take ``src``'s row (their local training)."""
        for d, x in zip(tree_leaves(dst), tree_leaves(src)):
            agg = self._leaf_mean(wnorm, x, mw, on_wire)
            if got is None:
                d.copy_(agg)
            else:
                torch.where(_rows(got, d), agg, x, out=d)

    @staticmethod
    def _keep(dst: Params, new: Params, sel: torch.Tensor,
              got: Optional[torch.Tensor] = None) -> None:
        """``new``'s rows where ``sel`` written into ``dst`` in place, the
        other rows kept; under a schedule the rows that did not arrive
        (``got``) take ``new``'s row."""
        for d, x in zip(tree_leaves(dst), tree_leaves(new)):
            torch.where(_rows(sel, d), x, d, out=d)
            if got is not None:
                torch.where(_rows(got, d), d, x, out=d)

    @torch.no_grad()
    def _fold(self, kind: str, state: tuple, trained: Params, new_c: Params, new_aux: Params,
              weights: torch.Tensor, valid: torch.Tensor, mw: Optional[_MeshWindow] = None,
              got: Optional[torch.Tensor] = None) -> None:
        """Masked FedAvg fold + broadcast, the SCAFFOLD server update and
        the aux aggregation (``engine.py:1237-1319``), written into the
        window's ``state`` (params, c_locals, c_global, aux) in place: no
        tensor the size of the state is allocated. Under a schedule only
        the arrivals (``got``) take the fold; stragglers keep their local
        training (params, variates, aux). On a mesh (``mw``) ``weights`` /
        ``valid`` are this rank's rows."""
        params, c_locals, c_global, aux = state
        psum = None if mw is None else mw.psum
        wnorm = self._fold_weights(weights, valid, psum)
        sel = weights > 0
        if kind == "scaffold":
            # c += (|S|/N) · uniform mean over ELECTED of delta_c, N the
            # LOGICAL federation size (pad rows are never elected); read
            # before the elected rows of c_locals move.
            mask = sel.to(torch.float32)
            um = self._fold_weights(mask, valid, psum)
            frac = _psum(mw, mask.sum()) / self.n_nodes
            f32 = torch.float32
            for cg, n, o in zip(tree_leaves(c_global), tree_leaves(new_c),
                                tree_leaves(c_locals)):
                cg.copy_((cg.to(f32) + frac * self._leaf_mean(
                    um, n.to(f32) - o.to(f32), mw)).to(cg.dtype))
            self._keep(c_locals, new_c, sel, got)
        self._broadcast(params, trained, wnorm, mw, got, on_wire=True)
        if kind == "plain":
            return
        if self.aux_mode == "local":
            # FedBN: stats stay per node — a w=0 node did not take part,
            # so its private stats do not advance.
            self._keep(aux, new_aux, sel, got)
        else:
            self._broadcast(aux, new_aux, wnorm, mw, got)

    @staticmethod
    def _per_node_sq(tree: Params) -> torch.Tensor:
        """Σ over leaves and features of x² per node row, in f32 (leaves
        in JAX's order, so a restored tree sums as the original did)."""
        total = torch.zeros((), dtype=torch.float32)
        for leaf in canonical_leaves(tree):
            total = total + leaf.to(torch.float32).reshape(leaf.shape[0], -1).pow(2).sum(1)
        return total

    @staticmethod
    def _per_node_dot(a: Params, b: Params) -> torch.Tensor:
        total = torch.zeros((), dtype=torch.float32)
        for x, y in zip(canonical_leaves(a), canonical_leaves(b)):
            total = total + (x.to(torch.float32) * y.to(torch.float32)).reshape(
                x.shape[0], -1).sum(1)
        return total

    def _round(self, kind: str, state: tuple, xs: torch.Tensor, ys: torch.Tensor,
               w: torch.Tensor, valid: torch.Tensor, epochs: int, codec: Callable,
               scale: Optional[torch.Tensor] = None,
               sched: Optional[tuple[torch.Tensor, torch.Tensor, float]] = None,
               wire_bpm: Optional[float] = None,
               mw: Optional[_MeshWindow] = None) -> tuple[tuple, torch.Tensor, Optional[tuple]]:
        """One round (``round_body``, ``engine.py:1452-1584``): (state,
        losses, telemetry stats or None); the fold writes ``state`` in
        place and the same tensors come back. ``sched`` is a fedbuff
        round's (arrivals, taus, staleness exponent); ``wire_bpm``, one
        model's wire bytes, turns the telemetry stats on. On a mesh
        (``mw``) ``w`` / ``valid`` and every tensor are this rank's rows."""
        params, c_locals, c_global, aux = state
        split = None if mw is None else mw.split[0]
        trained, new_c, new_aux, losses = self._local_train(
            kind, params, c_locals, c_global, aux, xs, ys, epochs, mw)
        with torch.no_grad():
            if sched is not None:
                arrive, tau, stale_exp = sched
                # The aggregator's staleness weight 1/(1+τ)^exp, exactly 1 at τ=0.
                w = w * arrive * (1.0 + tau) ** (-stale_exp)
            if scale is not None:  # the seeded adversary (engine.py:1467-1475)
                trained = tree_map(lambda t: _rows(scale, t).to(t.dtype) * t, trained)
            if split is None:
                trained = tree_map(codec, trained)
            else:  # the codec's scale and top-k see each node's whole leaf
                trained = mw.slice(tree_map(codec, mw.gather(trained, split)), split)
            node_stats = start_rows = None
            if wire_bpm is not None:
                f32 = torch.float32
                t_whole = trained if split is None else mw.gather(trained, split)
                p_whole = params if split is None else mw.gather(params, split)
                upd = tree_map(lambda t, p: t.to(f32) - p.to(f32), t_whole, p_whole)
                t_sq, s_sq = self._per_node_sq(t_whole), self._per_node_sq(p_whole)
                node_stats = {
                    "update_norm": self._per_node_sq(upd).sqrt(),
                    "cos_ref": self._per_node_dot(t_whole, p_whole)
                    / torch.clamp(t_sq * s_sq, min=1e-12).sqrt(),
                }
                if sched is not None:
                    node_stats["staleness"] = tau * arrive - (1.0 - arrive)
                # Row 0 of the round-start params, one model: the fold
                # overwrites them.
                start_rows = [p[0].to(f32, copy=True) for p in canonical_leaves(p_whole)]
        self._fold(kind, state, trained, new_c, new_aux, w, valid, mw,
                   None if sched is None else arrive > 0)
        if wire_bpm is not None:
            with torch.no_grad():
                # The fold broadcasts one aggregate, so row 0 carries the
                # global model's stats (engine.py:1526-1573); on a mesh,
                # each rank's first row, mean-reduced over the valid ones.
                o_whole = params if split is None else mw.gather(params, split)
                moved_sq = torch.zeros((), dtype=torch.float32)
                out_sq = torch.zeros((), dtype=torch.float32)
                for o, p0 in zip(canonical_leaves(o_whole), start_rows):
                    o0 = o[0].to(torch.float32)
                    moved_sq = moved_sq + (o0 - p0).pow(2).sum()
                    out_sq = out_sq + (o0 * o0).sum()
                delta_norm, model_norm = moved_sq.sqrt(), out_sq.sqrt()
                if mw is not None:
                    first = valid[0].to(torch.float32)
                    den = torch.clamp(_psum(mw, first), min=1.0)
                    delta_norm = _psum(mw, delta_norm.to(valid.device) * first) / den
                    model_norm = _psum(mw, model_norm.to(valid.device) * first) / den
                participation = _psum(mw, (w > 0).to(torch.float32).sum())
                round_stats = {
                    "delta_norm": delta_norm,
                    "model_norm": model_norm,
                    "participation": participation,
                    "weight_mass": _psum(mw, w.to(torch.float32).sum()),
                    "wire_bytes": participation * wire_bpm,
                }
                if mw is not None and mw.host_leg:
                    # The DCN leg ships one model-shaped partial per host
                    # and round, codec'd like the node exchange.
                    round_stats["dcn_bytes"] = torch.tensor(
                        float(mw.hosts), dtype=torch.float32) * torch.tensor(
                        float(wire_bpm), dtype=torch.float32)
            return state, losses, (node_stats, round_stats)
        return state, losses, None

    def round(self, params: Params, xs: Any, ys: Any, weights: Optional[Any] = None,
              epochs: int = 1, aux: Optional[Any] = None,
              scaffold_state: Optional[tuple[Any, Any]] = None) -> tuple:
        """One federated round: ``run_rounds`` with ``n_rounds=1``."""
        return self.run_rounds(params, xs, ys, weights=weights, epochs=epochs, n_rounds=1,
                               aux=aux, scaffold_state=scaffold_state)

    def run_rounds(
        self,
        params: Params,
        xs: Any,
        ys: Any,
        weights: Optional[Any] = None,
        epochs: int = 1,
        n_rounds: int = 1,
        aux: Optional[Any] = None,
        scaffold_state: Optional[tuple[Any, Any]] = None,
        donate: Optional[bool] = None,
        attack_scales: Optional[Any] = None,
        schedule: Optional[FedBuffSchedule] = None,
    ) -> tuple:
        """``n_rounds`` federation rounds over the same node-stacked data:
        ``dispatch_window(...).finalize()``.

        ``weights``: [n] per-node FedAvg weight (0 = not elected), or
        [n_rounds, n] per round; None = uniform. The wire codec is read
        from ``Settings.ENGINE_WIRE_CODEC`` / ``WIRE_TOPK_FRAC`` on each
        call. ``attack_scales`` ([n] or [n_rounds, n]): per-node
        multipliers of each node's trained params before the codec leg
        and the fold — ``AttackPlan.engine_scales``'s seeded sign-flip
        adversary; None runs no attack op at all. ``schedule`` (a
        :class:`FedBuffSchedule` of ``n_rounds`` rows) runs the window's
        rounds as FedBuff rounds. ``donate`` (None: ``Settings.ENGINE_DONATE``,
        read at each call) writes the window's state in place and returns
        those tensors: a caller tensor that already is window state (see
        the module's docstring) holds the outputs afterwards, anything
        else is copied once on entry. ``donate=False`` leaves every input
        intact. Both give the same bytes.

        Returns (params, losses) — with ``aux`` (possibly ``{}``)
        (params, aux, losses) — and for algorithm="scaffold"
        (params, aux, (c_locals, c_global), losses). ``losses`` is the
        LAST round's per-node loss vector (padded length)."""
        return self.dispatch_window(
            params, xs, ys, weights=weights, epochs=epochs, n_rounds=n_rounds, aux=aux,
            scaffold_state=scaffold_state, donate=donate, attack_scales=attack_scales,
            schedule=schedule,
        ).finalize()

    def _prepare_args(self, params: Params, xs: Any, ys: Any, weights: Optional[Any],
                      n_rounds: int, aux: Optional[Any],
                      scaffold_state: Optional[tuple[Any, Any]], attack_scales: Optional[Any],
                      schedule: Optional[FedBuffSchedule], donate: bool = False) -> tuple:
        """Pad, validate and place one window's inputs: (kind, the window
        program's arguments in the reference's order ``[params, c_locals,
        c_global, aux, xs, ys, weights, valid(, attack scales)(, arrivals,
        taus)]``). Host state (numpy, or CPU tensors for the card) moves
        to the engine's device. On a mesh the state and data are placed
        ``DTensor`` s; the weights, mask, scales and schedule stay whole
        (each rank takes its rows in :meth:`_localize`). Under ``donate``
        the state is the window's own (:meth:`_own_state`)."""
        kind = self._kind(aux)
        if kind == "scaffold" and scaffold_state is None:
            raise ValueError(
                "algorithm='scaffold' requires scaffold_state "
                "(init_scaffold_state(params))"
            )
        w = self.pad_weights(weights)
        if w.dim() == 2 and w.shape[0] != n_rounds:
            raise ValueError(
                f"per-round weights have {w.shape[0]} rows for {n_rounds} rounds"
            )
        extra = []
        if attack_scales is not None:
            scales = self.pad_attack_scales(attack_scales)
            if scales.dim() == 2 and scales.shape[0] != n_rounds:
                raise ValueError(
                    f"per-round attack_scales have {scales.shape[0]} rows for {n_rounds} rounds"
                )
            extra.append(scales)
        if schedule is not None:
            if schedule.n_rounds != n_rounds:
                raise ValueError(
                    f"schedule covers {schedule.n_rounds} rounds for a {n_rounds}-round window")
            if schedule.n_nodes != self.n_nodes:
                raise ValueError(f"schedule has {schedule.n_nodes} nodes for {self.n_nodes}")
            # Pad rows never arrive and carry zero staleness.
            pad = ((0, 0), (0, self.padded_nodes - self.n_nodes))
            extra += [_to_device(np.pad(np.asarray(a, np.float32), pad), self.device)
                      for a in (schedule.arrivals, schedule.taus)]
        c_locals, c_global = scaffold_state if kind == "scaffold" else ({}, {})
        caller = (params, c_locals, c_global, {} if aux is None else aux)
        params, c_locals, c_global, aux = (_on(tree, self.device) for tree in caller)
        state = (self.pad_stacked(params), self.pad_stacked(c_locals), c_global,
                 self.pad_stacked(aux))
        if self.mesh is not None:
            state = (self._shard_state(state[0]), self._shard_state(state[1]),
                     self._shard_global(state[2]), self._shard_state(state[3]))
        if donate:
            state = self._own_state(state, caller)
        xs, ys = self.shard_data(xs, ys)
        return kind, [*state, xs, ys, w, self.valid, *extra]

    def _own_state(self, state: tuple, caller: tuple) -> tuple:
        """The state a donating window writes: each padded, placed leaf
        that shares memory with a caller's leaf passes through only when
        the caller's leaf already is window state — a tensor (a placed
        ``DTensor`` on a mesh, whose local block this is), contiguous, not
        requiring grad, and no earlier leaf's storage — and is copied once
        otherwise. A leaf that padding or placement made new is kept."""
        mine = {_storage(c) for tree in caller for c in tree_leaves(tree)} - {None}
        placed = DTensor if self.mesh is not None else torch.Tensor
        seen: set = set()

        def own(t: Any, c: Any) -> Any:
            local = t.to_local() if isinstance(t, DTensor) else t
            ptr = _storage(local)
            if ptr in seen or (ptr in mine and not (
                    isinstance(c, placed) and local.is_contiguous()
                    and not local.requires_grad)):
                local = local.detach().clone(memory_format=torch.contiguous_format)
                ptr = _storage(local)
                t = spmd.place_like(local, t) if isinstance(t, DTensor) else local
            seen.add(ptr)
            return t

        return tuple(tree_map(own, tree, c) for tree, c in zip(state, caller))

    def _localize(self, args: Sequence[Any], a_ndim: int, fedbuff: bool) -> tuple:
        """A window program's arguments as its rounds take them: (state,
        xs, ys, weights, attack scales or None, (arrivals, taus) or None,
        valid, the window's :class:`_MeshWindow` or None) — this rank's
        blocks on a mesh, the placed state kept by the mesh view for the
        outputs' placements; the data must come placed (:meth:`shard_data`)."""
        state, (xs, ys, w, valid), extra = tuple(args[:4]), args[4:8], list(args[8:])
        scales = extra.pop(0) if a_ndim else None
        sched = (extra[0], extra[1]) if fedbuff else None
        if self.mesh is None:
            return state, xs, ys, w, scales, sched, valid, None
        mesh = self.mesh

        def rows(t: Any) -> Any:
            if t is None or isinstance(t, DTensor):
                return None if t is None else t.to_local()
            sh = federation_sharding(mesh) if t.dim() == 1 else round_node_sharding(mesh)
            return spmd.local_slice(t, mesh, sh.placements)

        mw = _MeshWindow(self, state)
        local = tuple(tree_map(lambda t: t.to_local(), tree) for tree in state)
        return (local, xs.to_local(), ys.to_local(), rows(w), rows(scales),
                None if sched is None else tuple(rows(a) for a in sched), rows(valid), mw)

    def _run_window(self, kind: str, state: tuple, xs: torch.Tensor, ys: torch.Tensor,
                    w: torch.Tensor, scales: Optional[torch.Tensor], sched: Optional[tuple],
                    epochs: int, n_rounds: int, codec: tuple[int, float], telemetry: bool,
                    stale_exp: float, mw: Optional[_MeshWindow] = None,
                    valid: Optional[torch.Tensor] = None, *,
                    donate: bool = True) -> tuple[tuple, torch.Tensor, Optional[dict]]:
        """Enqueue a window's rounds: (state, last losses, telemetry carry
        or None), this rank's blocks on a mesh (``mw``). Donating, the
        rounds write ``state`` itself and return it; else they write a
        copy made here, and ``state`` stays intact."""
        if not donate:
            state = tuple(tree_map(lambda t: t.detach().clone(), tree) for tree in state)
        roundtrip = compression.engine_codec_roundtrip_nodes(*codec)
        if valid is None:
            valid = self.valid if mw is None else mw.valid
        if mw is not None and mw.host_leg and codec[0]:
            mw.dcn_codec = compression.engine_codec_roundtrip(*codec)
        n_local = valid.shape[0]
        tele = bpm = None
        if telemetry:
            f32 = torch.float32
            tele = {k: torch.zeros((n_rounds, n_local), dtype=f32, device=self.device)
                    for k in TELEMETRY_NODE_FIELDS}
            if sched is not None:
                tele[TELEMETRY_STALENESS_FIELD] = torch.zeros((n_rounds, n_local), dtype=f32,
                                                              device=self.device)
            tele.update({k: torch.zeros((n_rounds,), dtype=f32, device=self.device)
                         for k in TELEMETRY_ROUND_FIELDS})
            if mw is not None and mw.host_leg:
                tele["dcn_bytes"] = torch.zeros((n_rounds,), dtype=f32, device=self.device)
            # Per-node payload bytes under the codec: a constant of the
            # (whole) leaf shapes.
            like = state[0] if mw is None else mw.like[0]
            bpm = float(compression.wire_bytes_per_model(
                tree_map(lambda t: torch.empty(t.shape[1:], dtype=t.dtype, device="meta"), like),
                *codec))
        losses = torch.zeros((n_local,), dtype=torch.float32, device=self.device)
        for r in range(n_rounds):
            scale = None if scales is None else scales if scales.dim() == 1 else scales[r]
            sched_r = None if sched is None else (sched[0][r], sched[1][r], stale_exp)
            state, losses, stats = self._round(
                kind, state, xs, ys, w if w.dim() == 1 else w[r], valid, epochs, roundtrip,
                scale, sched_r, bpm, mw)
            if stats is not None:
                with torch.no_grad():
                    tele["loss"][r] = losses.to(torch.float32)
                    for k, v in (*stats[0].items(), *stats[1].items()):
                        tele[k][r] = v
        return state, losses, tele

    def _placed(self, state: tuple, losses: torch.Tensor,
                mw: Optional[_MeshWindow]) -> tuple[tuple, torch.Tensor]:
        """A mesh window's local outputs as ``DTensor`` s placed like its
        inputs (the losses like the node axis)."""
        if mw is None:
            return state, losses
        state = tuple(tree_map(spmd.place_like, local, like)
                      for local, like in zip(state, mw.like))
        sh = federation_sharding(self.mesh)
        losses = DTensor.from_local(losses, self.mesh, sh.placements, run_check=False,
                                    shape=torch.Size((self.padded_nodes,)), stride=(1,))
        return state, losses

    def _window(self, params: Params, xs: Any, ys: Any, weights: Optional[Any], epochs: int,
                n_rounds: int, aux: Optional[Any], scaffold_state: Optional[tuple[Any, Any]],
                codec: tuple[int, float]) -> tuple:
        """A donating window with the codec given as (bits, top-k
        fraction), no telemetry carry and no host leg
        (``VmapFederation.round``, whose reference programs donate)."""
        kind, args = self._prepare_args(params, xs, ys, weights, n_rounds, aux, scaffold_state,
                                        None, None, donate=True)
        state, xs, ys, w, _, _, _, mw = self._localize(args, 0, False)
        state, losses, _ = self._run_window(kind, state, xs, ys, w, None, None, epochs,
                                            n_rounds, codec, False, 0.0, mw)
        state, losses = self._placed(state, losses, mw)
        return _result(kind, aux is not None, state, losses)

    def dispatch_window(
        self,
        params: Params,
        xs: Any,
        ys: Any,
        weights: Optional[Any] = None,
        epochs: int = 1,
        n_rounds: int = 1,
        aux: Optional[Any] = None,
        scaffold_state: Optional[tuple[Any, Any]] = None,
        donate: Optional[bool] = None,
        attack_scales: Optional[Any] = None,
        schedule: Optional[FedBuffSchedule] = None,
    ) -> EngineWindow:
        """Enqueue one window and return its :class:`EngineWindow` without
        a host sync (arguments as :meth:`run_rounds`). The window's
        outputs chain into the next dispatch as device tensors
        (``DTensor`` s on a mesh); under donation they are the state
        tensors the next window writes in place, so a caller keeps a
        window's values by copying them before that dispatch (stream
        order covers a copy enqueued in between). Its host leg runs at
        ``finalize``. A failure while enqueueing records ``engine_failure``
        in the ``engine`` flight ring, dumps it under
        ``Settings.TELEMETRY_DUMP_DIR`` and re-raises. Under
        ``Settings.TRACE_CONTRACTS`` a program whose stamp disagrees with
        this dispatch's knobs raises ``TraceContractError`` before it runs;
        under ``Settings.RANK_CONTRACTS`` the dispatch appends its receipt
        to :mod:`~tpfl_torch.parallel.ranksafe`'s log."""
        donate = bool(Settings.ENGINE_DONATE) if donate is None else bool(donate)
        kind, args = self._prepare_args(params, xs, ys, weights, n_rounds, aux, scaffold_state,
                                        attack_scales, schedule, donate)
        a_ndim = 0 if attack_scales is None else args[8].dim()
        fedbuff = schedule is not None
        tele_on = bool(Settings.ENGINE_TELEMETRY)
        codec = (compression.resolve_engine_codec(Settings.ENGINE_WIRE_CODEC),
                 float(Settings.WIRE_TOPK_FRAC))
        # Read at dispatch, 0 for a sync window.
        stale_exp = float(Settings.ASYNC_STALENESS_EXP) if fedbuff else 0.0
        prof = profiling.rounds.enabled()
        node_tag = f"engine:{profiling.module_tag(self.module)}"
        window_start = self._rounds_done
        if prof:
            self._windows += 1
            profiling.rounds.begin_round(node_tag, self._windows)
        key = self._program_key(kind, epochs, n_rounds, args[6].dim(), donate, tele_on, a_ndim,
                                codec, fedbuff, stale_exp)
        run = self._program(key)
        if Settings.TRACE_CONTRACTS:
            # The fetched program's build-time stamp must match this
            # dispatch's resolved knob values.
            concurrency.check_contract(run, self._contract(key))
        if Settings.RANK_CONTRACTS:
            ranksafe.record_dispatch(key, self._program_fingerprint(key))
        state, xs, ys, w, scales, sched, _, mw = self._localize(args, a_ndim, fedbuff)
        t0 = time.monotonic() if (prof or tele_on) else 0.0
        try:
            state, losses, tele = run(kind, state, xs, ys, w, scales, sched, epochs, n_rounds,
                                      codec, tele_on, stale_exp, mw)
        except Exception as e:
            self._dump_flight(e, kind, n_rounds)
            raise
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        copy = None if tele is None else start_host_copy((tele, w))
        self._rounds_done += n_rounds
        t1 = time.monotonic() if (prof or tele_on) else 0.0
        (params, c_locals, c_global, aux_out), losses = self._placed(state, losses, mw)
        return EngineWindow(self, kind, aux is not None,
                            (params, c_locals, c_global, aux_out, losses), copy, n_rounds,
                            window_start, self._windows, prof, node_tag, t0, t1, event)

    def _program_key(self, kind: str, epochs: int, n_rounds: int, w_ndim: int, donate: bool,
                     telemetry: bool, a_ndim: int, codec: tuple[int, float], fedbuff: bool,
                     stale_exp: float) -> tuple:
        """The reference's program cache key (``engine.py:1790-1935``):
        the variant axes, the model axis and layout, the padded capacity
        tier, the mesh's ``nodes`` and ``hosts`` sizes and the population
        census, in :meth:`program`'s argument order. Without a mesh the
        model axis is 1 and the layout "replicated"."""
        pop = 0 if self.population is None else int(self.population.registered)
        mesh_layout = "replicated" if self.mesh is None else self.layout.name
        return (kind, int(epochs), int(n_rounds), int(w_ndim), bool(donate), bool(telemetry),
                int(a_ndim), int(codec[0]), float(codec[1]), int(self.model_axes), mesh_layout,
                bool(fedbuff), float(stale_exp), int(self.padded_nodes),
                mesh_axis_size(self.mesh), mesh_axis_size(self.mesh, HOST_AXIS), pop)

    def _program(self, key: tuple) -> Callable:
        """The window callable of one dispatch key, behind the compile
        observatory, with the reference's program names, so a tier
        promotion reads as one new program with one signature and a
        variant never as a recompile of the base program."""
        fn = self._programs.get(key)
        if fn is None:
            # The reference's program cache sees a lookup only when its
            # wrapper cache misses: one miss per new key.
            profiling.observatory.cache_event("engine_programs", hit=False)
            (kind, _, n_rounds, _, _, telemetry, a_ndim, bits, _, model_axes, _, fedbuff,
             _, capacity, _, hosts, pop) = key
            suffix = ((":obs" if telemetry else "") + (":atk" if a_ndim else "")
                      + (f":{compression.codec_name(bits)}" if bits else "")
                      + (f":m{model_axes}" if model_axes > 1 else "")
                      + (":fb" if fedbuff else "") + f":c{capacity}"
                      + (f":h{hosts}" if hosts > 1 else "")
                      + (f":pop{pop}" if pop else ""))
            # TRACE_CONTRACTS (off = no wrapper): stamp the program with the
            # knob values its cache key encodes. The donation mode is the
            # program's own, as the reference's donate_argnums.
            fn = self._programs[key] = concurrency.stamp_contract(
                profiling.observatory.wrap(
                    functools.partial(self._run_window, donate=bool(key[4])),
                    f"engine_round:{kind}x{n_rounds}{suffix}:{profiling.module_tag(self.module)}"),
                self._contract(key))
        return fn

    def program(self, kind: str, epochs: int, n_rounds: int = 1, w_ndim: int = 1,
                donate: bool = True, telemetry: bool = False, a_ndim: int = 0, codec: int = 0,
                topk_frac: float = 0.05, model_axes: int = 1, layout: str = "replicated",
                fedbuff: bool = False, stale_exp: float = 0.0, capacity: int = 0,
                mesh_nodes: int = 1, mesh_hosts: int = 1, pop_size: int = 0) -> Callable:
        """The window callable of one cache key (``engine.py:1856-1935`` of
        the reference): ``fn(params, c_locals, c_global, aux, xs, ys,
        weights, valid, *extra) -> (params, c_locals, c_global, aux,
        losses[, telemetry carry])``, ``extra`` the attack scales when
        ``a_ndim`` and then the arrivals and taus when ``fedbuff``, every
        argument as a dispatch prepares it (padded; on a mesh the state and
        data placed). ``kind`` is "plain", "aux" or "scaffold"; ``codec``
        the codec's bits (``compression.resolve_engine_codec``). Each key
        axis is the reference's, ``donate`` included (a separate slot):
        a donating program consumes its state arguments 0-3 — writes them
        in place and returns them — so they must be distinct contiguous
        tensors of the window's padded shapes; ``donate=False`` leaves them
        intact. Time a donating program with
        :func:`~tpfl_torch.management.profiling.best_of_wall_donated`."""
        key = (kind, int(epochs), int(n_rounds), int(w_ndim), bool(donate), bool(telemetry),
               int(a_ndim), int(codec), float(topk_frac), int(model_axes), str(layout),
               bool(fedbuff), float(stale_exp), int(capacity), int(mesh_nodes),
               int(mesh_hosts), int(pop_size))
        if key in self._programs:  # a miss counts in _program
            profiling.observatory.cache_event("engine_programs", hit=True)
        run = self._program(key)

        def window(params: Params, c_locals: Params, c_global: Params, aux: Params, xs: Any,
                   ys: Any, weights: torch.Tensor, valid: torch.Tensor, *extra: Any) -> tuple:
            state, lxs, lys, w, scales, sched, lvalid, mw = self._localize(
                (params, c_locals, c_global, aux, xs, ys, weights, valid, *extra),
                int(a_ndim), bool(fedbuff))
            state, losses, tele = run(kind, state, lxs, lys, w, scales, sched, int(epochs),
                                      int(n_rounds), (int(codec), float(topk_frac)),
                                      bool(telemetry), float(stale_exp), mw, lvalid)
            state, losses = self._placed(state, losses, mw)
            return (*state, losses) + ((tele,) if telemetry else ())

        window.donates = bool(donate)  # type: ignore[attr-defined]
        return window

    @staticmethod
    def _contract(key: tuple) -> dict:
        """The reference's nine ``TRACE_CONTRACTS`` knobs as a dispatch
        key resolved them (``ASYNC_STALENESS_EXP`` is 0.0 for a sync
        window, ``SHARD_LAYOUT`` "replicated" without a mesh)."""
        return {"ENGINE_TELEMETRY": key[5], "ENGINE_WIRE_CODEC": key[7],
                "WIRE_TOPK_FRAC": key[8], "ENGINE_DONATE": key[4], "SHARD_MODEL": key[9],
                "SHARD_LAYOUT": key[10], "ASYNC_STALENESS_EXP": key[12],
                "SHARD_HOSTS": key[15], "POPULATION_CLIENTS": key[16]}

    def _program_fingerprint(self, key: tuple) -> str:
        """The ``RANK_CONTRACTS`` fingerprint of the program behind
        ``key``: the port has no lowered HLO, so it digests the program's
        description, the key's fields, the module, the mesh's shape and
        the kernel libraries this process loaded."""
        from tpfl_torch.parallel import _build

        mesh = None if self.mesh is None else tuple(
            zip(self.mesh.mesh_dim_names, self.mesh.mesh.shape))
        text = "|".join([repr(key), profiling.module_tag(self.module), repr(mesh),
                         *_build.loaded_libraries()])
        return ranksafe.hlo_fingerprint(text)

    def donation_report(self, params: Params, xs: Any, ys: Any,
                        weights: Optional[Any] = None, epochs: int = 1, n_rounds: int = 1,
                        aux: Optional[Any] = None,
                        scaffold_state: Optional[tuple[Any, Any]] = None) -> dict:
        """Buffer-donation inspection of the DONATING window program this
        engine would dispatch for these inputs (``engine.py:2113-2146`` of
        the reference: the same argument preparation and the same
        ``Settings``-resolved telemetry / codec variant): the program runs
        once on a copy of the prepared state — the caller's tensors are
        unchanged — and :func:`donation_analysis` counts which state
        leaves (params, SCAFFOLD variates, aux) come back as outputs in
        their own storage. On a mesh every rank must call it together.
        ``clean`` is the gate."""
        kind, args = self._prepare_args(params, xs, ys, weights, n_rounds, aux, scaffold_state,
                                        None, None)

        def copy(t: Any) -> Any:
            if isinstance(t, DTensor):
                return spmd.place_like(t.to_local().detach().clone(), t)
            return t.detach().clone()

        args[:4] = [tree_map(copy, tree) for tree in args[:4]]
        codec = (compression.resolve_engine_codec(Settings.ENGINE_WIRE_CODEC),
                 float(Settings.WIRE_TOPK_FRAC))
        fn = self.program(*self._program_key(kind, epochs, n_rounds, args[6].dim(), True,
                                             bool(Settings.ENGINE_TELEMETRY), 0, codec,
                                             False, 0.0))
        return donation_analysis(fn, tuple(args))

    def _dump_flight(self, exc: Exception, kind: str, n_rounds: int) -> None:
        """Black-box a failed dispatch: an ``engine_failure`` event in the
        ``engine`` flight ring, then the ring dumped as
        ``flight-engine-<reason>.json`` when ``TELEMETRY_DUMP_DIR`` is set
        (``engine.py:2377-2401``)."""
        from tpfl_torch.management.telemetry import flight

        try:
            flight.record("engine", {
                "kind": "event", "name": "engine_failure", "node": "engine", "trace": "",
                "t": time.monotonic(), "model": profiling.module_tag(self.module),
                "program": f"{kind}x{n_rounds}",
                "error": f"{type(exc).__name__}: {exc}"[:200],
            })
            flight.dump("engine", type(exc).__name__.lower())
        except Exception:
            pass  # observability must never mask the real failure

    # --- evaluation ---

    @torch.no_grad()
    def evaluate(self, params: Params, xs: Any, ys: Any,
                 aux: Optional[Any] = None) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-node (loss, accuracy) over node-stacked eval data
        [n, n_batches, b, ...]: means over batches of each batch's mean
        over samples (and tokens: a token model's accuracy is per
        token). With ``aux``, BatchNorm uses the running averages. On a
        mesh each rank evaluates its node rows (the leaves gathered whole
        over ``model``) and both results come back placed like the node
        axis."""
        params = self.pad_stacked(params)
        aux = {} if aux is None else self.pad_stacked(aux)
        xs, ys = self.shard_data(xs, ys)
        if self.mesh is not None:
            params, aux = self._shard_state(params), self._shard_state(aux)
            mw = _MeshWindow(self, (params, {}, {}, aux))
            params = mw.gather(tree_map(lambda t: t.to_local(), params), mw.split[0])
            aux = mw.gather(tree_map(lambda t: t.to_local(), aux), mw.split[3])
            xs, ys = xs.to_local(), ys.to_local()
        losses, accs = [], []
        for bi in range(xs.shape[1]):
            logits, _ = apply(self.module, params, aux, xs[:, bi], train=False)
            losses.append(_per_node_mean(self._loss_fn(logits, ys[:, bi])))
            accs.append(_per_node_mean((logits.argmax(-1) == ys[:, bi]).to(torch.float32)))
        loss, acc = torch.stack(losses).mean(0), torch.stack(accs).mean(0)
        if self.mesh is None:
            return loss, acc
        sh = federation_sharding(self.mesh)
        return tuple(DTensor.from_local(t, self.mesh, sh.placements, run_check=False,
                                        shape=torch.Size((self.padded_nodes,)), stride=(1,))
                     for t in (loss, acc))


def _result(kind: str, has_aux: bool, state: tuple, losses: torch.Tensor) -> tuple:
    """``run_rounds``' return convention for a window's final state."""
    params, c_locals, c_global, aux_out = state
    if kind == "scaffold":
        return params, aux_out, (c_locals, c_global), losses
    if has_aux:
        return params, aux_out, losses
    return params, losses


# --- batched-fit programs (the simulation pool's side of the seam) ---------


def build_masked_local_fit(module: Any, opt: SGDMomentum, loss_fn: Callable, has_aux: bool,
                           track_grads: bool, epochs: int) -> Callable:
    """A chunk of learners' masked local fits at once (``engine.py:2497-2552``
    of the reference): epochs × batches of :func:`make_train_step` — THE
    local SGD step ``TorchLearner.fit`` runs, here over the chunk's node
    axis — from a fresh optimizer trace, with per-batch 0/1 masks that
    make padding batches exact no-ops and, under ``track_grads``, the raw
    gradients summed over the real batches (SCAFFOLD).

    ``local_fit(params, aux, correction, anchor, mu, xs, ys, bmask,
    full=None) -> (params, aux, last epoch's loss [n], gradient sum or
    None)``: node-stacked trees, ``correction`` a stacked tree or None,
    ``mu`` [n] f32 or None, ``xs [n, n_batches, b, ...]``, ``bmask [n,
    n_batches]`` on the device. ``full`` (host booleans, one a batch)
    marks the batches that skip the mask's select: those every row trains
    (the default, read from ``bmask``), or every row whose output the
    caller keeps. An epoch's loss is each node's mean over its real
    batches."""
    step = make_train_step(module, loss_fn, has_aux, opt, with_grads=track_grads)

    def local_fit(params: Params, aux: Params, correction: Optional[Params], anchor: Params,
                  mu: Optional[torch.Tensor], xs: torch.Tensor, ys: torch.Tensor,
                  bmask: torch.Tensor, full: Optional[Sequence[bool]] = None) -> tuple:
        if full is None:
            full = [bool(c) for c in (bmask > 0).all(0).tolist()]
        state = TrainState(params, opt.init(params), aux)
        gsum = (tree_map(lambda p: torch.zeros(p.shape, device=p.device, dtype=torch.promote_types(
            p.dtype, torch.float32)), params) if track_grads else None)
        keep = bmask > 0
        count = torch.clamp(bmask.sum(1), min=1.0)
        loss = torch.zeros((bmask.shape[0],), dtype=torch.float32, device=bmask.device)
        for _ in range(epochs):
            total = torch.zeros_like(loss)
            for bi in range(xs.shape[1]):
                m = bmask[:, bi]
                out = step(state, xs[:, bi], ys[:, bi], correction, anchor, mu,
                           None if full[bi] else keep[:, bi])
                state, batch_loss = out[0], out[1]
                with torch.no_grad():
                    if track_grads:
                        if full[bi]:
                            gsum = tree_map(lambda a, g: a.add_(g.to(a.dtype)), gsum, out[3])
                        else:
                            gsum = tree_map(lambda a, g: a.add_((g * _rows(m, g)).to(a.dtype)),
                                            gsum, out[3])
                    total = total + batch_loss * m
            loss = total / count
        return state.params, state.aux, loss, gsum

    return local_fit


#: The pool's program over the stacked node axis. The reference jits
#: ``vmap(local_fit)``; here the masked fit already runs every row in each launch.
build_batched_fit_program = build_masked_local_fit


def donation_analysis(fn: Callable, args: tuple,
                      donate_argnums: tuple[int, ...] = (0, 1, 2, 3)) -> dict:
    """A window program's buffer donation, by storage identity: runs
    ``fn(*args)`` once — it consumes ``args`` as the donating program
    does, so pass copies of what you keep — and counts, in the
    reference's schema (``engine.py:2450-2491``)::

        {"donated_leaves": int,   # tensor leaves under donate_argnums
         "aliased": int,          # donated leaves whose storage an output holds
         "unaliased_donors": int, # donated leaves no output holds
         "output_aliases": int,   # output leaves in a donated leaf's storage
         "clean": bool}           # all three columns agree

    A ``DTensor`` counts by its local block. A program built with
    ``donate=False`` (``fn.donates`` False) takes no donation: it has no
    donors, as the reference's lowering marks none. ``clean`` is the
    gate: a donating window that returns fresh tensors fails it. Storage
    identity cannot see a copy back into the inputs; the peak memory of a
    donating window against a non-donating one can (``chip_smoke.py``'s
    phase 24)."""
    donated = [_storage(t) for i in donate_argnums for t in _tensors(args[i])]
    outputs = [_storage(t) for t in _tensors(fn(*args))]
    held, donors = set(outputs), set(donated)
    aliased = sum(p in held for p in donated)
    unaliased = len(donated) - aliased if getattr(fn, "donates", True) else 0
    output_aliases = sum(p in donors for p in outputs)
    return {
        "donated_leaves": len(donated),
        "aliased": aliased,
        "unaliased_donors": unaliased,
        "output_aliases": output_aliases,
        "clean": bool(unaliased == 0 and aliased == len(donated)
                      and output_aliases == len(donated)),
    }
