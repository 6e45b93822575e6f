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

The simulation plane's seams live here too, as in the reference:
:func:`sample_participants` (a seeded per-round cohort, numpy),
:meth:`~FederationEngine.attach_population` (a
:class:`~tpfl_torch.parallel.population.ClientPopulation`, whose state
rides :meth:`~FederationEngine.export_state`) and
:func:`build_masked_local_fit` / :func:`build_batched_fit_program`, the
simulation pool's masked node-stacked local fit over the learner's own
train step. :func:`maybe_nodes_mesh` is None: one device.

Refused, each naming its ``ROADMAP.md`` §1 item: a device mesh (item 7;
``dcn_bytes``, the hosts axis's carry row, comes with it) and the XLA
aliasing reports ``donation_report`` / ``donation_analysis`` (item 8).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from tpfl_torch import DeviceLike, resolve_device
from tpfl_torch.exceptions import MULTI_DEVICE_ITEM, REST_ITEM, not_ported
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
from tpfl_torch.parallel.mesh import (
    pad_node_axis,
    pad_node_weights,
    padded_node_count,
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


def _map_tensors(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """``fn`` over the tensors of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def maybe_nodes_mesh(width: int) -> None:
    """The mesh a batched node axis of ``width`` rows would shard over:
    None, as the reference's on one device (meshes are ``ROADMAP.md`` §1
    item 7)."""
    return None


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
    chain straight into the next dispatch. A CUDA event recorded after
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
        if self._tele is not None:
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
    """N-node federated training on one device.

    Args mirror the reference. ``device=None`` means the card; pass
    ``device="cpu"`` for the plain PyTorch path. Node-stacked state
    rides the padded node axis (``padded_nodes == n_nodes`` on one
    device)."""

    def __init__(
        self,
        module: Any,
        n_nodes: int,
        mesh: Any = None,
        learning_rate: float = 0.1,
        optimizer_factory: Optional[OptimizerFactory] = None,
        loss_fn: Callable = cross_entropy_loss,
        seed: int = 0,
        aux_mode: str = "mean",
        algorithm: str = "fedavg",
        prox_mu: float = 0.01,
        device: DeviceLike = None,
    ) -> None:
        if aux_mode not in ("mean", "local"):
            raise ValueError(f"aux_mode must be 'mean' or 'local', got {aux_mode!r}")
        if algorithm not in _ALGORITHMS:
            raise ValueError(
                f"algorithm must be one of {_ALGORITHMS}, got {algorithm!r}"
            )
        if mesh is not None:
            raise not_ported("FederationEngine(mesh=), a device mesh", MULTI_DEVICE_ITEM)
        Settings.refuse_unported("engine")
        self.device = resolve_device(device)
        self.module = module
        self.n_nodes = int(n_nodes)
        self.learning_rate = float(learning_rate)
        self._opt = (optimizer_factory or default_optimizer)(learning_rate)
        self._loss_fn = loss_fn
        self.seed = seed
        self.aux_mode = aux_mode
        self.algorithm = algorithm
        self.prox_mu = float(prox_mu)
        self.padded_nodes = padded_node_count(self.n_nodes)
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

    def init_state(self, input_shape: tuple[int, ...]) -> tuple[Params, Params]:
        """(stacked params, stacked aux), identical across nodes — aux is
        ``{}`` for modules without mutable collections. ``input_shape``
        is one sample's: ``(H, W, C)`` for images, ``(S,)`` for a token
        model."""
        params, aux = init_state(self.module, input_shape, self.seed, self.device)
        return self.broadcast_params(params), self.broadcast_params(aux)

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
        variates; ``c_global`` is one unstacked tree."""
        c_locals = tree_map(torch.zeros_like, params)
        c_global = tree_map(lambda p: torch.zeros(p.shape[1:], dtype=p.dtype, device=p.device),
                            params)
        return c_locals, c_global

    def broadcast_params(self, tree: Params) -> Params:
        """One model's tree broadcast onto the padded node axis."""
        return stack_params(tree, self.padded_nodes, self.device)

    def pad_stacked(self, tree: Any) -> Any:
        return pad_node_axis(tree, self.padded_nodes)

    def unpad(self, tree: Any) -> Any:
        """Strip pad rows from a node-stacked tree."""
        if self.padded_nodes == self.n_nodes:
            return tree
        return tree_map(lambda x: x[: self.n_nodes], tree)

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
        tokens stay integer)."""
        xs = _to_device(xs, self.device)
        ys = _to_device(ys, self.device).to(torch.long)
        return self.pad_stacked(xs), self.pad_stacked(ys)

    # --- elastic membership ---

    def resize_nodes(self, n_nodes: int) -> None:
        """Move the engine to a new node count (a capacity tier): the
        padded axis and the validity mask follow. The caller re-pads its
        state and data (:meth:`pad_stacked`, :meth:`shard_data`)."""
        self.n_nodes = int(n_nodes)
        self.padded_nodes = padded_node_count(self.n_nodes)
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
        A consumption boundary: it waits for the tensors it reads."""
        n = self.n_nodes

        def host(tree: Any, rows: bool = True) -> Any:
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
        checkpoint's count, the rows are padded onto this engine's device,
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

        out: dict = {"params": self.pad_stacked(on_device(state["params"])), "aux": None,
                     "scaffold_state": None}
        if "aux" in state:
            out["aux"] = self.pad_stacked(on_device(state["aux"]))
        if "c_locals" in state:
            out["scaffold_state"] = (self.pad_stacked(on_device(state["c_locals"])),
                                     on_device(state["c_global"]))
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
                     xs: torch.Tensor, ys: torch.Tensor,
                     epochs: int) -> tuple[Params, Params, Params, torch.Tensor]:
        """Every node's local fit (``engine.py:1103-1189``): returns
        (trained params, new c_i, new aux, last epoch's mean batch loss
        [n]). ``c_i`` / ``c_g`` / ``aux`` are ``{}`` for kinds that do
        not thread them."""
        module, loss_fn = self.module, self._loss_fn
        if epochs <= 0:  # aggregation-only round
            with torch.no_grad():
                logits, _ = apply(module, params, aux, xs[:, 0], train=False)
                return params, c_i, aux, _per_node_mean(loss_fn(logits, ys[:, 0]))
        p0 = params  # round-start weights (FedProx anchor, SCAFFOLD's x)
        train = kind != "plain"
        prox = self.algorithm == "fedprox"
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
                logits, new_aux = apply(module, leaves, aux, xs[:, bi], train=train)
                per_node = _per_node_mean(loss_fn(logits, ys[:, bi]))
                if prox:
                    per_node = per_node + self._prox(leaves, p0)
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
    def _fold_weights(weights: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """``weights / Σweights``, uniform over real nodes when all-zero
        (``engine.py:1192-1211``)."""
        total = weights.sum()
        fallback = valid / torch.clamp(valid.sum(), min=1.0)
        return torch.where(total > 0, weights / torch.clamp(total, min=1e-9), fallback)

    @staticmethod
    def _leaf_mean(wnorm: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """Σ_n wnorm[n]·p[n] in f32, cast back to p's dtype; w=0 rows are
        zeroed BEFORE the sum: 0 · inf would be NaN."""
        w = wnorm.to(torch.float32)
        clean = torch.where(_rows(w > 0, p), p.to(torch.float32),
                            torch.zeros((), device=p.device))
        return torch.tensordot(w, clean, dims=1).to(p.dtype)

    def _diffuse(self, tree: Params, wnorm: torch.Tensor) -> Params:
        """The weighted mean of every leaf, broadcast back to every node."""
        n = wnorm.shape[0]

        def leaf(p: torch.Tensor) -> torch.Tensor:
            agg = self._leaf_mean(wnorm, p)
            return agg[None].expand(n, *agg.shape).clone()

        return tree_map(leaf, tree)

    @torch.no_grad()
    def _fold(self, kind: str, trained: Params, new_c: Params, new_aux: Params,
              c_locals: Params, c_global: Params, aux: Params,
              weights: torch.Tensor) -> tuple[Params, Params, Params, Params]:
        """Masked FedAvg fold + broadcast, the SCAFFOLD server update and
        the aux aggregation (``engine.py:1237-1319``): (params, c_locals,
        c_global, aux)."""
        wnorm = self._fold_weights(weights, self.valid)
        out_params = self._diffuse(trained, wnorm)
        sel = weights > 0

        def keep_elected(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
            return torch.where(_rows(sel, new), new, old)

        out_c, out_cg = c_locals, c_global
        if kind == "scaffold":
            out_c = tree_map(keep_elected, new_c, c_locals)
            # c += (|S|/N) · uniform mean over ELECTED of delta_c, N the
            # LOGICAL federation size (pad rows are never elected).
            mask = sel.to(torch.float32)
            um = self._fold_weights(mask, self.valid)
            frac = mask.sum() / self.n_nodes
            f32 = torch.float32
            out_cg = tree_map(
                lambda cg, n, o: (cg.to(f32) + frac * self._leaf_mean(
                    um, n.to(f32) - o.to(f32))).to(cg.dtype),
                c_global, new_c, c_locals)
        if kind == "plain":
            out_aux = aux
        elif self.aux_mode == "local":
            # FedBN: stats stay per node — a w=0 node did not take part,
            # so its private stats do not advance.
            out_aux = tree_map(keep_elected, new_aux, aux)
        else:
            out_aux = self._diffuse(new_aux, wnorm)
        return out_params, out_c, out_cg, out_aux

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
               w: torch.Tensor, epochs: int, codec: Callable,
               scale: Optional[torch.Tensor] = None,
               sched: Optional[tuple[torch.Tensor, torch.Tensor, float]] = None,
               wire_bpm: Optional[float] = None) -> tuple[tuple, torch.Tensor, Optional[tuple]]:
        """One round (``round_body``, ``engine.py:1452-1584``): (state,
        losses, telemetry stats or None). ``sched`` is a fedbuff round's
        (arrivals, taus, staleness exponent); ``wire_bpm``, one model's
        wire bytes, turns the telemetry stats on."""
        params, c_locals, c_global, aux = state
        trained, new_c, new_aux, losses = self._local_train(
            kind, params, c_locals, c_global, aux, xs, ys, epochs)
        with torch.no_grad():
            if sched is not None:
                arrive, tau, stale_exp = sched
                # The aggregator's staleness weight 1/(1+τ)^exp, exactly 1 at τ=0.
                w = w * arrive * (1.0 + tau) ** (-stale_exp)
            if scale is not None:  # the seeded adversary (engine.py:1467-1475)
                trained = tree_map(lambda t: _rows(scale, t).to(t.dtype) * t, trained)
            trained = tree_map(codec, trained)
            node_stats = None
            if wire_bpm is not None:
                f32 = torch.float32
                upd = tree_map(lambda t, p: t.to(f32) - p.to(f32), trained, params)
                t_sq, s_sq = self._per_node_sq(trained), self._per_node_sq(params)
                node_stats = {
                    "update_norm": self._per_node_sq(upd).sqrt(),
                    "cos_ref": self._per_node_dot(trained, params)
                    / torch.clamp(t_sq * s_sq, min=1e-12).sqrt(),
                }
                if sched is not None:
                    node_stats["staleness"] = tau * arrive - (1.0 - arrive)
        out = self._fold(kind, trained, new_c, new_aux, c_locals, c_global, aux, w)
        if sched is not None:
            # Only arrivals take the broadcast; stragglers keep their
            # local training (params, variates, aux).
            got = arrive > 0
            out_params, out_c, out_cg, out_aux = out

            def took_fold(new: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
                return torch.where(_rows(got, new), new, local)

            out_params = tree_map(took_fold, out_params, trained)
            if kind == "scaffold":
                out_c = tree_map(took_fold, out_c, new_c)
            if kind != "plain":
                out_aux = tree_map(took_fold, out_aux, new_aux)
            out = (out_params, out_c, out_cg, out_aux)
        if wire_bpm is not None:
            with torch.no_grad():
                # The fold broadcasts one aggregate, so row 0 carries the
                # global model's stats (engine.py:1526-1573).
                moved_sq = torch.zeros((), dtype=torch.float32)
                out_sq = torch.zeros((), dtype=torch.float32)
                for o, p in zip(canonical_leaves(out[0]), canonical_leaves(params)):
                    o0, p0 = o[0].to(torch.float32), p[0].to(torch.float32)
                    moved_sq = moved_sq + (o0 - p0).pow(2).sum()
                    out_sq = out_sq + (o0 * o0).sum()
                participation = (w > 0).to(torch.float32).sum()
                round_stats = {
                    "delta_norm": moved_sq.sqrt(),
                    "model_norm": out_sq.sqrt(),
                    "participation": participation,
                    "weight_mass": w.to(torch.float32).sum(),
                    "wire_bytes": participation * wire_bpm,
                }
            return out, losses, (node_stats, round_stats)
        return out, losses, None

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
        rounds as FedBuff rounds. ``donate`` is accepted for parity with
        the reference, whose programs may consume their input buffers:
        the port never writes its input tensors, so both values give the
        same bytes and leave the inputs intact.

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
                      schedule: Optional[FedBuffSchedule]) -> tuple:
        """Pad, validate and place one window's inputs: (kind, state, xs,
        ys, weights, attack scales or None, (arrivals, taus) or None)."""
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
        scales = None
        if attack_scales is not None:
            scales = self.pad_attack_scales(attack_scales)
            if scales.dim() == 2 and scales.shape[0] != n_rounds:
                raise ValueError(
                    f"per-round attack_scales have {scales.shape[0]} rows for {n_rounds} rounds"
                )
        sched = None
        if schedule is not None:
            if schedule.n_rounds != n_rounds:
                raise ValueError(
                    f"schedule covers {schedule.n_rounds} rounds for a {n_rounds}-round window")
            if schedule.n_nodes != self.n_nodes:
                raise ValueError(f"schedule has {schedule.n_nodes} nodes for {self.n_nodes}")
            # Pad rows never arrive and carry zero staleness.
            extra = ((0, 0), (0, self.padded_nodes - self.n_nodes))
            sched = tuple(_to_device(np.pad(np.asarray(a, np.float32), extra), self.device)
                          for a in (schedule.arrivals, schedule.taus))
        c_locals, c_global = {}, {}
        if kind == "scaffold":
            c_locals, c_global = scaffold_state
            c_locals = self.pad_stacked(c_locals)
        state = (self.pad_stacked(params), c_locals, c_global,
                 {} if aux is None else self.pad_stacked(aux))
        xs, ys = self.shard_data(xs, ys)
        return kind, state, xs, ys, w, scales, sched

    def _run_window(self, kind: str, state: tuple, xs: torch.Tensor, ys: torch.Tensor,
                    w: torch.Tensor, scales: Optional[torch.Tensor], sched: Optional[tuple],
                    epochs: int, n_rounds: int, codec: tuple[int, float], telemetry: bool,
                    stale_exp: float) -> tuple[tuple, torch.Tensor, Optional[dict]]:
        """Enqueue a window's rounds: (state, last losses, telemetry carry
        or None)."""
        roundtrip = compression.engine_codec_roundtrip_nodes(*codec)
        tele = bpm = None
        if telemetry:
            f32, pn = torch.float32, self.padded_nodes
            tele = {k: torch.zeros((n_rounds, pn), dtype=f32, device=self.device)
                    for k in TELEMETRY_NODE_FIELDS}
            if sched is not None:
                tele[TELEMETRY_STALENESS_FIELD] = torch.zeros((n_rounds, pn), dtype=f32,
                                                              device=self.device)
            tele.update({k: torch.zeros((n_rounds,), dtype=f32, device=self.device)
                         for k in TELEMETRY_ROUND_FIELDS})
            # Per-node payload bytes under the codec: a constant of the shapes.
            bpm = float(compression.wire_bytes_per_model(
                tree_map(lambda t: t[0], state[0]), *codec))
        losses = torch.zeros((self.padded_nodes,), dtype=torch.float32, device=self.device)
        for r in range(n_rounds):
            scale = None if scales is None else scales if scales.dim() == 1 else scales[r]
            sched_r = None if sched is None else (sched[0][r], sched[1][r], stale_exp)
            state, losses, stats = self._round(
                kind, state, xs, ys, w if w.dim() == 1 else w[r], epochs, roundtrip, scale,
                sched_r, bpm)
            if stats is not None:
                with torch.no_grad():
                    tele["loss"][r] = losses.to(torch.float32)
                    for k, v in (*stats[0].items(), *stats[1].items()):
                        tele[k][r] = v
        return state, losses, tele

    def _window(self, params: Params, xs: Any, ys: Any, weights: Optional[Any], epochs: int,
                n_rounds: int, aux: Optional[Any], scaffold_state: Optional[tuple[Any, Any]],
                codec: tuple[int, float]) -> tuple:
        """A window with the codec given as (bits, top-k fraction), no
        telemetry carry and no host leg (``VmapFederation.round``)."""
        kind, state, xs, ys, w, _, _ = self._prepare_args(
            params, xs, ys, weights, n_rounds, aux, scaffold_state, None, None)
        state, losses, _ = self._run_window(kind, state, xs, ys, w, None, None, epochs,
                                            n_rounds, codec, False, 0.0)
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
        a host sync (arguments as :meth:`run_rounds`; ``donate`` changes
        nothing). The window's outputs chain into the next dispatch as
        device tensors; its host leg runs at ``finalize``. A failure while
        enqueueing records ``engine_failure`` in the ``engine`` flight
        ring, dumps it under ``Settings.TELEMETRY_DUMP_DIR`` and
        re-raises."""
        kind, state, xs, ys, w, scales, sched = self._prepare_args(
            params, xs, ys, weights, n_rounds, aux, scaffold_state, attack_scales, schedule)
        tele_on = bool(Settings.ENGINE_TELEMETRY)
        codec = (compression.resolve_engine_codec(Settings.ENGINE_WIRE_CODEC),
                 float(Settings.WIRE_TOPK_FRAC))
        # Read at dispatch, 0 for a sync window.
        stale_exp = float(Settings.ASYNC_STALENESS_EXP) if sched is not None else 0.0
        prof = profiling.rounds.enabled()
        node_tag = f"engine:{profiling.module_tag(self.module)}"
        window_start = self._rounds_done
        if prof:
            self._windows += 1
            profiling.rounds.begin_round(node_tag, self._windows)
        run = self._program(kind, epochs, n_rounds, w.dim(), donate is not False, tele_on,
                            0 if scales is None else scales.dim(), codec, sched is not None,
                            stale_exp)
        t0 = time.monotonic() if (prof or tele_on) else 0.0
        try:
            state, losses, tele = run(kind, state, xs, ys, w, scales, sched, epochs, n_rounds,
                                      codec, tele_on, stale_exp)
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
        params, c_locals, c_global, aux_out = state
        return EngineWindow(self, kind, aux is not None,
                            (params, c_locals, c_global, aux_out, losses), copy, n_rounds,
                            window_start, self._windows, prof, node_tag, t0, t1, event)

    def _program(self, kind: str, epochs: int, n_rounds: int, w_ndim: int, donate: bool,
                 telemetry: bool, a_ndim: int, codec: tuple[int, float], fedbuff: bool,
                 stale_exp: float) -> Callable:
        """The window callable of one dispatch key, behind the compile
        observatory: the reference's program cache key (with its
        one-device mesh axes and the padded capacity tier; ``donate``
        None counts as the reference's default True) and program names,
        so a tier promotion reads as one new program with one signature
        and a variant never as a recompile of the base program."""
        pop = 0 if self.population is None else int(self.population.registered)
        key = (kind, int(epochs), int(n_rounds), int(w_ndim), bool(donate), bool(telemetry),
               int(a_ndim), int(codec[0]), float(codec[1]), 1, "replicated", bool(fedbuff),
               float(stale_exp), int(self.padded_nodes), 1, 1, pop)
        fn = self._programs.get(key)
        if fn is None:
            # The reference's program cache sees a lookup only when its
            # wrapper cache misses: one miss per new key.
            profiling.observatory.cache_event("engine_programs", hit=False)
            suffix = ((":obs" if telemetry else "") + (":atk" if a_ndim else "")
                      + (f":{compression.codec_name(codec[0])}" if codec[0] else "")
                      + (":fb" if fedbuff else "") + f":c{self.padded_nodes}"
                      + (f":pop{pop}" if pop else ""))
            fn = self._programs[key] = profiling.observatory.wrap(
                self._run_window,
                f"engine_round:{kind}x{n_rounds}{suffix}:{profiling.module_tag(self.module)}")
        return fn

    def donation_report(self, *args: Any, **kwargs: Any) -> dict:
        """The reference's compiled-HLO buffer-donation report."""
        raise not_ported("FederationEngine.donation_report (an XLA aliasing report)", REST_ITEM)

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
        token). With ``aux``, BatchNorm uses the running averages."""
        params = self.pad_stacked(params)
        aux = {} if aux is None else self.pad_stacked(aux)
        xs, ys = self.shard_data(xs, ys)
        losses, accs = [], []
        for bi in range(xs.shape[1]):
            logits, _ = apply(self.module, params, aux, xs[:, bi], train=False)
            losses.append(_per_node_mean(self._loss_fn(logits, ys[:, bi])))
            accs.append(_per_node_mean((logits.argmax(-1) == ys[:, bi]).to(torch.float32)))
        return torch.stack(losses).mean(0), torch.stack(accs).mean(0)


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


def donation_analysis(*args: Any, **kwargs: Any) -> dict:
    """The reference's compiled-HLO donation analysis."""
    raise not_ported("parallel.engine.donation_analysis (an XLA aliasing report)", REST_ITEM)
