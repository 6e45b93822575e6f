"""Aggregation state machine — the port of
:mod:`tpfl.learning.aggregators.aggregator`.

Parity with the reference:

- ``set_nodes_to_aggregate`` declares the round's train set;
- thread-safe ``add_model`` with contributor-subset checks, closing the
  round when the train set (or ``Settings.ROUND_QUORUM`` of it) is
  covered; contributions fold on arrival into the subclass's running
  accumulator under ``Settings.AGG_STREAM_EAGER``, else at close in
  canonical (contributor-sorted) order;
- ``wait_and_get_aggregation(timeout)``, ``remove_dead_nodes``,
  ``stalled``, partial aggregation ``get_model(except_nodes)``;
- the active defense's intake (``set_quarantine``,
  ``Settings.QUARANTINE_ENABLED``): the attached
  :class:`~tpfl_torch.management.quarantine.QuarantineEngine` judges
  every contribution before it folds; an excluded one is kept as a
  coverage-only passenger (its contributor counts toward coverage and
  rides the aggregate's contributor list, its params never fold), an
  all-quarantined mixture is dropped, and a round whose every held
  model is excluded fails open to the undefended fold;
- the ledger taps (``Settings.LEDGER_ENABLED``): ``add_model`` records
  each accepted contribution, ``clear`` closes the ledger's round;
- the asynchronous buffered lifecycle (``Settings.ASYNC_ROUNDS``):
  ``set_nodes_to_aggregate(async_k=, round_ordinal=)`` opens a round
  that closes on ``async_k`` distinct contributors (``close_reason``
  "buffer_full") or ``async_deadline_close`` ("deadline"); a
  contribution tagged ``add_model(start_version=)`` folds at its sample
  count times :func:`staleness_weight` of ``round_ordinal −
  start_version``, untagged ones per ``Settings.ASYNC_UNTAGGED_POLICY``.
  Free-running (``ASYNC_SERIALIZED`` off) folds eagerly on arrival;
  serialized defers the fold to the close, in canonical order, and with
  a seeded ``AsyncSchedule`` attached (``set_async_schedule``) admits
  single contributions strictly in schedule order through a reorder
  buffer that survives round boundaries. ``take_arrival_observations``
  feeds the adaptive controller.

The math lives in subclasses' ``acc_init`` / ``accumulate`` /
``finalize``, as torch ops on the aggregator's device (``device=None``
means the card); the staleness weights scale the running sums there.
The fold and close times land in the logger's metrics registry
(``tpfl_agg_fold_seconds``, ``tpfl_agg_aggregate_seconds``) and in the
round profiler's ``fold`` component (:mod:`tpfl_torch.management.profiling`).
"""

from __future__ import annotations

import math
import threading
import time
from abc import ABC
from typing import Any

import torch

from tpfl_torch import DeviceLike, resolve_device
from tpfl_torch.concurrency import make_lock
from tpfl_torch.learning.model import TpflModel, to_device
from tpfl_torch.management import ledger, profiling, tracing
from tpfl_torch.management.logger import logger
from tpfl_torch.management.telemetry import flight
from tpfl_torch.settings import Settings
from tpfl_torch.utils.tree import canonical_leaves, canonical_map, canonical_unflatten

class NoModelsToAggregateError(Exception):
    """wait_and_get_aggregation timed out with zero models."""


def staleness_weight(tau: int) -> float:
    """FedBuff-style staleness decay ``w(τ) = 1/(1+τ)**exp``
    (``Settings.ASYNC_STALENESS_EXP``): τ ≤ 0 (fresh) folds at full
    weight, and exp = 0 disables discounting. Synchronous rounds fold
    every contribution at τ = 0."""
    exp = float(Settings.ASYNC_STALENESS_EXP)
    if exp == 0.0 or tau <= 0:
        return 1.0
    return float((1.0 + float(tau)) ** -exp)


def untagged_staleness() -> "int | None":
    """Staleness of an UNTAGGED async contribution per
    ``Settings.ASYNC_UNTAGGED_POLICY``: "fresh" → 0, "max-stale" →
    ``ASYNC_STALENESS_MAX``, "reject" → None (the intake refuses it).
    One resolution point, so the fold weight, the robust candidates' τ
    and the quarantine / ledger window see the same number."""
    policy = str(Settings.ASYNC_UNTAGGED_POLICY)
    if policy == "reject":
        return None
    if policy == "max-stale":
        return max(0, int(Settings.ASYNC_STALENESS_MAX))
    return 0


def on_device(tree: Any, device: torch.device) -> Any:
    """A tree's leaves as tensors on ``device`` in JAX's pytree order
    (wire-decoded numpy leaves go up in one transfer)."""
    return canonical_unflatten(tree, to_device(canonical_leaves(tree), device))


def stack_models(models: list[TpflModel], device: DeviceLike = None) -> tuple[Any, torch.Tensor]:
    """N parameter trees stacked along a leading node axis, and the
    per-model sample counts (f32) — for math that wants the models side
    by side."""
    dev = resolve_device(device)
    trees = [on_device(m.get_parameters(), dev) for m in models]
    stacked = canonical_map(lambda *xs: torch.stack(xs), *trees)
    weights = torch.tensor([float(m.get_num_samples()) for m in models], dtype=torch.float32,
                           device=dev)
    return stacked, weights


class AggStream:
    """Running-aggregation state of the accumulate/finalize API: the
    on-device accumulator (``acc``, updated in place) plus the
    bookkeeping finalize needs (template model, contributor union,
    sample total). ``offered`` counts every model handed to
    ``accumulate`` (including ones a subclass skipped, e.g. SCAFFOLD's
    zero-sample fits); ``count`` the models actually folded."""

    __slots__ = ("acc", "template", "contributors", "num_samples", "count", "offered", "extra")

    def __init__(self, template: TpflModel) -> None:
        self.acc: Any = None
        self.template = template
        self.contributors: set[str] = set()
        self.num_samples = 0
        self.count = 0
        self.offered = 0
        self.extra: dict[str, Any] = {}


class Aggregator(ABC):
    """Per-round aggregation state machine, one per node.

    ``device``: where the folds run (``None`` means the card; pass
    ``"cpu"`` for the CPU)."""

    SUPPORTS_PARTIAL_AGGREGATION: bool = False
    SUPPORTS_STREAMING: bool = False
    REQUIRED_CALLBACKS: list[str] = []

    def __init__(self, node_name: str = "unknown", device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        self.node_name = node_name
        # guarded-by: _lock
        self._train_set: list[str] = []
        # guarded-by: _lock
        self._models: list[TpflModel] = []
        # Eager streaming accumulator (Settings.AGG_STREAM_EAGER); None
        # until the first accepted model; dropped on any fold error (the
        # close then falls back to the sorted batch fold).
        # guarded-by: _lock
        self._stream: "AggStream | None" = None
        # guarded-by: _lock
        self._stream_dead = False
        # Members dropped by remove_dead_nodes this round — a partial
        # bundling one of them re-admits it (see _admit_locked).
        # guarded-by: _lock
        self._removed_dead: set[str] = set()
        # Active-defense seam (tpfl_torch.management.quarantine): wired
        # once before any thread adds models; None on bare aggregators.
        # unguarded: written once at set-up, read-only after.
        self._quarantine: Any = None
        # Models accepted for COVERAGE but excluded from the fold by a
        # quarantine verdict, keyed by object identity (they stay in
        # _models so contributor bookkeeping is unchanged; only the math
        # skips them).
        # guarded-by: _lock
        self._excluded: dict[int, str] = {}
        # --- asynchronous buffered rounds (Settings.ASYNC_ROUNDS) ---
        # Buffer size that closes the open round (0 = synchronous round).
        # Writes under _lock; lock-free int reads see at worst one round
        # of drift.
        # guarded-by: _lock writes
        self._async_k: int = 0
        # Model-version ordinal of the round being formed (the "r" of
        # τ = r − start_version).
        # guarded-by: _lock writes
        self._round_ordinal: int = 0
        # Per-held-model staleness, keyed by object identity.
        # guarded-by: _lock
        self._staleness: dict[int, int] = {}
        # Why the open round closed: "coverage", "buffer_full" or
        # "deadline"; None while open.
        # guarded-by: _lock writes
        self._close_reason: "str | None" = None
        # Serialized-arrival discipline: the attached seeded
        # AsyncSchedule (written once per experiment, before the nodes
        # start; its state mutates only under _lock) and the reorder
        # buffer of out-of-order arrivals by contributor, which survives
        # round boundaries.
        # guarded-by: _lock writes
        self._async_sched: Any = None
        # guarded-by: _lock
        self._async_hold: dict[str, list] = {}
        # Per-round (τ, stamp) arrival observations for the adaptive
        # controller: the schedule's virtual time for drained
        # admissions, the arrival ordinal serialized without a schedule,
        # time.monotonic() free-running.
        # guarded-by: _lock
        self._arrivals: list[tuple[int, float]] = []
        # Deadline attempt ordinal of the open async round.
        # guarded-by: _lock
        self._deadline_attempt: int = 0
        self._lock = make_lock("Aggregator._lock")
        self._finish_aggregation_event = threading.Event()
        self._finish_aggregation_event.set()
        # guarded-by: _lock
        self._last_intake = time.monotonic()
        # Bumped on every state change (round start/end, model added);
        # gossip loops key their encoded-payload caches on it.
        # guarded-by: _lock writes
        self.version = 0

    # --- math (subclasses) ---

    def aggregate(self, models: list[TpflModel]) -> TpflModel:
        """Combine models into one: a sequential accumulate/finalize fold
        for streaming aggregators."""
        if not models:
            raise ValueError("No models to aggregate")
        if not self.SUPPORTS_STREAMING:
            raise NotImplementedError(
                f"{type(self).__name__} must override aggregate() or set "
                "SUPPORTS_STREAMING and implement acc_init/accumulate/finalize"
            )
        state = self.acc_init(models[0])
        for m in models:
            state = self.accumulate(state, m)
        return self.finalize(state)

    def acc_init(self, template: TpflModel) -> AggStream:
        raise NotImplementedError

    def accumulate(self, state: AggStream, model: TpflModel, weight: "float | None" = None,
                   staleness: int = 0) -> AggStream:
        raise NotImplementedError

    def finalize(self, state: AggStream) -> TpflModel:
        raise NotImplementedError

    def set_quarantine(self, engine: Any) -> None:
        """Attach the node's QuarantineEngine, before any model arrives;
        its verdicts gate the fold only while
        ``Settings.QUARANTINE_ENABLED``."""
        self._quarantine = engine

    def quarantined_peers(self) -> set[str]:
        """Peers the attached engine currently excludes (empty with no
        engine or the defense off) — the robust aggregators' candidate
        shrink at finalize."""
        if self._quarantine is None or not Settings.QUARANTINE_ENABLED:
            return set()
        return self._quarantine.quarantined()

    def get_required_callbacks(self) -> list[str]:
        return list(self.REQUIRED_CALLBACKS)

    def initial_callback_info(self, name: str) -> dict:
        """Config a required callback starts with before the first
        aggregated model arrives (FedProx ships its ``proximal_mu``)."""
        return {}

    # --- round lifecycle ---

    def set_nodes_to_aggregate(self, nodes: list[str], async_k: "int | None" = None,
                               round_ordinal: int = 0) -> None:
        """Start a round: declare the train set whose contributions we
        await. ``async_k`` opens an asynchronous buffered round instead:
        it closes on ``async_k`` distinct covered contributors (clamped
        to ``[1, len(nodes)]``), whoever they are; ``round_ordinal`` is
        the model-version ordinal the round produces."""
        if not self._finish_aggregation_event.is_set():
            raise Exception(f"({self.node_name}) Aggregation already in progress")
        drained: list = []
        with self._lock:
            self._train_set = list(nodes)
            self._models = []
            self._stream = None
            self._stream_dead = False
            self._removed_dead = set()
            self._excluded = {}
            self._staleness = {}
            self._close_reason = None
            self._arrivals = []
            self._deadline_attempt = 0
            self._async_k = max(1, min(int(async_k), len(nodes))) if async_k else 0
            self._round_ordinal = int(round_ordinal)
            self.version += 1
            self._last_intake = time.monotonic()
            # Clear under the lock: a model arriving between the train-set
            # assignment and the clear would otherwise be dropped.
            self._finish_aggregation_event.clear()
            # Contributions the reorder buffer held while no round was
            # open admit into this one.
            if self._async_k and self._async_sched is not None:
                drained = self._drain_schedule_locked()
        self._post_admit(drained)

    def set_async_schedule(self, schedule: Any) -> None:
        """Attach this aggregator's own seeded
        :class:`~tpfl_torch.communication.faults.AsyncSchedule` (callers
        ``fork()`` one per node): async intake then admits single
        contributions strictly in schedule order. ``None`` detaches.
        Resets the reorder buffer either way."""
        with self._lock:
            self._async_sched = schedule
            self._async_hold = {}

    def reorders(self, contributors: list[str]) -> bool:
        """True when the attached schedule admits this contribution
        through the reorder buffer (a single contributor it knows) in an
        async round. Under ``ASYNC_ROUNDS`` the buffer holds it before
        this node's first round opens too, so a peer's fit that beats that
        open keeps its schedule slot; the JAX package's intake waits for
        the first ``async_k`` round and the ``partial_model`` command then
        stashes the contribution for round 1 (``ROADMAP.md`` §3). A
        synchronous round never reorders."""
        sched = self._async_sched
        return (sched is not None and bool(self._async_k or Settings.ASYNC_ROUNDS)
                and len(contributors) == 1 and sched.knows(contributors[0]))

    def is_async(self) -> bool:
        """True while the open (or last-opened) round is buffered async."""
        return bool(self._async_k)

    def round_ordinal(self) -> int:
        """The model-version ordinal of the open (or last-opened) round."""
        return self._round_ordinal

    def close_reason(self) -> "str | None":
        """Why the current round closed ("coverage", "buffer_full",
        "deadline"); None while still open."""
        return self._close_reason

    def is_open(self) -> bool:
        """True while a round's aggregation is in progress (between
        set_nodes_to_aggregate and full coverage / clear)."""
        return not self._finish_aggregation_event.is_set()

    def wait_closed(self, timeout: "float | None" = None) -> bool:
        """Block until the open round closes (coverage, buffer-full,
        deadline or clear); True when closed."""
        return self._finish_aggregation_event.wait(timeout=timeout)

    def stalled(self, stall_seconds: float) -> bool:
        """True when intake has gone quiet: the round is open, at least
        one contribution is held, and nothing new has arrived for
        ``stall_seconds`` (monotonic clock)."""
        with self._lock:
            return (
                not self._finish_aggregation_event.is_set()
                and bool(self._models)
                and (time.monotonic() - self._last_intake) > stall_seconds
            )

    def _covered_meets_quorum(self, covered: set[str]) -> bool:
        """Caller holds ``self._lock``. True when ``covered`` satisfies
        Settings.ROUND_QUORUM of the (possibly shrunk) expected set."""
        n = len(self._train_set)
        if n == 0:
            return False
        need = max(1, math.ceil(Settings.ROUND_QUORUM * n - 1e-9))
        return len(covered & set(self._train_set)) >= need

    def remove_dead_nodes(self, addrs: list[str]) -> bool:
        """Shrink the expected contributor set to the live members
        (members whose contribution already arrived are kept). Returns
        True when the aggregation is (now) closed."""
        with self._lock:
            if self._finish_aggregation_event.is_set():
                return True
            if self._async_k:
                # Async rounds await no specific member: nothing to shrink.
                return False
            covered = {c for m in self._models for c in m.get_contributors()}
            removable = [a for a in addrs if a in self._train_set and a not in covered]
            if removable:
                self._train_set = [a for a in self._train_set if a not in removable]
                self._removed_dead.update(removable)
                self.version += 1
                logger.warning(
                    self.node_name,
                    f"Dropping dead train-set members {removable}; "
                    f"now expecting {self._train_set}",
                )
                if self._covered_meets_quorum(covered):
                    self._finish_aggregation_event.set()
            closed = self._finish_aggregation_event.is_set()
        if removable:
            # Quorum degradation is a flight-recorder moment: record it
            # (and flush the ring for the post-mortem) OUTSIDE _lock —
            # telemetry must never extend a protocol critical section.
            logger.metrics.counter("tpfl_agg_quorum_degraded_total",
                                   labels={"node": self.node_name})
            tracing.event("quorum_degraded", self.node_name,
                          removed=",".join(sorted(removable)))
            flight.dump(self.node_name, "quorum_degraded")
        return closed

    def async_deadline_close(self) -> bool:
        """Deadline failsafe of an async round
        (``Settings.ASYNC_ROUND_DEADLINE``, polled by ``AsyncRoundStage``):
        close with whatever the buffer holds; True when the round is
        (now) closed. An EMPTY buffer fails open loudly: the deadline
        event and counter fire with the round's attempt ordinal, the
        round stays open, and the caller re-arms."""
        with self._lock:
            if self._finish_aggregation_event.is_set():
                return True
            if not self._async_k:
                return False
            held = bool(self._models)
            self._deadline_attempt += 1
            attempt = self._deadline_attempt
            if held:
                self._close_reason = "deadline"
                self._finish_aggregation_event.set()
        outcome = "closed" if held else "empty"
        logger.metrics.counter("tpfl_agg_deadline_total",
                               labels={"node": self.node_name, "outcome": outcome})
        tracing.event("round_deadline", self.node_name, outcome=outcome,
                      round=self._round_ordinal, attempt=attempt)
        if not held:
            logger.metrics.counter("tpfl_agg_deadline_rearm_total",
                                   labels={"node": self.node_name})
            logger.warning(
                self.node_name,
                f"Async round {self._round_ordinal} deadline expired with an EMPTY buffer "
                f"(attempt {attempt}); failing open (round stays open, deadline re-arms)",
            )
            return False
        self._emit_async_close("deadline")
        return True

    def clear(self) -> None:
        """End a round."""
        with self._lock:
            self._train_set = []
            self._models = []
            self._stream = None
            self._stream_dead = False
            self._removed_dead = set()
            self._excluded = {}
            self._staleness = {}
            self._close_reason = None
            self._arrivals = []
            self._deadline_attempt = 0
            self.version += 1
        self._finish_aggregation_event.set()
        # Close the ledger's round (unconditional: a round opened with a
        # knob on must release its pinned reference even if the knob was
        # turned off mid-round).
        ledger.contrib.close_round(self.node_name)

    # --- model intake ---

    def get_aggregated_models(self) -> list[str]:
        """Contributors covered so far."""
        with self._lock:
            return [c for m in self._models for c in m.get_contributors()]

    def get_missing_models(self) -> set[str]:
        with self._lock:
            covered = {c for m in self._models for c in m.get_contributors()}
            return set(self._train_set) - covered

    def _staleness_of(self, start_version: "int | None") -> int:
        """Staleness of a contribution trained from ``start_version``
        folding into the round being formed: 0 in synchronous rounds;
        untagged async ones per :func:`untagged_staleness` ("reject" is
        enforced by ``add_model`` first)."""
        if not self._async_k:
            return 0
        if start_version is None:
            return untagged_staleness() or 0
        return max(0, int(self._round_ordinal) - int(start_version))

    def take_arrival_observations(self) -> "list[tuple[int, float]]":
        """Drain the round's (τ, stamp) arrival observations — the
        adaptive controller's feed."""
        with self._lock:
            out, self._arrivals = self._arrivals, []
        return out

    def add_model(self, model: TpflModel, trace: str = "",
                  start_version: "int | None" = None) -> list[str]:
        """Add a (possibly partially-aggregated) model; returns the list
        of contributors now covered, or [] if the model was rejected.
        ``start_version`` (async rounds): the model-version ordinal the
        contributor trained from; the fold weight and the ledger /
        quarantine taps carry the staleness it gives."""
        try:
            contributors = model.get_contributors()
        except ValueError:
            logger.debug(self.node_name, "Dropping model with no contributors")
            return []
        if self._async_k and start_version is None and untagged_staleness() is None:
            # ASYNC_UNTAGGED_POLICY == "reject", loudly.
            logger.metrics.counter("tpfl_agg_untagged_rejected_total",
                                   labels={"node": self.node_name})
            logger.debug(self.node_name, f"Dropping untagged contribution from {contributors} "
                                         "(ASYNC_UNTAGGED_POLICY=reject)")
            return []
        staleness = self._staleness_of(start_version)
        # Active-defense verdict BEFORE the fold, outside _lock (the
        # engine and the ledger hold only their own locks). An excluded
        # contribution is still accepted for coverage; re-pushes of the
        # same (peer, round) are judged once.
        verdict: "dict | None" = None
        if Settings.QUARANTINE_ENABLED and self._quarantine is not None:
            verdict = self._quarantine.assess(model, contributors, trace=trace,
                                              staleness=staleness)
        if verdict is not None and verdict["exclude"] and not verdict["recorded"]:
            # All-quarantined mixture: pure poison, and each member's own
            # contribution covers it.
            logger.debug(self.node_name, f"Dropping quarantined mixture from {contributors}")
            return []
        exclude = bool(verdict is not None and verdict["exclude"])
        recorded = bool(verdict is not None and verdict["recorded"])
        # Serialized async discipline: single contributions from
        # scheduled trainers enter the reorder buffer and admit strictly
        # in schedule order (possibly later, possibly unblocking others).
        if self.reorders(contributors):
            with self._lock:
                self._async_hold.setdefault(contributors[0], []).append(
                    (model, start_version, exclude, trace, recorded))
                drained = ([] if self._finish_aggregation_event.is_set()
                           else self._drain_schedule_locked())
                covered = {c for m in self._models for c in m.get_contributors()}
            self._post_admit(drained)
            return sorted(covered)
        out = self._intake(model, contributors, exclude=exclude, start_version=start_version)
        if out is None:
            return []
        # Ledger tap, outside _lock; the assessment above already
        # recorded and scored single contributions.
        if Settings.LEDGER_ENABLED and not recorded:
            ledger.contrib.record(self.node_name, model, trace=trace, staleness=staleness)
        return out

    def _drain_schedule_locked(self) -> list:
        """Caller holds ``_lock``. Admit held contributions in schedule
        order while the round stays open and the schedule's head is
        held; returns the admitted entries for :meth:`_post_admit`."""
        admitted: list = []
        sched = self._async_sched
        while not self._finish_aggregation_event.is_set():
            exp = sched.expected()
            if exp is None:
                break
            queue = self._async_hold.get(exp)
            if not queue:
                break
            model, start_version, exclude, trace, recorded = queue.pop(0)
            # The virtual-clock stamp of this admission, read before
            # advance() consumes the head. The slot is consumed whether or
            # not the coverage checks accept the model: every node sees
            # the same sequence, so a rejection is the same everywhere.
            vt = sched.expected_time()
            sched.advance()
            covered = self._admit_locked(model, [exp], exclude=exclude,
                                         start_version=start_version, virtual_stamp=vt)
            admitted.append((model, trace, recorded, covered, self._staleness.get(id(model), 0)))
        return admitted

    def _post_admit(self, admitted: list) -> None:
        """Ledger taps and close telemetry of schedule-drained
        admissions, outside ``_lock``."""
        closed_now = False
        for model, trace, recorded, covered, tau in admitted:
            if covered is None:
                continue
            closed_now = closed_now or not self.is_open()
            if Settings.LEDGER_ENABLED and not recorded:
                ledger.contrib.record(self.node_name, model, trace=trace, staleness=tau)
        if closed_now:
            self._emit_async_close("buffer_full")

    def _emit_async_close(self, reason: str) -> None:
        """An async round's close: a counter and a flight event."""
        logger.metrics.counter("tpfl_agg_async_close_total",
                               labels={"node": self.node_name, "reason": reason})
        tracing.event("round_close", self.node_name, reason=reason, round=self._round_ordinal)

    def _intake(self, model: TpflModel, contributors: list[str], exclude: bool = False,
                start_version: "int | None" = None) -> "list[str] | None":
        """The locked intake half of :meth:`add_model`: the covered list
        on acceptance, None on rejection. ``exclude`` (a quarantine
        verdict) accepts the model for coverage only."""
        with self._lock:
            was_open = not self._finish_aggregation_event.is_set()
            out = self._admit_locked(model, contributors, exclude, start_version=start_version)
            closed_now = was_open and out is not None and self._finish_aggregation_event.is_set()
        if closed_now and self._async_k:
            self._emit_async_close("buffer_full")
        return out

    def _admit_locked(self, model: TpflModel, contributors: list[str], exclude: bool = False,
                      start_version: "int | None" = None,
                      virtual_stamp: "float | None" = None) -> "list[str] | None":
        """Caller holds ``_lock``: the coverage checks + fold bookkeeping
        of one contribution. ``virtual_stamp``: the schedule's virtual
        time of a drained admission."""
        if self._finish_aggregation_event.is_set():
            logger.debug(self.node_name, "Dropping model: no aggregation in progress")
            return None
        if not self._train_set:
            logger.debug(self.node_name, "Dropping model: no train set")
            return None
        extras = set(contributors) - set(self._train_set)
        if extras:
            if self._async_k:
                # Async rounds police no elected set: a peer that joined
                # since the round opened grows it.
                self._train_set = list(self._train_set) + sorted(extras)
            elif extras <= self._removed_dead:
                # A peer bundles a member we declared dead: its
                # contribution is real, re-admit it (it arrives covered
                # by this very model, so nothing new is awaited).
                self._train_set = list(self._train_set) + sorted(extras)
                self._removed_dead -= extras
                logger.warning(
                    self.node_name,
                    f"Re-admitting dead-dropped members {sorted(extras)}: "
                    f"their contribution arrived via {contributors}",
                )
            else:
                logger.debug(
                    self.node_name,
                    f"Dropping model: contributors {contributors} not in train set",
                )
                return None
        covered = {c for m in self._models for c in m.get_contributors()}
        if set(contributors).issubset(covered):
            logger.debug(self.node_name,
                         f"Dropping model: contributors {contributors} already covered")
            return None
        if covered & set(contributors):
            # Overlap would double-count in a weighted mean.
            logger.debug(self.node_name,
                         f"Dropping model: contributors {contributors} overlap {covered}")
            return None
        self._models.append(model)
        tau = 0
        if self._async_k:
            tau = self._staleness_of(start_version)
            self._staleness[id(model)] = tau
            # The controller's observation: virtual clock (drained) >
            # arrival ordinal (serialized) > monotonic (free-running).
            if virtual_stamp is not None:
                stamp = float(virtual_stamp)
            elif Settings.ASYNC_SERIALIZED:
                stamp = float(len(self._arrivals))
            else:
                stamp = time.monotonic()
            self._arrivals.append((tau, stamp))
        # Eager folds: sync rounds follow Settings.AGG_STREAM_EAGER; async
        # rounds fold eagerly only free-running — the serialized
        # discipline defers every fold to the close, in canonical order.
        eager = (self.SUPPORTS_STREAMING and not self._stream_dead
                 and (Settings.AGG_STREAM_EAGER if not self._async_k
                      else not Settings.ASYNC_SERIALIZED))
        if exclude:
            # Quarantined: a coverage-only passenger. The eager stream
            # counts it "offered" (like a skipped zero-sample fit), so the
            # close still trusts the stream.
            self._excluded[id(model)] = ",".join(sorted(contributors))
            if eager:
                try:
                    if self._stream is None:
                        self._stream = self.acc_init(model)
                    self._stream.offered += 1
                except Exception:
                    self._stream = None
                    self._stream_dead = True
        # Eager on-arrival reduce: fold the accepted contribution into the
        # device accumulator NOW, so the round close is one finalize. The
        # torch ops are enqueued asynchronously on the card; the lock
        # covers the enqueue. Any fold error kills the stream for the
        # round; close falls back to the batch fold over the held models.
        if eager and not exclude:
            try:
                t_fold = time.monotonic()
                if self._stream is None:
                    self._stream = self.acc_init(model)
                if self._async_k:
                    # FedBuff: sample mass decayed by the version distance;
                    # τ rides along for the robust family's cut.
                    self._stream = self.accumulate(
                        self._stream, model,
                        weight=model.get_num_samples() * staleness_weight(tau), staleness=tau)
                else:
                    self._stream = self.accumulate(self._stream, model)
                logger.metrics.observe("tpfl_agg_fold_seconds", time.monotonic() - t_fold,
                                       labels={"node": self.node_name})
                # Eager folds are "fold" time even on a handler thread.
                profiling.rounds.add(self.node_name, "fold", time.monotonic() - t_fold)
            except Exception as e:
                logger.debug(self.node_name,
                             f"Eager accumulate failed ({e}); will batch-fold at round close")
                self._stream = None
                self._stream_dead = True
        self.version += 1
        self._last_intake = time.monotonic()
        covered |= set(contributors)
        logger.debug(
            self.node_name,
            f"Model added ({len(covered)}/{len(self._train_set)}) from {contributors}",
        )
        if self._async_k:
            # Buffer-full close (FedBuff's K): whoever reported first.
            if len(covered) >= self._async_k:
                self._close_reason = "buffer_full"
                self._finish_aggregation_event.set()
        elif self._covered_meets_quorum(covered):
            self._close_reason = "coverage"
            self._finish_aggregation_event.set()
        return sorted(covered)

    # --- results ---

    def wait_and_get_aggregation(self, timeout: float | None = None) -> TpflModel:
        """Block until the train set is covered (or timeout), then run
        the aggregation math."""
        if timeout is None:
            timeout = Settings.AGGREGATION_TIMEOUT
        finished = self._finish_aggregation_event.wait(timeout=timeout)
        with self._lock:
            # Canonical order: arrival order is scheduling noise, and
            # float reduction order must not depend on it. Under
            # AGG_STREAM_EAGER the arrival-order fold already ran; take
            # the stream when it covers exactly the held models.
            models = sorted(self._models, key=lambda m: tuple(sorted(m.get_contributors())))
            stream, self._stream = self._stream, None
            excluded_ids = dict(self._excluded)
            async_k = self._async_k
            staleness = dict(self._staleness)
            train_set = list(self._train_set)
        if not finished:
            missing = self.get_missing_models()
            logger.warning(
                self.node_name,
                f"Aggregation timed out; proceeding without {missing} "
                f"(train_set={train_set}, held={[m.get_contributors() for m in models]})",
            )
        if not models:
            raise NoModelsToAggregateError(f"({self.node_name}) No models to aggregate")
        # Quarantine verdicts: passengers never fold. If the verdicts
        # emptied the fold (every contribution flagged), fail open, loud:
        # a defense degrades to the undefended aggregate, never bricks
        # the round.
        fold_models = [m for m in models if id(m) not in excluded_ids]
        if not fold_models:
            if excluded_ids:
                logger.warning(
                    self.node_name,
                    "Quarantine excluded EVERY held contribution "
                    f"({sorted(excluded_ids.values())}); failing open to the undefended fold",
                )
                logger.metrics.counter("tpfl_quarantine_fail_open_total",
                                       labels={"node": self.node_name})
            fold_models = models
        t_close = time.monotonic()
        try:
            with tracing.maybe_span("aggregate", self.node_name, held=len(models),
                                    eager=bool(stream is not None)):
                if stream is not None and stream.offered == len(models) and stream.count:
                    out = self.finalize(stream)
                elif async_k and self.SUPPORTS_STREAMING:
                    # Serialized async close: the deferred
                    # staleness-weighted fold in canonical order.
                    state = self.acc_init(fold_models[0])
                    for m in fold_models:
                        tau = staleness.get(id(m), 0)
                        state = self.accumulate(
                            state, m, weight=m.get_num_samples() * staleness_weight(tau),
                            staleness=tau)
                    out = self.finalize(state)
                else:
                    out = self.aggregate(fold_models)
                return self._with_passengers(out, models, excluded_ids,
                                             folded_all=fold_models is models)
        finally:
            logger.metrics.observe("tpfl_agg_aggregate_seconds", time.monotonic() - t_close,
                                   labels={"node": self.node_name})
            profiling.rounds.add(self.node_name, "fold", time.monotonic() - t_close)

    def get_model(self, except_nodes: list[str] | None = None) -> TpflModel | None:
        """Partial aggregate of held models excluding contributions from
        ``except_nodes`` — what we gossip to a peer that already has
        those. None if nothing to send. Without partial aggregation, one
        of the peer's missing single-contributor models per call
        (deterministic sorted order, clean ones first). Quarantined
        holdings never fold: a multi-model partial carries them as
        coverage-only passengers, and a lone one is pushed verbatim."""
        except_nodes = except_nodes or []
        with self._lock:
            usable = sorted(
                (m for m in self._models if not (set(m.get_contributors()) & set(except_nodes))),
                key=lambda m: tuple(sorted(m.get_contributors())),
            )
            excluded_ids = dict(self._excluded)
        if not usable:
            return None
        if len(usable) == 1:
            return usable[0]
        if not self.SUPPORTS_PARTIAL_AGGREGATION:
            singles = [m for m in usable if len(m.get_contributors()) == 1]
            clean = [m for m in singles if id(m) not in excluded_ids]
            pick = clean or singles
            return pick[0] if pick else None
        folded = [m for m in usable if id(m) not in excluded_ids]
        if not folded:
            # Every usable holding is quarantined: push one verbatim (the
            # receiver assesses it) instead of aggregating poison.
            return usable[0]
        return self._with_passengers(self.aggregate(folded), usable, excluded_ids)

    @staticmethod
    def _with_passengers(out: TpflModel, models: list[TpflModel], excluded_ids: "dict[int, str]",
                         folded_all: bool = False) -> TpflModel:
        """The aggregate with the quarantine-excluded passengers among
        ``models`` added to its contributor list. Their params never
        folded, and ``num_samples`` stays the folded total, so the
        payload weighs exactly the honest mass it carries."""
        if folded_all or not excluded_ids:
            return out
        passengers = {c for m in models if id(m) in excluded_ids
                      for c in m.get_contributors()} - set(out.get_contributors())
        if not passengers:
            return out
        return out.build_copy(params=out.get_parameters(),
                              contributors=sorted(set(out.get_contributors()) | passengers),
                              num_samples=out.get_num_samples())


__all__ = ["AggStream", "Aggregator", "NoModelsToAggregateError", "on_device",
           "stack_models", "staleness_weight", "untagged_staleness"]
