"""Aggregation state machine — the port of
:mod:`tpfl.learning.aggregators.aggregator`, synchronous rounds.

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
  each accepted contribution, ``clear`` closes the ledger's round.

The math lives in subclasses' ``acc_init`` / ``accumulate`` /
``finalize``, as torch ops on the aggregator's device (``device=None``
means the card).

Not ported (each raises ``NotImplementedError`` naming its
``ROADMAP.md`` item when asked for, never skipped silently): the
asynchronous buffered lifecycle (``set_nodes_to_aggregate(async_k=)``,
``start_version``, ``set_async_schedule``, ``async_deadline_close``,
``Settings.ASYNC_ROUNDS``, ``staleness_weight`` for τ > 0). The fold
and close times land in the logger's metrics registry
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
from tpfl_torch.exceptions import ASYNC_ITEM as _ASYNC_ITEM
from tpfl_torch.exceptions import not_ported as _not_ported
from tpfl_torch.management import ledger, profiling, tracing
from tpfl_torch.management.logger import logger
from tpfl_torch.management.telemetry import flight
from tpfl_torch.settings import Settings
from tpfl_torch.utils.tree import canonical_leaves, canonical_map, canonical_unflatten

def not_ported(what: str, item: str) -> NotImplementedError:
    return _not_ported(f"aggregators: {what}", item)


def refuse_unported_knobs() -> None:
    """Raise for a Settings flag whose plane the port does not have."""
    if Settings.ASYNC_ROUNDS:
        raise not_ported("Settings.ASYNC_ROUNDS", _ASYNC_ITEM)


class NoModelsToAggregateError(Exception):
    """wait_and_get_aggregation timed out with zero models."""


def staleness_weight(tau: int) -> float:
    """FedBuff-style decay ``1/(1+τ)**0.5`` of the reference's async
    rounds; synchronous rounds fold every contribution at τ = 0, where
    it is 1. The port has no async rounds, so τ > 0 is refused."""
    if tau <= 0:
        return 1.0
    raise not_ported("staleness-weighted folds", _ASYNC_ITEM)


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
        await. ``async_k`` (the buffered async round) is refused."""
        if async_k:
            raise not_ported("set_nodes_to_aggregate(async_k=...)", _ASYNC_ITEM)
        refuse_unported_knobs()
        if not self._finish_aggregation_event.is_set():
            raise Exception(f"({self.node_name}) Aggregation already in progress")
        with self._lock:
            self._train_set = list(nodes)
            self._models = []
            self._stream = None
            self._stream_dead = False
            self._removed_dead = set()
            self._excluded = {}
            self.version += 1
            self._last_intake = time.monotonic()
            # Clear under the lock: a model arriving between the train-set
            # assignment and the clear would otherwise be dropped.
            self._finish_aggregation_event.clear()

    def set_async_schedule(self, schedule: Any) -> None:
        raise not_ported("set_async_schedule", _ASYNC_ITEM)

    def async_deadline_close(self) -> bool:
        raise not_ported("async_deadline_close", _ASYNC_ITEM)

    def is_open(self) -> bool:
        """True while a round's aggregation is in progress (between
        set_nodes_to_aggregate and full coverage / clear)."""
        return not self._finish_aggregation_event.is_set()

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

    def clear(self) -> None:
        """End a round."""
        with self._lock:
            self._train_set = []
            self._models = []
            self._stream = None
            self._stream_dead = False
            self._removed_dead = set()
            self._excluded = {}
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

    def add_model(self, model: TpflModel, trace: str = "",
                  start_version: "int | None" = None) -> list[str]:
        """Add a (possibly partially-aggregated) model; returns the list
        of contributors now covered, or [] if the model was rejected.
        ``start_version`` (async rounds) is refused."""
        if start_version is not None:
            raise not_ported("add_model(start_version=...)", _ASYNC_ITEM)
        refuse_unported_knobs()
        try:
            contributors = model.get_contributors()
        except ValueError:
            logger.debug(self.node_name, "Dropping model with no contributors")
            return []
        # Active-defense verdict BEFORE the fold, outside _lock (the
        # engine and the ledger hold only their own locks). An excluded
        # contribution is still accepted for coverage; re-pushes of the
        # same (peer, round) are judged once.
        verdict: "dict | None" = None
        if Settings.QUARANTINE_ENABLED and self._quarantine is not None:
            verdict = self._quarantine.assess(model, contributors, trace=trace)
        if verdict is not None and verdict["exclude"] and not verdict["recorded"]:
            # All-quarantined mixture: pure poison, and each member's own
            # contribution covers it.
            logger.debug(self.node_name, f"Dropping quarantined mixture from {contributors}")
            return []
        exclude = bool(verdict is not None and verdict["exclude"])
        out = self._intake(model, contributors, exclude=exclude)
        if out is None:
            return []
        # Ledger tap, outside _lock; the assessment above already
        # recorded and scored single contributions.
        if Settings.LEDGER_ENABLED and not (verdict is not None and verdict["recorded"]):
            ledger.contrib.record(self.node_name, model, trace=trace)
        return out

    def _intake(self, model: TpflModel, contributors: list[str],
                exclude: bool = False) -> "list[str] | None":
        """The locked intake half of :meth:`add_model`: the covered list
        on acceptance, None on rejection. ``exclude`` (a quarantine
        verdict) accepts the model for coverage only."""
        with self._lock:
            return self._admit_locked(model, contributors, exclude)

    def _admit_locked(self, model: TpflModel, contributors: list[str],
                      exclude: bool = False) -> "list[str] | None":
        """Caller holds ``_lock``: the coverage checks + fold bookkeeping
        of one contribution."""
        if self._finish_aggregation_event.is_set():
            logger.debug(self.node_name, "Dropping model: no aggregation in progress")
            return None
        if not self._train_set:
            logger.debug(self.node_name, "Dropping model: no train set")
            return None
        extras = set(contributors) - set(self._train_set)
        if extras:
            if extras <= self._removed_dead:
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
        eager = self.SUPPORTS_STREAMING and Settings.AGG_STREAM_EAGER and not self._stream_dead
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
        # Eager on-arrival reduce (Settings.AGG_STREAM_EAGER): fold the
        # accepted contribution into the device accumulator NOW, so the
        # round close is one finalize. The torch ops are enqueued
        # asynchronously on the card; the lock covers the enqueue. Any
        # fold error kills the stream for the round; close falls back to
        # the batch fold over the held models.
        if eager and not exclude:
            try:
                t_fold = time.monotonic()
                if self._stream is None:
                    self._stream = self.acc_init(model)
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
        if self._covered_meets_quorum(covered):
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
           "refuse_unported_knobs", "stack_models", "staleness_weight"]
