"""NodeState — all mutable per-node learning state, a copy of
:mod:`tpfl.node_state` (with the adaptive async controller).

Parity with reference ``p2pfl/node_state.py:26-127``: the dicts/events
here are the synchronization points between protocol handler threads
(commands mutating state on message arrival) and the learning thread
(stages blocking on events). The reference uses raw ``threading.Lock``
acquire/release pairs as signals; here they are ``threading.Event``s,
which express the same handoffs without the acquire-twice idiom.

Concurrency contract: every mutable field carries a ``# guarded-by:``
or ``# unguarded:`` annotation (the reference enforces them with a
static race lint) — a read/write of a guarded field
outside a ``with <lock>:`` block is a race.
"""

from __future__ import annotations

import threading
from typing import Optional

from tpfl_torch.concurrency import make_lock
from tpfl_torch.experiment import Experiment


class NodeState:
    def __init__(self, addr: str, simulation: bool = False) -> None:
        self.addr = addr
        self.simulation = simulation
        self.status: str = "Idle"
        self.experiment: Optional[Experiment] = None

        # Voting (reference vote_train_set_command.py / stage).
        # Votes are tagged with the voter's round: a fast peer's round-r+1
        # vote arriving while we are still in round r must survive our
        # round-r tally and cleanup (the tally filters by round).
        # unguarded: replaced wholesale by the learning thread between
        # rounds; command/stage readers iterate whichever snapshot
        # reference they loaded (atomic under the GIL), never a
        # half-built list.
        self.train_set: list[str] = []
        # guarded-by: train_set_votes_lock
        self.train_set_votes: dict[str, tuple[int, dict[str, int]]] = {}
        self.train_set_votes_lock = make_lock("NodeState.train_set_votes_lock")
        self.votes_ready_event = threading.Event()

        # Model lifecycle events
        self.model_initialized_event = threading.Event()
        self.aggregated_model_event = threading.Event()
        # guarded-by: relay_lock writes
        self.last_full_model_round: int = -1
        """Highest round for which a FullModel was received/produced —
        compared against the current round by WaitAggregatedModelsStage
        (event-only signalling can lose an early-arriving FullModel).
        Writes are read-modify-write (``max``) racing between the
        learning thread (TrainStage adoption) and gRPC handlers
        (FullModelCommand), so they serialize under ``relay_lock``;
        lock-free reads are safe — a monotonic int watermark read is
        atomic under the GIL and a stale read only delays adoption by
        one poll tick."""
        self.relay_lock = make_lock("NodeState.relay_lock")
        # guarded-by: relay_lock
        self.last_relayed_round: int = -1
        """Epidemic-relay bookkeeping (FullModelCommand): highest round
        whose aggregate this node has re-sent to lagging neighbors.
        Check-and-mark happens under ``relay_lock`` — concurrent
        deliveries of the same round from two peers (gRPC handler pool)
        must not both fan the payload out."""
        # guarded-by: relay_lock writes
        self.model_version: int = 0
        """Bumped whenever an incoming FullModelCommand replaces the
        learner's model. GossipModelStage keys its encoded-payload
        cache on it: a round's AUTHORITATIVE aggregate can land while
        the stage is mid-push (the node entered holding a timed-out
        partial aggregate), and the cached stale bytes must not keep
        flowing. ``+=`` from concurrent handlers loses bumps, hence
        writes under ``relay_lock``; cache-key reads are lock-free."""
        # guarded-by: relay_lock writes
        self.model_round_origin: int = 0
        """Model-version ORDINAL of the params the learner currently
        holds — the round whose aggregate (or init, ordinal 0) they
        came from. The async round lifecycle (Settings.ASYNC_ROUNDS)
        tags every contribution with the ordinal its fit STARTED from;
        the receiving aggregator's staleness weight ``w(τ)`` is keyed
        off the distance between that tag and the round it folds into.
        Monotonic max-bumps under ``relay_lock`` (same discipline as
        ``last_full_model_round``); lock-free reads are one-ordinal
        stale at worst, which only over-discounts a contribution by
        one τ step."""

        # Gossip bookkeeping
        # guarded-by: models_aggregated_lock
        self.models_aggregated: dict[str, list[str]] = {}
        self.models_aggregated_lock = make_lock(
            "NodeState.models_aggregated_lock"
        )
        # guarded-by: nei_status_lock
        self.nei_status: dict[str, int] = {}
        """addr -> last finished round (-1 = model initialized).
        Written by command handlers (gRPC pool / relay threads), read —
        and previously ITERATED bare — by the learning thread's gossip
        closures; a handler insert during ``sorted(nei_status)`` raises
        ``RuntimeError: dictionary changed size during iteration``.
        All access goes through the accessors below."""
        self.nei_status_lock = make_lock("NodeState.nei_status_lock")

        # Next-round partial models. At scale, a fast peer's round-r+1
        # PartialModel can arrive while this node is still closing round
        # r; dropping it (reference partial_model_command.py:72-82) makes
        # the late trainer block the whole AGGREGATION_TIMEOUT. Stash and
        # replay when the round's TrainStage opens.
        # guarded-by: pending_partials_lock
        self.pending_partials: list[tuple] = []
        self.pending_partials_lock = make_lock(
            "NodeState.pending_partials_lock"
        )

        # Delta-gossip wire state (tpfl_torch.learning.compression): the
        # round -> full-model bases this node has adopted (what residual
        # payloads decode against), and the peers that nacked a delta
        # (missing/mismatched base) — GossipModelStage sends those dense
        # until the next experiment.
        from tpfl_torch.learning.compression import BaseCache

        # unguarded: BaseCache is internally synchronized (own _lock).
        self.wire_bases = BaseCache()

        # Active Byzantine defense (tpfl_torch.management.quarantine): the
        # per-node quarantine state machine Node wires into the
        # aggregator's intake. Quarantine state deliberately SURVIVES
        # round boundaries within an experiment — a peer flagged in
        # round r stays excluded in round r+1 until probation clears
        # it — and resets with the rest of the learning state when the
        # experiment ends (clear()).
        from tpfl_torch.management.quarantine import QuarantineEngine

        # unguarded: QuarantineEngine is internally synchronized (own
        # _lock); the reference itself is written once here.
        self.quarantine = QuarantineEngine(addr)

        # Adaptive async control plane (tpfl_torch.learning.async_control):
        # AsyncRoundStage consults it at every async round open and
        # feeds it the closed round's arrival observations. Static
        # knob passthrough while Settings.ASYNC_ADAPTIVE is off; its
        # learned state belongs to one experiment and resets with the
        # rest of the learning state (clear()).
        from tpfl_torch.learning.async_control import AsyncController

        # unguarded: AsyncController is internally synchronized (own
        # _lock); the reference itself is written once here.
        self.async_controller = AsyncController(addr)

        # unguarded: handler threads add(), the learning thread tests
        # membership and replaces the set wholesale at round
        # boundaries — all GIL-atomic set ops on a best-effort hint
        # (a missed nack costs one redundant delta push, re-nacked).
        self.delta_nack_peers: set[str] = set()

    # --- experiment delegation (reference node_state.py:84-97) ---

    @property
    def round(self) -> Optional[int]:
        return self.experiment.round if self.experiment else None

    @property
    def total_rounds(self) -> Optional[int]:
        return self.experiment.total_rounds if self.experiment else None

    @property
    def exp_name(self) -> Optional[str]:
        return self.experiment.exp_name if self.experiment else None

    def set_experiment(self, experiment: Experiment) -> None:
        self.status = "Learning"
        self.experiment = experiment

    def increase_round(self) -> None:
        if self.experiment is None:
            raise ValueError("No experiment running")
        self.experiment.increase_round()
        with self.models_aggregated_lock:
            self.models_aggregated = {}
        # Delta nacks are per-round hints, not a permanent downgrade: a
        # peer that adopted round r VIA a residual holds a slightly
        # different base than a dense receiver and will nack round
        # r+1's delta once — after which it adopts dense and re-syncs.
        self.delta_nack_peers = set()

    def stash_pending_partial(self, args: tuple, for_round: int) -> None:
        """Hold a next-round PartialModel until that round opens; stale
        entries (older rounds) are pruned in passing."""
        with self.pending_partials_lock:
            cur = self.round
            self.pending_partials = [
                (r, a)
                for r, a in self.pending_partials
                if cur is None or r >= cur
            ][-64:]
            self.pending_partials.append((for_round, args))

    def drain_pending_partials(self, for_round: int) -> list[tuple]:
        with self.pending_partials_lock:
            take = [a for r, a in self.pending_partials if r == for_round]
            self.pending_partials = [
                (r, a) for r, a in self.pending_partials if r != for_round
            ]
        return take

    def set_models_aggregated(self, node: str, models: list[str]) -> None:
        with self.models_aggregated_lock:
            self.models_aggregated[node] = models

    def get_models_aggregated(self) -> dict[str, list[str]]:
        with self.models_aggregated_lock:
            return dict(self.models_aggregated)

    # --- nei_status accessors (the only sanctioned access paths) ---

    def set_nei_status(self, addr: str, round: int) -> None:
        with self.nei_status_lock:
            self.nei_status[addr] = round

    def get_nei_status(self) -> dict[str, int]:
        """Snapshot copy — safe to iterate/sort outside the lock."""
        with self.nei_status_lock:
            return dict(self.nei_status)

    def nei_status_of(self, addr: str, default: int = -1) -> int:
        with self.nei_status_lock:
            return self.nei_status.get(addr, default)

    def prepare_experiment(self) -> None:
        """Reset per-experiment bookkeeping before the learning thread
        spawns. Preserves ``model_initialized_event`` and ``nei_status``
        — the initiator (or an early InitModel/ModelInitialized command)
        may legitimately arrive before the thread starts."""
        with self.train_set_votes_lock:
            self.train_set_votes = {}
        with self.models_aggregated_lock:
            self.models_aggregated = {}
        self.train_set = []
        with self.relay_lock:
            self.last_full_model_round = -1
            self.last_relayed_round = -1
            self.model_round_origin = 0
        self.votes_ready_event.clear()
        self.aggregated_model_event.clear()
        self.wire_bases.clear()
        self.delta_nack_peers = set()

    def clear(self) -> None:
        """Reset to idle (reference node_state.py:125-127). Event
        *objects* are preserved (only cleared): stage threads blocked on
        them must keep waiting on the same object a stop/command will
        set."""
        self.status = "Idle"
        self.experiment = None
        self.prepare_experiment()
        with self.nei_status_lock:
            self.nei_status = {}
        self.model_initialized_event.clear()
        self.quarantine.reset()
        self.async_controller.reset()

    def __repr__(self) -> str:
        return (
            f"NodeState(addr={self.addr}, status={self.status}, "
            f"round={self.round}, train_set={self.train_set})"
        )
