"""Application protocol verbs (commands) — a copy of
:mod:`tpfl.communication.commands`, with the asynchronous-round intake of
``partial_model`` (``Settings.ASYNC_ROUNDS``).

Parity with reference ``p2pfl/communication/commands/`` — the 11 verbs
dispatched by the transport's server into node internals
(``command.py:24-43`` ABC; registration ``node.py:122-134``).

Heartbeat is transport-internal here (the protocol registers its own
``beat`` handler), so this module defines the remaining verbs. Each
command binds to the node facade at construction and mutates
``NodeState`` / ``Aggregator`` / ``Learner`` exactly at the reference's
synchronization points.
"""

from __future__ import annotations

import queue
import threading
from abc import ABC, abstractmethod
from typing import Any, Callable, Optional, TYPE_CHECKING

from tpfl_torch.management import tracing
from tpfl_torch.management.logger import logger

if TYPE_CHECKING:
    from tpfl_torch.node import Node


class _DaemonPool:
    """Shared bounded pool for epidemic FullModel relays (all
    in-process nodes): each relay is short-lived (a handful of
    verbatim re-sends), so a few workers drain the whole diffusion
    wave without the thread-per-adoption burst. DAEMON workers — not
    ThreadPoolExecutor, whose non-daemon threads are joined at
    interpreter exit: relays are best-effort, and a queued diffusion
    backlog must never block process shutdown."""

    def __init__(self, workers: int = 8) -> None:
        self._q: "queue.SimpleQueue[Callable[[], None]]" = queue.SimpleQueue()
        for i in range(workers):
            threading.Thread(
                target=self._run, daemon=True, name=f"tpfl-relay-{i}"
            ).start()

    def _run(self) -> None:
        while True:
            job = self._q.get()
            try:
                job()
            except Exception:  # best-effort; jobs log their own errors
                pass

    def submit(self, job: Callable[[], None]) -> None:
        self._q.put(job)


_relay_pool_lock = threading.Lock()
_relay_pool_inst: Optional[_DaemonPool] = None


def _relay_pool() -> _DaemonPool:
    global _relay_pool_inst
    with _relay_pool_lock:
        if _relay_pool_inst is None:
            _relay_pool_inst = _DaemonPool(workers=8)
        return _relay_pool_inst


class Command(ABC):
    """Verb ABC (reference command.py:24-43)."""

    name: str = "unnamed"

    @classmethod
    def get_name(cls) -> str:
        return cls.name

    @abstractmethod
    def execute(self, source: str, round: int, **kwargs: Any) -> None: ...


class NodeCommand(Command):
    def __init__(self, node: "Node") -> None:
        self.node = node

    @property
    def state(self):
        return self.node.state


class StartLearningCommand(NodeCommand):
    """Peer asks us to join an experiment (reference
    start_learning_command.py:26-58): spawn the learning thread with the
    broadcast (rounds, epochs)."""

    name = "start_learning"

    def execute(self, source: str, round: int, args: list[str], **kwargs: Any) -> None:
        rounds, epochs = int(args[0]), int(args[1])
        exp_name = args[2] if len(args) > 2 else "experiment"
        beacon = args[3] if len(args) > 3 else ""
        self.node.start_learning_thread(rounds, epochs, exp_name, beacon=beacon)


class StopLearningCommand(NodeCommand):
    """Abort the experiment (reference stop_learning_command.py:30)."""

    name = "stop_learning"

    def execute(self, source: str, round: int, **kwargs: Any) -> None:
        self.node.stop_learning()


class ModelInitializedCommand(NodeCommand):
    """Peer announces its model is initialized (reference
    model_initialized_command.py:25): nei_status[source] = -1."""

    name = "model_initialized"

    def execute(self, source: str, round: int, **kwargs: Any) -> None:
        self.state.set_nei_status(source, -1)


class InitModelRequestCommand(NodeCommand):
    """Pull path for init weights (tpfl addition, no reference
    analog): a node stuck waiting for the initial model asks its direct
    neighbors. Push-only diffusion (InitModelCommand gossip) provably
    strands stragglers at scale — a 500-node StartLearning flood takes
    tens of seconds to spread, and any hub whose init-gossip quiet
    window expired first never pushes again. The requester re-asks
    every few seconds, so convergence no longer depends on start-time
    skew."""

    name = "init_model_request"

    def execute(
        self, source: str, round: int, args: list[str], **kwargs: Any
    ) -> None:
        st = self.state
        # Serve only for the requester's OWN experiment (args[0]): while
        # we are learning it, or after we FINISHED it (state cleared,
        # but the final model is exactly what a straggler needs — its
        # hub finishing first must not strand it). Without the name
        # check, a node learning a DIFFERENT experiment would hand the
        # straggler foreign weights.
        same_exp = bool(
            args
            and self.node.exp_name is not None
            and args[0] == self.node.exp_name
        )
        live = (
            same_exp
            and st.model_initialized_event.is_set()
            and st.status == "Learning"
        )
        # "Finished" requires positive completion evidence, not merely
        # status != Learning: exp_name is assigned in
        # start_learning_thread BEFORE the stage flips status, so a node
        # hit in that window — or one whose run aborted before init —
        # would otherwise serve its local randomly-seeded weights and
        # silently break the requester's common-init assumption.
        finished_same_exp = (
            same_exp
            and st.status != "Learning"
            and getattr(self.node, "completed_experiment", None)
            == self.node.exp_name
        )
        if not (live or finished_same_exp):
            return  # nothing to serve
        try:
            payload = self.node.communication.model_payload(
                self.node.learner.get_model()
            )
        except Exception as e:
            logger.debug(st.addr, f"init request from {source} failed: {e}")
            return
        self.node.communication.send(
            source,
            self.node.communication.build_weights(
                InitModelCommand.name,
                st.round if st.round is not None else 0,
                payload,
            ),
        )


class VoteTrainSetCommand(NodeCommand):
    """Train-set vote intake (reference vote_train_set_command.py:28):
    args are flattened (candidate, weight) pairs; accept current or next
    round (validation may arrive before our round increments)."""

    name = "vote_train_set"

    def execute(self, source: str, round: int, args: list[str], **kwargs: Any) -> None:
        st = self.state
        if st.round is None or round not in (st.round, st.round + 1):
            logger.debug(
                st.addr,
                f"Vote from {source} for round {round} dropped (at {st.round})",
            )
            return
        votes = dict(zip(args[::2], (int(w) for w in args[1::2])))
        with st.train_set_votes_lock:
            st.train_set_votes[source] = (round, votes)
        st.votes_ready_event.set()


class ModelsAggregatedCommand(NodeCommand):
    """Peer reports which contributors its aggregation covers
    (reference models_agregated_command.py:26)."""

    name = "models_aggregated"

    def execute(self, source: str, round: int, args: list[str], **kwargs: Any) -> None:
        if round != self.state.round:
            return
        self.state.set_models_aggregated(source, list(args))


def send_models_aggregated(node: Any, covered: list[str]) -> None:
    """Coverage announcements go DIRECTLY to train-set peers — the only
    consumers (partial-push targeting and except-set computation). The
    reference TTL-floods them to the whole network
    (train_stage.py:119-176); at 1000 nodes that flood lags the direct
    partial exchange by minutes, so senders compute except-sets from
    stale coverage, peers drop the overlapping partials
    (aggregator.add_model's double-count guard), and the trainers
    fracture into different partial subsets — seen as every
    trainer "proceeding without" a DIFFERENT peer that in fact trained
    and gossiped. Direct sends keep coverage knowledge as fresh as the
    payloads it steers. Shared by TrainStage (own fit) and
    PartialModelCommand (intake)."""
    st = node.state
    msg = node.communication.build_msg(
        ModelsAggregatedCommand.name, covered, round=st.round
    )
    for nei in st.train_set:
        if nei != st.addr:
            node.communication.send(nei, msg, create_connection=True)


class ModelsReadyCommand(NodeCommand):
    """Peer finished its round (reference models_ready_command.py:26):
    accept round-1 or round; nei_status[source] = round."""

    name = "models_ready"

    def execute(self, source: str, round: int, **kwargs: Any) -> None:
        st = self.state
        if st.round is None or round not in (st.round - 1, st.round):
            logger.debug(
                st.addr,
                f"ModelsReady from {source} round {round} dropped (at {st.round})",
            )
            return
        st.set_nei_status(source, round)


class MetricsCommand(NodeCommand):
    """Gossiped eval metrics (reference metrics_command.py:26): args are
    flattened (name, value) pairs."""

    name = "metrics"

    def execute(self, source: str, round: int, args: list[str], **kwargs: Any) -> None:
        for name, value in zip(args[::2], args[1::2]):
            logger.log_metric(source, name, float(value), round=round)


class InitModelCommand(NodeCommand):
    """Initial weights arrive (reference init_model_command.py:31,46-97):
    only accepted while uninitialized; sets the init event."""

    name = "init_model"

    def execute(
        self,
        source: str,
        round: int,
        weights: bytes,
        contributors: list[str],
        num_samples: int,
        **kwargs: Any,
    ) -> None:
        st = self.state
        if st.model_initialized_event.is_set():
            logger.debug(st.addr, f"InitModel from {source} ignored (already init)")
            # Anti-entropy repair: a redundant push means the sender
            # never saw our one-shot ModelInitialized broadcast (lost
            # on a lossy link). Re-announce directly to it, or its
            # init gossip keeps pushing at us until its whole static
            # window (INIT_GOSSIP_STATIC_EXIT_S) expires.
            try:
                self.node.communication.send(
                    source,
                    self.node.communication.build_msg(
                        ModelInitializedCommand.name
                    ),
                )
            except Exception as e:
                logger.debug(st.addr, f"Re-announce to {source} failed: {e}")
            return
        if st.status != "Learning":
            # Reference parity (init_model_command.py:46-97: weights are
            # taken only while the init lock is held): an IDLE node —
            # e.g. a late joiner that missed this experiment's
            # StartLearning — must not adopt stray init weights, or its
            # init event stays set and the NEXT experiment skips the
            # init wait and trains from stale weights. A node whose
            # learning thread hasn't reached the stage yet simply drops
            # this push; the sender's init gossip re-pushes every
            # period until we announce.
            logger.debug(
                st.addr, f"InitModel from {source} ignored (not learning)"
            )
            return
        try:
            with tracing.maybe_span(
                "decode", st.addr, trace=kwargs.get("trace", ""),
                cmd=self.name, peer=source,
            ):
                self.node.learner.set_model(weights)
        except Exception as e:
            logger.error(st.addr, f"InitModel decode failed: {e}")
            return
        st.model_initialized_event.set()
        logger.info(st.addr, f"Model initialized from {source}")
        # Announce so peers stop gossiping init weights at us.
        self.node.communication.broadcast(
            self.node.communication.build_msg(ModelInitializedCommand.name)
        )


class PartialModelCommand(NodeCommand):
    """Partial aggregate from a train-set peer (reference
    partial_model_command.py:33,56-113): add to aggregator, then
    re-announce our coverage."""

    name = "partial_model"

    def execute(
        self,
        source: str,
        round: int,
        weights: bytes,
        contributors: list[str],
        num_samples: int,
        **kwargs: Any,
    ) -> None:
        st = self.state
        if st.round is None:
            return
        from tpfl_torch.settings import Settings as _S

        if _S.ASYNC_ROUNDS:
            # Async buffered rounds: the sender's round number is its own
            # cadence; the model-version ordinal it trained from
            # (``version`` on the envelope) sets the staleness against
            # whatever round is forming here.
            self._execute_async(source, weights, contributors, num_samples, kwargs)
            return
        if round == st.round + 1:
            # Fast peer already in the next round: hold the model until
            # our TrainStage opens that round (drained there), instead
            # of dropping it and stalling the late trainer for the full
            # aggregation timeout.
            st.stash_pending_partial(
                (source, round, weights, contributors, num_samples,
                 int(kwargs.get("version", -1)), kwargs.get("trace", "")),
                round,
            )
            # Close the stash/drain race: if our round advanced (and its
            # aggregation opened) while we were stashing, TrainStage's
            # drain may have already run — replay now. drain is
            # pop-once, so a concurrent drain can't double-deliver.
            if st.round == round and self.node.aggregator.is_open():
                for args in st.drain_pending_partials(round):
                    self.execute(
                        args[0],
                        args[1],
                        weights=args[2],
                        contributors=args[3],
                        num_samples=args[4],
                        version=args[5],
                        trace=args[6],
                    )
            return
        if round != st.round:
            logger.debug(
                st.addr,
                f"PartialModel from {source} round {round} dropped (at {st.round})",
            )
            return
        if not st.train_set:
            logger.debug(st.addr, f"PartialModel from {source} dropped (no train set)")
            return
        trace = kwargs.get("trace", "")
        try:
            with tracing.maybe_span(
                "decode", st.addr, trace=trace, cmd=self.name, peer=source,
            ):
                model = self.node.learner.get_model().build_copy(params=weights)
        except Exception as e:
            logger.error(st.addr, f"PartialModel decode failed: {e}")
            return
        with tracing.maybe_span(
            "fold", st.addr, trace=trace, peer=source,
        ) as fold_span:
            covered = self.node.aggregator.add_model(model, trace=trace)
            fold_span.set(covered=len(covered))
        if covered:
            st.set_models_aggregated(st.addr, covered)
            send_models_aggregated(self.node, covered)

    def _execute_async(self, source: str, weights: bytes, contributors: list[str],
                       num_samples: int, kwargs: dict) -> None:
        """Async-round intake: fold into whatever round is forming. A
        contribution arriving between rounds (buffer just closed) is
        stashed and replayed when ``AsyncRoundStage`` opens the next one;
        the serialized discipline holds it in the aggregator's reorder
        buffer instead."""
        st = self.state
        trace = kwargs.get("trace", "")
        raw_version = int(kwargs.get("version", -1))
        start_version = None if raw_version < 0 else raw_version
        agg = self.node.aggregator
        try:
            with tracing.maybe_span(
                "decode", st.addr, trace=trace, cmd=self.name, peer=source,
            ):
                model = self.node.learner.get_model().build_copy(params=weights)
        except Exception as e:
            logger.error(st.addr, f"PartialModel decode failed: {e}")
            return
        with tracing.maybe_span(
            "fold", st.addr, trace=trace, peer=source,
        ) as fold_span:
            covered = agg.add_model(model, trace=trace, start_version=start_version)
            fold_span.set(covered=len(covered))
        if (not covered and not agg.is_open() and st.round is not None
                and not agg.reorders(contributors)):
            # Between rounds with no reorder buffer to hold it: stash for
            # the round this node opens next rather than waste a finished
            # fit. That is st.round itself once RoundFinishedStage has
            # advanced it (or before the first round opens): the JAX
            # package stashes for st.round + 1 there, so the contribution
            # misses that round, which then waits for its deadline
            # (ROADMAP.md §3).
            opened = agg.is_async() and agg.round_ordinal() == st.round
            nxt = st.round + 1 if opened else st.round
            st.stash_pending_partial(
                (source, nxt, weights, contributors, num_samples, raw_version, trace), nxt)
            # Close the stash/drain race: if that round opened (and
            # AsyncRoundStage drained) while we were stashing, replay now;
            # drain is pop-once, so nothing is delivered twice.
            if agg.is_open() and agg.round_ordinal() == nxt:
                for args in st.drain_pending_partials(nxt):
                    self._execute_async(args[0], args[2], args[3], args[4],
                                        {"version": args[5], "trace": args[6]})


class CodecNackCommand(NodeCommand):
    """Receiver could not decode our residual (delta) payload — it does
    not hold the base round (or holds it with a different fingerprint).
    Mark the peer so GossipModelStage sends it dense from now on; the
    set resets with the experiment (NodeState.prepare_experiment). This
    is the negotiation half of the codec-id byte: a peer that cannot
    decode a codec tells us, instead of silently dropping payloads
    forever."""

    name = "codec_nack"

    def execute(self, source: str, round: int, **kwargs: Any) -> None:
        self.state.delta_nack_peers.add(source)
        logger.debug(
            self.state.addr,
            f"{source} nacked a delta payload (round {round}); "
            f"falling back to dense for it",
        )


class FullModelCommand(NodeCommand):
    """Aggregated round result arrives (reference
    full_model_command.py:31,46-89): set it and release the wait
    stage.

    Epidemic relay (tpfl addition): on FIRST adoption of a round's
    aggregate, re-send the received payload to direct neighbors whose
    known status lags the round. The reference diffuses the full model
    only while a node sits in GossipModelStage; at scale (at
    1000 single-core nodes) most nodes have long exited that stage —
    or timed out of WaitAggregatedModels — before the wave reaches
    their hub, so diffusion crawls at the stage-timeout cadence.
    Relay-on-receive makes the wave O(topology diameter) hops,
    independent of stage timing. At most one relay per (node, round);
    the payload bytes are forwarded verbatim (no re-encode)."""

    name = "full_model"

    def execute(
        self,
        source: str,
        round: int,
        weights: bytes,
        contributors: list[str],
        num_samples: int,
        **kwargs: Any,
    ) -> None:
        from tpfl_torch.exceptions import DeltaBaseMismatchError
        from tpfl_torch.learning import compression

        st = self.state
        if st.round is None:
            return
        if round < st.round:
            return
        try:
            with tracing.maybe_span(
                "decode", st.addr, trace=kwargs.get("trace", ""),
                cmd=self.name, peer=source,
            ):
                self.node.learner.set_model(weights)
        except DeltaBaseMismatchError as e:
            # Recoverable codec negotiation: tell the sender we lack the
            # base; it re-sends dense (Settings.WIRE_DELTA docs).
            logger.debug(st.addr, f"FullModel delta refused: {e}")
            try:
                self.node.communication.send(
                    source,
                    self.node.communication.build_msg(
                        CodecNackCommand.name, [], round=round, ttl=1
                    ),
                    create_connection=True,
                )
            except Exception:
                pass  # best-effort; the sender's push loop retries anyway
            return
        except Exception as e:
            logger.error(st.addr, f"FullModel decode failed: {e}")
            return
        # The adopted aggregate becomes the delta-gossip base for the
        # NEXT round's pushes (and for decoding residuals sent to us).
        try:
            st.wire_bases.put(
                round, self.node.learner.get_model().get_parameters()
            )
        except Exception as e:
            logger.debug(st.addr, f"Base registration failed: {e}")
        # At-most-once per (node, round), atomically — concurrent
        # deliveries of the same round from two peers (gRPC runs
        # handlers on a thread pool) must not both fan out. The
        # version bump shares the lock: an unsynchronized += from two
        # handlers can lose a bump, leaving GossipModelStage's
        # bytes-cache key pointing at a superseded payload.
        with st.relay_lock:
            st.model_version += 1
            st.last_full_model_round = max(st.last_full_model_round, round)
            # Version-origin bookkeeping (async staleness tags): round
            # r's aggregate IS model-version ordinal r+1 (init = 0).
            st.model_round_origin = max(st.model_round_origin, round + 1)
            do_relay = round > st.last_relayed_round
            if do_relay:
                st.last_relayed_round = round
        st.aggregated_model_event.set()
        if do_relay:
            # Relay OFF the handler thread: the in-memory transport
            # dispatches handlers synchronously in the sender's stack,
            # so an inline relay would recurse one level per hop (a
            # LINE/RING wave overflows the interpreter's recursion
            # limit), and on gRPC it would hold a server worker through
            # many large sends. Relays share one BOUNDED pool: a fresh
            # thread per adoption was a ~N-thread burst per round in
            # the N-node in-process simulation (GIL pressure during
            # the diffusion wave on a single-core host).
            node = self.node

            def _relay() -> None:
                try:
                    status = st.get_nei_status()
                    lagging = [
                        n
                        for n in node.communication.get_neighbors(
                            only_direct=True
                        )
                        if n != source and status.get(n, -1) < round
                    ]
                    if not lagging:
                        return
                    relay_bytes = weights
                    if compression.payload_is_delta(weights):
                        # A residual payload only decodes against a base
                        # WE held — a lagging neighbor (the relay's
                        # whole audience) usually doesn't. Re-encode the
                        # just-adopted full model through the configured
                        # codec (no delta) instead of forwarding bytes
                        # it will have to nack. (By-reference payloads
                        # are never delta — payload_is_delta is False —
                        # so zero-copy relays forward the ref verbatim.)
                        relay_bytes = node.communication.model_payload(
                            node.learner.get_model()
                        )
                    payload = node.communication.build_weights(
                        FullModelCommand.name,
                        round,
                        relay_bytes,
                        contributors=contributors,
                        num_samples=num_samples,
                    )
                    for nei in lagging:
                        node.communication.send(nei, payload)
                    logger.debug(
                        st.addr,
                        f"Relayed round-{round} model to {len(lagging)} "
                        f"lagging neighbors",
                    )
                except Exception as e:  # relay is best-effort
                    logger.debug(st.addr, f"FullModel relay failed: {e}")

            _relay_pool().submit(_relay)
        if not st.model_initialized_event.is_set():
            # A round's aggregate is an authoritative model for this
            # experiment: a straggler still blocked waiting for init
            # weights (start-flood skew at scale) initializes from it
            # and re-announces, instead of idling the experiment away.
            st.model_initialized_event.set()
            self.node.communication.broadcast(
                self.node.communication.build_msg(ModelInitializedCommand.name)
            )


ALL_COMMANDS = [
    StartLearningCommand,
    StopLearningCommand,
    ModelInitializedCommand,
    InitModelRequestCommand,
    VoteTrainSetCommand,
    ModelsAggregatedCommand,
    ModelsReadyCommand,
    MetricsCommand,
    InitModelCommand,
    PartialModelCommand,
    FullModelCommand,
    CodecNackCommand,
]
