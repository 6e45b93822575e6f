"""The six FL round stages — a copy of :mod:`tpfl.stages.base_node`
(reference ``p2pfl/stages/base_node/``) without ``AsyncRoundStage`` (the
asynchronous buffered rounds, ``ROADMAP.md`` §1 item 3) and without the
residual (``Settings.WIRE_DELTA``) gossip, which ``Node`` refuses when an
experiment starts.

Synchronization-point differences from
the reference (each fixes a reference wart without changing semantics):

- the aggregated-model handoff is tracked as ``state.last_full_model_round``
  compared against the current round instead of a bare event cleared at
  stage entry (the reference can lose a FullModel that arrives before
  ``WaitAggregatedModelsStage`` clears the event, wait_agg_models_stage.py:47-50);
- vote weights and gossip peer sampling derive from seeded RNGs for
  reproducible simulations.

The election is timed as the round profiler's ``vote`` component (an
addition of the port; the reference leaves it in the residual).
"""

from __future__ import annotations

import time
from typing import TYPE_CHECKING, Callable, Optional, Type

from tpfl_torch.communication.commands import (
    FullModelCommand,
    InitModelCommand,
    MetricsCommand,
    ModelsAggregatedCommand,
    ModelsReadyCommand,
    PartialModelCommand,
    VoteTrainSetCommand,
    send_models_aggregated,
)
from tpfl_torch.exceptions import ASYNC_ITEM, not_ported
from tpfl_torch.experiment import Experiment
from tpfl_torch.learning.aggregators.aggregator import NoModelsToAggregateError
from tpfl_torch.management import ledger, profiling, tracing
from tpfl_torch.management.logger import logger
from tpfl_torch.settings import Settings
from tpfl_torch.stages.stage import Stage, check_early_stop

if TYPE_CHECKING:
    from tpfl_torch.node import Node


def election_rank(exp_name, beacon: str, round, addr: str) -> str:
    """Hash-election sort key (Settings.ELECTION == "hash"): rank by
    H(exp | beacon | round | addr), lowest first. The beacon is the
    per-experiment shared random value from the StartLearning
    broadcast (hash of the initiator's init-model bytes): without it a
    participant could grind an address that ranks top-K for every
    round of a predictable exp_name; with it, grinding requires
    choosing the address AFTER the experiment — and its beacon —
    exist (see settings.py ELECTION docs for the remaining
    pre-commitment assumption)."""
    import hashlib

    return hashlib.sha256(
        f"{exp_name}|{beacon}|{round}|{addr}".encode()
    ).hexdigest()


class StartLearningStage(Stage):
    """Reference start_learning_stage.py:35-112."""

    name = "StartLearningStage"

    @staticmethod
    def execute(node: "Node") -> Optional[Type[Stage]]:
        st = node.state
        st.set_experiment(Experiment(node.exp_name, node.rounds))
        logger.experiment_started(node.addr, st.experiment)
        node.learner.set_epochs(node.epochs)
        # Any run can produce a device trace: when the experiment
        # carries a profile dir (Settings.PROFILING_TRACE_DIR), wrap it
        # in a process-wide torch.profiler trace (idempotent — in-process
        # peers share one profiler; stopped at experiment finish or
        # Node.stop).
        if st.experiment.profile_dir:
            profiling.start_trace(st.experiment.profile_dir)

        # Wait for weights: released locally by set_start_learning (the
        # initiator), by an incoming InitModelCommand push, or by the
        # reply to our periodic pull (InitModelRequestCommand) — the
        # pull is what makes init robust to start-time skew at scale.
        from tpfl_torch.communication.commands import InitModelRequestCommand

        ticks = 0  # integer tick count — a float accumulator drifts
        while not st.model_initialized_event.wait(timeout=0.1):
            if check_early_stop(node):
                return None
            ticks += 1
            if ticks % 50 == 0:  # every ~5 s
                node.communication.broadcast(
                    node.communication.build_msg(
                        InitModelRequestCommand.name,
                        # exp name: lets a neighbor that already
                        # FINISHED this experiment serve us its final
                        # model instead of leaving us stranded.
                        [str(node.exp_name)],
                        ttl=1,
                    )
                )
            if ticks % 300 == 0:  # every ~30 s
                logger.warning(
                    node.addr,
                    f"Still waiting for initial model after ~{ticks / 10:.0f}s",
                )

        # Diffuse initial weights to direct neighbors that have not
        # announced a model yet (reference :81-112).
        def candidates() -> list[str]:
            # Snapshot (get_nei_status): command handlers insert
            # concurrently, and a bare membership scan during insert is
            # the race the guarded-by lint flags.
            status = st.get_nei_status()
            return [
                n
                for n in node.communication.get_neighbors(only_direct=True)
                if n not in status
            ]

        # Encode once: params are fixed during init diffusion, and at a
        # tree hub re-encoding per push is the dominant cost. On a
        # zero-copy in-process transport this is a by-reference handoff
        # (no encode at all — communication.model_payload).
        init_payload = node.communication.model_payload(node.learner.get_model())
        node.communication.gossip_weights(
            early_stopping_fn=lambda: check_early_stop(node),
            get_candidates_fn=candidates,
            status_fn=lambda: sorted(st.get_nei_status()),
            model_fn=lambda nei: node.communication.build_weights(
                InitModelCommand.name,
                st.round if st.round is not None else 0,
                init_payload,
            ),
            # Time-based static exit instead of the default iteration
            # count: on sparse topologies (TREE) a leaf has exactly one
            # supplier, and at 500-node scale the StartLearning flood
            # takes tens of seconds to reach stragglers — a hub whose
            # init gossip gives up after a few quiet iterations (2.5 s
            # under the scale profile) strands every late starter
            # behind it. A generous wall-clock window still terminates
            # against a live-but-idle neighbor (one that will never
            # announce because it isn't in this experiment).
            exit_on_static=max(
                1,
                int(
                    Settings.INIT_GOSSIP_STATIC_EXIT_S
                    / max(Settings.GOSSIP_MODELS_PERIOD, 0.01)
                ),
            ),
        )
        time.sleep(Settings.WAIT_HEARTBEATS_CONVERGENCE)
        if Settings.ASYNC_ROUNDS:
            raise not_ported("AsyncRoundStage (Settings.ASYNC_ROUNDS)", ASYNC_ITEM)
        return VoteTrainSetStage


class VoteTrainSetStage(Stage):
    """Reference vote_train_set_stage.py:34-184."""

    name = "VoteTrainSetStage"

    @staticmethod
    def execute(node: "Node") -> Optional[Type[Stage]]:
        st = node.state
        if check_early_stop(node):
            return None
        # Round-attribution window opens here (the first stage every
        # participant — trainer or waiter — enters each round) and
        # closes in RoundFinishedStage.
        profiling.rounds.begin_round(node.addr, st.round)
        with profiling.rounds.span(node.addr, "vote"):
            train_set = VoteTrainSetStage._elect(node)
        if train_set is None:
            return None
        st.train_set = train_set
        if check_early_stop(node):
            return None
        return TrainStage if node.addr in st.train_set else WaitAggregatedModelsStage

    @staticmethod
    def _elect(node: "Node") -> Optional[list[str]]:
        """The round's train set, or None on an early stop."""
        st = node.state
        candidates = list(node.communication.get_neighbors()) + [node.addr]

        if Settings.ELECTION == "hash":
            # Deterministic sortition (Settings.ELECTION docs): rank by
            # H(exp|beacon|round|addr), top-K — no messages, no vote
            # wait; agreement follows from membership-view agreement
            # (the beacon rides the StartLearning broadcast, so every
            # participant has it). The aggregator still tolerates view
            # divergence exactly as it tolerates missing votes under
            # the vote protocol.
            beacon = getattr(node, "beacon", "")
            ranked = sorted(
                set(candidates),
                key=lambda a: election_rank(st.exp_name, beacon, st.round, a),
            )
            train_set = ranked[: Settings.TRAIN_SET_SIZE]
            logger.info(node.addr, f"Train set (hash): {train_set}")
            return train_set

        # Cast my vote: sample ≤ TRAIN_SET_SIZE candidates with random
        # weights (reference :79-107), seeded per node for determinism.
        sample = node.rng.sample(
            candidates, min(Settings.TRAIN_SET_SIZE, len(candidates))
        )
        weights = [node.rng.randint(0, 1000) for _ in sample]
        my_votes = dict(zip(sample, weights))
        with st.train_set_votes_lock:
            st.train_set_votes[node.addr] = (st.round or 0, my_votes)
        flat: list[str] = []
        for c, w in my_votes.items():
            flat += [c, str(w)]
        node.communication.broadcast(
            node.communication.build_msg(
                VoteTrainSetCommand.name, flat, round=st.round
            )
        )

        # Tally once all live candidates voted or VOTE_TIMEOUT
        # (reference :109-171). Monotonic clock, like every round
        # deadline: an NTP step mid-vote must not stretch or collapse
        # the window (the aggregator's stall clock moved first;
        # mixing clocks made a skewed host tally while still waiting
        # on the other).
        deadline = time.monotonic() + Settings.VOTE_TIMEOUT
        while time.monotonic() < deadline:
            if check_early_stop(node):
                return None
            with st.train_set_votes_lock:
                voters = {
                    src
                    for src, (rnd, _) in st.train_set_votes.items()
                    if rnd == st.round
                }
            alive = set(node.communication.get_neighbors()) | {node.addr}
            if alive - voters == set():
                break
            st.votes_ready_event.wait(timeout=0.1)
            st.votes_ready_event.clear()
        else:
            logger.warning(node.addr, "Vote timeout; tallying what arrived")

        with st.train_set_votes_lock:
            all_votes = [
                dict(votes)
                for (rnd, votes) in st.train_set_votes.values()
                if rnd == st.round
            ]
        tally: dict[str, int] = {}
        for votes in all_votes:
            for cand, w in votes.items():
                tally[cand] = tally.get(cand, 0) + int(w)
        ranked = sorted(tally.items(), key=lambda kv: (-kv[1], kv[0]))
        train_set = [c for c, _ in ranked[: Settings.TRAIN_SET_SIZE]]

        # Drop dead candidates (reference :173-184).
        alive = set(node.communication.get_neighbors()) | {node.addr}
        train_set = [c for c in train_set if c in alive]
        logger.info(node.addr, f"Train set: {train_set}")
        return train_set


def _await_round_result(
    node: "Node", deadline: float, done_fn: "Optional[Callable[[], bool]]" = None
) -> str:
    """Shared round-result wait (TrainStage + WaitAggregatedModelsStage):
    poll until the round's full model arrives (``"full_model"``), an
    optional extra condition holds (``"done"`` — e.g. local aggregation
    coverage), early stop (``"early_stop"``), or ``deadline``
    (``"timeout"``). ``deadline`` is a ``time.monotonic()`` instant —
    wall-clock steps must not stretch or collapse round waits.
    FullModelCommand sets ``aggregated_model_event``."""
    st = node.state
    while time.monotonic() < deadline:
        if check_early_stop(node):
            return "early_stop"
        if st.round is not None and st.last_full_model_round >= st.round:
            return "full_model"
        if done_fn is not None and done_fn():
            return "done"
        # The event wakes this immediately on FullModel arrival; the
        # timeout only bounds early-stop/done_fn detection latency
        # (Settings.ROUND_WAIT_POLL: 0.5 s default, 2.0 s in the scale
        # profile — at 1000 in-process nodes, ~990 fast-polling
        # waiters are a GIL tax on the very trainers forming the
        # aggregate they wait for).
        st.aggregated_model_event.wait(timeout=Settings.ROUND_WAIT_POLL)
        st.aggregated_model_event.clear()
    return "timeout"


class TrainStage(Stage):
    """Reference train_stage.py:35-176."""

    name = "TrainStage"

    @staticmethod
    def execute(node: "Node") -> Optional[Type[Stage]]:
        st = node.state
        node.aggregator.set_nodes_to_aggregate(st.train_set)
        # Learning-plane ledger: pin this round's ordinal and the
        # round-start global parameters — the reference every accepted
        # contribution's update stats are measured against (the model
        # here is the adopted previous aggregate / init weights; the
        # fit below trains on a copy, so the reference stays intact).
        # The active defense (QUARANTINE_ENABLED) scores its verdicts
        # against the same reference, so it opens the round too even
        # when the observational ledger knob is off.
        if ledger.active():
            ledger.contrib.open_round(
                node.addr, st.round,
                node.learner.get_model().get_parameters(),
            )

        # Replay partial models that arrived before this round opened
        # (stashed by PartialModelCommand; see NodeState.pending_partials).
        for args in st.drain_pending_partials(st.round):
            source, rnd, weights, contributors, num_samples, version = args
            PartialModelCommand(node).execute(
                source,
                rnd,
                weights=weights,
                contributors=contributors,
                num_samples=num_samples,
                version=version,
            )

        TrainStage._evaluate(node)
        if check_early_stop(node):
            node.aggregator.clear()
            return None

        logger.info(node.addr, f"Training (round {st.round})")
        # All train-set peers fit around now; the simulation pool can
        # batch the in-process members into one vmapped program.
        node.learner.set_fit_group_hint(list(st.train_set))
        # Use fit()'s returned model, NOT learner.get_model(): a slow
        # trainer can be lapped — peers finish the round without us and
        # their GossipModelStage replaces our learner's model with the
        # aggregated full model (contributors = whole train set, no
        # per-client callback info) mid-fit, which must never enter our
        # own aggregator.
        with tracing.maybe_span(
            "train_fit", node.addr,
            round=st.round if st.round is not None else -1,
        ):
            fitted = node.learner.fit()
        if check_early_stop(node):
            node.aggregator.clear()
            return None

        covered = node.aggregator.add_model(fitted)
        st.set_models_aggregated(node.addr, covered)
        # Directly to train-set peers, not a network-wide flood (see
        # the helper's docstring for the measured fracture this fixes).
        send_models_aggregated(node, covered)

        # Gossip partial aggregates to train-set peers still missing
        # contributors (reference :119-176; create_connection=True fully
        # connects the train set). Coverage targets are computed over
        # the LIVE view of the train set: a member the heartbeater has
        # evicted mid-round can neither report coverage nor receive
        # pushes, and chasing it would pin the exchange until the
        # static-status exit every time a trainer crashes. With no
        # faults the live view IS the train set (identical behavior).

        def live_train_set() -> set[str]:
            alive = set(node.communication.get_neighbors()) | {node.addr}
            return {n for n in st.train_set if n in alive}

        def early_stop() -> bool:
            if check_early_stop(node):
                return True
            # Every live member (including us) covers the live set.
            live = live_train_set()
            agg = st.get_models_aggregated()
            return all(set(agg.get(n, [])) >= live for n in live)

        def candidates() -> list[str]:
            agg = st.get_models_aggregated()
            live = live_train_set()
            return [
                n
                for n in live
                if n != node.addr and not set(agg.get(n, [])) >= live
            ]

        # Partial-aggregate encodes are cached per (aggregator state,
        # except-set): between aggregator changes the payload bytes are
        # identical, and re-running the partial aggregation +
        # device->host transfer + msgpack encode on EVERY push tick was
        # a formation bottleneck at 1000 single-core nodes
        # (the 10 trainers' exchange serialized behind per-tick encodes
        # while 990 peers shared the GIL).
        encode_cache: dict = {}

        def model_for(nei: str) -> Optional[object]:
            known = tuple(sorted(st.get_models_aggregated().get(nei, [])))
            key = (node.aggregator.version, known)
            hit = encode_cache.get(key)
            if hit is None:
                model = node.aggregator.get_model(except_nodes=list(known))
                if model is None:
                    hit = (None, None, 0)
                else:
                    hit = (
                        node.communication.model_payload(model),
                        model.get_contributors(),
                        model.get_num_samples(),
                    )
                if len(encode_cache) > 64:  # one round's worth, bounded
                    encode_cache.clear()
                encode_cache[key] = hit
            payload, contributors, num_samples = hit
            if payload is None:
                return None
            return node.communication.build_weights(
                PartialModelCommand.name,
                st.round,
                payload,
                contributors=contributors,
                num_samples=num_samples,
            )

        # "gossip" attribution: the partial-aggregate exchange and the
        # round-result wait below are wire/peer time, not compute.
        with profiling.rounds.span(node.addr, "gossip"):
            node.communication.gossip_weights(
                early_stopping_fn=early_stop,
                get_candidates_fn=candidates,
                status_fn=lambda: sorted(
                    (k, tuple(sorted(v)))
                    for k, v in st.get_models_aggregated().items()
                ),
                model_fn=model_for,
                create_connection=True,
            )
        if check_early_stop(node):
            node.aggregator.clear()
            return None

        # Wait for coverage, but notice being lapped: if the round's
        # full model already arrived (FullModelCommand sets
        # last_full_model_round), the round is decided — adopt it
        # instead of burning the whole aggregation timeout.
        deadline = time.monotonic() + Settings.AGGREGATION_TIMEOUT

        # Round degradation bookkeeping: first-seen-missing time per
        # train-set member. A member must stay OUT of the live view for
        # a full further HEARTBEAT_TIMEOUT beyond its eviction before
        # the round gives up on it — eviction alone is one stale-beat
        # observation, and a beat delayed by CPU contention (a peer's
        # long first step stalls its heartbeater) would otherwise shrink
        # the round on a node that is alive and about to contribute,
        # making fault-free results timing-dependent.
        dead_since: dict[str, float] = {}

        def confirmed_dead() -> list[str]:
            now = time.monotonic()
            live = live_train_set()
            for member in st.train_set:
                if member in live:
                    dead_since.pop(member, None)
                else:
                    dead_since.setdefault(member, now)
            return [
                m
                for m, t0 in dead_since.items()
                if now - t0 >= Settings.HEARTBEAT_TIMEOUT
            ]

        def coverage_done() -> bool:
            if not node.aggregator.is_open():
                return True
            # Round degradation: heartbeat loss evicted a train-set
            # member mid-round — shrink the expected contributor set to
            # the live members (Settings.ROUND_QUORUM then decides how
            # much of it must report). A crashed trainer no longer
            # costs every peer the full AGGREGATION_TIMEOUT.
            dead = confirmed_dead()
            if dead and node.aggregator.remove_dead_nodes(dead):
                return True
            # Stall exit (scale profile): intake has gone quiet with
            # contributions held — an elected peer is absent; proceed
            # with the partial aggregate now rather than burning the
            # full timeout (the gossip exchange already ran to static
            # before this wait, so a quiet aggregator means quiet
            # peers, not an in-flight exchange).
            stall = Settings.AGGREGATION_STALL
            return stall is not None and node.aggregator.stalled(stall)

        with profiling.rounds.span(node.addr, "gossip"):
            status = _await_round_result(node, deadline, done_fn=coverage_done)
        if status == "early_stop":
            node.aggregator.clear()
            return None
        if status == "full_model":
            logger.info(
                node.addr,
                "Lapped: round result arrived while training; adopting it",
            )
        else:
            try:
                # On a stall exit the event is unset and coverage will
                # not complete — waiting out the remaining deadline
                # would undo the early exit, so don't block again.
                remaining = (
                    0.0
                    if (status == "done" and node.aggregator.is_open())
                    else max(0.0, deadline - time.monotonic())
                )
                agg_model = node.aggregator.wait_and_get_aggregation(
                    timeout=remaining
                )
            except NoModelsToAggregateError:
                # Deliberate empty-round case: no result to diffuse.
                # Same honesty rule as the wait-stage timeout: do NOT
                # broadcast ModelsReady — we hold only round-start
                # weights, and the announcement would mark us finished
                # in every peer's nei_status, removing us as a
                # FullModel push/relay target while a real aggregate
                # may still exist elsewhere. (ModelsReady releases no
                # waiter anyway: _await_round_result returns only on
                # full-model arrival, done_fn, or timeout.) Routing
                # through GossipModelStage keeps us receptive during
                # the diffusion window; with no aggregate held it is a
                # pass-through (holds_aggregate() is False).
                logger.error(node.addr, "Nothing aggregated this round")
                return GossipModelStage
            except Exception as e:  # byzantine/malformed peer payloads
                logger.error(node.addr, f"Aggregation failed: {e}")
                return GossipModelStage
            # A timed-out partial aggregate must not shadow the round's
            # authoritative full model if one arrived while the (possibly
            # slow) aggregation math ran.
            if st.round is not None and st.last_full_model_round >= st.round:
                logger.info(
                    node.addr, "Round result arrived during aggregation; adopting it"
                )
            else:
                node.learner.set_model(agg_model)
                if st.round is not None:
                    # Watermark bump is a read-modify-write racing
                    # FullModelCommand's (gRPC handler pool): both
                    # serialize under relay_lock or a concurrent max()
                    # can regress the adopted round.
                    with st.relay_lock:
                        st.last_full_model_round = max(
                            st.last_full_model_round, st.round
                        )
                        st.model_round_origin = max(
                            st.model_round_origin, st.round + 1
                        )
        node.communication.broadcast(
            node.communication.build_msg(
                ModelsReadyCommand.name, [], round=st.round
            )
        )
        return GossipModelStage

    @staticmethod
    def _evaluate(node: "Node") -> None:
        """Eval + metric gossip (reference train_stage.py:102-117)."""
        metrics = node.learner.evaluate()
        if not metrics or not Settings.GOSSIP_METRICS:
            return
        flat: list[str] = []
        for k, v in metrics.items():
            flat += [k, str(v)]
        node.communication.broadcast(
            node.communication.build_msg(
                MetricsCommand.name, flat, round=node.state.round
            )
        )


class WaitAggregatedModelsStage(Stage):
    """Reference wait_agg_models_stage.py:31-67."""

    name = "WaitAggregatedModelsStage"

    @staticmethod
    def execute(node: "Node") -> Optional[Type[Stage]]:
        st = node.state
        deadline = time.monotonic() + Settings.AGGREGATION_TIMEOUT
        # Non-trainers spend their round waiting on the result to
        # arrive over gossip — attribute it as such.
        with profiling.rounds.span(node.addr, "gossip"):
            status = _await_round_result(node, deadline)
        if status == "early_stop":
            return None
        if status == "timeout":
            logger.warning(node.addr, "Aggregation wait timed out")
            # Do NOT advertise ModelsReady: we do not hold the round
            # result, and the announcement would mark us up to date in
            # every peer's nei_status — exactly the filter the
            # FullModel pushers AND the epidemic relay use to pick
            # targets. Staying silent keeps the aggregate flowing
            # toward us for as long as we remain in this round.
            # (The reference broadcasts regardless,
            # wait_agg_models_stage.py:58-63 — at scale that poisons
            # diffusion for every timed-out node.)
            return GossipModelStage
        node.communication.broadcast(
            node.communication.build_msg(
                ModelsReadyCommand.name, [], round=st.round
            )
        )
        return GossipModelStage


class GossipModelStage(Stage):
    """Full-model diffusion (reference gossip_model_stage.py:32-87)."""

    name = "GossipModelStage"

    @staticmethod
    def execute(node: "Node") -> Optional[Type[Stage]]:
        st = node.state

        def holds_aggregate() -> bool:
            # Only push a round result we actually HOLD: trainers set
            # the watermark when they aggregate, receivers when a
            # FullModelCommand lands. A node that TIMED OUT of the
            # aggregation wait reaches this stage with only its
            # round-start weights — pushing those as an authoritative
            # FullModel would overwrite real aggregates on peers (the
            # reference does exactly that, gossip_model_stage.py:55-66;
            # observed corrupting 1000-node single-core runs where most
            # nodes time out before the aggregate exists). Such a node
            # stays quiet; the epidemic relay still delivers the real
            # aggregate to it if one appears.
            return (
                st.round is not None
                and st.last_full_model_round >= st.round
            )

        def candidates() -> list[str]:
            if st.round is None or not holds_aggregate():
                return []
            status = st.get_nei_status()
            return [
                n
                for n in node.communication.get_neighbors(only_direct=True)
                if status.get(n, -1) < st.round
            ]

        # One encode per MODEL VERSION: per-push re-encodes
        # (device->host + msgpack each) would burn the GIL the
        # diffusion wave needs — same caching rule as TrainStage's
        # partial pushes and StartLearningStage's init payload. Keyed
        # on state.model_version, NOT once per stage entry: a node that
        # entered holding its timed-out PARTIAL aggregate can receive
        # the round's authoritative FullModel mid-push, and the stale
        # cached bytes must not keep flowing (peers accept same-round
        # FullModels unconditionally).
        fullmodel_cache: dict = {}

        def model_for(nei: str) -> Optional[object]:
            version = st.model_version
            hit = fullmodel_cache.get(version)
            if hit is None:
                model = node.learner.get_model()
                try:
                    contributors = model.get_contributors()
                except ValueError:
                    contributors = [node.addr]
                hit = (node.communication.model_payload(model), contributors,
                       model.get_num_samples())
                fullmodel_cache.clear()
                fullmodel_cache[version] = hit
            payload, contributors, num_samples = hit
            return node.communication.build_weights(
                FullModelCommand.name,
                st.round if st.round is not None else 0,
                payload,
                contributors=contributors,
                num_samples=num_samples,
            )

        with profiling.rounds.span(node.addr, "gossip"):
            node.communication.gossip_weights(
                early_stopping_fn=lambda: check_early_stop(node)
                or not candidates(),
                get_candidates_fn=candidates,
                status_fn=lambda: sorted(st.get_nei_status().items()),
                model_fn=model_for,
            )
        return RoundFinishedStage


class RoundFinishedStage(Stage):
    """Reference round_finished_stage.py:33-74."""

    name = "RoundFinishedStage"

    @staticmethod
    def execute(node: "Node") -> Optional[Type[Stage]]:
        st = node.state
        if check_early_stop(node):
            return None
        node.aggregator.clear()
        # Close the round-attribution window (opened at the vote
        # stage): components + residual land in the registry and the
        # flight ring before the round counter advances.
        profiling.rounds.end_round(node.addr, st.round)
        # Convergence monitor: every participant adopted the round
        # result by now — one fused delta-norm dispatch per round when
        # the ledger is on (divergence/plateau events + gauges).
        if Settings.LEDGER_ENABLED:
            ledger.convergence.observe_global(
                node.addr, st.round,
                node.learner.get_model().get_parameters(),
            )
        # Keep train_set_votes: next-round votes may already be in it
        # (round-tagged entries are filtered at tally time).
        st.votes_ready_event.clear()
        st.increase_round()
        tracing.event(
            "round_finished", node.addr,
            round=(st.round - 1) if st.round is not None else -1,
        )
        logger.round_finished(node.addr)
        logger.info(
            node.addr,
            f"Round {st.round - 1 if st.round else '?'} finished "
            f"({st.round}/{st.total_rounds})",
        )

        if st.round is not None and st.total_rounds is not None and st.round < st.total_rounds:
            return VoteTrainSetStage

        # Experiment done: final eval, back to idle (reference :66-74).
        TrainStage._evaluate(node)
        logger.experiment_finished(node.addr)
        # First finisher closes the process-wide profiler trace (no-op
        # when none is active).
        profiling.stop_trace()
        # Durable completion evidence: InitModelRequestCommand serves
        # final weights to stragglers only for experiments that actually
        # ran to completion here — status checks alone race the window
        # between start_learning_thread and set_experiment, where an
        # 'Idle' node would serve its random init weights.
        node.completed_experiment = st.exp_name
        st.clear()
        return None
