"""Node — the composition root of one FL participant, the port of
:mod:`tpfl.node`: a :class:`~tpfl_torch.learning.torch_learner.TorchLearner`
on the card by default (``device=None``; ``device="cpu"`` asks for the
CPU), the in-memory transport, FedAvg.

Parity with reference ``p2pfl/node.py:57-413``: wires protocol + learner
+ aggregator + commands (ctor, reference :89-134), exposes
``connect/disconnect`` (:140-184), ``start/stop`` (:210-253), and
``set_start_learning`` (:342-372) which broadcasts StartLearning +
ModelInitialized and spawns the daemon learning thread running the stage
workflow (:333-400).

Under ``Settings.ASYNC_ROUNDS`` the stage workflow runs asynchronous
buffered rounds; free-running (``ASYNC_SERIALIZED`` off) each node also
runs one trainer thread, which :meth:`Node.stop` interrupts and joins.
Refused with ``NotImplementedError`` naming the ``ROADMAP.md`` §1 item:
the pooled simulation learner (``Settings.DISABLE_SIMULATION`` off, item
5, at construction); checkpoints (item 4). With
``Settings.TELEMETRY_ENABLED`` the node's hops land in the flight
recorder, and :meth:`Node.stop` dumps its ring (to
``Settings.TELEMETRY_DUMP_DIR`` when set).
"""

from __future__ import annotations

import random
import threading
import uuid
import zlib
from typing import Any, Optional, Type

from tpfl_torch.communication.commands import ALL_COMMANDS, StartLearningCommand
from tpfl_torch.communication.memory import InMemoryCommunicationProtocol
from tpfl_torch.communication.protocol import CommunicationProtocol
from tpfl_torch import DeviceLike
from tpfl_torch.exceptions import (
    ENGINE_ITEM,
    LearnerRunningException,
    NodeRunningException,
    ZeroRoundsException,
    not_ported,
)
from tpfl_torch.learning.aggregators import FedAvg
from tpfl_torch.learning.aggregators.aggregator import Aggregator
from tpfl_torch.learning.dataset.tpfl_dataset import TpflDataset
from tpfl_torch.learning.learner import Learner
from tpfl_torch.learning.model import TpflModel
from tpfl_torch.learning.torch_learner import TorchLearner
from tpfl_torch.management.logger import logger
from tpfl_torch.settings import Settings
from tpfl_torch.stages.stage import LearningWorkflow


class Node:
    """One FL participant: model + data + transport + aggregator.

    Args:
        model: initial TpflModel (zoo module + params).
        data: local dataset partition.
        addr: optional explicit address (transports auto-assign).
        protocol: CommunicationProtocol class or instance.
        learner: Learner class or instance.
        aggregator: Aggregator instance (default FedAvg).
        simulation: mark the node as simulated (logger bookkeeping).
        device: where the learner trains and the default aggregator
            folds; ``None`` means the card, ``"cpu"`` asks for the CPU.
        **learner_kwargs: forwarded to the learner constructor
            (learning_rate, batch_size, ...).
    """

    def __init__(
        self,
        model: TpflModel,
        data: TpflDataset,
        addr: Optional[str] = None,
        protocol: Type[CommunicationProtocol] | CommunicationProtocol = InMemoryCommunicationProtocol,
        learner: Type[Learner] | Learner = TorchLearner,
        aggregator: Optional[Aggregator] = None,
        simulation: bool = False,
        device: DeviceLike = None,
        **learner_kwargs: Any,
    ) -> None:
        if isinstance(protocol, CommunicationProtocol):
            self.communication = protocol
        else:
            self.communication = protocol(addr) if addr else protocol()
        self.addr = self.communication.get_address()

        from tpfl_torch.node_state import NodeState

        self.state = NodeState(self.addr, simulation=simulation)
        self.aggregator = aggregator if aggregator is not None else FedAvg(device=device)
        self.aggregator.node_name = self.addr
        # Active-defense wiring: the aggregator consults the node's
        # quarantine engine at every intake (one attribute read while
        # Settings.QUARANTINE_ENABLED is off).
        self.aggregator.set_quarantine(self.state.quarantine)

        if isinstance(learner, Learner):
            self.learner = learner
            self.learner.set_addr(self.addr)
            self.learner.set_model(model)
            self.learner.set_data(data)
        else:
            self.learner = learner(
                model=model,
                data=data,
                addr=self.addr,
                aggregator=self.aggregator,
                device=device,
                **learner_kwargs,
            )

        # Simulation activation hook (reference node wiring via
        # try_init_learner_with_ray, simulation/__init__.py:16-33): the
        # pooled learner is refused unless Settings.DISABLE_SIMULATION.
        from tpfl_torch.simulation import try_init_learner_with_simulation

        self.learner = try_init_learner_with_simulation(self.learner)

        # Delta-gossip wiring: every model derived from this one (wire
        # intake via build_copy, aggregates) inherits the resolver, so
        # residual payloads decode against the bases this node adopted.
        self.learner.get_model().base_store = self.state.wire_bases
        # Zero-copy model plane: a per-node reusable serialization
        # buffer (tpfl_torch.learning.bufferpool) — v3 encodes stage into it
        # instead of allocating fresh multi-MB bytes per gossip tick;
        # inherited by every wire-derived model copy alongside the
        # base resolver.
        from tpfl_torch.learning.bufferpool import BufferPool

        self.buffer_pool = BufferPool(
            max_buffers=Settings.BUFFER_POOL_BUFFERS,
            max_bytes=Settings.BUFFER_POOL_MAX_BYTES,
        )
        self.learner.get_model().buffer_pool = self.buffer_pool

        # Buffer-pool stats publish through the metrics registry as a
        # pull-style collector (invoked at scrape/dump time, outside
        # the pool's hot path); unregistered in stop().
        pool, addr = self.buffer_pool, self.addr

        def _pool_collector(registry: Any) -> None:
            labels = {"node": addr}
            registry.gauge("tpfl_bufferpool_hits", float(pool.hits), labels=labels)
            registry.gauge(
                "tpfl_bufferpool_misses", float(pool.misses), labels=labels
            )
            registry.gauge(
                "tpfl_bufferpool_pooled_bytes", float(pool.pooled_bytes),
                labels=labels,
            )
            registry.gauge(
                "tpfl_bufferpool_outstanding", float(pool.outstanding),
                labels=labels,
            )

        self._pool_collector = _pool_collector
        logger.metrics.register_collector(_pool_collector)

        # Experiment parameters (set by set_start_learning / command)
        self.rounds: int = 0
        self.epochs: int = 1
        self.exp_name: str = "experiment"
        self.beacon: str = ""
        # Name of the last experiment that ran to completion HERE —
        # the evidence InitModelRequestCommand requires before serving
        # "finished" weights to a straggler (set by RoundFinishedStage).
        self.completed_experiment: Optional[str] = None
        self.learning_workflow = LearningWorkflow()
        self._learning_thread: Optional[threading.Thread] = None
        # Free-running async trainer loop (AsyncRoundStage
        # ._ensure_trainer_loop): one daemon thread per experiment, exits
        # through check_early_stop / an experiment-name change.
        # unguarded: written only by the learning thread (stage entry);
        # the thread object itself is the synchronization.
        self._async_trainer_thread: Optional[threading.Thread] = None
        self._running = False
        self.rng = random.Random((Settings.SEED or 0) + zlib.crc32(self.addr.encode()))

        # Register application verbs (reference node.py:122-134).
        for cmd_cls in ALL_COMMANDS:
            cmd = cmd_cls(self)
            self.communication.add_command(cmd.get_name(), cmd.execute)

    # --- lifecycle (reference node.py:210-253) ---

    def start(self, wait: bool = False) -> None:
        if self._running:
            raise NodeRunningException(f"Node {self.addr} already running")
        Settings.refuse_unported("node")
        logger.register_node(self.addr, simulation=self.state.simulation)
        self.communication.start()
        self._running = True
        logger.info(self.addr, "Node started")
        if wait:
            self.communication.wait_for_termination()
            logger.unregister_node(self.addr)

    def stop(self) -> None:
        if not self._running:
            return
        if self.state.status == "Learning":
            self.stop_learning()
        # The free-running async trainer: interrupt its in-flight fit and
        # let the thread drain before the transport goes down — a daemon
        # thread left mid-launch at interpreter teardown can abort the
        # process.
        trainer = self._async_trainer_thread
        if trainer is not None and trainer.is_alive():
            self.learner.interrupt_fit()
            trainer.join(timeout=5.0)
        self.communication.stop()
        logger.unregister_node(self.addr)
        self._running = False
        logger.info(self.addr, "Node stopped")
        logger.metrics.unregister_collector(self._pool_collector)
        if Settings.TELEMETRY_ENABLED:
            # Flush this node's flight ring on the way out: the last N
            # spans/events are the post-mortem for whatever ended the
            # node (a JSON dump lands in Settings.TELEMETRY_DUMP_DIR
            # when set — the traceview input).
            from tpfl_torch.management.telemetry import flight

            path = flight.dump(self.addr, "stop")
            if path is not None:
                logger.info(self.addr, f"Flight recorder dumped to {path}")
        if Settings.LOCK_TRACING:
            # Traced runs check the RUNTIME lock-acquisition graph on
            # the way out: a cycle is a latent deadlock, and the
            # LockOrderError carries the witness chain with real thread
            # names.
            from tpfl_torch.concurrency import lock_graph

            lock_graph.assert_acyclic()
        # A profiler trace left open by an aborted experiment would
        # otherwise never flush to disk (idempotent no-op normally —
        # the experiment-finished path already closed it).
        from tpfl_torch.management import profiling

        profiling.stop_trace()

    # --- topology (reference node.py:140-184) ---

    def connect(self, addr: str) -> bool:
        if not self._running:
            raise NodeRunningException("Node must be started to connect")
        return self.communication.connect(addr)

    def disconnect(self, addr: str) -> None:
        self.communication.disconnect(addr)

    def get_neighbors(self, only_direct: bool = False) -> dict[str, Any]:
        return self.communication.get_neighbors(only_direct)

    # --- learning (reference node.py:333-400) ---

    def set_start_learning(self, rounds: int = 1, epochs: int = 1) -> str:
        """Kick off a federated experiment from this node. Returns the
        experiment name (unique per start; all nodes share it — the
        reference's newer API returns it for metric retrieval,
        exp_SAVE3.txt:107-113)."""
        if not self._running:
            raise NodeRunningException("Node must be started")
        if rounds < 1:
            raise ZeroRoundsException("rounds must be >= 1")
        if self.state.status == "Learning":
            raise LearnerRunningException("Already learning")
        # Before the broadcast, so a refused switch leaves the peers
        # untouched (start_learning_thread checks again for the nodes
        # that join through the StartLearning command).
        Settings.refuse_unported("node")
        exp_name = f"experiment_{uuid.uuid4().hex[:8]}"
        # Election beacon: a per-experiment shared random value every
        # participant learns WITH the experiment announcement, mixed
        # into the hash-election rank (Settings.ELECTION docs). Derived
        # from the initiator's init-model bytes, so it is not known
        # before the experiment exists — an adversary must commit its
        # address before the beacon is revealed to grind the election.
        import hashlib

        beacon = hashlib.sha256(
            self.learner.get_model().encode_parameters()
        ).hexdigest()
        self.communication.broadcast(
            self.communication.build_msg(
                StartLearningCommand.name,
                [str(rounds), str(epochs), exp_name, beacon],
            )
        )
        # Initiator has the weights: release its own init event and
        # announce (reference node.py:362-368).
        self.state.model_initialized_event.set()
        from tpfl_torch.communication.commands import ModelInitializedCommand

        self.communication.broadcast(
            self.communication.build_msg(ModelInitializedCommand.name)
        )
        self.start_learning_thread(rounds, epochs, exp_name, beacon=beacon)
        return exp_name

    def start_learning_thread(
        self,
        rounds: int,
        epochs: int,
        exp_name: str = "experiment",
        beacon: str = "",
    ) -> None:
        """Spawn the stage-workflow thread (also the StartLearningCommand
        entry point for non-initiator nodes)."""
        if self._learning_thread is not None and self._learning_thread.is_alive():
            logger.debug(self.addr, "Learning thread already running")
            return
        Settings.refuse_unported("node")
        self.rounds = rounds
        self.epochs = epochs
        self.exp_name = exp_name
        self.beacon = beacon
        # A new run invalidates the previous run's "finished" evidence:
        # if exp_name is reused, a straggler's InitModelRequest during
        # the pre-Learning window must NOT be served the old final
        # weights (common-init violation).
        self.completed_experiment = None
        self.state.prepare_experiment()
        self.learning_workflow = LearningWorkflow()
        self._learning_thread = threading.Thread(
            target=self._run_workflow,
            daemon=True,
            name=f"learning-{self.addr}",
        )
        self._learning_thread.start()

    def _run_workflow(self) -> None:
        try:
            self.learning_workflow.run(self)
        except Exception as e:  # pragma: no cover - last-resort guard
            logger.error(self.addr, f"Learning workflow crashed: {e}")
            import traceback

            logger.error(self.addr, traceback.format_exc())
            self.learning_workflow.finished = True

    def stop_learning(self) -> None:
        """Abort the experiment (reference stop_learning_command path).

        Order matters: mark the state idle FIRST (early-stop predicate
        becomes true), then set the events so blocked stages wake and
        observe it. Full bookkeeping reset happens on the next
        ``start_learning_thread`` (prepare_experiment)."""
        logger.info(self.addr, "Stopping learning")
        self.learner.interrupt_fit()
        st = self.state
        st.status = "Idle"
        st.experiment = None
        st.model_initialized_event.set()
        st.aggregated_model_event.set()
        st.votes_ready_event.set()
        self.aggregator.clear()

    # --- checkpoint / resume (not ported) ---

    def save_checkpoint(self, directory: str) -> None:
        """Persist this node's model + round metadata (the reference's
        ``management/checkpoint.py``)."""
        raise not_ported("Node.save_checkpoint (management/checkpoint.py)", ENGINE_ITEM)

    def load_checkpoint(self, directory: str) -> dict:
        """Restore model weights saved by :meth:`save_checkpoint`."""
        raise not_ported("Node.load_checkpoint (management/checkpoint.py)", ENGINE_ITEM)

    # --- introspection ---

    def learning_finished(self) -> bool:
        return self.learning_workflow.finished

    def __repr__(self) -> str:
        return f"Node({self.addr}, running={self._running})"
