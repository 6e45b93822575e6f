"""The subset of :mod:`tpfl.management.logger` that the port's learning
layer and node runtime call: leveled, node-tagged logging (the level read
from ``Settings.LOG_LEVEL`` when the logger is built), the node registry
(``get_nodes``) and experiment lifecycle hooks, metric routing
(``log_metric``) into the two-tier stores of
:mod:`tpfl_torch.management.metric_storage`, the per-link send-health
store (``transport_metrics``), the process metrics registry
``logger.metrics`` (:data:`tpfl_torch.management.telemetry.metrics`),
and the reference's ``WebLogger`` push path: after :meth:`TpflLogger.connect_web`,
logs and metrics also go to a web dashboard
(:class:`~tpfl_torch.management.web_services.TpflWebServices`) and every
registered node gets a :class:`~tpfl_torch.management.node_monitor.NodeMonitor`
that pushes its system metrics. Until then nothing is sent and no
monitor runs.

Routing rule (the reference's): a metric logged with a ``step`` goes to
the *local* (per-step) store; one logged without goes to the *global*
(per-round) store.
"""

from __future__ import annotations

import atexit
import datetime
import logging
import logging.handlers
import os
import queue
from typing import Any, Optional

from tpfl_torch.concurrency import make_lock
from tpfl_torch.management import telemetry
from tpfl_torch.management.metric_storage import (
    GlobalMetricStorage,
    LocalMetricStorage,
    TransportMetricStorage,
)
from tpfl_torch.settings import Settings

class FileFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        node = getattr(record, "node", "")
        ts = datetime.datetime.fromtimestamp(record.created).isoformat()
        return f"[{ts}|{record.levelname}|{node}] {record.getMessage()}"


class _LazyFileHandler(logging.Handler):
    """Creates ``Settings.LOG_DIR`` and the rotating file only at the
    first record emitted while ``Settings.FILE_LOGGER`` is on: importing
    the package never touches the file system."""

    def __init__(self) -> None:
        super().__init__()
        self._real: Optional[logging.handlers.RotatingFileHandler] = None

    def emit(self, record: logging.LogRecord) -> None:
        if not Settings.FILE_LOGGER:
            return
        if self._real is None:
            os.makedirs(Settings.LOG_DIR, exist_ok=True)
            self._real = logging.handlers.RotatingFileHandler(
                os.path.join(Settings.LOG_DIR,
                             f"tpfl-{datetime.datetime.now():%Y%m%d-%H%M%S}.log"),
                maxBytes=Settings.LOG_FILE_MAX_BYTES,
                backupCount=Settings.LOG_FILE_BACKUP_COUNT,
            )
            self._real.setFormatter(FileFormatter())
        self._real.emit(record)

    def close(self) -> None:
        if self._real is not None:
            self._real.close()
        super().close()


class _LazyQueueHandler(logging.handlers.QueueHandler):
    """Hands records to a listener thread that runs ``handlers``; the
    thread starts at the first record (importing the package starts no
    thread) and stops at exit or :meth:`TpflLogger.cleanup`."""

    def __init__(self, handlers: list[logging.Handler]) -> None:
        super().__init__(queue.Queue(-1))
        self.listener = logging.handlers.QueueListener(self.queue, *handlers,
                                                       respect_handler_level=True)
        self._start_lock = make_lock("TpflLogger._start_lock")
        self._started = False  # guarded-by: _start_lock (written)
        atexit.register(self.stop)

    def enqueue(self, record: logging.LogRecord) -> None:
        if not self._started:
            with self._start_lock:
                if not self._started:
                    self.listener.start()
                    self._started = True
        super().enqueue(record)

    def stop(self) -> None:
        """Drain the queue and join the listener, if it runs."""
        with self._start_lock:
            if self._started:
                self.listener.stop()
                self._started = False


class TpflLogger:
    """Python logging + node registry + metric stores."""

    def __init__(self) -> None:
        self._logger = logging.getLogger("tpfl_torch")
        self._logger.propagate = False
        self._logger.setLevel(getattr(logging, Settings.LOG_LEVEL, logging.INFO))
        if not self._logger.handlers:
            handler = logging.StreamHandler()
            handler.setFormatter(logging.Formatter("[ %(asctime)s | %(levelname)s ] "
                                                   "(%(node)s) %(message)s", "%H:%M:%S"))
            self._logger.addHandler(handler)
            self._logger.addHandler(_LazyFileHandler())
        if Settings.ASYNC_LOGGER and not any(isinstance(h, _LazyQueueHandler)
                                             for h in self._logger.handlers):
            handlers = list(self._logger.handlers)
            for h in handlers:
                self._logger.removeHandler(h)
            self._logger.addHandler(_LazyQueueHandler(handlers))
        # The process metrics registry (tpfl_torch.management.telemetry).
        self.metrics = telemetry.metrics
        self.local_metrics = LocalMetricStorage()
        self.global_metrics = GlobalMetricStorage()
        # Per-(node, neighbor) send health, fed by the circuit breaker
        # (communication.resilience) and mirrored into ``metrics``.
        self.transport_metrics = TransportMetricStorage()
        self._lock = make_lock("TpflLogger._lock")
        # guarded-by: _lock — addr -> {"simulation": bool, "experiment": ...}
        self._nodes: dict[str, dict[str, Any]] = {}
        # The web dashboard client (connect_web) and one NodeMonitor per
        # registered node while it is connected. unguarded: written on the
        # node-lifecycle thread (start / stop), one key per node.
        self._web: Any = None
        self._monitors: dict[str, Any] = {}

    # --- levels / log methods ---

    def set_level(self, level: "int | str") -> None:
        self._logger.setLevel(getattr(logging, level) if isinstance(level, str) else level)

    def get_level(self) -> int:
        return self._logger.level

    def log(self, level: int, node: str, message: str) -> None:
        self._logger.log(level, message, extra={"node": node})
        if self._web is not None:
            self._web.send_log(str(datetime.datetime.now()), node,
                               logging.getLevelName(level), message)

    def debug(self, node: str, message: str) -> None:
        self.log(logging.DEBUG, node, message)

    def info(self, node: str, message: str) -> None:
        self.log(logging.INFO, node, message)

    def warning(self, node: str, message: str) -> None:
        self.log(logging.WARNING, node, message)

    def error(self, node: str, message: str) -> None:
        self.log(logging.ERROR, node, message)

    def cleanup(self) -> None:
        """Drain and stop the async listener, if one runs."""
        for h in self._logger.handlers:
            if isinstance(h, _LazyQueueHandler):
                h.stop()

    # --- node registry ---

    def register_node(self, node: str, simulation: bool = False) -> None:
        with self._lock:
            if node in self._nodes:
                raise Exception(f"Node {node} already registered.")
            self._nodes[node] = {"simulation": simulation, "experiment": None}
        if self._web is not None:
            self._web.register_node(node, simulation)
            from tpfl_torch.management.node_monitor import NodeMonitor

            mon = NodeMonitor(node, self.log_system_metric)
            mon.start()
            self._monitors[node] = mon

    def unregister_node(self, node: str) -> None:
        with self._lock:
            self._nodes.pop(node, None)
        mon = self._monitors.pop(node, None)
        if mon is not None:
            mon.stop()
        if self._web is not None:
            self._web.unregister_node(node)

    # --- web dashboard ---

    def connect_web(self, url: str, key: str) -> None:
        """Push logs, metrics and the system metrics of nodes registered
        from now on to the dashboard at ``url`` (``x-api-key: key``)."""
        from tpfl_torch.management.web_services import TpflWebServices

        self._web = TpflWebServices(url, key)

    def log_system_metric(self, node: str, metric: str, value: float) -> None:
        """A :class:`NodeMonitor` reading, pushed to the dashboard."""
        if self._web is not None:
            self._web.send_system_metric(node, metric, value, str(datetime.datetime.now()))

    def get_nodes(self) -> dict[str, dict[str, Any]]:
        """Snapshot copy of the registry."""
        with self._lock:
            return {k: dict(v) for k, v in self._nodes.items()}

    def experiment_started(self, node: str, experiment: Any) -> None:
        """Attach an experiment (an object with ``exp_name`` and
        ``round``) to a node: its learner's metrics are then logged."""
        with self._lock:
            self._nodes.setdefault(node, {"simulation": False})["experiment"] = experiment
        self.info(node, f"Experiment '{getattr(experiment, 'exp_name', '?')}' started")

    def experiment_finished(self, node: str) -> None:
        self.info(node, "Experiment finished")

    def round_finished(self, node: str) -> None:
        self.debug(node, "Round finished")

    # --- metrics ---

    def resolve_experiment(self, addr: str, round: Optional[int]) -> tuple[str, Optional[int]]:
        """(exp_name, round) for a node, filling round from its running
        experiment when not given."""
        with self._lock:
            info = self._nodes.get(addr)
        exp_name = "unknown-exp"
        if info is not None and info.get("experiment") is not None:
            exp = info["experiment"]
            exp_name = exp.exp_name
            if round is None:
                round = exp.round
        return exp_name, round

    def log_metric(self, addr: str, metric: str, value: float, step: Optional[int] = None,
                   round: Optional[int] = None) -> None:
        exp_name, round = self.resolve_experiment(addr, round)
        if round is None:
            raise ValueError(f"No round info for node {addr}; pass round=")
        if step is None:
            self.global_metrics.add_log(exp_name, round, metric, addr, value)
        else:
            self.local_metrics.add_log(exp_name, round, metric, addr, value, step)
        if self._web is not None:
            if step is None:
                self._web.send_global_metric(addr, metric, value, round)
            else:
                self._web.send_local_metric(addr, metric, value, step, round)

    def get_local_logs(self) -> dict:
        """exp -> round -> node -> metric -> [(step, value)], a copy."""
        return self.local_metrics.get_all_logs()

    def get_global_logs(self) -> dict:
        """exp -> node -> metric -> [(round, value)], a copy."""
        return self.global_metrics.get_all_logs()

    def get_transport_logs(self) -> dict:
        """node -> neighbor -> send-health counters, a copy."""
        return self.transport_metrics.get_all_logs()


logger = TpflLogger()

__all__ = ["TpflLogger", "logger"]
