"""The subset of :mod:`tpfl.management.logger` that the ported learning
layer calls: leveled, node-tagged logging, the node registry
(``get_nodes``), metric routing (``log_metric``) and the process metrics
registry (``logger.metrics.counter`` / ``observe`` / ``gauge``) as
plain counts that can be read back.

Routing rule (the reference's): a metric logged with a ``step`` goes to
the *local* (per-step) store; one logged without goes to the *global*
(per-round) store. The rest of the reference's management plane (file
and async handlers, the web dashboard, Prometheus export, telemetry
spans) waits for the node runtime (``ROADMAP.md`` §1 item 7).
"""

from __future__ import annotations

import logging
from typing import Any, Optional

from tpfl_torch.concurrency import make_lock

# The reference's LOG_LEVEL default.
LOG_LEVEL = logging.INFO

LabelKey = tuple[tuple[str, str], ...]


def _labels(labels: Optional[dict[str, str]]) -> LabelKey:
    return tuple(sorted((labels or {}).items()))


class MetricsRegistry:
    """Counters, gauges and histogram summaries keyed by ``(name,
    labels)``, thread-safe, readable back (:meth:`value`,
    :meth:`snapshot`)."""

    def __init__(self) -> None:
        self._lock = make_lock("MetricsRegistry._lock")
        # guarded-by: _lock
        self._counters: dict[tuple[str, LabelKey], float] = {}
        # guarded-by: _lock
        self._gauges: dict[tuple[str, LabelKey], float] = {}
        # guarded-by: _lock — [count, sum] per series
        self._observed: dict[tuple[str, LabelKey], list[float]] = {}

    def counter(self, name: str, value: float = 1.0,
                labels: Optional[dict[str, str]] = None) -> None:
        key = (name, _labels(labels))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + value

    def gauge(self, name: str, value: float, labels: Optional[dict[str, str]] = None) -> None:
        with self._lock:
            self._gauges[(name, _labels(labels))] = float(value)

    def observe(self, name: str, value: float, labels: Optional[dict[str, str]] = None,
                buckets: Any = None) -> None:
        key = (name, _labels(labels))
        with self._lock:
            entry = self._observed.setdefault(key, [0, 0.0])
            entry[0] += 1
            entry[1] += float(value)

    def value(self, name: str, labels: Optional[dict[str, str]] = None) -> float:
        """A counter's or gauge's value (0 when never written)."""
        key = (name, _labels(labels))
        with self._lock:
            return self._counters.get(key, self._gauges.get(key, 0.0))

    def observed(self, name: str, labels: Optional[dict[str, str]] = None) -> tuple[int, float]:
        """(count, sum) of the values observed under ``name``."""
        with self._lock:
            count, total = self._observed.get((name, _labels(labels)), [0, 0.0])
        return int(count), total

    def snapshot(self) -> dict[str, dict]:
        with self._lock:
            return {"counters": dict(self._counters), "gauges": dict(self._gauges),
                    "observed": {k: tuple(v) for k, v in self._observed.items()}}

    def clear(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._observed.clear()


class TpflLogger:
    """Python logging + node registry + metric stores."""

    def __init__(self) -> None:
        self._logger = logging.getLogger("tpfl_torch")
        self._logger.propagate = False
        self._logger.setLevel(LOG_LEVEL)
        if not self._logger.handlers:
            handler = logging.StreamHandler()
            handler.setFormatter(logging.Formatter("[ %(asctime)s | %(levelname)s ] "
                                                   "(%(node)s) %(message)s", "%H:%M:%S"))
            self._logger.addHandler(handler)
        self.metrics = MetricsRegistry()
        self._lock = make_lock("TpflLogger._lock")
        # guarded-by: _lock — addr -> {"simulation": bool, "experiment": ...}
        self._nodes: dict[str, dict[str, Any]] = {}
        # guarded-by: _lock — exp -> round -> metric -> node -> value
        self._global: dict = {}
        # guarded-by: _lock — exp -> round -> metric -> node -> [(step, value)]
        self._local: dict = {}

    # --- levels / log methods ---

    def set_level(self, level: "int | str") -> None:
        self._logger.setLevel(getattr(logging, level) if isinstance(level, str) else level)

    def get_level(self) -> int:
        return self._logger.level

    def log(self, level: int, node: str, message: str) -> None:
        self._logger.log(level, message, extra={"node": node})

    def debug(self, node: str, message: str) -> None:
        self.log(logging.DEBUG, node, message)

    def info(self, node: str, message: str) -> None:
        self.log(logging.INFO, node, message)

    def warning(self, node: str, message: str) -> None:
        self.log(logging.WARNING, node, message)

    def error(self, node: str, message: str) -> None:
        self.log(logging.ERROR, node, message)

    # --- node registry ---

    def register_node(self, node: str, simulation: bool = False) -> None:
        with self._lock:
            if node in self._nodes:
                raise Exception(f"Node {node} already registered.")
            self._nodes[node] = {"simulation": simulation, "experiment": None}

    def unregister_node(self, node: str) -> None:
        with self._lock:
            self._nodes.pop(node, None)

    def get_nodes(self) -> dict[str, dict[str, Any]]:
        """Snapshot copy of the registry."""
        with self._lock:
            return {k: dict(v) for k, v in self._nodes.items()}

    def experiment_started(self, node: str, experiment: Any) -> None:
        """Attach an experiment (an object with ``exp_name`` and
        ``round``) to a node: its learner's metrics are then logged."""
        with self._lock:
            self._nodes.setdefault(node, {"simulation": False})["experiment"] = experiment

    # --- metrics ---

    def log_metric(self, addr: str, metric: str, value: float, step: Optional[int] = None,
                   round: Optional[int] = None) -> None:
        with self._lock:
            info = self._nodes.get(addr) or {}
            exp = info.get("experiment")
            exp_name = getattr(exp, "exp_name", "unknown-exp") if exp is not None else \
                "unknown-exp"
            if round is None and exp is not None:
                round = exp.round
            if round is None:
                raise ValueError(f"No round info for node {addr}; pass round=")
            store = self._global if step is None else self._local
            series = store.setdefault(exp_name, {}).setdefault(round, {}).setdefault(metric, {})
            if step is None:
                series[addr] = value
            else:
                series.setdefault(addr, []).append((step, value))

    def get_global_logs(self) -> dict:
        with self._lock:
            return _copy(self._global)

    def get_local_logs(self) -> dict:
        with self._lock:
            return _copy(self._local)


def _copy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return list(tree) if isinstance(tree, list) else tree


logger = TpflLogger()

__all__ = ["MetricsRegistry", "TpflLogger", "logger"]
