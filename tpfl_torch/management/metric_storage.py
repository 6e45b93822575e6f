"""Two-tier metric stores — a copy of :mod:`tpfl.management.metric_storage`.

Parity with reference ``p2pfl/management/metric_storage.py``:

- :class:`LocalMetricStorage` — per-step training metrics,
  ``exp -> round -> node -> metric -> [(step, value)]``
  (reference ``metric_storage.py:30``).
- :class:`GlobalMetricStorage` — per-round evaluation metrics,
  ``exp -> node -> metric -> [(round, value)]`` with per-round dedup
  (reference ``metric_storage.py:158,208-210``).
- :class:`TransportMetricStorage` — per-(node, neighbor) send-health
  counters (``sends_ok`` / ``sends_failed`` / ``retries`` /
  ``breaker_state``), fed by the communication layer's circuit breaker
  so dropped gossip/heartbeat sends are observable instead of
  vanishing at debug level (tpfl addition, no reference analog).

Thread-safe: gRPC handler threads, the learning thread, and the monitor
thread all log concurrently.

Bounded: every per-series point list is capped at
``Settings.METRIC_MAX_POINTS`` (oldest evicted first) — a long-running
node's per-step training series must not be the one unbounded
allocation in the management layer. Transport counters are mirrored
into the process metrics registry
(:data:`tpfl_torch.management.telemetry.metrics`, ``logger.metrics``).
"""

from __future__ import annotations

import copy

from tpfl_torch.concurrency import make_lock
from tpfl_torch.management import telemetry
from tpfl_torch.settings import Settings


def _capped_append(series: list, point: tuple) -> None:
    """Append honoring Settings.METRIC_MAX_POINTS (drop-oldest).
    Caller holds the owning store's lock."""
    series.append(point)
    cap = max(1, int(Settings.METRIC_MAX_POINTS))
    if len(series) > cap:
        del series[: len(series) - cap]

LocalMetrics = dict[str, dict[int, dict[str, dict[str, list[tuple[int, float]]]]]]
GlobalMetrics = dict[str, dict[str, dict[str, list[tuple[int, float]]]]]


class LocalMetricStorage:
    """exp -> round -> node -> metric -> [(step, value)]"""

    def __init__(self) -> None:
        # guarded-by: _lock
        self._store: LocalMetrics = {}
        self._lock = make_lock("LocalMetricStorage._lock")

    def add_log(
        self,
        exp_name: str,
        round: int,
        metric: str,
        node: str,
        val: float,
        step: int,
    ) -> None:
        with self._lock:
            exp = self._store.setdefault(exp_name, {})
            rnd = exp.setdefault(round, {})
            nd = rnd.setdefault(node, {})
            _capped_append(nd.setdefault(metric, []), (step, float(val)))

    def get_all_logs(self) -> LocalMetrics:
        with self._lock:
            return copy.deepcopy(self._store)

    def get_experiment_logs(self, exp: str) -> dict:
        with self._lock:
            return copy.deepcopy(self._store.get(exp, {}))

    def get_experiment_round_logs(self, exp: str, round: int) -> dict:
        with self._lock:
            return copy.deepcopy(self._store.get(exp, {}).get(round, {}))

    def get_experiment_round_node_logs(self, exp: str, round: int, node: str) -> dict:
        with self._lock:
            return copy.deepcopy(self._store.get(exp, {}).get(round, {}).get(node, {}))


class GlobalMetricStorage:
    """exp -> node -> metric -> [(round, value)] (deduped per round)"""

    def __init__(self) -> None:
        # guarded-by: _lock
        self._store: GlobalMetrics = {}
        self._lock = make_lock("GlobalMetricStorage._lock")

    def add_log(
        self, exp_name: str, round: int, metric: str, node: str, val: float
    ) -> None:
        with self._lock:
            exp = self._store.setdefault(exp_name, {})
            nd = exp.setdefault(node, {})
            series = nd.setdefault(metric, [])
            # Dedup: only one value per (metric, round) — metric_storage.py:208-210
            if round not in [r for r, _ in series]:
                _capped_append(series, (round, float(val)))

    def get_all_logs(self) -> GlobalMetrics:
        with self._lock:
            return copy.deepcopy(self._store)

    def get_experiment_logs(self, exp: str) -> dict:
        with self._lock:
            return copy.deepcopy(self._store.get(exp, {}))

    def get_experiment_node_logs(self, exp: str, node: str) -> dict:
        with self._lock:
            return copy.deepcopy(self._store.get(exp, {}).get(node, {}))


TransportMetrics = dict[str, dict[str, dict[str, object]]]


class TransportMetricStorage:
    """node -> neighbor -> {sends_ok, sends_failed, retries,
    breaker_state, breaker_opens}

    Counters survive neighbor eviction/re-admission (they describe the
    link's history, not the table entry), and reset only with the
    process — they answer "how flaky has this link been", which a
    per-round store cannot."""

    def __init__(self) -> None:
        # guarded-by: _lock
        self._store: TransportMetrics = {}
        self._lock = make_lock("TransportMetricStorage._lock")

    def _entry(self, node: str, neighbor: str) -> dict[str, object]:
        nd = self._store.setdefault(node, {})
        e = nd.get(neighbor)
        if e is None:
            e = nd[neighbor] = {
                "sends_ok": 0,
                "sends_failed": 0,
                "retries": 0,
                "breaker_state": "closed",
                "breaker_opens": 0,
            }
        return e

    def record_send(
        self, node: str, neighbor: str, ok: bool, attempts: int = 1
    ) -> None:
        with self._lock:
            e = self._entry(node, neighbor)
            e["sends_ok" if ok else "sends_failed"] += 1  # type: ignore[operator]
            e["retries"] += max(0, attempts - 1)  # type: ignore[operator]
        # Mirror into the process registry (outside the store lock: no
        # lock-order edge between the two).
        telemetry.metrics.counter(
            "tpfl_transport_sends_total",
            labels={"node": node, "ok": "1" if ok else "0"},
        )
        if attempts > 1:
            telemetry.metrics.counter(
                "tpfl_transport_retries_total",
                float(attempts - 1),
                labels={"node": node},
            )

    def record_breaker(self, node: str, neighbor: str, state: str) -> None:
        with self._lock:
            e = self._entry(node, neighbor)
            e["breaker_state"] = state
            if state == "open":
                e["breaker_opens"] += 1  # type: ignore[operator]
        if state == "open":
            telemetry.metrics.counter(
                "tpfl_breaker_opens_total", labels={"node": node}
            )
        telemetry.metrics.gauge(
            "tpfl_breaker_open",
            1.0 if state == "open" else 0.0,
            labels={"node": node, "neighbor": neighbor},
        )

    def get_all_logs(self) -> TransportMetrics:
        with self._lock:
            return copy.deepcopy(self._store)

    def get_node_logs(self, node: str) -> dict:
        with self._lock:
            return copy.deepcopy(self._store.get(node, {}))
