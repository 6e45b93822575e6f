"""Per-node metrics registry + flight recorder — a copy of
:mod:`tpfl.management.telemetry` (the telemetry core).

The decentralized protocol means no single process sees a round
end-to-end: a model update crosses gossip hops, retry/breaker layers,
and the streaming aggregator before it lands. This module gives every
node two always-available sinks:

- :class:`MetricsRegistry` — counters/gauges/histograms with BOUNDED
  label sets, exposed process-wide as ``logger.metrics``. Updates are
  lock-free per-thread shards (each thread owns a private dict; the
  hot path is a plain dict update with no lock), folded on read.
  Holds the circuit breaker's transport counters, buffer-pool stats,
  payload bytes, aggregator fold timings, the ledger's and the
  quarantine's series, and ``NodeMonitor``'s system gauges. Exportable
  as Prometheus text (:meth:`MetricsRegistry.render_prometheus`, served
  over HTTP by ``web_services.MetricsHTTPServer``) and dumpable as
  JSON. :meth:`MetricsRegistry.value`
  reads one counter or gauge back through :meth:`~MetricsRegistry.fold`.

- :class:`FlightRecorder` — a bounded ring of the last
  ``Settings.TELEMETRY_RING`` spans/events PER NODE. ``Node.stop()``,
  the chaos harness's injected crashes, and quorum degradation dump it
  (to ``Settings.TELEMETRY_DUMP_DIR`` when set) as the document
  ``tools/traceview.py`` reads, making every fault-injection failure
  post-mortem-able. Span *production* is gated by
  ``Settings.TELEMETRY_ENABLED`` (see ``tpfl_torch.management.tracing``);
  the recorder itself is always willing.

Concurrency: shard updates are owner-thread-only (no lock); the fold
path copies each shard's items under a retry loop (a concurrent
insert can raise RuntimeError mid-copy — rare, bounded, and the
retry re-reads a consistent snapshot). All registry bookkeeping that
IS shared (shard list, label-set budgets, collectors) sits under
``_meta_lock``; the recorder's rings under its own ``_lock``. Neither
lock is ever held while calling out of this module, so no lock-order
edges can form back into protocol locks.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Iterable, Optional

from tpfl_torch.concurrency import make_lock
from tpfl_torch.settings import Settings

# Wall-clock anchor for cross-process timeline merges: every span
# timestamp is time.monotonic(); dumps carry this anchor so
# tools/traceview.py can place dumps from different processes on one
# wall-clock axis (same-process exports share it exactly).
WALL_ANCHOR = time.time() - time.monotonic()

#: Default histogram bucket upper bounds (seconds-flavored, matching
#: Prometheus conventions); every histogram also gets a +Inf bucket.
DEFAULT_BUCKETS: tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

#: The reserved label set cardinality-capped series collapse into.
OVERFLOW_LABELS: tuple[tuple[str, str], ...] = (("overflow", "true"),)

_SeriesKey = "tuple[str, tuple[tuple[str, str], ...]]"


def _labels_key(labels: "dict[str, str] | None") -> tuple[tuple[str, str], ...]:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _retry_items(d: dict) -> list:
    """Snapshot a dict another thread may be inserting into: list() of
    a mutating dict can raise RuntimeError — re-read until consistent
    (inserts are rare relative to reads; two retries suffice in
    practice, the loop is bounded regardless)."""
    for _ in range(8):
        try:
            return list(d.items())
        except RuntimeError:
            continue
    return list(d.items())  # last try surfaces the error if truly hot


class _Shard:
    """One thread's private accumulation buffers. The owner thread
    mutates without locks; the fold path reads via _retry_items."""

    __slots__ = ("counters", "gauges", "hists")

    def __init__(self) -> None:
        # unguarded: owner-thread writes only; fold reads via
        # _retry_items (bounded re-read on concurrent mutation).
        self.counters: dict = {}
        # unguarded: same ownership as counters; values are
        # (seq, value) so the fold can take the latest write globally.
        self.gauges: dict = {}
        # unguarded: same ownership as counters; values are
        # [bucket_counts..., +inf] + [sum, count] appended.
        self.hists: dict = {}


class MetricsRegistry:
    """Process-wide metric sink with per-thread lock-free shards.

    API shape (labels are plain str->str dicts, bounded per metric by
    ``Settings.TELEMETRY_MAX_LABELSETS``)::

        logger.metrics.counter("tpfl_sends_total", labels={"node": a})
        logger.metrics.gauge("tpfl_cpu_percent", 42.0, labels={...})
        logger.metrics.observe("tpfl_agg_fold_seconds", dt, labels={...})

    ``register_collector(fn)`` adds a callable invoked (outside all
    registry locks) at render/dump time — how pull-style stats
    (buffer-pool occupancy, the ledger's occupancy) publish without instrumenting their hot
    paths.
    """

    def __init__(self) -> None:
        self._meta_lock = make_lock("MetricsRegistry._meta_lock")
        # guarded-by: _meta_lock
        self._shards: list[_Shard] = []
        # guarded-by: _meta_lock
        self._labelsets: dict[str, set] = {}
        # guarded-by: _meta_lock
        self._collectors: list[Callable[["MetricsRegistry"], None]] = []
        # unguarded: replaced wholesale under _meta_lock only in
        # reset(); per-metric bucket tuples are immutable after set.
        self._buckets: dict[str, tuple[float, ...]] = {}
        self._local = threading.local()
        # Gauge write ordering: a GIL-atomic counter (itertools.count
        # next() is a single C call) — the fold takes the globally
        # latest write per series without a lock on the set path.
        self._gauge_seq = itertools.count(1)

    # --- shard plumbing ---

    def _shard(self) -> _Shard:
        shard = getattr(self._local, "shard", None)
        if shard is None:
            shard = self._local.shard = _Shard()
            with self._meta_lock:
                self._shards.append(shard)
        return shard

    def _series_key(self, name: str, labels: "dict[str, str] | None"):
        key = _labels_key(labels)
        if not key:
            return (name, key)
        with self._meta_lock:
            known = self._labelsets.setdefault(name, set())
            if key in known:
                return (name, key)
            if len(known) >= max(1, int(Settings.TELEMETRY_MAX_LABELSETS)):
                return (name, OVERFLOW_LABELS)
            known.add(key)
            return (name, key)

    # --- instrumentation API ---

    def counter(
        self, name: str, value: float = 1.0,
        labels: "dict[str, str] | None" = None,
    ) -> None:
        shard = self._shard()
        key = (name, _labels_key(labels))
        if key in shard.counters:  # hot path: no lock at all
            shard.counters[key] += value
            return
        key = self._series_key(name, labels)
        shard.counters[key] = shard.counters.get(key, 0.0) + value

    def gauge(
        self, name: str, value: float,
        labels: "dict[str, str] | None" = None,
    ) -> None:
        shard = self._shard()
        key = (name, _labels_key(labels))
        if key not in shard.gauges:
            key = self._series_key(name, labels)
        shard.gauges[key] = (next(self._gauge_seq), float(value))

    def observe(
        self, name: str, value: float,
        labels: "dict[str, str] | None" = None,
        buckets: "Iterable[float] | None" = None,
    ) -> None:
        shard = self._shard()
        key = (name, _labels_key(labels))
        hist = shard.hists.get(key)
        edges = self._edges(name, buckets)
        if hist is None:
            key = self._series_key(name, labels)
            # [per-bucket counts..., +inf count, sum, count]
            hist = shard.hists.get(key)
            if hist is None:
                hist = shard.hists[key] = [0] * (len(edges) + 1) + [0.0, 0]
        i = 0
        for i, edge in enumerate(edges):
            if value <= edge:
                break
        else:
            i = len(edges)
        hist[i] += 1
        hist[-2] += float(value)
        hist[-1] += 1

    def _edges(
        self, name: str, buckets: "Iterable[float] | None"
    ) -> tuple[float, ...]:
        edges = self._buckets.get(name)
        if edges is None:
            edges = tuple(sorted(buckets)) if buckets else DEFAULT_BUCKETS
            with self._meta_lock:
                edges = self._buckets.setdefault(name, edges)
        return edges

    def register_collector(
        self, fn: Callable[["MetricsRegistry"], None]
    ) -> None:
        with self._meta_lock:
            self._collectors.append(fn)

    def unregister_collector(
        self, fn: Callable[["MetricsRegistry"], None]
    ) -> None:
        with self._meta_lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    # --- fold-on-read ---

    def _run_collectors(self) -> None:
        with self._meta_lock:
            collectors = list(self._collectors)
        # OUTSIDE _meta_lock: a collector may take foreign locks
        # (BufferPool._lock), and holding ours here would create the
        # only possible lock-order edge back into the protocol.
        for fn in collectors:
            try:
                fn(self)
            except Exception:
                pass  # observability must never take a node down

    def fold(self) -> dict[str, Any]:
        """Merge every shard into
        ``{"counters": {...}, "gauges": {...}, "histograms": {...}}``
        keyed by (name, labels-tuple). Runs the collectors first."""
        self._run_collectors()
        with self._meta_lock:
            shards = list(self._shards)
        counters: dict = {}
        gauges: dict = {}  # key -> (seq, value); latest seq wins
        hists: dict = {}
        for shard in shards:
            for key, v in _retry_items(shard.counters):
                counters[key] = counters.get(key, 0.0) + v
            for key, (seq, v) in _retry_items(shard.gauges):
                cur = gauges.get(key)
                if cur is None or seq > cur[0]:
                    gauges[key] = (seq, v)
            for key, h in _retry_items(shard.hists):
                cur = hists.get(key)
                if cur is None:
                    hists[key] = list(h)
                else:
                    for i, c in enumerate(h):
                        cur[i] += c
        return {
            "counters": counters,
            "gauges": {k: v for k, (_, v) in gauges.items()},
            "histograms": hists,
        }

    def value(self, name: str, labels: "dict[str, str] | None" = None) -> float:
        """One counter's or gauge's folded value (0 when never written)."""
        folded = self.fold()
        key = (name, _labels_key(labels))
        return folded["counters"].get(key, folded["gauges"].get(key, 0.0))

    # --- export ---

    def render_prometheus(self) -> str:
        """Prometheus text exposition of the folded registry."""

        def fmt_labels(key) -> str:
            _, labels = key
            if not labels:
                return ""
            inner = ",".join(f'{k}="{v}"' for k, v in labels)
            return "{" + inner + "}"

        folded = self.fold()
        lines: list[str] = []
        typed: set[str] = set()

        def type_line(name: str, kind: str) -> None:
            if name not in typed:
                typed.add(name)
                lines.append(f"# TYPE {name} {kind}")

        for key in sorted(folded["counters"]):
            name = key[0]
            type_line(name, "counter")
            lines.append(f"{name}{fmt_labels(key)} {folded['counters'][key]:g}")
        for key in sorted(folded["gauges"]):
            name = key[0]
            type_line(name, "gauge")
            lines.append(f"{name}{fmt_labels(key)} {folded['gauges'][key]:g}")
        for key in sorted(folded["histograms"]):
            name = key[0]
            type_line(name, "histogram")
            edges = self._buckets.get(name, DEFAULT_BUCKETS)
            h = folded["histograms"][key]
            _, labels = key
            cum = 0
            for i, edge in enumerate(edges):
                cum += h[i]
                le = tuple(list(labels) + [("le", f"{edge:g}")])
                lines.append(f"{name}_bucket{fmt_labels((name, le))} {cum}")
            cum += h[len(edges)]
            le = tuple(list(labels) + [("le", "+Inf")])
            lines.append(f"{name}_bucket{fmt_labels((name, le))} {cum}")
            lines.append(f"{name}_sum{fmt_labels(key)} {h[-2]:g}")
            lines.append(f"{name}_count{fmt_labels(key)} {h[-1]}")
        return "\n".join(lines) + "\n"

    def dump_json(self) -> str:
        """The folded registry as a JSON document (labels flattened to
        ``name{k=v,...}`` series names)."""

        def series(key) -> str:
            name, labels = key
            if not labels:
                return name
            return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"

        folded = self.fold()
        return json.dumps(
            {
                "counters": {series(k): v for k, v in folded["counters"].items()},
                "gauges": {series(k): v for k, v in folded["gauges"].items()},
                "histograms": {
                    series(k): {
                        "buckets": list(self._buckets.get(k[0], DEFAULT_BUCKETS)),
                        "counts": h[:-2],
                        "sum": h[-2],
                        "count": h[-1],
                    }
                    for k, h in folded["histograms"].items()
                },
                "wall_anchor": WALL_ANCHOR,
            },
            sort_keys=True,
        )

    @classmethod
    def merge(
        cls,
        *registries: "MetricsRegistry",
        names: "Iterable[str] | None" = None,
    ) -> "MetricsRegistry":
        """One registry holding every input registry's folded series —
        the FLEET view (``tools/traceview.py --fleet`` renders it):
        counters sum, gauges take the later registry's value, and
        histograms with matching bucket edges sum elementwise
        (mismatched edges keep the first registry's series — merging
        counts across different edges would fabricate observations).

        ``names`` (one per registry) labels every series from registry
        i with ``origin=<name>``, so per-node registries that never
        labeled their own series stay distinguishable in the merged
        Prometheus/JSON view."""
        name_list = list(names) if names is not None else None
        if name_list is not None and len(name_list) != len(registries):
            raise ValueError(
                f"{len(name_list)} names for {len(registries)} registries"
            )
        merged = cls()
        shard = merged._shard()
        for i, reg in enumerate(registries):
            tag = (
                ()
                if name_list is None
                else (("origin", str(name_list[i])),)
            )

            def key_of(key):
                name, labels = key
                if not tag:
                    return key
                return (name, tuple(sorted(tuple(labels) + tag)))

            folded = reg.fold()
            for key, v in folded["counters"].items():
                k = key_of(key)
                shard.counters[k] = shard.counters.get(k, 0.0) + v
            for key, v in folded["gauges"].items():
                shard.gauges[key_of(key)] = (
                    next(merged._gauge_seq), float(v),
                )
            for key, h in folded["histograms"].items():
                k = key_of(key)
                edges = reg._buckets.get(key[0], DEFAULT_BUCKETS)
                known = merged._buckets.setdefault(key[0], edges)
                cur = shard.hists.get(k)
                if cur is None and known == edges:
                    shard.hists[k] = list(h)
                elif cur is not None and known == edges and len(cur) == len(h):
                    for j, c in enumerate(h):
                        cur[j] += c
        return merged

    def reset(self) -> None:
        """Drop all recorded series (tests / bench A-B runs). Shards
        registered by live threads are emptied, not discarded — the
        thread-local pointers stay valid."""
        with self._meta_lock:
            for shard in self._shards:
                shard.counters.clear()
                shard.gauges.clear()
                shard.hists.clear()
            self._labelsets.clear()
            self._buckets = {}


class FlightRecorder:
    """Bounded per-node ring of spans/events — the post-mortem buffer.

    Every entry is a plain dict (msgpack/JSON-safe): spans are
    ``{"kind": "span", "name", "node", "trace", "span", "t0", "t1",
    ...attrs}``, events ``{"kind": "event", "name", "node", "trace",
    "t", ...attrs}`` — timestamps are ``time.monotonic()`` seconds
    (dumps carry :data:`WALL_ANCHOR` for cross-process merges)."""

    def __init__(self) -> None:
        self._lock = make_lock("FlightRecorder._lock")
        # guarded-by: _lock
        self._rings: dict[str, deque] = {}

    def record(self, node: str, entry: dict) -> None:
        with self._lock:
            ring = self._rings.get(node)
            if ring is None:
                ring = self._rings[node] = deque(
                    maxlen=max(1, int(Settings.TELEMETRY_RING))
                )
            ring.append(entry)

    def snapshot(self, node: Optional[str] = None) -> list[dict]:
        """Events for one node (or all nodes, time-ordered)."""
        with self._lock:
            if node is not None:
                return list(self._rings.get(node, ()))
            merged = [e for ring in self._rings.values() for e in ring]
        merged.sort(key=lambda e: e.get("t0", e.get("t", 0.0)))
        return merged

    def nodes(self) -> list[str]:
        with self._lock:
            return sorted(self._rings)

    def clear(self, node: Optional[str] = None) -> None:
        with self._lock:
            if node is None:
                self._rings.clear()
            else:
                self._rings.pop(node, None)

    def dump(self, node: str, reason: str) -> "str | None":
        """Flush one node's ring: always logs the event count, and —
        when ``Settings.TELEMETRY_DUMP_DIR`` is set — writes
        ``flight-<node>-<reason>.json`` there and returns its path.
        The dump document is what ``tools/traceview.py`` consumes."""
        events = self.snapshot(node)
        directory = Settings.TELEMETRY_DUMP_DIR
        if not directory or not events:
            return None
        os.makedirs(directory, exist_ok=True)
        safe = "".join(c if c.isalnum() or c in "-._" else "_" for c in node)
        path = os.path.join(directory, f"flight-{safe}-{reason}.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(
                {
                    "node": node,
                    "reason": reason,
                    "wall_anchor": WALL_ANCHOR,
                    "events": events,
                },
                f,
            )
        return path

    def dump_all(self, reason: str) -> list[str]:
        return [
            p for n in self.nodes() if (p := self.dump(n, reason)) is not None
        ]


#: Process-wide singletons (one federation per process in every
#: simulation mode — same scope rationale as concurrency.lock_graph).
#: Exposed to the rest of tpfl_torch as ``logger.metrics`` / the tracing
#: module's recorder; import them from here only inside management.
metrics = MetricsRegistry()
flight = FlightRecorder()
