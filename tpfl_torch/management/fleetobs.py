"""Fleet observatory — the port of :mod:`tpfl.management.fleetobs`:
cross-process metric federation, population-plane telemetry and the
live SLO watchdog.

1. **Cross-process federation.** :func:`snapshot` folds a process'
   :class:`~tpfl_torch.management.telemetry.MetricsRegistry` into a
   JSON-safe document; :func:`fold` rebuilds one registry per snapshot
   and merges them (``origin=<rank>`` on every series) into one fleet
   registry, which ``MetricsHTTPServer`` serves at ``/fleet.json``.
   Snapshots travel in worker receipts (:func:`fold_receipts`) or as
   ``fleetsnap-<origin>.json`` files that :class:`FleetPublisher` writes
   every ``Settings.FLEETOBS_SNAPSHOT_PERIOD`` seconds into
   ``Settings.FLEETOBS_DIR`` (:func:`fleet_from_dir`). A snapshot
   restricted to :data:`DETERMINISTIC_PREFIXES` renders byte-identically
   across same-seed runs.
2. **Population observatory.** :func:`population_round` fans one
   committed round of a
   :class:`~tpfl_torch.parallel.population.ClientPopulation` (census
   coverage, participation fairness, straggler cutoff, staleness gaps)
   into ``tpfl_pop_*`` series and one ``population_round`` flight event.
3. **Live SLO watchdog.** :class:`SLOWatchdog` evaluates
   ``Settings.SLO_TARGETS`` (``rate(counter) / gauge(name) / ratio(a,
   b)`` against a threshold) over the live registry, EWMA-smoothed
   (``Settings.SLO_EWMA``); ``Settings.SLO_BREACH_WINDOWS`` consecutive
   violations fire one ``slo_breach`` flight event and bump
   ``tpfl_slo_breach_total`` — the verdict behind ``/healthz``.

:func:`register_view` / :func:`register_population` hold weak references
to the membership views and populations attached to an engine;
:func:`emit_fleet_gauges` samples them (``NodeMonitor``'s cadence).
Host-side dict and numpy work only; snapshot writes are tmp + rename, so
a concurrent fold never reads a torn document.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
import weakref
from typing import Any, Callable, Iterable

from tpfl_torch.concurrency import make_lock
from tpfl_torch.management.telemetry import (
    DEFAULT_BUCKETS,
    WALL_ANCHOR,
    MetricsRegistry,
    flight,
    metrics,
)
from tpfl_torch.settings import Settings

__all__ = [
    "DETERMINISTIC_PREFIXES",
    "FleetPublisher",
    "POP_STALENESS_BUCKETS",
    "SLOTarget",
    "SLOWatchdog",
    "emit_fleet_gauges",
    "fleet_from_dir",
    "fold",
    "fold_receipts",
    "load_fleet_dir",
    "parse_targets",
    "population_round",
    "register_population",
    "register_view",
    "registry_from_snapshot",
    "round_sig",
    "snapshot",
]

#: Series-name prefixes whose values are pure functions of a seeded run.
DETERMINISTIC_PREFIXES: tuple[str, ...] = ("tpfl_engine_", "tpfl_pop_", "tpfl_slo_")

#: Staleness-gap buckets (rounds since a client last folded) of the
#: ``tpfl_pop_staleness`` histogram.
POP_STALENESS_BUCKETS: tuple[float, ...] = (
    0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
)


# --- snapshot / fold: the cross-process federation ----------------------


def _series_name(key: "tuple[str, tuple]") -> str:
    """``(name, labels)`` → the flattened ``name{k=v,...}`` form of
    ``MetricsRegistry.dump_json`` (parsed back by :func:`_parse_series`).
    Label keys and values hold no ``,`` ``=`` ``{`` ``}``."""
    name, labels = key
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


def _parse_series(series: str) -> "tuple[str, tuple[tuple[str, str], ...]]":
    name, brace, rest = series.partition("{")
    if not brace:
        return name, ()
    labels = []
    for item in rest.rstrip("}").split(","):
        k, _, v = item.partition("=")
        labels.append((k, v))
    return name, tuple(sorted(labels))


def snapshot(registry: "MetricsRegistry | None" = None, origin: str = "",
             prefixes: "Iterable[str] | None" = None) -> dict:
    """One process' registry as a JSON-safe fleet-snapshot document.
    ``prefixes`` keeps the series whose name starts with one of them
    (None: all; :data:`DETERMINISTIC_PREFIXES` for receipts compared
    byte for byte across same-seed runs). Histograms ship their raw
    ``[bucket counts..., +inf, sum, count]`` row and their bucket edges,
    so :func:`registry_from_snapshot` rebuilds them exactly."""
    reg = registry if registry is not None else metrics
    pref = tuple(prefixes) if prefixes is not None else None

    def keep(name: str) -> bool:
        return pref is None or any(name.startswith(p) for p in pref)

    folded = reg.fold()
    hists = {_series_name(k): [float(c) for c in h]
             for k, h in folded["histograms"].items() if keep(k[0])}
    buckets = {k[0]: [float(e) for e in reg._buckets.get(k[0], DEFAULT_BUCKETS)]
               for k in folded["histograms"] if keep(k[0])}
    return {
        "origin": str(origin),
        "counters": {_series_name(k): float(v) for k, v in folded["counters"].items()
                     if keep(k[0])},
        "gauges": {_series_name(k): float(v) for k, v in folded["gauges"].items()
                   if keep(k[0])},
        "histograms": hists,
        "buckets": buckets,
        "wall_anchor": WALL_ANCHOR,
    }


def registry_from_snapshot(snap: dict) -> MetricsRegistry:
    """A live :class:`MetricsRegistry` rebuilt from a :func:`snapshot`
    document (series in one shard, bucket edges restored so merged
    histograms stay compatible)."""
    reg = MetricsRegistry()
    shard = reg._shard()
    for series, v in (snap.get("counters") or {}).items():
        shard.counters[_parse_series(series)] = float(v)
    for series, v in (snap.get("gauges") or {}).items():
        shard.gauges[_parse_series(series)] = (next(reg._gauge_seq), float(v))
    for name, edges in (snap.get("buckets") or {}).items():
        reg._buckets[name] = tuple(float(e) for e in edges)
    for series, h in (snap.get("histograms") or {}).items():
        shard.hists[_parse_series(series)] = [int(c) for c in h[:-2]] + [float(h[-2]),
                                                                          int(h[-1])]
    return reg


def fold(snapshots: Iterable[dict]) -> MetricsRegistry:
    """Snapshot documents merged into one fleet registry
    (``MetricsRegistry.merge``): every series gains ``origin=<snapshot
    origin>``, counters sum, gauges take the later value, histograms
    with equal edges sum. Snapshots fold in origin order, so the merged
    view is a function of the snapshot set, whatever the arrival order."""
    snaps = sorted(snapshots, key=lambda s: str(s.get("origin", "")))
    return MetricsRegistry.merge(*(registry_from_snapshot(s) for s in snaps),
                                 names=[str(s.get("origin", "")) for s in snaps])


def fold_receipts(results: Iterable[dict]) -> MetricsRegistry:
    """The ``metrics_snapshot`` documents of worker receipts folded into
    the fleet registry (ranks without one contribute nothing)."""
    return fold(r["metrics_snapshot"] for r in results
                if isinstance(r.get("metrics_snapshot"), dict))


def load_fleet_dir(directory: str) -> list[dict]:
    """Every ``fleetsnap-*.json`` under ``directory`` (the
    :class:`FleetPublisher` drop point); unreadable or torn files are
    skipped, never fatal."""
    snaps: list[dict] = []
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return snaps
    for fname in names:
        if not (fname.startswith("fleetsnap-") and fname.endswith(".json")):
            continue
        try:
            with open(os.path.join(directory, fname), encoding="utf-8") as f:
                doc = json.load(f)
            if isinstance(doc, dict):
                snaps.append(doc)
        except (OSError, ValueError):
            continue
    return snaps


def fleet_from_dir(directory: "str | None" = None) -> MetricsRegistry:
    """Every published snapshot in ``directory`` (default
    ``Settings.FLEETOBS_DIR``) merged into one fleet registry."""
    d = directory if directory is not None else Settings.FLEETOBS_DIR
    return fold(load_fleet_dir(d) if d else ())


class FleetPublisher(threading.Thread):
    """Every ``Settings.FLEETOBS_SNAPSHOT_PERIOD`` seconds, snapshot this
    process' registry into ``fleetsnap-<origin>.json`` under
    ``Settings.FLEETOBS_DIR`` (tmp + rename). :meth:`publish_once` is
    the thread-free unit; a period of 0 publishes once and ends."""

    def __init__(self, origin: str, directory: "str | None" = None,
                 period: "float | None" = None, registry: "MetricsRegistry | None" = None,
                 prefixes: "Iterable[str] | None" = None) -> None:
        safe = "".join(c if c.isalnum() or c in "-._" else "_" for c in str(origin))
        super().__init__(daemon=True, name=f"fleet-publisher-{safe}")
        self._origin = str(origin)
        self._safe = safe
        self._directory = directory
        self._period = period
        self._registry = registry
        self._prefixes = tuple(prefixes) if prefixes is not None else None
        self._running = threading.Event()
        self._running.set()

    def publish_once(self) -> "str | None":
        directory = self._directory if self._directory is not None else Settings.FLEETOBS_DIR
        if not directory:
            return None
        os.makedirs(directory, exist_ok=True)
        doc = snapshot(self._registry, origin=self._origin, prefixes=self._prefixes)
        path = os.path.join(directory, f"fleetsnap-{self._safe}.json")
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, sort_keys=True)
        os.replace(tmp, path)
        return path

    def stop(self) -> None:
        self._running.clear()

    def run(self) -> None:
        while self._running.is_set():
            try:
                self.publish_once()
            except Exception:
                pass  # observability never takes a node down
            period = (self._period if self._period is not None
                      else float(Settings.FLEETOBS_SNAPSHOT_PERIOD))
            if period <= 0:
                return
            deadline = time.monotonic() + period
            while self._running.is_set():
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                time.sleep(min(left, 0.2))  # stop() lands within ~0.2 s


# --- population observatory ---------------------------------------------


def population_round(
    node: str,
    *,
    round: int,
    census: int,
    sampled: int,
    folded: int,
    cut: int,
    touched: int,
    coverage: float,
    fairness: float,
    staleness: "Iterable[float]" = (),
) -> None:
    """Fan one committed population round's sketch out into the registry
    and the flight ring (``ClientPopulation.complete_round`` calls it):
    the ``tpfl_pop_census`` / ``_touched`` / ``_round`` / ``_coverage`` /
    ``_fairness`` / ``_cutoff_frac`` gauges, the ``tpfl_pop_folded_total``
    and ``tpfl_pop_cutoff_total`` counters, the ``tpfl_pop_staleness``
    histogram (rounds since each folding client last folded) and one
    ``population_round`` event."""
    labels = {"node": node}
    metrics.gauge("tpfl_pop_census", float(census), labels=labels)
    metrics.gauge("tpfl_pop_touched", float(touched), labels=labels)
    metrics.gauge("tpfl_pop_round", float(round), labels=labels)
    metrics.gauge("tpfl_pop_coverage", float(coverage), labels=labels)
    metrics.gauge("tpfl_pop_fairness", float(fairness), labels=labels)
    metrics.counter("tpfl_pop_folded_total", float(folded), labels=labels)
    if cut:
        metrics.counter("tpfl_pop_cutoff_total", float(cut), labels=labels)
    metrics.gauge("tpfl_pop_cutoff_frac", float(cut) / max(float(sampled), 1.0), labels=labels)
    for gap in staleness:
        metrics.observe("tpfl_pop_staleness", float(gap), labels=labels,
                        buckets=POP_STALENESS_BUCKETS)
    flight.record(node, {
        "kind": "event",
        "name": "population_round",
        "node": node,
        "trace": "",
        "t": time.monotonic(),
        "round": int(round),
        "census": int(census),
        "sampled": int(sampled),
        "folded": int(folded),
        "cut": int(cut),
        "touched": int(touched),
        "coverage": round_sig(coverage),
        "fairness": round_sig(fairness),
    })


def round_sig(x: float, digits: int = 6) -> float:
    """Round for event payloads (six digits keep dumps stable)."""
    return round(float(x), digits)


# --- live-view gauges -----------------------------------------------------

_meta_lock = make_lock("fleetobs._meta_lock")
# guarded-by: _meta_lock
_views: "weakref.WeakSet[Any]" = weakref.WeakSet()
# guarded-by: _meta_lock
_populations: "weakref.WeakSet[Any]" = weakref.WeakSet()


def register_view(view: Any) -> None:
    """Weakly register an attached MembershipView for
    :func:`emit_fleet_gauges` (``FederationEngine.attach_membership``)."""
    if view is None:
        return
    with _meta_lock:
        _views.add(view)


def register_population(population: Any) -> None:
    """Weakly register an attached ClientPopulation for census / touched
    gauges (``FederationEngine.attach_population``)."""
    if population is None:
        return
    with _meta_lock:
        _populations.add(population)


def emit_fleet_gauges(node: str) -> None:
    """Sample every live membership view (capacity, live, quarantined,
    fill) and population (census, touched) into gauges labelled
    ``node``: host attribute reads only."""
    with _meta_lock:
        views = list(_views)
        pops = list(_populations)
    labels = {"node": node}
    for view in views:
        try:
            capacity = float(view.capacity)
            live_attr = view.live
            live = float(live_attr() if callable(live_attr) else live_attr)
            metrics.gauge("tpfl_membership_capacity", capacity, labels=labels)
            metrics.gauge("tpfl_membership_live", live, labels=labels)
            metrics.gauge("tpfl_membership_quarantined", float(len(view.quarantined())),
                          labels=labels)
            metrics.gauge("tpfl_membership_fill", live / max(capacity, 1.0), labels=labels)
        except Exception:
            continue
    for pop in pops:
        try:
            metrics.gauge("tpfl_pop_census", float(pop.registered), labels=labels)
            metrics.gauge("tpfl_pop_touched", float(pop.touched), labels=labels)
        except Exception:
            continue


# --- live SLO watchdog ----------------------------------------------------

_CLAUSE_RE = re.compile(
    r"^\s*(rate|gauge|ratio)\s*\(\s*([A-Za-z_][\w:]*)\s*"
    r"(?:,\s*([A-Za-z_][\w:]*)\s*)?\)\s*(<=|>=|<|>)\s*"
    r"([-+]?[0-9.][0-9.eE+-]*)\s*$"
)

_OPS: dict[str, Callable[[float, float], bool]] = {
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}


class SLOTarget:
    """One parsed ``Settings.SLO_TARGETS`` clause and its online state
    (EWMA signal, breach streak), mutated only by its watchdog's
    :meth:`SLOWatchdog.evaluate`."""

    __slots__ = (
        "kind", "metric", "metric_b", "op", "threshold", "key",
        "ewma", "streak", "breached", "evaluations",
        "_last_value", "_last_value_b", "_last_t",
    )

    def __init__(self, kind: str, metric: str, metric_b: "str | None", op: str,
                 threshold: float) -> None:
        self.kind = kind
        self.metric = metric
        self.metric_b = metric_b
        self.op = op
        self.threshold = float(threshold)
        inner = metric if metric_b is None else f"{metric},{metric_b}"
        self.key = f"{kind}({inner}){op}{threshold:g}"
        self.ewma: "float | None" = None
        self.streak = 0
        self.breached = False
        self.evaluations = 0
        self._last_value: "float | None" = None
        self._last_value_b: "float | None" = None
        self._last_t: "float | None" = None

    def verdict(self) -> dict:
        healthy = True
        if self.ewma is not None:
            healthy = _OPS[self.op](self.ewma, self.threshold)
        return {
            "target": self.key,
            "kind": self.kind,
            "metric": self.metric,
            "op": self.op,
            "threshold": self.threshold,
            "signal": None if self.ewma is None else round(self.ewma, 6),
            "healthy": bool(healthy),
            "breached": bool(self.breached),
            "evaluations": int(self.evaluations),
        }


def parse_targets(spec: "str | None" = None) -> list[SLOTarget]:
    """Parse the ``Settings.SLO_TARGETS`` grammar (``;``-separated
    ``rate(c) / gauge(g) / ratio(a, b)`` clauses against a threshold);
    ``ValueError`` names a clause that does not parse."""
    text = Settings.SLO_TARGETS if spec is None else spec
    targets: list[SLOTarget] = []
    for clause in str(text or "").split(";"):
        if not clause.strip():
            continue
        m = _CLAUSE_RE.match(clause)
        if m is None:
            raise ValueError(
                f"unparseable SLO clause {clause.strip()!r} (grammar: "
                "'rate(counter) | gauge(name) | ratio(a, b)  <op>  "
                "<number>', clauses ';'-separated)"
            )
        kind, a, b, op, value = m.groups()
        if kind == "ratio" and b is None:
            raise ValueError(f"SLO ratio clause {clause.strip()!r} needs two metrics")
        if kind != "ratio" and b is not None:
            raise ValueError(f"SLO {kind} clause {clause.strip()!r} takes one metric")
        targets.append(SLOTarget(kind, a, b, op, float(value)))
    return targets


def _metric_totals(folded: dict) -> "tuple[dict[str, float], dict[str, float]]":
    """(counter totals, gauge totals) summed over the label sets of each
    metric name: an SLO is a fleet-level statement."""
    counters: dict[str, float] = {}
    for (name, _), v in folded["counters"].items():
        counters[name] = counters.get(name, 0.0) + float(v)
    gauges: dict[str, float] = {}
    for (name, _), v in folded["gauges"].items():
        gauges[name] = gauges.get(name, 0.0) + float(v)
    return counters, gauges


class SLOWatchdog:
    """Online breach detection over live registry series.

    :meth:`evaluate` is one window: each target's signal from the folded
    registry (counter rates and counter ratios are deltas between
    evaluations, so the first window only warms them), EWMA-smoothed
    (``Settings.SLO_EWMA``); ``Settings.SLO_BREACH_WINDOWS`` consecutive
    violations fire one ``slo_breach`` flight event and one
    ``tpfl_slo_breach_total{target}`` bump, re-armed when the target
    recovers. ``now`` is injectable for deterministic windows;
    :meth:`start` evaluates on a named daemon thread; ``/healthz`` reads
    :meth:`healthy` / :meth:`verdicts`."""

    def __init__(self, targets: "str | list[SLOTarget] | None" = None,
                 registry: "MetricsRegistry | None" = None,
                 node: str = "fleet-watchdog") -> None:
        self._registry = registry if registry is not None else metrics
        self._node = node
        self._lock = make_lock("SLOWatchdog._lock")
        # guarded-by: _lock
        self._targets = list(targets) if isinstance(targets, list) else parse_targets(targets)
        self._thread: "threading.Thread | None" = None
        self._running = threading.Event()

    def evaluate(self, now: "float | None" = None) -> list[dict]:
        """One watchdog window; returns the per-target verdicts. The
        breach side effects run outside the watchdog's lock."""
        t = time.monotonic() if now is None else float(now)
        counters, gauges = _metric_totals(self._registry.fold())
        alpha = min(max(float(Settings.SLO_EWMA), 1e-6), 1.0)
        need = max(1, int(Settings.SLO_BREACH_WINDOWS))
        breaches: list[dict] = []
        out: list[dict] = []
        with self._lock:
            for tgt in self._targets:
                signal = self._signal(tgt, counters, gauges, t)
                if signal is None:
                    out.append(tgt.verdict())
                    continue
                tgt.evaluations += 1
                tgt.ewma = signal if tgt.ewma is None else alpha * signal + (1.0 - alpha) * tgt.ewma
                if _OPS[tgt.op](tgt.ewma, tgt.threshold):
                    tgt.streak = 0
                    tgt.breached = False
                else:
                    tgt.streak += 1
                    if tgt.streak >= need and not tgt.breached:
                        tgt.breached = True
                        breaches.append({"target": tgt.key, "signal": round(tgt.ewma, 6),
                                         "threshold": tgt.threshold, "windows": tgt.streak})
                out.append(tgt.verdict())
        for b in breaches:
            metrics.counter("tpfl_slo_breach_total", labels={"target": b["target"]})
            flight.record(self._node, {"kind": "event", "name": "slo_breach", "node": self._node,
                                       "trace": "", "t": t, **b})
        return out

    def _signal(self, tgt: SLOTarget, counters: "dict[str, float]",
                gauges: "dict[str, float]", t: float) -> "float | None":
        if tgt.kind == "gauge":
            return gauges.get(tgt.metric)
        cur = counters.get(tgt.metric)
        if cur is None:
            return None
        if tgt.kind == "rate":
            last_v, last_t = tgt._last_value, tgt._last_t
            tgt._last_value, tgt._last_t = cur, t
            if last_v is None or last_t is None or t <= last_t:
                return None
            return (cur - last_v) / (t - last_t)
        # ratio(a, b): delta(a) / delta(b) between evaluations; a window
        # without progress of b gives no signal.
        cur_b = counters.get(tgt.metric_b or "")
        last_v, last_b = tgt._last_value, tgt._last_value_b
        tgt._last_value, tgt._last_value_b = cur, cur_b
        if cur_b is None or last_v is None or last_b is None:
            return None
        db = cur_b - last_b
        if db <= 0:
            return None
        return (cur - last_v) / db

    def verdicts(self) -> list[dict]:
        with self._lock:
            return [t.verdict() for t in self._targets]

    def healthy(self) -> bool:
        """False only while a target is in breach (a warming-up target
        counts healthy)."""
        with self._lock:
            return not any(t.breached for t in self._targets)

    def start(self, period: float = 5.0) -> None:
        """Evaluate every ``period`` seconds on a named daemon thread."""
        if self._thread is not None:
            return
        self._running.set()

        def loop() -> None:
            while self._running.is_set():
                try:
                    self.evaluate()
                except Exception:
                    pass  # observability never takes a node down
                deadline = time.monotonic() + max(float(period), 0.05)
                while self._running.is_set():
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    time.sleep(min(left, 0.2))

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name=f"slo-watchdog-{self._node}")
        self._thread.start()

    def stop(self) -> None:
        self._running.clear()
        if self._thread is not None:
            self._thread.join(timeout=3)
            self._thread = None
