"""Fleet observatory, the part the simulation plane calls — the port of
:mod:`tpfl.management.fleetobs`'s population observatory and live-view
gauges.

- :func:`population_round` fans one committed round of a
  :class:`~tpfl_torch.parallel.population.ClientPopulation` (census
  coverage, participation fairness, straggler cutoff, staleness gaps)
  into ``tpfl_pop_*`` series of the process registry and one
  ``population_round`` flight event, as the reference does.
- :func:`register_view` / :func:`register_population` hold weak
  references to the membership views and populations attached to an
  engine; :func:`emit_fleet_gauges` samples them into gauges.

The rest of the reference's module — cross-host snapshots and their fold
(:func:`snapshot`, :func:`fold`, ...), the snapshot publisher and the SLO
watchdog — is the observatory remainder of ``ROADMAP.md`` §1 item 5: each
entry point raises ``NotImplementedError`` naming it.
"""

from __future__ import annotations

import time
import weakref
from typing import Any, Iterable

from tpfl_torch.concurrency import make_lock
from tpfl_torch.exceptions import SIMULATION_ITEM, not_ported
from tpfl_torch.management.telemetry import flight, metrics

__all__ = [
    "DETERMINISTIC_PREFIXES",
    "FleetPublisher",
    "POP_STALENESS_BUCKETS",
    "SLOWatchdog",
    "emit_fleet_gauges",
    "fleet_from_dir",
    "fold",
    "fold_receipts",
    "load_fleet_dir",
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


# --- the observatory remainder (ROADMAP.md §1 item 5) ---------------------


def _remainder(what: str) -> NotImplementedError:
    return not_ported(f"management.fleetobs.{what} (the fleet observatory)", SIMULATION_ITEM)


def snapshot(*args: Any, **kwargs: Any) -> dict:
    raise _remainder("snapshot")


def registry_from_snapshot(*args: Any, **kwargs: Any) -> Any:
    raise _remainder("registry_from_snapshot")


def fold(*args: Any, **kwargs: Any) -> Any:
    raise _remainder("fold")


def fold_receipts(*args: Any, **kwargs: Any) -> Any:
    raise _remainder("fold_receipts")


def load_fleet_dir(*args: Any, **kwargs: Any) -> list:
    raise _remainder("load_fleet_dir")


def fleet_from_dir(*args: Any, **kwargs: Any) -> Any:
    raise _remainder("fleet_from_dir")


def parse_targets(*args: Any, **kwargs: Any) -> list:
    raise _remainder("parse_targets")


class FleetPublisher:
    def __init__(self, *args: Any, **kwargs: Any) -> None:
        raise _remainder("FleetPublisher")


class SLOTarget:
    def __init__(self, *args: Any, **kwargs: Any) -> None:
        raise _remainder("SLOTarget")


class SLOWatchdog:
    def __init__(self, *args: Any, **kwargs: Any) -> None:
        raise _remainder("SLOWatchdog")
