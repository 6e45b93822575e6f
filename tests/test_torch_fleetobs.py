"""The part of the fleet observatory the simulation plane calls
(tpfl_torch.management.fleetobs) against the JAX package's, on the CPU:
the population and view scenarios of ``tests/test_fleetobs.py``.

- ``population_round``'s ``tpfl_pop_*`` series and ``population_round``
  event equal the JAX package's for the same arguments, and
  ``tools/traceview.py --population`` joins the port's event with a
  quarantine verdict as it joins the reference's;
- ``ClientPopulation.complete_round`` emits the series;
- ``emit_fleet_gauges`` over fake and real membership views and
  populations, the same gauges as the JAX package's;
- the engine's ``attach_membership`` / ``attach_population`` register
  their view and population.

The cross-process federation, the publisher and the SLO watchdog are
held to the JAX package in ``tests/test_torch_fleetobs_remainder.py``.
"""

import pytest
import torch

from tpfl.management import fleetobs as jax_fleetobs
from tpfl.management.telemetry import flight as jax_flight
from tpfl.management.telemetry import metrics as jax_metrics
from tpfl.parallel.membership import MembershipView as JaxView
from tpfl_torch.management import fleetobs
from tpfl_torch.management.telemetry import flight, metrics
from tpfl_torch.models import MLP
from tpfl_torch.parallel import ClientPopulation, FederationEngine
from tpfl_torch.parallel.membership import MembershipView

POP = (("node", "population"),)


@pytest.fixture(autouse=True)
def _clean():
    for reg in (metrics, jax_metrics):
        reg.reset()
    for ring in (flight, jax_flight):
        ring.clear()
    for mod in (fleetobs, jax_fleetobs):
        with mod._meta_lock:
            mod._views.clear()
            mod._populations.clear()
    yield


def _series(folded, prefix):
    return {kind: {k: v for k, v in folded[kind].items() if k[0].startswith(prefix)}
            for kind in ("counters", "gauges", "histograms")}


def _events(ring, node):
    return [{k: v for k, v in e.items() if k != "t"} for e in ring.snapshot(node)
            if e.get("name") == "population_round"]


def test_population_round_fanout_and_traceview_join():
    from tools.traceview import build_timeline, population_report, render_population

    kw = dict(round=3, census=1000, sampled=10, folded=7, cut=3, touched=42, coverage=0.05,
              fairness=0.9, staleness=[0.0, 1.0, 4.0])
    fleetobs.population_round("population", **kw)
    jax_fleetobs.population_round("population", **kw)
    folded = metrics.fold()
    assert folded["gauges"][("tpfl_pop_coverage", POP)] == 0.05
    assert folded["gauges"][("tpfl_pop_cutoff_frac", POP)] == 0.3
    assert folded["histograms"][("tpfl_pop_staleness", POP)][-1] >= 3
    assert _series(folded, "tpfl_pop_") == _series(jax_metrics.fold(), "tpfl_pop_")
    assert _events(flight, "population") == _events(jax_flight, "population")
    events = [dict(e) for e in flight.snapshot("population")]
    assert events[-1]["fairness"] == 0.9
    events.append({"kind": "event", "name": "quarantine", "node": "a", "trace": "", "t": 1.0,
                   "peer": "evil", "round": 3})
    rows = population_report(build_timeline(events))
    assert rows[-1]["round"] == 3 and rows[-1]["actions"] == ["quarantine:evil"]
    text = render_population(build_timeline(events))
    assert "quarantine:evil" in text and "0.0500" in text


def test_complete_round_emits_population_series():
    from tpfl.parallel.population import ClientPopulation as JaxPopulation

    for cls in (ClientPopulation, JaxPopulation):
        pop = cls(registered=512, sample=8, seed=3)
        ids = pop.begin_round()
        w = pop.round_weights(ids, cutoff_frac=0.25)
        pop.complete_round(ids, weights=w)
    folded = metrics.fold()
    assert folded["gauges"][("tpfl_pop_census", POP)] == 512.0
    assert folded["gauges"][("tpfl_pop_coverage", POP)] == pytest.approx(8 / 512)
    events = _events(flight, "population")
    assert events[-1]["sampled"] == 8 and events[-1]["cut"] == int((w <= 0).sum())
    assert events == _events(jax_flight, "population")
    assert _series(folded, "tpfl_pop_") == _series(jax_metrics.fold(), "tpfl_pop_")


def test_emit_fleet_gauges_from_registered_views():
    class FakeView:
        capacity = 8

        def live(self):
            return 5

        def quarantined(self):
            return {"bad-node"}

    class FakePop:
        registered = 1000
        touched = 17

    view, pop = FakeView(), FakePop()
    for mod in (fleetobs, jax_fleetobs):
        mod.register_view(view)
        mod.register_population(pop)
    fleetobs.emit_fleet_gauges("mon-node")
    jax_fleetobs.emit_fleet_gauges("mon-node")
    folded = metrics.fold()
    labels = (("node", "mon-node"),)
    assert folded["gauges"][("tpfl_membership_capacity", labels)] == 8.0
    assert folded["gauges"][("tpfl_membership_live", labels)] == 5.0
    assert folded["gauges"][("tpfl_membership_quarantined", labels)] == 1.0
    assert folded["gauges"][("tpfl_membership_fill", labels)] == 5 / 8
    assert folded["gauges"][("tpfl_pop_touched", labels)] == 17.0
    want = jax_metrics.fold()["gauges"]
    assert {k: v for k, v in folded["gauges"].items() if k[1] == labels} == {
        k: v for k, v in want.items() if k[1] == labels}
    # Weak registration: a dead view drops out, and the emit never raises.
    del view, pop
    fleetobs.emit_fleet_gauges("mon-node")


def test_emit_fleet_gauges_reads_real_membership_view():
    """The real view's ``live`` is a property: the same gauges as the JAX
    package's real view."""
    view, jview = (cls([f"n{i}" for i in range(5)]) for cls in (MembershipView, JaxView))
    view.quarantine("n4")
    jview.quarantine("n4")
    fleetobs.register_view(view)
    jax_fleetobs.register_view(jview)
    fleetobs.emit_fleet_gauges("mon-real")
    jax_fleetobs.emit_fleet_gauges("mon-real")
    folded = metrics.fold()
    labels = (("node", "mon-real"),)
    assert folded["gauges"][("tpfl_membership_capacity", labels)] == float(view.capacity)
    assert folded["gauges"][("tpfl_membership_live", labels)] == 5.0
    assert folded["gauges"][("tpfl_membership_quarantined", labels)] == 1.0
    want = jax_metrics.fold()["gauges"]
    assert {k: v for k, v in folded["gauges"].items() if k[1] == labels} == {
        k: v for k, v in want.items() if k[1] == labels}


def test_engine_attach_registers_with_fleetobs():
    eng = FederationEngine(MLP(hidden_sizes=(4,), out_channels=10, compute_dtype=torch.float32),
                           4, seed=0, device="cpu")
    view = MembershipView([f"n{i}" for i in range(4)])
    eng.attach_membership(view)
    pop = ClientPopulation(registered=64, sample=4, seed=0)
    eng.attach_population(pop)
    with fleetobs._meta_lock:
        assert view in fleetobs._views and pop in fleetobs._populations
