"""The port's cross-device population tier
(tpfl_torch.parallel.population.ClientPopulation) against the JAX
package's, on the CPU: the scenarios of ``tests/test_population.py``, each
on both packages from the same arguments.

Cohorts, straggler weights, FedBuff schedules and edge assignments are
numpy draws in both packages: bit-equal. Records, coverage, fairness and
``state_export`` are exact (the engine round's losses, f32 compute in two
frameworks, within rtol 1e-4 / atol 1e-5). The checkpoint round trip runs
through the port's ``EngineCheckpointer``; the resume test of a
JAX-written checkpoint is in ``tests/test_torch_checkpoint.py``.
"""

import resource

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpfl.management.telemetry import metrics as jax_metrics
from tpfl.models import MLP as JaxMLP
from tpfl.parallel import ClientPopulation as JaxPopulation
from tpfl.parallel import FederationEngine as JaxEngine
from tpfl.parallel import sample_participants as jax_sample_participants
from tpfl.settings import Settings as JaxSettings
from tpfl_torch.interop import params_from_flax
from tpfl_torch.management.checkpoint import EngineCheckpointer
from tpfl_torch.management.telemetry import metrics
from tpfl_torch.models import MLP
from tpfl_torch.parallel import ClientPopulation, FederationEngine, sample_participants
from tpfl_torch.settings import Settings


@pytest.fixture(autouse=True)
def _settings():
    snaps = (Settings.snapshot(), JaxSettings.snapshot())
    yield
    Settings.restore(snaps[0])
    JaxSettings.restore(snaps[1])


def _pops(**kw):
    return ClientPopulation(**kw), JaxPopulation(**kw)


def _engines(n=8):
    eng = FederationEngine(MLP(hidden_sizes=(8,), out_channels=10, compute_dtype=torch.float32),
                           n, seed=0, learning_rate=0.1, device="cpu")
    jeng = JaxEngine(JaxMLP(hidden_sizes=(8,), compute_dtype=jnp.float32), n, mesh=None,
                     seed=0, learning_rate=0.1)
    return eng, jeng


def _data(n, bs=8, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((n, 1, bs, 8, 8)).astype(np.float32),
            rng.integers(0, 10, (n, 1, bs)).astype(np.int32))


def _same_records(got, want):
    assert got.keys() == want.keys()
    for cid, rec in want.items():
        assert (got[cid]["rounds"], got[cid]["last_round"]) == (rec["rounds"], rec["last_round"])
        np.testing.assert_allclose(got[cid]["loss"], rec["loss"], rtol=1e-4, atol=1e-5)


def test_cohort_sampling_deterministic():
    pop, jpop = _pops(registered=1_000_000, sample=100, seed=7)
    ids = pop.begin_round()
    assert ids.shape == (100,) and len(set(ids.tolist())) == 100 and ids.max() < 1_000_000
    np.testing.assert_array_equal(ids, jpop.begin_round())
    np.testing.assert_array_equal(ids, pop.begin_round())
    assert not np.array_equal(ids, pop.begin_round(round=1))
    np.testing.assert_array_equal(pop.begin_round(round=1), jpop.begin_round(round=1))
    np.testing.assert_array_equal(sample_participants(500, 17, 3, 9),
                                  jax_sample_participants(500, 17, 3, 9))


def test_population_knob_defaults_and_validation():
    Settings.POPULATION_CLIENTS = JaxSettings.POPULATION_CLIENTS = 5000
    Settings.POPULATION_SAMPLE = JaxSettings.POPULATION_SAMPLE = 50
    assert (ClientPopulation().registered, ClientPopulation().sample) == (5000, 50)
    for cls in (ClientPopulation, JaxPopulation):
        with pytest.raises(ValueError, match="registered"):
            cls(registered=0, sample=10)
        with pytest.raises(ValueError, match="sample"):
            cls(registered=10, sample=11)


def test_straggler_cutoff_zero_weights():
    pop, jpop = _pops(registered=10_000, sample=64, seed=3)
    ids = pop.begin_round()
    w = pop.round_weights(ids, cutoff_frac=0.25)
    assert w.shape == (64,) and int((w == 0).sum()) == 16
    np.testing.assert_array_equal(w, jpop.round_weights(ids, cutoff_frac=0.25))
    np.testing.assert_array_equal(pop.round_weights(ids, 1.0), jpop.round_weights(ids, 1.0))
    assert pop.round_weights(ids, 1.0).sum() >= 1.0


def test_straggler_schedule_is_valid_fedbuff():
    pop, jpop = _pops(registered=10_000, sample=16, seed=1)
    sched = pop.straggler_schedule(n_rounds=6, straggler_frac=0.5)
    jsched = jpop.straggler_schedule(n_rounds=6, straggler_frac=0.5)
    assert sched.arrivals.shape == (6, 16) and (sched.arrivals.sum(axis=1) >= 1).all()
    assert (sched.taus[sched.arrivals > 0] > 0).any()
    np.testing.assert_array_equal(sched.arrivals, jsched.arrivals)
    np.testing.assert_array_equal(sched.taus, jsched.taus)


def test_edge_assignment_balanced():
    eng, jeng = _engines()
    pop, jpop = _pops(registered=100_000, sample=8, seed=0)
    eng.attach_population(pop)
    jeng.attach_population(jpop)
    edges = pop.edge_assignment(pop.begin_round())
    np.testing.assert_array_equal(edges, jpop.edge_assignment(jpop.begin_round()))
    counts = np.bincount(edges, minlength=eng.n_nodes)
    assert counts.max() - counts.min() <= 1
    with pytest.raises(ValueError, match="fit"):
        eng.attach_population(ClientPopulation(registered=100, sample=99, seed=0))


def test_population_checkpoint_roundtrip_exact(tmp_path):
    """Three engine rounds over each round's cohort in both packages (the
    same params and data), the population committed each round; the
    port's checkpoint restores exactly the sampled clients' records."""
    eng, jeng = _engines()
    pop, jpop = _pops(registered=50_000, sample=8, seed=11)
    eng.attach_population(pop)
    jeng.attach_population(jpop)
    jp = jeng.init_params((8, 8))
    p = params_from_flax(jax.tree_util.tree_map(np.array, dict(jp)), device="cpu")
    xs, ys = _data(8)
    for _ in range(3):
        ids = pop.begin_round()
        w = pop.round_weights(ids, cutoff_frac=0.25)
        p, losses = eng.run_rounds(p, xs, ys, weights=w, donate=False)
        jp, jlosses = jeng.run_rounds(jp, xs, ys, weights=w, donate=False)
        pop.complete_round(ids, w, losses.numpy()[:8])
        jpop.complete_round(ids, w, np.asarray(jlosses)[:8])
    assert pop.round == jpop.round == 3 and 0 < pop.touched == jpop.touched <= 24
    _same_records(pop.clients, jpop.clients)
    ck = EngineCheckpointer(str(tmp_path))
    ck.save(eng.export_state(p), step=3)
    state, meta = ck.restore()
    assert meta["step"] == 3
    fresh = FederationEngine(MLP(hidden_sizes=(8,), out_channels=10,
                                 compute_dtype=torch.float32), 8, seed=0, device="cpu")
    fresh.import_state(state)
    got = fresh.population
    assert got is not None and got is not pop
    assert (got.registered, got.sample, got.seed, got.round) == (50_000, 8, 11, 3)
    assert got.clients == pop.clients
    np.testing.assert_array_equal(got.begin_round(), jpop.begin_round())


def test_population_restore_onto_existing_population():
    eng, jeng = _engines()
    pop = ClientPopulation(registered=1000, sample=4, seed=2)
    eng.attach_population(pop)
    pop.complete_round(pop.begin_round())
    snap = eng.export_state(eng.init_params((8, 8)))
    eng2 = FederationEngine(MLP(hidden_sizes=(8,), out_channels=10), 8, device="cpu")
    eng2.attach_population(ClientPopulation(registered=9, sample=2, seed=0))
    eng2.import_state(snap)
    jeng.attach_population(JaxPopulation(registered=9, sample=2, seed=0))
    jeng.import_state(snap)
    assert eng2.population.registered == jeng.population.registered == 1000
    assert eng2.population.clients == jeng.population.clients == pop.clients


def test_population_state_o_active_rss():
    """Registered 100k -> 1M with K = 100: records bounded by rounds x K,
    the snapshot O(touched), peak RSS growth far under O(census), the
    coverage bitset one bit a client; both packages' states equal."""
    K, R = 100, 3

    def run(cls, registered):
        pop = cls(registered=registered, sample=K, seed=5)
        for _ in range(R):
            ids = pop.begin_round()
            pop.complete_round(ids, pop.round_weights(ids, cutoff_frac=0.1))
        return pop

    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    small, big = run(ClientPopulation, 100_000), run(ClientPopulation, 1_000_000)
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    for pop in (small, big):
        assert pop.touched <= R * K
        assert len(pop.state_export()["clients"]) == pop.touched
    assert (rss1 - rss0) / 1024.0 < 64.0
    assert big._coverage.nbytes == (1_000_000 + 7) // 8
    assert big.state_export() == run(JaxPopulation, 1_000_000).state_export()


def test_population_coverage_and_fairness_sketches():
    pop, jpop = _pops(registered=64, sample=4, seed=9)
    seen: set = set()
    for _ in range(5):
        ids = pop.begin_round()
        seen.update(int(i) for i in ids)
        pop.complete_round(ids)
        jpop.complete_round(jpop.begin_round())
    assert pop.coverage == pytest.approx(len(seen) / 64) and pop.coverage == jpop.coverage
    counts = [rec["rounds"] for rec in pop.clients.values()]
    assert pop.fairness == pytest.approx(sum(counts) ** 2 / (len(counts)
                                                             * sum(c * c for c in counts)))
    assert pop.fairness == jpop.fairness and 0.0 < pop.fairness <= 1.0


def test_population_cut_clients_count_for_coverage_not_fairness():
    pop, jpop = _pops(registered=32, sample=8, seed=1)
    w = np.ones(8, np.float32)
    w[:3] = 0.0
    pop.complete_round(pop.begin_round(), w)
    jpop.complete_round(jpop.begin_round(), w)
    assert pop.coverage == pytest.approx(8 / 32) and pop.touched == 5
    assert pop.fairness == 1.0
    assert pop.state_export() == jpop.state_export()


def test_population_staleness_gap_semantics():
    """The ``tpfl_pop_*`` series and the ``population_round`` events are
    the JAX package's: the same gauges, counters and staleness histogram,
    and the same event payloads (but the time stamp)."""
    from tpfl.management.telemetry import flight as jax_flight
    from tpfl_torch.management.telemetry import flight

    metrics.reset()
    jax_metrics.reset()
    flight.clear("population")
    jax_flight.clear("population")
    pop, jpop = _pops(registered=16, sample=2, seed=0)
    for p in (pop, jpop):
        ids = p.begin_round()
        p.complete_round(ids)
        p.round = 5
        p.complete_round(ids, np.array([1.0, 0.0], np.float32))
    key = ("tpfl_pop_staleness", (("node", "population"),))
    hist = metrics.fold()["histograms"][key]
    assert hist[-2] >= 5.0
    folded, jfolded = metrics.fold(), jax_metrics.fold()
    for kind in ("counters", "gauges", "histograms"):
        got = {k: v for k, v in folded[kind].items() if k[0].startswith("tpfl_pop_")}
        want = {k: v for k, v in jfolded[kind].items() if k[0].startswith("tpfl_pop_")}
        assert got == want, kind
    events = [{k: v for k, v in e.items() if k != "t"} for e in flight.snapshot("population")]
    jevents = [{k: v for k, v in e.items() if k != "t"}
               for e in jax_flight.snapshot("population")]
    assert events == jevents and [e["name"] for e in events] == ["population_round"] * 2


def test_population_sketch_state_roundtrip():
    pop, jpop = _pops(registered=1000, sample=16, seed=4)
    for p in (pop, jpop):
        for _ in range(4):
            ids = p.begin_round()
            p.complete_round(ids, p.round_weights(ids, cutoff_frac=0.25))
    state = pop.state_export()
    assert state == jpop.state_export()
    assert isinstance(state["coverage"], bytes) and len(state["coverage"]) == (1000 + 7) // 8
    twin = ClientPopulation.from_state(state)
    assert twin.coverage == pop.coverage and twin._sampled_count == pop._sampled_count
    assert twin.fairness == pytest.approx(pop.fairness)
    np.testing.assert_array_equal(twin._coverage, pop._coverage)
    jtwin = JaxPopulation.from_state(state)
    assert jtwin.state_export() == twin.state_export()


def test_population_legacy_checkpoint_rebuilds_coverage():
    pop = ClientPopulation(registered=256, sample=8, seed=6)
    ids = pop.begin_round()
    pop.complete_round(ids, pop.round_weights(ids, cutoff_frac=0.25))
    state = pop.state_export()
    del state["coverage"]  # a snapshot without the bitset
    old, jold = ClientPopulation.from_state(state), JaxPopulation.from_state(state)
    assert old._sampled_count == old.touched <= pop._sampled_count
    assert old.fairness == pytest.approx(pop.fairness)
    assert old.state_export() == jold.state_export()
