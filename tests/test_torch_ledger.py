"""The port's contribution ledger (tpfl_torch.management.ledger) against
the JAX package's, on the CPU, the same contributions fed to both.

- The contribution stats (update norm, reference norm, ``cos_ref``,
  ``cos_mean``, per-leaf norms, the running-sum accumulator) against
  JAX's jitted ``_stats``: rtol 1e-5 (f32 sums in other orders).
- ``robust_z`` and ``AnomalyScorer.score``: exact.
- Scripted rounds through ``record`` / ``flush`` / ``score_now``: the
  same flags and reasons per entry, ``detections()`` equal (flags,
  reasons, rounds, peers exact; norms and cosines at rtol 1e-5).
- ``ConvergenceMonitor``: the same events and slopes.
- The aggregator taps (``add_model`` records, ``clear`` closes the
  round) leave the aggregate bit-identical; with both knobs off a ledger
  call adds no tensor op (counted by a dispatch mode).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tpfl.learning.model import TpflModel as JaxModel
from tpfl.management import ledger as jledger
from tpfl.settings import Settings as JaxSettings
from tpfl_torch.learning.aggregators import FedAvg
from tpfl_torch.learning.model import TpflModel
from tpfl_torch.management import ledger
from tpfl_torch.settings import Settings
from tpfl_torch.utils.tree import canonical_leaves

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _isolated():
    snap, jsnap = Settings.snapshot(), JaxSettings.snapshot()
    for mod in (ledger, jledger):
        mod.contrib.reset()
        mod.convergence.reset()
    yield
    Settings.restore(snap)
    JaxSettings.restore(jsnap)
    for mod in (ledger, jledger):
        mod.contrib.reset()
        mod.convergence.reset()


def _set_both(**knobs):
    for k, v in knobs.items():
        setattr(Settings, k, v)
        setattr(JaxSettings, k, v)


def _ref(seed=0):
    rng = np.random.default_rng(seed)
    return {"out": {"b": (0.1 * rng.normal(size=(20,))).astype(np.float32)},
            "dense": {"w": (0.3 * rng.normal(size=(100, 20))).astype(np.float32)}}


def _honest(ref, seed, scale=0.01):
    rng = np.random.default_rng(1000 + seed)
    return {k: {n: (v + scale * rng.normal(size=v.shape)).astype(np.float32)
                for n, v in layer.items()} for k, layer in ref.items()}


def _flip(tree):
    return {k: {n: -v for n, v in layer.items()} for k, layer in tree.items()}


def _noise(tree, seed, std=0.1):
    rng = np.random.default_rng(seed)
    return {k: {n: (v + std * rng.normal(size=v.shape)).astype(np.float32)
                for n, v in layer.items()} for k, layer in tree.items()}


def _pair(params, who, samples=10):
    """(JAX model, port model) of one contribution."""
    contributors = who if isinstance(who, list) else [who]
    return (JaxModel(params=jax.tree_util.tree_map(jnp.asarray, params),
                     contributors=contributors, num_samples=samples),
            TpflModel(params=params, contributors=contributors, num_samples=samples,
                      device="cpu"))


def _assert_entry(got, want):
    for k in ("peer", "round", "flagged", "reasons", "single", "num_samples", "quarantined"):
        assert got[k] == want[k], k
    for k in ("update_norm", "ref_norm", "cos_ref", "cos_mean"):
        if want[k] is None:
            assert got[k] is None, k
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(got["leaf_norms"], want["leaf_norms"], rtol=RTOL, atol=1e-6)


def _assert_detections(got, want):
    assert got["flagged"] == want["flagged"]
    assert got["peers"] == want["peers"]
    assert len(got["entries"]) == len(want["entries"])
    for g, w in zip(got["entries"], want["entries"]):
        for k in ("peer", "round", "flagged", "reasons", "staleness", "version"):
            assert g[k] == w[k], k
        for k in ("update_norm", "cos_ref"):
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=1e-6)
        np.testing.assert_allclose(g["z_norm"], w["z_norm"], rtol=1e-3, atol=1e-3)


# --- stats and scoring ------------------------------------------------------------


def test_stats_match_jax_stats():
    ref = _ref()
    jacc = tacc = None
    for i, params in enumerate([_honest(ref, 0), _flip(ref), _noise(ref, 3), _honest(ref, 1)]):
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        js, jl, jacc = jledger._stats(jp, jax.tree_util.tree_map(jnp.asarray, ref), jacc, i)
        ts, tl, tacc = ledger._stats(params, ref, tacc, i)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL, atol=1e-7)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL)
        for t, j in zip(tacc, jax.tree_util.tree_leaves(jacc)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=1e-6)


def test_robust_z_and_scorer_exact():
    rng = np.random.default_rng(0)
    for n in (0, 1, 2, 3, 4, 7, 10):
        window = [float(v) for v in rng.uniform(0.5, 1.5, n)]
        for value in (0.2, 1.0, 3.0, 50.0):
            assert ledger.robust_z(value, window) == jledger.robust_z(value, window)
    assert ledger.robust_z(2.0, [1.0] * 4) == jledger.robust_z(2.0, [1.0] * 4)
    _set_both(ASYNC_STALENESS_MAX=3)
    for args in [(1.0, 0.99, [1.0] * 3), (1.0, -0.9, []), (9.0, 0.99, [1.0, 1.1, 0.9, 1.0]),
                 (9.0, 0.99, [1.0, 1.1, 0.9]), (1.0, 0.5, [1.0] * 5, 4),
                 (1.0, 0.5, [1.0] * 5, 0, True)]:
        assert ledger.AnomalyScorer.score(*args) == jledger.AnomalyScorer.score(*args)


def test_record_flush_flags_match():
    """Passive taps: six honest contributions, a sign flip and a noisy
    one; intake only parks them, the flush scores them as JAX's does."""
    _set_both(LEDGER_ENABLED=True)
    ref = _ref()
    for mod in (ledger, jledger):
        mod.contrib.open_round("obs", 2, ref)
    pending = []
    contributions = [(_honest(ref, i), f"honest-{i}") for i in range(6)]
    contributions += [(_flip(ref), "adv-flip"), (_noise(ref, 7), "adv-noise")]
    for params, who in contributions:
        jm, tm = _pair(params, who)
        je = jledger.contrib.record("obs", jm, trace=who)
        te = ledger.contrib.record("obs", tm, trace=who)
        assert te["update_norm"] is None
        pending.append((te, je))
    jledger.contrib.flush()
    ledger.contrib.flush()
    for te, je in pending:
        _assert_entry(te, je)
    assert "sign_flip" in pending[6][0]["reasons"]
    assert pending[7][0]["reasons"] == ["norm_outlier"]
    _assert_detections(ledger.contrib.detections(), jledger.contrib.detections())


def test_detections_scripted_rounds_two_observers():
    """Three rounds, two observers scoring at intake (``score_now``, the
    defense's path) with a partial aggregate and a re-push: the deduped
    verdict surface equals JAX's."""
    _set_both(LEDGER_ENABLED=True, QUARANTINE_ENABLED=True)
    ref = _ref(1)
    for rnd in range(3):
        for obs in ("obs-a", "obs-b"):
            for mod in (ledger, jledger):
                mod.contrib.open_round(obs, rnd, ref)
            models = [(_honest(ref, 10 * rnd + i), f"h{i}") for i in range(5)]
            models.append((_flip(_honest(ref, 99 + rnd)), "flip"))
            models.append((_noise(ref, 50 + rnd, std=0.2 if rnd else 0.0), "noise"))
            for params, who in models + models[:1]:  # the first one pushed twice
                jm, tm = _pair(params, who)
                je = jledger.contrib.score_now(obs, jm)
                te = ledger.contrib.score_now(obs, tm)
                _assert_entry(te, je)
            jm, tm = _pair(_honest(ref, 7), ["h0", "h1"], samples=20)
            assert ledger.contrib.score_now(obs, tm) is None
            ledger.contrib.record(obs, tm)
            jledger.contrib.record(obs, jm)
            for mod in (ledger, jledger):
                mod.contrib.close_round(obs)
    got, want = ledger.contrib.detections(), jledger.contrib.detections()
    _assert_detections(got, want)
    assert set(got["flagged"]) == {"flip", "noise"}
    assert ledger.contrib.stats_for("obs-a") == jledger.contrib.stats_for("obs-a")


@pytest.mark.parametrize("first", ["obs-a", "obs-b"])
def test_score_now_window_is_the_first_observers_ring(first):
    """``score_now``'s norm window is the observer's own ring, as in the
    reference, and the verdict is cached for every later observer. Round
    0: obs-a scores five honest singles, obs-b none. Round 1: a noisy
    single is flagged against obs-a's round-0 entries when obs-a scores
    it first, and not when obs-b (no prior entry) does; the second
    observer gets the first one's verdict. Both packages agree."""
    _set_both(LEDGER_ENABLED=True, QUARANTINE_ENABLED=True)
    ref = _ref(2)
    for mod in (ledger, jledger):
        mod.contrib.open_round("obs-a", 0, ref)
        mod.contrib.open_round("obs-b", 0, ref)
    for i in range(5):
        jm, tm = _pair(_honest(ref, i), f"h{i}")
        jledger.contrib.score_now("obs-a", jm)
        ledger.contrib.score_now("obs-a", tm)
    for mod in (ledger, jledger):
        for obs in ("obs-a", "obs-b"):
            mod.contrib.close_round(obs)
            mod.contrib.open_round(obs, 1, ref)
    jm, tm = _pair(_noise(ref, 77, std=0.2), "noise")
    got = ledger.contrib.score_now(first, tm)
    want = jledger.contrib.score_now(first, jm)
    _assert_entry(got, want)
    assert got["flagged"] == (first == "obs-a")
    other = "obs-b" if first == "obs-a" else "obs-a"
    again = ledger.contrib.score_now(other, tm)
    _assert_entry(again, jledger.contrib.score_now(other, jm))
    assert again["flagged"] == got["flagged"]


def test_partial_ring_and_round_lifecycle():
    _set_both(LEDGER_ENABLED=True, LEDGER_RING=8)
    ref = _ref()
    ledger.contrib.open_round("obs", 1, ref)
    _, partial = _pair(_flip(ref), ["a", "b"], samples=20)
    e = ledger.contrib.record("obs", partial)
    assert e is not None and not e["single"] and e["peer"] == "a+b" and not e["flagged"]
    assert ledger.contrib.detections()["entries"] == []
    for i in range(30):
        ledger.contrib.record("obs", _pair(_honest(ref, i), f"n{i}")[1])
    assert len(ledger.contrib.entries("obs")) == 8
    assert ledger.contrib.stats_for("obs") == {"entries": 8, "flagged": 0}
    ledger.contrib.close_round("obs")
    assert ledger.contrib.record("obs", _pair(ref, "late")[1]) is None
    # The engine carry's entry point records into the same ring, as the
    # JAX ledger's does from the same ring state.
    jledger.contrib.open_round("obs", 1, jax.tree_util.tree_map(jnp.asarray, ref))
    for i in range(30):
        jledger.contrib.record("obs", _pair(_honest(ref, i), f"n{i}")[0])
    jledger.contrib.close_round("obs")
    got = ledger.contrib.record_external("obs", "p", 0, 1.0, 1.0)
    want = jledger.contrib.record_external("obs", "p", 0, 1.0, 1.0)
    keys = ("peer", "single", "round", "staleness", "version", "flagged", "reasons", "z_norm")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert len(ledger.contrib.entries("obs")) == 8


# --- convergence ------------------------------------------------------------------


def test_convergence_monitor_matches():
    _set_both(LEDGER_ENABLED=True, LEDGER_CONVERGENCE_WINDOW=3)
    ref = _ref()
    seqs = {"plateau": [ref, _honest(ref, 1)] + [ref] * 4,
            "divergence": [{k: {n: v + 0.1 * (2 ** r - 1) for n, v in layer.items()}
                            for k, layer in ref.items()} for r in range(7)]}
    for name, seq in seqs.items():
        events = []
        for r, params in enumerate(seq):
            got = ledger.convergence.observe_global(name, r, TpflModel(
                params=params, device="cpu").get_parameters())
            want = jledger.convergence.observe_global(
                name, r, jax.tree_util.tree_map(jnp.asarray, params))
            assert (got is None) == (want is None)
            if got is not None:
                assert got.get("event") == want.get("event")
                np.testing.assert_allclose(got["delta"], want["delta"], rtol=RTOL)
                events.append(got.get("event"))
        assert name in events
    for i, loss in enumerate([1.0, 0.8, 0.6, 0.4, 0.5, 0.7, 0.9]):
        assert ledger.convergence.observe_loss("n", i, loss) == pytest.approx(
            jledger.convergence.observe_loss("n", i, loss), rel=1e-12)
    assert ledger.metrics.value("tpfl_convergence_divergence_total", {"node": "n"}) >= 1


# --- the aggregator taps and the disabled path -------------------------------------


def test_aggregator_tap_records_and_preserves_results():
    ref = _ref()

    def run(enabled):
        Settings.LEDGER_ENABLED = enabled
        ledger.contrib.reset()
        agg = FedAvg("tap-obs", device="cpu")
        agg.set_nodes_to_aggregate(["p0", "p1", "p2"])
        ledger.contrib.open_round("tap-obs", 0, ref)
        for i in range(3):
            assert f"p{i}" in agg.add_model(_pair(_honest(ref, i), f"p{i}")[1], trace=f"t{i}")
        out = agg.wait_and_get_aggregation(timeout=5)
        agg.clear()
        return out

    on = run(True)
    entries = ledger.contrib.entries("tap-obs")
    assert [e["peer"] for e in entries] == ["p0", "p1", "p2"]
    assert [e["trace"] for e in entries] == ["t0", "t1", "t2"]
    assert all(e["update_norm"] is not None for e in entries)  # clear() flushed
    assert ledger.contrib.record("tap-obs", _pair(ref, "late")[1]) is None
    off = run(False)
    assert ledger.contrib.entries("tap-obs") == []
    for a, b in zip(canonical_leaves(on.get_parameters()), canonical_leaves(off.get_parameters())):
        assert torch.equal(a, b)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


def test_knobs_off_add_no_tensor_op():
    Settings.LEDGER_ENABLED = Settings.QUARANTINE_ENABLED = False
    ref = _ref()
    _, model = _pair(_honest(ref, 0), "a")
    params = model.get_parameters()
    with _CountOps() as mode:
        ledger.contrib.open_round("obs", 0, params)
        assert ledger.contrib.record("obs", model) is None
        assert ledger.contrib.score_now("obs", model) is None
        ledger.contrib.close_round("obs")
        assert ledger.convergence.observe_global("obs", 0, params) is None
        assert ledger.convergence.observe_loss("obs", 0, 1.0) is None
    assert mode.ops == []
    assert ledger.contrib.entries() == []
    # The mode does see the ledger's ops once a knob is on.
    Settings.LEDGER_ENABLED = True
    with _CountOps() as mode:
        ledger.contrib.open_round("obs", 0, params)
        ledger.contrib.record("obs", model)
        ledger.contrib.close_round("obs")
    assert len(mode.ops) > 0
