"""The port's robust aggregators (tpfl_torch.learning.aggregators.robust:
Krum, MultiKrum, TrimmedMean) against the JAX package's, on the CPU.

The same models (random trees, contributors and sample counts from a
seed) go through both packages' aggregators: whole rounds through the
state machine (eager and deferred folds), the streaming
``acc_init`` / ``accumulate`` / ``finalize`` in any arrival order
against the batch ``aggregate``, the bounded buffer past
``AGG_ROBUST_BUFFER`` (the seeded reservoir keeps the same peers), the
quarantine shrink at finalize, single-model rounds, bf16 leaves, and the
precondition counters. Aggregates: rtol 1e-6, atol 1e-7 (Krum returns a
candidate bit for bit; the means are f32 folds); contributors and sample
counts exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpfl.learning.aggregators import Krum as JaxKrum
from tpfl.learning.aggregators import MultiKrum as JaxMultiKrum
from tpfl.learning.aggregators import TrimmedMean as JaxTrimmedMean
from tpfl.learning.model import TpflModel as JaxModel
from tpfl.settings import Settings as JaxSettings
from tpfl_torch.learning.aggregators import Krum, MultiKrum, TrimmedMean
from tpfl_torch.learning.aggregators.robust import krum_requirement_met, krum_scores
from tpfl_torch.learning.model import TpflModel
from tpfl_torch.management.logger import logger
from tpfl_torch.settings import Settings
from tpfl_torch.utils.tree import tree_items

RTOL, ATOL = 1e-6, 1e-7
TIMEOUT = 5.0

AGGREGATORS = {
    "krum": (lambda n: JaxKrum(n, n_byzantine=1), lambda n: Krum(n, n_byzantine=1, device="cpu")),
    "multikrum": (lambda n: JaxMultiKrum(n, n_byzantine=1, m=3),
                  lambda n: MultiKrum(n, n_byzantine=1, m=3, device="cpu")),
    "trimmedmean": (lambda n: JaxTrimmedMean(n, trim=1),
                    lambda n: TrimmedMean(n, trim=1, device="cpu")),
}


@pytest.fixture(autouse=True)
def both_settings():
    snap, jsnap = Settings.snapshot(), JaxSettings.snapshot()
    yield
    Settings.restore(snap)
    JaxSettings.restore(jsnap)


def _set_both(**knobs):
    for k, v in knobs.items():
        setattr(Settings, k, v)
        setattr(JaxSettings, k, v)


def _pairs(names, seed=0, dtype=np.float32, outliers=()):
    """(JAX model, port model) per contributor name; names in
    ``outliers`` get a far-off tree."""
    rng = np.random.default_rng(seed)
    out = []
    for i, name in enumerate(names):
        shift = 40.0 if name in outliers else 0.0
        tree = {"Dense_1": {"kernel": (rng.normal(size=(6, 3)) + shift).astype(dtype),
                            "bias": rng.normal(size=(3,)).astype(dtype)},
                "Conv_0": {"kernel": (rng.normal(size=(3, 3, 2, 4)) - shift).astype(dtype),
                           "bias": rng.normal(size=(4,)).astype(dtype)}}
        samples = int(rng.integers(1, 9))
        out.append((JaxModel(params=jax.tree_util.tree_map(jnp.asarray, tree), num_samples=samples,
                             contributors=[name]),
                    TpflModel(params=tree, num_samples=samples, contributors=[name],
                              device="cpu")))
    return out


def _assert_same(tout, jout, what=""):
    got = {k: v.float().numpy() for k, v in tree_items(tout.get_parameters())}
    want = {k: np.asarray(v, np.float32) for k, v in tree_items(
        jax.tree_util.tree_map(np.asarray, jout.get_parameters()))}
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=f"{what} {k}")
    assert tout.get_contributors() == jout.get_contributors(), what
    assert tout.get_num_samples() == jout.get_num_samples(), what


def _stream(agg, models):
    st = agg.acc_init(models[0])
    for m in models:
        st = agg.accumulate(st, m)
    return agg.finalize(st)


NAMES = ["n3", "n0", "n5", "n1", "evil", "n4", "n2"]


@pytest.mark.parametrize("eager", [False, True])
@pytest.mark.parametrize("kind", list(AGGREGATORS))
def test_round_matches_jax(kind, eager):
    _set_both(AGG_STREAM_EAGER=eager)
    jf, tf = AGGREGATORS[kind]
    jagg, tagg = jf("obs"), tf("obs")
    pairs = _pairs(NAMES, seed=1, outliers=("evil",))
    jagg.set_nodes_to_aggregate(NAMES)
    tagg.set_nodes_to_aggregate(NAMES)
    for jm, tm in pairs:
        assert tagg.add_model(tm) == jagg.add_model(jm)
    assert tagg.get_model(except_nodes=["n0"]).get_contributors() == \
        jagg.get_model(except_nodes=["n0"]).get_contributors()
    tout = tagg.wait_and_get_aggregation(timeout=TIMEOUT)
    _assert_same(tout, jagg.wait_and_get_aggregation(timeout=TIMEOUT), kind)
    assert tout.get_contributors() == sorted(NAMES)


@pytest.mark.parametrize("kind", list(AGGREGATORS))
def test_streaming_any_order_matches_batch(kind):
    jf, tf = AGGREGATORS[kind]
    pairs = _pairs(NAMES, seed=2, outliers=("evil",))
    jmodels, tmodels = [p[0] for p in pairs], [p[1] for p in pairs]
    want = jf("t").aggregate(jmodels)
    _assert_same(tf("t").aggregate(tmodels), want, "batch")
    _assert_same(_stream(tf("t"), tmodels[::-1]), _stream(jf("t"), jmodels[::-1]), "reversed")
    if kind == "krum":  # a selection: the same pick whatever the order
        _assert_same(_stream(tf("t"), tmodels[::-1]), want, "krum order")


@pytest.mark.parametrize("kind", list(AGGREGATORS))
def test_bounded_buffer_keeps_the_reference_peers(kind):
    _set_both(AGG_ROBUST_BUFFER=4, SEED=3)
    jf, tf = AGGREGATORS[kind]
    names = [f"n{i:02d}" for i in range(13)]
    pairs = _pairs(names, seed=4)
    jagg, tagg = jf("obs-7"), tf("obs-7")
    jst, tst = jagg.acc_init(pairs[0][0]), tagg.acc_init(pairs[0][1])
    for jm, tm in pairs:
        jst, tst = jagg.accumulate(jst, jm), tagg.accumulate(tst, tm)
    assert tst.extra["peers"] == jst.extra["peers"]
    assert tst.extra["weights"] == jst.extra["weights"]
    assert len(tst.extra["params"]) == 4
    _assert_same(tagg.finalize(tst), jagg.finalize(jst), "reservoir")


def test_multikrum_weighted_mean_and_metadata():
    values = [(1.0, 1, "a"), (1.2, 3, "b"), (5.0, 2, "c"), (-99.0, 1, "evil")]
    tmodels = [TpflModel(params={"w": np.full((2, 2), v, np.float32)}, num_samples=n,
                         contributors=[c], device="cpu") for v, n, c in values]
    out = MultiKrum("t", n_byzantine=1, m=2, device="cpu").aggregate(tmodels)
    assert out.get_contributors() == ["a", "b", "c", "evil"] and out.get_num_samples() == 7
    assert float(out.get_parameters()["w"][0, 0]) == pytest.approx(1.15, rel=1e-6)


def test_trimmed_mean_bf16_keeps_dtype_and_matches():
    pairs = _pairs(["a", "b", "c", "d", "e"], seed=5, dtype=np.float32)
    tms = [TpflModel(params={k: {n: torch.from_numpy(v.numpy()).to(torch.bfloat16)
                                 for n, v in layer.items()}
                             for k, layer in t.get_parameters().items()},
                     num_samples=t.get_num_samples(), contributors=t.get_contributors(),
                     device="cpu") for _, t in pairs]
    jms = [JaxModel(params=jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16),
                                                  j.get_parameters()),
                    num_samples=j.get_num_samples(), contributors=j.get_contributors())
           for j, _ in pairs]
    tout = _stream(TrimmedMean("t", trim=1, device="cpu"), tms)
    assert tout.get_parameters()["Dense_1"]["kernel"].dtype == torch.bfloat16
    _assert_same(tout, JaxTrimmedMean("t", trim=1).aggregate(jms), "bf16")


@pytest.mark.parametrize("kind", list(AGGREGATORS))
def test_single_model_round(kind):
    jf, tf = AGGREGATORS[kind]
    (jm, tm), = _pairs(["only"], seed=6)
    _assert_same(_stream(tf("t"), [tm]), _stream(jf("t"), [jm]), "single")


@pytest.mark.parametrize("kind", list(AGGREGATORS))
def test_quarantine_shrinks_candidates(kind):
    class Engine:
        def quarantined(self):
            return {"evil"}

    _set_both(QUARANTINE_ENABLED=True)
    jf, tf = AGGREGATORS[kind]
    jagg, tagg = jf("t"), tf("t")
    jagg.set_quarantine(Engine())
    tagg.set_quarantine(Engine())
    assert tagg.quarantined_peers() == {"evil"}
    pairs = _pairs(NAMES, seed=7, outliers=("evil",))
    _assert_same(_stream(tagg, [p[1] for p in pairs]), _stream(jagg, [p[0] for p in pairs]),
                 "shrunk")
    assert logger.metrics.value("tpfl_agg_candidates_shrunk_total", {"node": "t"}) >= 1


def test_preconditions_and_counters():
    assert krum_requirement_met(5, 1) and not krum_requirement_met(4, 1)
    pairs = _pairs(["a", "b", "c", "d"], seed=8)
    before = logger.metrics.value("tpfl_agg_krum_underprovisioned_total", {"node": "pc"})
    _assert_same(Krum("pc", n_byzantine=1, device="cpu").aggregate([p[1] for p in pairs]),
                 JaxKrum("pc", n_byzantine=1).aggregate([p[0] for p in pairs]), "under")
    assert logger.metrics.value("tpfl_agg_krum_underprovisioned_total",
                                {"node": "pc"}) == before + 1
    out = TrimmedMean("pc", trim=2, device="cpu").aggregate([p[1] for p in pairs])
    _assert_same(out, JaxTrimmedMean("pc", trim=2).aggregate([p[0] for p in pairs]), "no trim")
    assert logger.metrics.value("tpfl_agg_effective_trim", {"node": "pc"}) == 0.0
    assert logger.metrics.value("tpfl_agg_trimmed_no_trim_total", {"node": "pc"}) >= 1


def test_krum_scores_match_f64():
    rng = np.random.default_rng(9)
    flat = rng.normal(size=(9, 300)).astype(np.float32) + 3.0
    got = krum_scores(torch.from_numpy(flat), 2).numpy()
    x = flat.astype(np.float64)
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    want = np.sort(d2, axis=1)[:, :9 - 2 - 2].sum(1)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert int(np.argmin(got)) == int(np.argmin(want))


def test_async_staleness_matches_jax():
    """Candidates buffered with their async τ: the ``ASYNC_STALENESS_MAX``
    cut at finalize (τ = 3 dropped, τ = max kept), Krum's ``(1+τ)^exp``
    score penalty and Multi-Krum's ``staleness_weight`` discount give the
    JAX package's aggregate; an all-stale buffer fails open to it too."""
    _set_both(ASYNC_STALENESS_MAX=2, ASYNC_STALENESS_EXP=0.5)
    pairs = _pairs([f"p{i}" for i in range(7)], seed=5, outliers=("p6",))
    taus = [0, 1, 2, 0, 3, 1, 0]
    for kind, (make_jax, make_port) in AGGREGATORS.items():
        for label, ts in (("mixed", taus), ("all stale", [5] * len(taus))):
            jagg, tagg = make_jax("st"), make_port("st")
            jst, tst = jagg.acc_init(pairs[0][0]), tagg.acc_init(pairs[0][1])
            for (jm, tm), t in zip(pairs, ts):
                jst = jagg.accumulate(jst, jm, staleness=t)
                tst = tagg.accumulate(tst, tm, staleness=t)
            assert tst.extra["taus"] == jst.extra["taus"] == ts
            _assert_same(tagg.finalize(tst), jagg.finalize(jst), f"{kind} {label}")
