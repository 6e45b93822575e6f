"""The port's aggregators (tpfl_torch.learning.aggregators) against the
JAX package's, on the CPU: FedAvg, FedProx, SCAFFOLD and FedMedian fed
the same models (the same params carried across by
``model_state_from_jax``) give the same aggregate, contributors,
num_samples and info — with the eager (on-arrival) and the deferred
(sorted, at close) fold, partial models with several contributors,
``get_model(except_nodes)``, even and odd FedMedian counts, all-zero
weights, ``ROUND_QUORUM < 1`` and ``remove_dead_nodes``. f32; rtol 1e-6
(the folds round as the reference's do, in the same order).

Every wait has a timeout. The seams of the asynchronous rounds
(``async_k``, ``start_version``, ``set_async_schedule``,
``async_deadline_close``, ``Settings.ASYNC_ROUNDS``) give the JAX
package's results here; their full cases are ``tests/test_torch_async.py``
and ``tests/test_torch_async_control.py`` (the quarantine intake and the
ledger taps: ``tests/test_torch_quarantine.py``,
``tests/test_torch_ledger.py``).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpfl.learning.aggregators import FedAvg as JaxFedAvg
from tpfl.learning.aggregators import FedMedian as JaxFedMedian
from tpfl.learning.aggregators import FedProx as JaxFedProx
from tpfl.learning.aggregators import Scaffold as JaxScaffold
from tpfl.learning.model import TpflModel as JaxModel
from tpfl.settings import Settings as JaxSettings
from tpfl_torch.interop import model_state_from_jax, params_to_numpy
from tpfl_torch.learning.aggregators import FedAvg, FedMedian, FedProx, Scaffold
from tpfl_torch.learning.aggregators.aggregator import NoModelsToAggregateError
from tpfl_torch.learning.model import TpflModel
from tpfl_torch.management.logger import logger
from tpfl_torch.settings import Settings
from tpfl_torch.utils.tree import tree_items

RTOL, ATOL = 1e-6, 1e-7
TIMEOUT = 5.0

AGGREGATORS = {
    "fedavg": (lambda n: JaxFedAvg(n), lambda n: FedAvg(n, device="cpu")),
    "fedprox": (lambda n: JaxFedProx(n, proximal_mu=0.3),
                lambda n: FedProx(n, proximal_mu=0.3, device="cpu")),
    "scaffold": (lambda n: JaxScaffold(n, global_lr=0.5),
                 lambda n: Scaffold(n, global_lr=0.5, device="cpu")),
    "fedmedian": (lambda n: JaxFedMedian(n), lambda n: FedMedian(n, device="cpu")),
}


def _tree(rng):
    return {"Dense_1": {"kernel": rng.normal(size=(6, 3)).astype(np.float32),
                        "bias": rng.normal(size=(3,)).astype(np.float32)},
            "Dense_0": {"kernel": rng.normal(size=(4, 6)).astype(np.float32),
                        "bias": rng.normal(size=(6,)).astype(np.float32)}}


def _pairs(names, samples, seed=0, scaffold=False):
    """(jax model, port model) per contributor name (a name may be a
    tuple: a partial model covering several contributors)."""
    rng = np.random.default_rng(seed)
    out = []
    for name, n in zip(names, samples):
        contribs = list(name) if isinstance(name, tuple) else [name]
        info = {}
        if scaffold:
            info = {"scaffold": {"delta_y_i": _tree(rng), "delta_c_i": _tree(rng)}}
        jm = JaxModel(params=jax.tree_util.tree_map(jnp.asarray, _tree(rng)), num_samples=n,
                      contributors=contribs, additional_info=info)
        state = model_state_from_jax(jm, device="cpu")
        out.append((jm, TpflModel(**state)))
    return out


@pytest.fixture
def both_settings():
    snap, jsnap = Settings.snapshot(), JaxSettings.snapshot()
    yield
    Settings.restore(snap)
    JaxSettings.restore(jsnap)


def _set_both(**knobs):
    for k, v in knobs.items():
        setattr(Settings, k, v)
        setattr(JaxSettings, k, v)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def _assert_same(tout, jout, what=""):
    got = dict(tree_items(params_to_numpy(tout.get_parameters())))
    want = dict(tree_items(_numpy(jout.get_parameters())))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=f"{what} {k}")
    assert tout.get_contributors() == jout.get_contributors()
    assert tout.get_num_samples() == jout.get_num_samples()
    assert sorted(tout.get_info()) == sorted(jout.get_info())


def _round(kind, names, samples, train_set=None, seed=0, node="agg"):
    jagg, tagg = (make(node) for make in AGGREGATORS[kind])
    pairs = _pairs(names, samples, seed=seed, scaffold=kind == "scaffold")
    covered = []
    for agg in (jagg, tagg):
        agg.set_nodes_to_aggregate(train_set or [c for n in names for c in
                                                 (n if isinstance(n, tuple) else (n,))])
    for jm, tm in pairs:
        covered.append((jagg.add_model(jm), tagg.add_model(tm)))
    return jagg, tagg, pairs, covered


@pytest.mark.parametrize("eager", [False, True])
@pytest.mark.parametrize("kind", list(AGGREGATORS))
def test_round_matches_jax(both_settings, kind, eager):
    _set_both(AGG_STREAM_EAGER=eager)
    names = ["n2", "n0", "n3", "n1"]
    jagg, tagg, _, covered = _round(kind, names, [10, 30, 5, 20])
    for jc, tc in covered:
        assert tc == jc
    jout = jagg.wait_and_get_aggregation(timeout=TIMEOUT)
    tout = tagg.wait_and_get_aggregation(timeout=TIMEOUT)
    _assert_same(tout, jout, kind)
    assert tout.get_contributors() == ["n0", "n1", "n2", "n3"]
    if kind == "fedprox":
        assert tout.get_info("fedprox") == jout.get_info("fedprox") == {"mu": 0.3}
    if kind == "scaffold":
        jc, tc = jout.get_info("scaffold")["global_c"], tout.get_info("scaffold")["global_c"]
        for (k, g), (_, w) in zip(tree_items(params_to_numpy(tc)), tree_items(_numpy(jc))):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("count", [2, 3, 4])
def test_fedmedian_even_and_odd_counts(count):
    names = [f"n{i}" for i in range(count)]
    jagg, tagg, _, _ = _round("fedmedian", names, [1] * count, seed=count)
    _assert_same(tagg.wait_and_get_aggregation(timeout=TIMEOUT),
                 jagg.wait_and_get_aggregation(timeout=TIMEOUT), f"median of {count}")


def test_fedmedian_reservoir_sampling_matches(both_settings):
    _set_both(AGG_MEDIAN_RESERVOIR=3, SEED=5)
    names = [f"n{i}" for i in range(7)]
    jagg, tagg, _, _ = _round("fedmedian", names, [1] * 7, seed=9)
    _assert_same(tagg.wait_and_get_aggregation(timeout=TIMEOUT),
                 jagg.wait_and_get_aggregation(timeout=TIMEOUT), "reservoir")


@pytest.mark.parametrize("kind", ["fedavg", "fedprox"])
def test_all_zero_weights_give_the_uniform_mean(kind):
    jagg, tagg, _, _ = _round(kind, ["a", "b", "c"], [0, 0, 0])
    tout = tagg.wait_and_get_aggregation(timeout=TIMEOUT)
    _assert_same(tout, jagg.wait_and_get_aggregation(timeout=TIMEOUT), "uniform")
    assert tout.get_num_samples() == 0


@pytest.mark.parametrize("eager", [False, True])
def test_partial_models_and_get_model_except(both_settings, eager):
    _set_both(AGG_STREAM_EAGER=eager)
    names = [("n0", "n1"), "n2", ("n3", "n4", "n5")]
    jagg, tagg, pairs, covered = _round("fedavg", names, [7, 2, 11])
    assert [c[1] for c in covered] == [["n0", "n1"], ["n0", "n1", "n2"],
                                       ["n0", "n1", "n2", "n3", "n4", "n5"]]
    for except_nodes in ([], ["n2"], ["n0", "n3"], ["n0", "n2", "n3"]):
        jp, tp = jagg.get_model(except_nodes), tagg.get_model(except_nodes)
        if jp is None:
            assert tp is None
        else:
            _assert_same(tp, jp, f"except {except_nodes}")
    # A model overlapping covered contributors is rejected by both.
    jm, tm = _pairs([("n1", "n2")], [1])[0]
    assert tagg.add_model(tm) == jagg.add_model(jm) == []
    _assert_same(tagg.wait_and_get_aggregation(timeout=TIMEOUT),
                 jagg.wait_and_get_aggregation(timeout=TIMEOUT), "partials")


def test_no_partial_aggregation_hands_out_singles():
    jagg, tagg, _, _ = _round("scaffold", ["a", "b", "c"], [1, 2, 3], train_set=["a", "b",
                                                                                 "c", "d"])
    for except_nodes in ([], ["a"], ["a", "b", "c"]):
        jp, tp = jagg.get_model(except_nodes), tagg.get_model(except_nodes)
        assert (tp is None) == (jp is None)
        if tp is not None:
            assert tp.get_contributors() == jp.get_contributors()


def test_round_quorum_closes_early(both_settings):
    _set_both(ROUND_QUORUM=0.5)
    jagg, tagg = JaxFedAvg("q"), FedAvg("q", device="cpu")
    pairs = _pairs(["a", "b", "c", "d"], [1, 2, 3, 4])
    for agg in (jagg, tagg):
        agg.set_nodes_to_aggregate(["a", "b", "c", "d"])
    for jm, tm in pairs[:2]:
        assert not tagg._finish_aggregation_event.is_set()
        jagg.add_model(jm)
        tagg.add_model(tm)
    assert tagg._finish_aggregation_event.is_set()
    assert tagg.get_missing_models() == jagg.get_missing_models() == {"c", "d"}
    _assert_same(tagg.wait_and_get_aggregation(timeout=TIMEOUT),
                 jagg.wait_and_get_aggregation(timeout=TIMEOUT), "quorum")


def test_remove_dead_nodes_shrinks_closes_and_readmits():
    jagg, tagg = JaxFedAvg("d"), FedAvg("d", device="cpu")
    pairs = _pairs(["a", ("b", "c")], [3, 5])
    for agg in (jagg, tagg):
        agg.set_nodes_to_aggregate(["a", "b", "c"])
        agg.add_model(pairs[0][0] if agg is jagg else pairs[0][1])
    before = logger.metrics.value("tpfl_agg_quorum_degraded_total", {"node": "d"})
    # "a" already reported: only b and c are removable; a is kept.
    assert tagg.remove_dead_nodes(["a", "b", "c"]) == jagg.remove_dead_nodes(["a", "b", "c"])
    assert tagg._train_set == jagg._train_set == ["a"]
    assert logger.metrics.value("tpfl_agg_quorum_degraded_total", {"node": "d"}) == before + 1
    _assert_same(tagg.wait_and_get_aggregation(timeout=TIMEOUT),
                 jagg.wait_and_get_aggregation(timeout=TIMEOUT), "dead")
    # A partial bundling dead-dropped members re-admits them.
    for agg in (jagg, tagg):
        agg.clear()
        agg.set_nodes_to_aggregate(["a", "b", "c"])
        agg.remove_dead_nodes(["b", "c"])
    assert tagg.add_model(pairs[1][1]) == jagg.add_model(pairs[1][0]) == ["b", "c"]
    assert tagg._train_set == jagg._train_set


def test_timeout_partial_and_empty():
    tagg = FedAvg("t", device="cpu")
    tagg.set_nodes_to_aggregate(["a", "b"])
    with pytest.raises(NoModelsToAggregateError):
        tagg.wait_and_get_aggregation(timeout=0.05)
    tagg.clear()
    tagg.set_nodes_to_aggregate(["a", "b"])
    (_, tm), = _pairs(["a"], [4])
    tagg.add_model(tm)
    out = tagg.wait_and_get_aggregation(timeout=0.05)
    assert out.get_contributors() == ["a"] and tagg.stalled(0.0)


def test_add_model_unblocks_waiter_thread():
    tagg = FedAvg("w", device="cpu")
    tagg.set_nodes_to_aggregate(["a", "b"])
    result = {}
    waiter = threading.Thread(target=lambda: result.update(
        out=tagg.wait_and_get_aggregation(timeout=TIMEOUT)), name="test-agg-waiter")
    waiter.start()
    for _, tm in _pairs(["a", "b"], [1, 1]):
        tagg.add_model(tm)
    waiter.join(timeout=TIMEOUT)
    assert not waiter.is_alive()
    assert result["out"].get_contributors() == ["a", "b"]
    with pytest.raises(Exception, match="already in progress"):
        tagg.set_nodes_to_aggregate(["a"])
        tagg.set_nodes_to_aggregate(["a"])


def test_scaffold_ignores_skipped_models_and_refuses_missing_info():
    jagg, tagg, _, _ = _round("scaffold", ["a", "b", "c"], [4, 0, 6])
    _assert_same(tagg.wait_and_get_aggregation(timeout=TIMEOUT),
                 jagg.wait_and_get_aggregation(timeout=TIMEOUT), "skipped")
    tagg = Scaffold("s", device="cpu")
    tagg.set_nodes_to_aggregate(["a"])
    tagg.add_model(_pairs(["a"], [3])[0][1])
    with pytest.raises(ValueError, match="delta_y_i"):
        tagg.wait_and_get_aggregation(timeout=TIMEOUT)


def _async_k(aggs, pairs):
    """An async round of K = 2 over three peers: two contributions close
    it on buffer-full."""
    for agg in aggs:
        agg.set_nodes_to_aggregate(["a", "b", "c"], async_k=2, round_ordinal=3)
    for j, (jm, tm) in enumerate(pairs[:2]):
        assert aggs[0].add_model(jm, start_version=3) == aggs[1].add_model(tm, start_version=3)
    return "buffer_full"


def _start_version(aggs, pairs):
    """Tags two and three versions behind the round: staleness weights."""
    for agg in aggs:
        agg.set_nodes_to_aggregate(["a", "b"], async_k=2, round_ordinal=5)
    for (jm, tm), v in zip(pairs[:2], (3, 2)):
        assert aggs[0].add_model(jm, start_version=v) == aggs[1].add_model(tm, start_version=v)
    return "buffer_full"


def _set_async_schedule(aggs, pairs):
    """A seeded schedule: the reverse-order arrivals admit in its order."""
    from tpfl.communication.faults import AsyncSchedule as JaxSchedule
    from tpfl_torch.communication.faults import AsyncSchedule

    aggs[0].set_async_schedule(JaxSchedule({"a": 1.0, "b": 1.0}, seed=4))
    aggs[1].set_async_schedule(AsyncSchedule({"a": 1.0, "b": 1.0}, seed=4))
    for agg in aggs:
        agg.set_nodes_to_aggregate(["a", "b"], async_k=2, round_ordinal=1)
    for jm, tm in reversed(pairs[:2]):
        assert aggs[0].add_model(jm, start_version=0) == aggs[1].add_model(tm, start_version=0)
    return "buffer_full"


def _async_deadline_close(aggs, pairs):
    """The deadline closes a K = 3 round holding one contribution."""
    for agg in aggs:
        agg.set_nodes_to_aggregate(["a", "b", "c"], async_k=3, round_ordinal=0)
        assert agg.async_deadline_close() is False
    jm, tm = pairs[0]
    assert aggs[0].add_model(jm, start_version=0) == aggs[1].add_model(tm, start_version=0)
    assert aggs[0].async_deadline_close() is aggs[1].async_deadline_close() is True
    return "deadline"


ASYNC_SEAMS = {"async_k": _async_k, "start_version": _start_version,
               "set_async_schedule": _set_async_schedule,
               "async_deadline_close": _async_deadline_close}


@pytest.mark.parametrize("seam", list(ASYNC_SEAMS))
def test_async_seams_match_jax(both_settings, seam):
    """Each async seam closes the round as the JAX package's does, with
    the same aggregate (the staleness-weighted fold)."""
    _set_both(ASYNC_STALENESS_EXP=0.5)
    aggs = (JaxFedAvg("r"), FedAvg("r", device="cpu"))
    reason = ASYNC_SEAMS[seam](aggs, _pairs(["a", "b"], [3, 5], seed=8))
    assert aggs[0].close_reason() == aggs[1].close_reason() == reason
    assert aggs[1].is_async() and not aggs[1].is_open() and aggs[1].wait_closed(timeout=0.0)
    _assert_same(aggs[1].wait_and_get_aggregation(timeout=TIMEOUT),
                 aggs[0].wait_and_get_aggregation(timeout=TIMEOUT), seam)


@pytest.mark.parametrize("knob", ["ASYNC_ROUNDS"])
def test_async_knobs_leave_sync_rounds_alone(both_settings, knob):
    """The async master switch is the stages' to read: a synchronous
    round (no ``async_k``) closes on coverage with it on, as the JAX
    package's does."""
    _set_both(**{knob: True})
    jagg, tagg, _, covered = _round("fedavg", ["a", "b"], [2, 3])
    assert [t for _, t in covered] == [j for j, _ in covered] == [["a"], ["a", "b"]]
    assert tagg.close_reason() == jagg.close_reason() == "coverage"
    assert not tagg.is_async()
    _assert_same(tagg.wait_and_get_aggregation(timeout=TIMEOUT),
                 jagg.wait_and_get_aggregation(timeout=TIMEOUT), knob)


def test_stack_models_and_staleness_weight_match():
    from tpfl.learning.aggregators.aggregator import stack_models as jax_stack
    from tpfl.learning.aggregators.aggregator import staleness_weight as jax_staleness
    from tpfl_torch.learning.aggregators.aggregator import stack_models, staleness_weight

    pairs = _pairs(["a", "b", "c"], [3, 0, 5])
    jstacked, jw = jax_stack([j for j, _ in pairs])
    tstacked, tw = stack_models([t for _, t in pairs], device="cpu")
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    for (k, g), (_, w) in zip(tree_items(params_to_numpy(tstacked)),
                              tree_items(_numpy(jstacked))):
        np.testing.assert_array_equal(g, w, err_msg=k)
    assert staleness_weight(0) == jax_staleness(0) == 1.0
    assert staleness_weight(2) == jax_staleness(2) == 3.0 ** -0.5


@pytest.mark.parametrize("eager", [False, True])
def test_concurrent_add_model_loses_no_contribution(both_settings, eager):
    """16 threads add their models at once under a short switch interval:
    every contribution is covered exactly once and the aggregate equals
    the deferred sorted fold of the same models."""
    import sys

    _set_both(AGG_STREAM_EAGER=eager)
    names = [f"n{i:02d}" for i in range(16)]
    pairs = _pairs(names, list(range(1, 17)), seed=3)
    tagg = FedAvg("c", device="cpu")
    tagg.set_nodes_to_aggregate(names)
    barrier = threading.Barrier(len(pairs))

    def add(model):
        barrier.wait(timeout=TIMEOUT)
        tagg.add_model(model)

    threads = [threading.Thread(target=add, args=(tm,), name=f"test-add-{i}")
               for i, (_, tm) in enumerate(pairs)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert sorted(tagg.get_aggregated_models()) == names
    out = tagg.wait_and_get_aggregation(timeout=TIMEOUT)
    jagg = JaxFedAvg("c")
    jagg.set_nodes_to_aggregate(names)
    for jm, _ in pairs:
        jagg.add_model(jm)
    _assert_same(out, jagg.wait_and_get_aggregation(timeout=TIMEOUT), "concurrent")
