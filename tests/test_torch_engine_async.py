"""The port's FedBuff windows and free-running window pipeline
(``tpfl_torch.parallel.engine`` / ``window_pipeline``) against the JAX
package's, on the CPU — the cases of ``tests/test_engine_async.py`` that
exist in the port, each on both packages with the same params (moved
across with ``tpfl_torch.interop``) and the same numpy-seeded data:

- the tiers' ``MLP(hidden_sizes=(64,))`` on 28×28 and a narrow f32 CNN
  through ``conv_impl="pallas"`` (the port's plain versions; the JAX
  package's Pallas kernels in interpret mode): FedBuff windows, τ-0
  windows, the staleness weight and the stragglers' rows allclose to the
  JAX engine's ``run_rounds(schedule=)`` at rtol 1e-4, atol 1e-5 (the
  port's CPU bounds: f32 sums in another order);
- the schedule's masks (``from_periods``, ``from_plan``, ``window``)
  equal to the JAX package's, exactly;
- in the port: pipelined bytes equal to sequential dispatch, with a
  schedule and the telemetry carry too; two same-seed pipelined fedbuff
  runs equal; an all-arrive schedule equal to the sync window, byte for
  byte;
- the pipeline's behaviour: prefetch threads joined, interrupts between
  windows, a failing supplier propagates;
- the fedbuff telemetry fan-out: the ledger's arrival-gated entries and
  the staleness gauge equal to the JAX package's, and the controller's
  state after the window equal to the JAX controller's.

Windows donate their state (``Settings.ENGINE_DONATE``): a run that
must start from a state another run also starts from gets its own copy
(``_copy``). The donation report of a 4-node window equals the JAX
engine's (the reference's ``test_donation_still_clean``); the 8-device
mesh case runs in ``tests/test_torch_engine_mesh.py``.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpfl.communication.faults import TrainerSpeedPlan as JaxSpeedPlan
from tpfl.learning.async_control import AsyncController as JaxController
from tpfl.management import ledger as jax_ledger
from tpfl.management.telemetry import flight as jax_flight
from tpfl.management.telemetry import metrics as jax_metrics
from tpfl.models import CNN as JaxCNN
from tpfl.models import MLP as JaxMLP
from tpfl.parallel import FedBuffSchedule as JaxSchedule
from tpfl.parallel import FederationEngine as JaxEngine
from tpfl.settings import Settings as JaxSettings
from tpfl_torch.communication.faults import TrainerSpeedPlan
from tpfl_torch.interop import params_from_flax, params_to_numpy
from tpfl_torch.learning.aggregators.aggregator import staleness_weight
from tpfl_torch.learning.async_control import AsyncController
from tpfl_torch.management import ledger
from tpfl_torch.management.telemetry import flight, metrics
from tpfl_torch.models import CNN, MLP
from tpfl_torch.parallel import FedBuffSchedule, FederationEngine, WindowPipeline
from tpfl_torch.settings import Settings
from tpfl_torch.utils.tree import canonical_leaves, tree_map

RTOL, ATOL = 1e-4, 1e-5

MODELS = {
    "mlp": (lambda: JaxMLP(hidden_sizes=(64,), compute_dtype=jnp.float32),
            lambda: MLP(hidden_sizes=(64,), compute_dtype=torch.float32), (28, 28)),
    "cnn": (lambda: JaxCNN(channels=(4, 8), dense=16, out_channels=10,
                           compute_dtype=jnp.float32, conv_impl="pallas"),
            lambda: CNN(channels=(4, 8), dense=16, out_channels=10,
                        compute_dtype=torch.float32, conv_impl="pallas"), (8, 8, 3)),
}


@pytest.fixture(autouse=True)
def _settings():
    snaps = Settings.snapshot(), JaxSettings.snapshot()
    Settings.set_test_settings()
    yield
    Settings.restore(snaps[0])
    JaxSettings.restore(snaps[1])
    for lg in (ledger, jax_ledger):
        lg.contrib.reset()
        lg.convergence.reset()
    flight.clear()
    jax_flight.clear()
    # No engine series stays behind for a later file on the same worker
    # (tests/test_engine_async.py reads the first tpfl_engine_staleness).
    metrics.reset()
    jax_metrics.reset()


def _set_both(**knobs):
    for s in (Settings, JaxSettings):
        for k, v in knobs.items():
            setattr(s, k, v)


def _data(n, shape=(28, 28), nb=2, bs=8, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.random((n, nb, bs, *shape)).astype(np.float32)
    ys = rng.integers(0, 10, (n, nb, bs)).astype(np.int32)
    return xs, ys


def _host(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), dict(tree))


def _engines(n, model="mlp"):
    """(JAX engine, port engine, JAX params, port params): the same
    stacked initial params on both."""
    jax_module, port_module, shape = MODELS[model]
    jeng = JaxEngine(jax_module(), n, seed=0)
    jp = jeng.init_params(shape)
    teng = FederationEngine(port_module(), n, device="cpu")
    return jeng, teng, jp, params_from_flax(_host(jp), device="cpu")


def _copy(tree):
    """An own copy of a port state tree, for a second run from the same
    start (a donating window writes its input state)."""
    return tree_map(torch.clone, tree)


def _bytes(tree):
    return b"".join(t.contiguous().numpy().tobytes() for t in canonical_leaves(tree))


def _assert_close(port_params, jax_params):
    got, want = params_to_numpy(port_params), _host(jax_params)
    for layer in want:
        for leaf in want[layer]:
            np.testing.assert_allclose(got[layer][leaf], want[layer][leaf], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{layer}/{leaf}")


def _run_sequential(teng, p, xs, ys, n_rounds, window, schedule=None):
    done, losses = 0, None
    while done < n_rounds:
        k = min(window, n_rounds - done)
        sub = None if schedule is None else schedule.window(done, k)
        p, losses = teng.run_rounds(p, xs, ys, n_rounds=k, schedule=sub)
        done += k
    return p, losses


def _run_pipelined(teng, p, xs, ys, n_rounds, window, schedule=None, **kw):
    pipe = WindowPipeline(teng)
    (p, losses), done = pipe.run(p, xs, ys, n_rounds=n_rounds, window=window,
                                 schedule=schedule, **kw)
    assert done == n_rounds
    return p, losses, pipe


# --- FedBuff windows against the JAX engine --------------------------------


@pytest.mark.parametrize("model", sorted(MODELS))
def test_fedbuff_windows_match_jax(model):
    """Chained fedbuff windows (a 3-period straggler, a 2-period one) and
    the last losses allclose to the JAX engine's, per window."""
    _set_both(ASYNC_STALENESS_EXP=0.5)
    n = 4
    jeng, teng, jp, tp = _engines(n, model)
    xs, ys = _data(n, MODELS[model][2])
    jx, jy = jeng.shard_data(xs, ys)
    for start in (0, 3):
        js = JaxSchedule.from_periods([1, 1, 2, 3], 3, start_round=start)
        ts = FedBuffSchedule.from_periods([1, 1, 2, 3], 3, start_round=start)
        jp, jl = jeng.run_rounds(jp, jx, jy, n_rounds=3, schedule=js, donate=False)
        tp, tl = teng.run_rounds(tp, xs, ys, n_rounds=3, schedule=ts)
        _assert_close(tp, jp)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)
    assert teng._rounds_done == jeng._rounds_done == 6


def test_pipeline_byte_identical_to_sequential():
    n = 4
    _, teng, _, tp = _engines(n)
    xs, ys = teng.shard_data(*_data(n))
    ps, ls = _run_sequential(teng, _copy(tp), xs, ys, n_rounds=6, window=2)
    pp, lp, _ = _run_pipelined(teng, tp, xs, ys, n_rounds=6, window=2)
    assert _bytes(ps) == _bytes(pp)
    assert ls.numpy().tobytes() == lp.numpy().tobytes()


@pytest.mark.parametrize("model", sorted(MODELS))
def test_pipeline_byte_identical_with_fedbuff_and_telemetry(model):
    """Schedule + telemetry carry + pipelining: the model bytes equal the
    sequential chain's, the JAX pipeline's within the CPU bounds, and two
    same-seed pipelined runs are byte-identical."""
    _set_both(ENGINE_TELEMETRY=True)
    n = 4
    jeng, teng, jp, tp = _engines(n, model)
    xs, ys = teng.shard_data(*_data(n, MODELS[model][2]))
    ps, _ = _run_sequential(teng, _copy(tp), xs, ys, n_rounds=6, window=2,
                            schedule=FedBuffSchedule.from_periods([1, 1, 2, 3], 6))
    runs = [_run_pipelined(teng, _copy(tp), xs, ys, n_rounds=6, window=2,
                           schedule=FedBuffSchedule.from_periods([1, 1, 2, 3], 6))[0]
            for _ in range(2)]
    assert _bytes(ps) == _bytes(runs[0]) == _bytes(runs[1])
    from tpfl.parallel import WindowPipeline as JaxPipeline

    (jout, _), done = JaxPipeline(jeng).run(
        jp, *jeng.shard_data(*_data(n, MODELS[model][2])), n_rounds=6, window=2,
        schedule=JaxSchedule.from_periods([1, 1, 2, 3], 6), donate=False)
    assert done == 6
    _assert_close(runs[0], jout)


def test_donation_report_refused_naming_item_8():
    """The donation report of a 4-node window (the reference's
    ``test_donation_still_clean``) is clean and equals the JAX engine's
    dict; donating and non-donating windows give the same bytes, the
    non-donating one leaving its input intact."""
    n = 4
    jeng, teng, jp, tp = _engines(n)
    xs, ys = _data(n)
    report = teng.donation_report(tp, xs, ys, n_rounds=2)
    assert report["clean"], report
    assert report == jeng.donation_report(jp, *jeng.shard_data(xs, ys), n_rounds=2)
    start = _bytes(tp)
    b, _ = teng.run_rounds(tp, xs, ys, n_rounds=2, donate=False)
    assert _bytes(tp) == start
    a, _ = teng.run_rounds(tp, xs, ys, n_rounds=2, donate=True)
    assert _bytes(a) == _bytes(b) != start
    assert all(x is y for x, y in zip(canonical_leaves(a), canonical_leaves(tp)))


# --- the staleness math ----------------------------------------------------


@pytest.mark.parametrize("model", sorted(MODELS))
def test_fedbuff_tau_zero_bit_parity_with_sync(model):
    """An all-arrive, τ-0 schedule gives the sync window's bytes in the
    port, and the JAX fedbuff window's values within the CPU bounds."""
    n, n_rounds = 4, 3
    jeng, teng, jp, tp = _engines(n, model)
    xs, ys = _data(n, MODELS[model][2])
    sync_p, sync_l = teng.run_rounds(_copy(tp), xs, ys, n_rounds=n_rounds)
    sched = FedBuffSchedule.from_periods([1] * n, n_rounds)
    assert sched.arrivals.all() and not sched.taus.any()
    fb_p, fb_l = teng.run_rounds(tp, xs, ys, n_rounds=n_rounds, schedule=sched)
    assert _bytes(sync_p) == _bytes(fb_p)
    assert sync_l.numpy().tobytes() == fb_l.numpy().tobytes()
    jfb, _ = jeng.run_rounds(jp, *jeng.shard_data(xs, ys), n_rounds=n_rounds, donate=False,
                             schedule=JaxSchedule.from_periods([1] * n, n_rounds))
    _assert_close(fb_p, jfb)


def test_fedbuff_staleness_weight_matches_host_math():
    """Arrival i folds at ``w_i·(1+τ_i)^−exp`` — the port aggregator's
    ``staleness_weight`` — against a hand-computed fold of each node's
    solo-trained params, and the JAX engine's fold."""
    _set_both(ASYNC_STALENESS_EXP=0.5)
    n, taus = 4, [0, 1, 2, 3]
    jeng, teng, jp, tp = _engines(n)
    xs, ys = _data(n)
    trained = []
    for i in range(n):
        w = np.zeros((n,), np.float32)
        w[i] = 1.0
        pi, _ = teng.run_rounds(_copy(tp), xs, ys, weights=w, n_rounds=1)
        trained.append([t[i].numpy().astype(np.float64) for t in canonical_leaves(pi)])
    sched = FedBuffSchedule(np.ones((1, n), np.float32), np.asarray([taus], np.float32))
    fb, _ = teng.run_rounds(tp, xs, ys, n_rounds=1, schedule=sched)
    sw = np.asarray([staleness_weight(t) for t in taus], np.float64)
    np.testing.assert_allclose(sw, (1.0 + np.asarray(taus, np.float64)) ** -0.5)
    for li, leaf in enumerate(canonical_leaves(fb)):
        expect = sum(sw[i] * trained[i][li] for i in range(n)) / sw.sum()
        np.testing.assert_allclose(leaf[0].numpy().astype(np.float64), expect, rtol=2e-5,
                                   atol=2e-6)
    jfb, _ = jeng.run_rounds(jp, *jeng.shard_data(xs, ys), n_rounds=1, donate=False,
                             schedule=JaxSchedule(np.ones((1, n), np.float32),
                                                  np.asarray([taus], np.float32)))
    _assert_close(fb, jfb)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_fedbuff_stragglers_keep_local_state(model):
    """A node in flight keeps its locally-trained params (its solo
    training's row, byte for byte); arrivals hold the fold; both as the
    JAX engine's rows within the CPU bounds."""
    n = 4
    jeng, teng, jp, tp = _engines(n, model)
    xs, ys = _data(n, MODELS[model][2])
    arrivals = np.asarray([[1, 1, 1, 0]], np.float32)
    sched = FedBuffSchedule(arrivals, np.zeros((1, n), np.float32))
    fb, _ = teng.run_rounds(_copy(tp), xs, ys, n_rounds=1, schedule=sched)
    solo, _ = teng.run_rounds(tp, xs, ys, weights=np.asarray([0, 0, 0, 1], np.float32),
                              n_rounds=1)
    row = lambda tree, i: tree_map(lambda t: t[i], tree)  # noqa: E731
    assert _bytes(row(fb, 3)) == _bytes(row(solo, 3))
    assert _bytes(row(fb, 0)) == _bytes(row(fb, 1)) != _bytes(row(fb, 3))
    jfb, _ = jeng.run_rounds(jp, *jeng.shard_data(xs, ys), n_rounds=1, donate=False,
                             schedule=JaxSchedule(arrivals, np.zeros((1, n), np.float32)))
    _assert_close(fb, jfb)


# --- the schedule's masks --------------------------------------------------


def test_speed_plan_mask_determinism_and_jax_equality():
    addrs = [f"node-{i}" for i in range(10)]
    kw = dict(slow_frac=0.2, skew=10.0, seed=3)
    sa = FedBuffSchedule.from_plan(TrainerSpeedPlan.skewed(addrs, **kw), addrs, n_rounds=20)
    sb = FedBuffSchedule.from_plan(TrainerSpeedPlan.skewed(addrs, **kw), addrs, n_rounds=20)
    sj = JaxSchedule.from_plan(JaxSpeedPlan.skewed(addrs, **kw), addrs, n_rounds=20)
    for a in (sb, sj):
        assert np.array_equal(sa.arrivals, a.arrivals) and np.array_equal(sa.taus, a.taus)
    per_node = sa.arrivals.sum(axis=0)
    assert max(per_node) == 20 and min(per_node) == 2 and sa.taus.max() == 9.0
    assert (sa.arrivals.sum(axis=1) > 0).all()
    parts = [sa.window(0, 8), sa.window(8, 8), sa.window(16, 4)]
    jparts = [sj.window(0, 8), sj.window(8, 8), sj.window(16, 4)]
    assert np.array_equal(np.concatenate([p.arrivals for p in parts]), sa.arrivals)
    for p, q in zip(parts, jparts):
        assert np.array_equal(p.arrivals, q.arrivals) and np.array_equal(p.taus, q.taus)
    for periods, start in (([1, 2, 3, 5], 0), ([1, 2, 7], 4)):
        t, j = (FedBuffSchedule.from_periods(periods, 9, start),
                JaxSchedule.from_periods(periods, 9, start))
        assert np.array_equal(t.arrivals, j.arrivals) and np.array_equal(t.taus, j.taus)


def test_schedule_rejects_empty_round_and_bad_windows():
    for sched_cls in (FedBuffSchedule, JaxSchedule):
        with pytest.raises(ValueError, match="no arrivals"):
            sched_cls(np.asarray([[1, 1], [0, 0]], np.float32), np.zeros((2, 2), np.float32))
        with pytest.raises(ValueError, match="outside"):
            sched_cls.from_periods([1, 1], 3).window(2, 2)
    n = 4
    _, teng, _, tp = _engines(n)
    xs, ys = _data(n)
    with pytest.raises(ValueError, match="schedule covers 3 rounds"):
        teng.run_rounds(tp, xs, ys, n_rounds=2, schedule=FedBuffSchedule.from_periods([1] * n, 3))
    with pytest.raises(ValueError, match="schedule has 3 nodes"):
        teng.run_rounds(tp, xs, ys, n_rounds=3, schedule=FedBuffSchedule.from_periods([1] * 3, 3))


# --- shutdown hygiene ------------------------------------------------------


def _prefetch_threads():
    return [t for t in threading.enumerate() if "prefetch" in t.name]


def test_pipeline_prefetch_no_leaked_threads():
    calls = []

    def data_for(widx, start, k):
        calls.append((widx, start, k, threading.current_thread().name))
        return None

    n = 4
    _, teng, _, tp = _engines(n)
    xs, ys = teng.shard_data(*_data(n))
    _run_pipelined(teng, tp, xs, ys, n_rounds=6, window=2, data_for=data_for, prefetch=True)
    assert _prefetch_threads() == []
    assert [c[:3] for c in calls] == [(0, 0, 2), (1, 2, 2), (2, 4, 2)]
    assert calls[0][3] == threading.current_thread().name
    assert all("tpfl-window-prefetch" in c[3] for c in calls[1:])


def test_pipeline_staged_data_equals_inline_data():
    """The prefetch knob never changes bytes: fresh data per window from
    ``data_for``, staged on the thread or inline."""
    n = 4
    _, teng, _, tp = _engines(n)

    def data_for(widx, start, k):
        return teng.shard_data(*_data(n, seed=10 + widx))

    outs = [_run_pipelined(teng, _copy(tp), None, None, n_rounds=6, window=2, data_for=data_for,
                           prefetch=pre)[0] for pre in (True, False)]
    assert _bytes(outs[0]) == _bytes(outs[1])


def test_pipeline_interrupt_stops_between_windows():
    n = 4
    _, teng, _, tp = _engines(n)
    xs, ys = teng.shard_data(*_data(n))
    polls = {"n": 0}

    def should_stop():
        polls["n"] += 1
        return polls["n"] > 2

    pipe = WindowPipeline(teng)
    result, done = pipe.run(tp, xs, ys, n_rounds=6, window=2, prefetch=True,
                            should_stop=should_stop)
    assert done == 4 and result is not None and pipe.windows_run == 2
    assert _prefetch_threads() == []


def test_pipeline_supplier_error_propagates_and_joins():
    def data_for(widx, start, k):
        if widx == 1:
            raise RuntimeError("staging exploded")
        return None

    n = 4
    _, teng, _, tp = _engines(n)
    xs, ys = teng.shard_data(*_data(n))
    with pytest.raises(RuntimeError, match="staging exploded"):
        WindowPipeline(teng).run(tp, xs, ys, n_rounds=6, window=2, data_for=data_for,
                                 prefetch=True)
    assert _prefetch_threads() == []


# --- the telemetry fan-out: staleness and the controller ----------------------


def _staleness_gauge(registry, tag):
    return registry.fold()["gauges"][("tpfl_engine_staleness", (("model", tag),))]


def test_fedbuff_telemetry_staleness_fanout():
    """Ledger entries for arrivals only, with their staleness and
    version, equal to the JAX fan-out's; the staleness gauge too."""
    _set_both(ENGINE_TELEMETRY=True, LEDGER_ENABLED=True)
    n = 4
    jeng, teng, jp, tp = _engines(n)
    xs, ys = _data(n)
    teng.run_rounds(tp, xs, ys, n_rounds=3, schedule=FedBuffSchedule.from_periods([1, 1, 1, 3], 3))
    jeng.run_rounds(jp, *jeng.shard_data(xs, ys), n_rounds=3, donate=False,
                    schedule=JaxSchedule.from_periods([1, 1, 1, 3], 3))
    from tpfl.management.profiling import module_tag as jax_tag
    from tpfl_torch.management.profiling import module_tag

    assert (_staleness_gauge(metrics, module_tag(teng.module)) == pytest.approx(0.5)
            == _staleness_gauge(jax_metrics, jax_tag(jeng.module)))

    def entries(lg):
        return [e for e in lg.contrib.entries() if str(e["peer"]).startswith("engine-node-")]

    got, want = entries(ledger), entries(jax_ledger)
    assert len(got) == len(want) == 10
    keys = ("peer", "round", "staleness", "version", "num_samples", "flagged", "reasons")
    assert [{k: e[k] for k in keys} for e in got] == [{k: e[k] for k in keys} for e in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose([a["update_norm"], a["cos_ref"]],
                                   [b["update_norm"], b["cos_ref"]], rtol=RTOL, atol=ATOL)
    late = [e for e in got if e["peer"] == "engine-node-3"]
    assert [(e["round"], e["staleness"], e["version"]) for e in late] == [(2, 2, 0)]


def test_fedbuff_feeds_async_controller():
    """The controller folds each fedbuff round's arrivals as the JAX
    controller does: equal state after the window."""
    _set_both(ENGINE_TELEMETRY=True, ASYNC_ADAPTIVE=True)
    n = 4
    jeng, teng, jp, tp = _engines(n)
    teng.controller, jeng.controller = AsyncController(), JaxController()
    xs, ys = _data(n)
    teng.run_rounds(tp, xs, ys, n_rounds=3, schedule=FedBuffSchedule.from_periods([1, 1, 1, 3], 3))
    jeng.run_rounds(jp, *jeng.shard_data(xs, ys), n_rounds=3, donate=False,
                    schedule=JaxSchedule.from_periods([1, 1, 1, 3], 3))
    ctrl = teng.controller
    assert ctrl._last_reason == "buffer_full" and ctrl._last_arrivals == n
    assert ctrl._tau_mean is not None and ctrl._tau_mean > 0.0
    assert ctrl.state_export() == jeng.controller.state_export()
    assert ctrl.round_open(3, n) == jeng.controller.round_open(3, n)


def test_dispatch_window_handle_chains_and_finalizes_once():
    """``run_rounds`` is ``dispatch_window(...).finalize()``: a handle's
    params chain into the next dispatch, ``finalize`` is idempotent, and
    on the CPU the window is ready when the dispatch returns."""
    n = 4
    _, teng, _, tp = _engines(n)
    xs, ys = teng.shard_data(*_data(n))
    h1 = teng.dispatch_window(_copy(tp), xs, ys, n_rounds=2)
    h2 = teng.dispatch_window(h1.params, xs, ys, n_rounds=1)
    assert h1.ready() and h2.ready() and h2.n_rounds == 1
    out = h2.finalize()
    assert h2.finalize() is out
    ref, _ = teng.run_rounds(tp, xs, ys, n_rounds=3)
    assert _bytes(out[0]) == _bytes(ref)
