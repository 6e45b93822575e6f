"""The port's elastic membership (``tpfl_torch.parallel.membership``, the
engine's ``resize_nodes`` / ``attach_membership`` / ``sync_membership``)
and the pipeline's elastic hooks against the JAX package's, on the CPU —
the cases of ``tests/test_elastic.py`` that exist in the port:

- ``capacity_tier`` and every ``MembershipView`` case — slots, weights,
  tier events, promotions, demotion hysteresis and its deferral under
  staleness pressure, quarantine masks, the state round trip — equal to
  the JAX view after the same event sequence, exactly, and a view's state
  crosses between the packages;
- the reference's "churn inside a tier never recompiles" is, in the
  port, "churn inside a tier never resizes the node-stacked state": a
  churn storm at a fixed tier calls ``resize_nodes`` zero times and
  keeps every state tensor's shape, and ends allclose (rtol 1e-4, atol
  1e-5) to the JAX engine's storm; a promotion and a demotion resize
  once each;
- a masked capacity-8 window with 4 live members against an exact n = 4
  window: live rows allclose;
- ``WindowPipeline``'s ``weights_for`` and snapshot cadence, its
  interrupt through ``interrupt_for``, and ``EngineWindow.abandon``.

The reference's compile-cache cases (``test_ensure_compile_cache_idempotent``,
``test_compile_cache_knob_via_engine``) and its ``FederationLearner``
cases (``ROADMAP.md`` §1 item 5) have no counterpart here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpfl.models import MLP as JaxMLP
from tpfl.parallel import FederationEngine as JaxEngine
from tpfl.parallel.membership import MembershipView as JaxView
from tpfl.parallel.mesh import capacity_tier as jax_capacity_tier
from tpfl.settings import Settings as JaxSettings
from tpfl_torch.interop import params_from_flax, params_to_numpy
from tpfl_torch.models import MLP
from tpfl_torch.parallel import FederationEngine, MembershipView, WindowPipeline, window_pipeline
from tpfl_torch.parallel.mesh import capacity_tier
from tpfl_torch.parallel.window_pipeline import interrupt_for
from tpfl_torch.settings import Settings
from tpfl_torch.utils.tree import canonical_leaves, tree_items, tree_map

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _settings():
    snaps = Settings.snapshot(), JaxSettings.snapshot()
    Settings.set_test_settings()
    yield
    Settings.restore(snaps[0])
    JaxSettings.restore(snaps[1])


def _data(n, nb=2, bs=8, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((n, nb, bs, 28, 28)).astype(np.float32),
            rng.integers(0, 10, (n, nb, bs)).astype(np.int32))


def _engines(n):
    jeng = JaxEngine(JaxMLP(hidden_sizes=(64,), compute_dtype=jnp.float32), n, seed=0)
    jp = jeng.init_params((28, 28))
    host = jax.tree_util.tree_map(np.array, dict(jp))
    teng = FederationEngine(MLP(hidden_sizes=(64,), compute_dtype=torch.float32), n,
                            device="cpu")
    return jeng, teng, jp, params_from_flax(host, device="cpu")


def _assert_close(port_params, jax_params, rows=None):
    got = params_to_numpy(port_params)
    want = jax.tree_util.tree_map(np.array, dict(jax_params))
    for layer in want:
        for leaf in want[layer]:
            g, w = got[layer][leaf], want[layer][leaf]
            if rows is not None:
                g, w = g[:rows], w[:rows]
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=f"{layer}/{leaf}")


def _views(*args, **kw):
    return MembershipView(*args, **kw), JaxView(*args, **kw)


def _same(view, jview):
    """Every observable of the two views equal."""
    assert view.capacity == jview.capacity and view.live == jview.live
    assert view.members() == jview.members()
    assert view.quarantined() == jview.quarantined()
    assert view.tier_events() == jview.tier_events()
    assert view.promotions() == jview.promotions()
    np.testing.assert_array_equal(view.weights(), jview.weights())
    assert view.state_export() == jview.state_export()


def _apply(views, kind, *args):
    outs = [getattr(v, kind)(*args) for v in views]
    assert outs[0] == outs[1], (kind, args, outs)
    return outs[0]


# --- capacity tiers and the view --------------------------------------------


def test_capacity_tier_pow2_buckets():
    for n in range(0, 70):
        for floor in (1, 2, 4, 8):
            assert capacity_tier(n, floor) == jax_capacity_tier(n, floor)
    assert [capacity_tier(n) for n in (0, 1, 2, 3, 5, 8, 9)] == [1, 1, 2, 4, 8, 8, 16]
    assert capacity_tier(1, floor=4) == 4 and capacity_tier(6, floor=4) == 8
    assert capacity_tier(100, floor=2) == 128


def test_membership_join_leave_slot_reuse():
    views = _views(["a", "b", "c"], capacity_min=2)
    assert views[0].capacity == 4 and views[0].live == 3
    assert _apply(views, "leave", "b") == 1
    assert _apply(views, "join", "d") == 1
    assert _apply(views, "join", "d") == 1
    assert _apply(views, "crash", "nobody") is None
    w = views[0].weights()
    assert w.shape == (4,) and w.dtype == np.float32
    np.testing.assert_array_equal(w, [1.0, 1.0, 1.0, 0.0])
    _same(*views)


def test_membership_promotion_doubles_capacity():
    views = _views(["a", "b"], capacity_min=2)
    assert views[0].capacity == 2 and views[0].promotions() == 0
    for addr, cap in (("c", 4), ("d", 4), ("e", 8)):
        _apply(views, "join", addr)
        assert views[0].capacity == cap
    assert [e["kind"] for e in views[0].tier_events()] == ["promote", "promote"]
    _same(*views)


def test_membership_demotion_hysteresis_and_compaction():
    views = _views([f"n{i}" for i in range(8)], capacity_min=2)
    for i in range(2, 7):
        _apply(views, "leave", f"n{i}")
    assert _apply(views, "maybe_resize") is None and views[0].capacity == 8
    _apply(views, "leave", "n7")
    assert _apply(views, "maybe_resize") == 2
    assert views[0].slot_of("n0") == 0 and views[0].slot_of("n1") == 1
    assert views[0].weights().shape == (2,)
    _same(*views)


def test_membership_demotion_defers_under_staleness_pressure():
    class _Controller:
        def __init__(self, tau):
            self.tau = tau

        def state_export(self):
            return {"tau_mean": self.tau}

    views = _views([f"n{i}" for i in range(8)], capacity_min=2)
    for i in range(1, 8):
        _apply(views, "leave", f"n{i}")
    assert _apply(views, "maybe_resize", _Controller(3.0)) is None
    assert views[0].capacity == 8
    assert _apply(views, "maybe_resize", _Controller(0.5)) == 2
    _same(*views)


def test_membership_quarantine_is_a_mask_edit():
    views = _views(["a", "b", "c"], capacity_min=4)
    assert _apply(views, "quarantine", "b") and not _apply(views, "quarantine", "ghost")
    np.testing.assert_array_equal(views[0].weights(), [1.0, 0.0, 1.0, 0.0])
    assert views[0].slot_of("b") == 1
    assert _apply(views, "readmit", "b") and not _apply(views, "readmit", "b")
    _apply(views, "apply_verdicts", {"a", "c", "not-a-member"})
    assert views[0].quarantined() == {"a", "c"}
    np.testing.assert_array_equal(views[0].weights(), [0.0, 1.0, 0.0, 0.0])
    _same(*views)
    _apply(views, "apply_verdicts", set())
    np.testing.assert_array_equal(views[0].weights(), [1.0, 1.0, 1.0, 0.0])


def test_membership_weights_base_dict():
    views = _views(["a", "b"], capacity_min=4)
    np.testing.assert_array_equal(views[0].weights({"a": 0.5}), [0.5, 1.0, 0.0, 0.0])
    np.testing.assert_array_equal(views[0].weights({"a": 0.5}), views[1].weights({"a": 0.5}))


def test_membership_state_round_trip_and_cross_package():
    views = _views(["a", "b", "c"], capacity_min=2)
    for kind, addr in (("join", "d"), ("join", "e"), ("leave", "b"), ("quarantine", "c")):
        _apply(views, kind, addr)
    _same(*views)
    state = views[0].state_export()
    back, jback = MembershipView.from_state(views[1].state_export()), JaxView.from_state(state)
    _same(back, jback)
    assert back.capacity == 8 and back.quarantined() == {"c"}
    assert back.join("b") == 1 == jback.join("b")


# --- the engine at a tier -----------------------------------------------------

STORM = [("leave", "n1"), ("join", "n1"), ("crash", "n2"), ("join", "n2"),
         ("quarantine", "n3"), ("readmit", "n3"), ("leave", "n0"), ("join", "n0"),
         ("quarantine", "n1"), ("readmit", "n1")]


def _counting_resizes(engine):
    calls = []
    real = engine.resize_nodes

    def resize(n):
        calls.append(n)
        real(n)

    engine.resize_nodes = resize
    return calls


def test_churn_storm_never_resizes_at_fixed_tier():
    """Ten membership events at tier 4: each is a weight edit — no
    ``resize_nodes`` call, every state tensor keeps its shape — and the
    stormed params end allclose to the JAX engine's over the same
    weights."""
    n = 4
    jeng, teng, jp, tp = _engines(n)
    xs, ys = _data(n)
    views = _views([f"n{i}" for i in range(n)], capacity_min=4)
    teng.attach_membership(views[0])
    jeng.attach_membership(views[1])
    resizes = _counting_resizes(teng)
    shapes = [t.shape for t in canonical_leaves(tp)]
    jx, jy = jeng.shard_data(xs, ys)
    for kind, addr in STORM:
        _apply(views, kind, addr)
        assert not teng.sync_membership() and not jeng.sync_membership()
        tp, _ = teng.run_rounds(tp, xs, ys, weights=views[0].weights(), n_rounds=1)
        jp, _ = jeng.run_rounds(jp, jx, jy, weights=views[1].weights(), n_rounds=1,
                                donate=False)
        assert [t.shape for t in canonical_leaves(tp)] == shapes
    assert resizes == [] and views[0].promotions() == 0 and teng.n_nodes == 4
    _assert_close(tp, jp)


def test_tier_promotion_and_demotion_resize_once_each():
    view = MembershipView([f"n{i}" for i in range(4)], capacity_min=4)
    _, teng, _, tp = _engines(4)
    teng.attach_membership(view)
    resizes = _counting_resizes(teng)
    xs8, ys8 = _data(8)
    teng.run_rounds(tp, xs8[:4], ys8[:4], weights=view.weights(), n_rounds=1)
    view.join("n4")
    assert view.promotions() == 1 and teng.sync_membership()
    assert teng.n_nodes == teng.padded_nodes == 8 and teng.valid.shape == (8,)
    p8, _ = teng.run_rounds(teng.pad_stacked(tp), xs8, ys8, weights=view.weights(), n_rounds=1)
    assert next(iter(canonical_leaves(p8))).shape[0] == 8
    for a in ("n4", "n3", "n2", "n1"):
        view.leave(a)
    assert teng.sync_membership() and view.capacity == 4
    assert not teng.sync_membership()
    assert resizes == [8, 4]


def test_attach_membership_adopts_the_tier():
    view = MembershipView([f"n{i}" for i in range(5)], capacity_min=2)
    _, teng, _, _ = _engines(5)
    teng.attach_membership(view)
    assert teng.membership is view and teng.n_nodes == teng.padded_nodes == 8


def test_masked_run_matches_exact_size_run():
    """A capacity-8 window with 4 live members (rows 4-7 clones of row 0
    at weight zero) against an exact n = 4 window: the live rows agree
    within the CPU bounds, as the JAX elastic run's do."""
    n_live = 4
    jeng, exact, jp, tp = _engines(n_live)
    xs, ys = _data(n_live)
    out_exact, _ = exact.run_rounds(tp, xs, ys, n_rounds=2, donate=False)  # tp runs again
    view = MembershipView([f"n{i}" for i in range(n_live)], capacity_min=8)
    elastic = FederationEngine(MLP(hidden_sizes=(64,), compute_dtype=torch.float32), n_live,
                               device="cpu")
    elastic.attach_membership(view)
    assert elastic.n_nodes == 8
    out_el, _ = elastic.run_rounds(elastic.pad_stacked(tp), *elastic.shard_data(xs, ys),
                                   weights=view.weights(), n_rounds=2)
    for (path, a), (_, b) in zip(tree_items(out_el), tree_items(out_exact)):
        torch.testing.assert_close(a[:n_live], b, rtol=RTOL, atol=ATOL, msg=path)
    jout, _ = jeng.run_rounds(jp, *jeng.shard_data(xs, ys), n_rounds=2, donate=False)
    _assert_close(tree_map(lambda t: t[:n_live], out_el), jout)


# --- the pipeline's elastic hooks ----------------------------------------------


def test_pipeline_weights_for_and_snapshot_cadence():
    n = 4
    _, teng, _, tp = _engines(n)
    xs, ys = teng.shard_data(*_data(n))
    calls, snaps = [], []

    def weights_for(widx):
        calls.append(widx)
        return np.ones((teng.padded_nodes,), np.float32)

    result, done = WindowPipeline(teng).run(
        tp, xs, ys, n_rounds=6, window=2, weights_for=weights_for, snapshot_every=1,
        snapshot_to=lambda r, s: snaps.append((r, s)))
    assert done == 6 and result is not None and calls == [0, 1, 2]
    assert [r for r, _ in snaps] == [2, 4, 6]
    assert [s["rounds_done"] for _, s in snaps] == [2, 4, 6]
    final = params_to_numpy(teng.unpad(result[0]))
    for layer, leaves in snaps[-1][1]["params"].items():
        for leaf, v in leaves.items():
            np.testing.assert_array_equal(v, final[layer][leaf])


def test_pipeline_interrupt_abandons_cleanly():
    assert interrupt_for("nobody-registered") is False
    n = 4
    _, teng, _, tp = _engines(n)
    xs, ys = teng.shard_data(*_data(n))
    hits = []

    def weights_for(widx):
        hits.append(widx)
        if widx == 1:
            assert interrupt_for("host-0")
        return None

    result, done = WindowPipeline(teng).run(tp, xs, ys, n_rounds=8, window=2,
                                            weights_for=weights_for, owner="host-0")
    assert result is None and done == 4 and hits == [0, 1]
    with window_pipeline._ACTIVE_LOCK:
        assert "host-0" not in window_pipeline._ACTIVE


def test_engine_window_abandon_is_terminal():
    n = 2
    _, teng, _, tp = _engines(n)
    handle = teng.dispatch_window(tp, *_data(n), n_rounds=1)
    handle.abandon()
    assert handle.finalize() is None
    handle.abandon()
    assert handle.finalize() is None


def test_export_state_owns_its_bytes():
    """A snapshot does not alias the engine's tensors: rounds after it
    (from the same params) leave it as it was."""
    n = 2
    _, teng, _, tp = _engines(n)
    snap = teng.export_state(tp)
    before = {k: {kk: v.copy() for kk, v in d.items()} for k, d in snap["params"].items()}
    out, _ = teng.run_rounds(tp, *_data(n), n_rounds=1)
    for leaf in canonical_leaves(tp):
        leaf.add_(1.0)  # even a caller that writes the input in place
    for layer, leaves in before.items():
        for leaf, v in leaves.items():
            np.testing.assert_array_equal(snap["params"][layer][leaf], v)
    moved = max(float((a[:n] - torch.from_numpy(b)).abs().max())
                for a, b in zip(canonical_leaves(out), canonical_leaves(before)))
    assert moved > 0


def test_crash_and_stop_reach_the_pipeline_interrupt(monkeypatch):
    """``FaultInjector.crash`` and ``Node.stop`` interrupt a pipeline run
    registered for the node's address, as the reference's do."""
    from tpfl_torch.communication.faults import FaultInjector, FaultPlan
    from tpfl_torch.learning.dataset.synthetic import synthetic_mnist
    from tpfl_torch.learning.model import TpflModel
    from tpfl_torch.node import Node

    calls = []
    monkeypatch.setattr(window_pipeline, "interrupt_for", calls.append)
    FaultInjector(FaultPlan(), seed=0).crash("elastic-crash")
    Settings.DISABLE_SIMULATION = True
    from tpfl_torch.models import init_params

    module = MLP(hidden_sizes=(8,), compute_dtype=torch.float32)
    model = TpflModel(module, init_params(module, (28, 28), seed=0, device="cpu"), device="cpu")
    node = Node(model, synthetic_mnist(n_train=16, n_test=8, seed=0), addr="elastic-stop",
                device="cpu")
    node.start()
    node.stop()
    assert calls == ["elastic-crash", "elastic-stop"]
