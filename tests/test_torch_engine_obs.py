"""The port's engine telemetry carry (``Settings.ENGINE_TELEMETRY``) and
its fan-out (``tpfl_torch.management.engine_obs``) against the JAX
package's, on the CPU — the cases of ``tests/test_engine_obs.py`` that
exist in the port, with the same params and numpy-seeded data:

- the carry's schema and values (loss, update norm, reference cosine,
  delta and model norms, participation, weight mass, wire bytes) allclose
  to the JAX carry at rtol 1e-4, atol 1e-5, for the tiers' MLP and a
  narrow f32 CNN through ``conv_impl="pallas"``;
- model bytes identical with the carry on and off;
- the fan-out into the profiler's per-round rows, the convergence
  monitor and the registry series, the ledger's election-gated entries;
- a sign-flip adversary (``attack_scales``) flagged from the carry, with
  the same detections and quarantine replay as the JAX package's;
- ``replay_window`` over one host carry gives both packages the same
  ledger entries, detections and flags, exactly;
- ``record_external`` (ledger and profiler) and ``observe_delta``;
- a failed dispatch dumps the ``engine`` flight ring.

The reference's HLO-text case (the program without the carry lowers to
the same bytes across a toggle) has no counterpart: the port compiles no
programs.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpfl.attacks.plan import AttackPlan as JaxPlan
from tpfl.attacks.plan import AttackSpec as JaxSpec
from tpfl.management import engine_obs as jax_engine_obs
from tpfl.management import ledger as jax_ledger
from tpfl.management import quarantine as jax_quarantine
from tpfl.management.telemetry import flight as jax_flight
from tpfl.management.telemetry import metrics as jax_metrics
from tpfl.models import CNN as JaxCNN
from tpfl.models import MLP as JaxMLP
from tpfl.parallel import FederationEngine as JaxEngine
from tpfl.settings import Settings as JaxSettings
from tpfl_torch.attacks.plan import AttackPlan, AttackSpec
from tpfl_torch.interop import params_from_flax
from tpfl_torch.management import engine_obs, ledger, profiling, quarantine
from tpfl_torch.management.telemetry import flight, metrics
from tpfl_torch.models import CNN, MLP
from tpfl_torch.parallel import FederationEngine
from tpfl_torch.parallel.engine import (
    TELEMETRY_FIELDS,
    TELEMETRY_NODE_FIELDS,
    TELEMETRY_ROUND_FIELDS,
)
from tpfl_torch.settings import Settings
from tpfl_torch.utils.tree import canonical_leaves

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
    for lg in (ledger, jax_ledger):
        lg.contrib.reset()
        lg.convergence.reset()
    profiling.rounds.reset()
    yield
    Settings.restore(snaps[0])
    JaxSettings.restore(snaps[1])
    for lg in (ledger, jax_ledger):
        lg.contrib.reset()
        lg.convergence.reset()
    profiling.rounds.reset()
    # No engine series or engine:<tag> ring stays behind for a later file
    # on the same worker (tests/test_engine_async.py reads the first
    # tpfl_engine_staleness series; tests/test_engine_obs.py the first
    # engine ring).
    for reg in (metrics, jax_metrics):
        reg.reset()
    for ring in (flight, jax_flight):
        for node in ring.nodes():
            if node.startswith("engine:"):
                ring.clear(node)


def _set_both(**knobs):
    for s in (Settings, JaxSettings):
        for k, v in knobs.items():
            setattr(s, k, v)


def _data(n, shape=(28, 28), nb=1, bs=4, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((n, nb, bs, *shape)).astype(np.float32),
            rng.integers(0, 10, (n, nb, bs)).astype(np.int32))


def _engines(n=8, model="mlp"):
    jax_module, port_module, shape = MODELS[model]
    jeng = JaxEngine(jax_module(), n, seed=0)
    jp = jeng.init_params(shape)
    host = jax.tree_util.tree_map(np.array, dict(jp))
    return jeng, FederationEngine(port_module(), n, device="cpu"), jp, params_from_flax(
        host, device="cpu")


def _port_carry(teng, tp, xs, ys, n_rounds, weights=None, scales=None):
    """The port's carry of one window, as host numpy: the telemetry
    program of the window's cache key, as ``_jax_carry`` takes the JAX
    engine's."""
    kind, args = teng._prepare_args(tp, xs, ys, weights, n_rounds, None, None, scales, None)
    fn = teng.program(kind, 1, n_rounds, args[6].dim(), donate=False, telemetry=True,
                      a_ndim=0 if scales is None else args[8].dim())
    return {k: v.numpy() for k, v in fn(*args)[5].items()}


def _jax_carry(jeng, jp, xs, ys, n_rounds, weights=None):
    fn = jeng.program("plain", 1, n_rounds, 1, donate=False, telemetry=True)
    dx, dy = jeng.shard_data(xs, ys)
    out = fn(jp, {}, {}, {}, dx, dy, jeng.pad_weights(weights), jeng.valid)
    return {k: np.asarray(v) for k, v in out[5].items()}


def _model_bytes(tele, n=8, rounds=3, scales=None, weights=None):
    Settings.ENGINE_TELEMETRY = tele
    _, teng, _, tp = _engines(n)
    p, _ = teng.run_rounds(tp, *_data(n), weights=weights, n_rounds=rounds, attack_scales=scales)
    return b"".join(t.numpy().tobytes() for t in canonical_leaves(p))


# --- the carry -------------------------------------------------------------


@pytest.mark.parametrize("model", sorted(MODELS))
def test_telemetry_carry_matches_jax_carry(model):
    n, rounds = 8, 3
    jeng, teng, jp, tp = _engines(n, model)
    xs, ys = _data(n, MODELS[model][2])
    w = np.asarray([1, 1, 0, 1, 0, 2, 1, 1], np.float32)
    got, want = _port_carry(teng, tp, xs, ys, rounds, w), _jax_carry(jeng, jp, xs, ys, rounds, w)
    assert set(got) == set(want) == set(TELEMETRY_FIELDS)
    for k in TELEMETRY_NODE_FIELDS:
        assert got[k].shape == (rounds, teng.padded_nodes)
    for k in TELEMETRY_ROUND_FIELDS:
        assert got[k].shape == (rounds,)
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)
    for k in TELEMETRY_NODE_FIELDS:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)
    np.testing.assert_allclose(got["participation"], 6.0)
    np.testing.assert_allclose(got["weight_mass"], 7.0)


def test_telemetry_carry_schema_full_participation():
    n = 8
    _, teng, _, tp = _engines(n)
    tele = _port_carry(teng, tp, *_data(n), n_rounds=3)
    np.testing.assert_allclose(tele["participation"], 8.0)
    np.testing.assert_allclose(tele["weight_mass"], 8.0)
    assert np.all(tele["cos_ref"] > 0.9) and np.all(tele["update_norm"] > 0.0)
    assert np.all(tele["delta_norm"] > 0.0)


def test_model_bytes_identical_with_telemetry():
    w = np.asarray([1, 1, 0, 1, 0, 1, 1, 1], np.float32)
    assert _model_bytes(False, weights=w) == _model_bytes(True, weights=w)


# --- the fan-out -----------------------------------------------------------


def _run_windowed(tele=True, n=8, rounds=3, scales=None, weights=None, model="mlp"):
    Settings.ENGINE_TELEMETRY = tele
    _, teng, _, tp = _engines(n, model)
    teng.run_rounds(tp, *_data(n, MODELS[model][2]), weights=weights, n_rounds=rounds,
                    attack_scales=scales)
    return teng


def _node_tag(teng):
    return f"engine:{profiling.module_tag(teng.module)}"


def test_fanout_profiler_rows_per_round():
    Settings.PROFILING_ENABLED = True
    teng = _run_windowed(rounds=3)
    mine = profiling.rounds.attribution(_node_tag(teng))
    per_round = [r for r in mine if r.get("external")]
    assert len(mine) == 4
    assert [r["round"] for r in per_round] == [0, 1, 2]
    for rec in per_round:
        assert rec["parts"]["dispatch"] >= 0.0 and rec["parts"]["train"] >= 0.0
        assert rec["coverage"] >= 0.95


def test_fanout_convergence_and_registry_series():
    Settings.LEDGER_ENABLED = True
    flight.clear()
    teng = _run_windowed(rounds=3)
    folded = metrics.fold()
    names = {k[0] for kind in ("counters", "gauges", "histograms") for k in folded[kind]}
    for expect in ("tpfl_engine_rounds_total", "tpfl_engine_loss", "tpfl_engine_delta_norm",
                   "tpfl_engine_participation", "tpfl_engine_weight_mass",
                   "tpfl_engine_update_norm", "tpfl_engine_cos_ref", "tpfl_engine_wire_bytes",
                   "tpfl_convergence_delta_norm"):
        assert expect in names, expect
    events = [e for e in flight.snapshot(_node_tag(teng)) if e.get("name") == "engine_window"]
    assert events and events[-1]["rounds"] == 3


def test_fanout_ledger_respects_election():
    Settings.LEDGER_ENABLED = True
    w = np.asarray([1, 1, 0, 1, 0, 1, 1, 0], np.float32)
    _run_windowed(rounds=2, weights=w)
    entries = ledger.contrib.entries()
    assert {e["peer"] for e in entries} == {f"engine-node-{i}" for i in np.flatnonzero(w > 0)}
    assert len(entries) == 2 * int((w > 0).sum())


def test_disabled_planes_record_nothing():
    assert not Settings.PROFILING_ENABLED and not Settings.LEDGER_ENABLED
    _run_windowed(rounds=2)
    assert ledger.contrib.entries() == []
    assert profiling.rounds.attribution() == []


# --- a seeded adversary through the ledger and the quarantine --------------


@pytest.mark.parametrize("model", sorted(MODELS))
def test_engine_sign_flip_adversary_precision_recall_one(model):
    """Flips on nodes 2 and 5: the port's detections flag exactly them,
    as the JAX package's do from the same params and data, and the
    quarantine replays agree."""
    _set_both(LEDGER_ENABLED=True, ENGINE_TELEMETRY=True)
    n = 8
    specs = {2: "sign_flip", 5: "sign_flip"}
    plan = AttackPlan({i: AttackSpec(a) for i, a in specs.items()}, seed=7)
    jplan = JaxPlan({i: JaxSpec(a) for i, a in specs.items()}, seed=7)
    addrs = engine_obs.peer_names(n)
    scales = plan.engine_scales(addrs, n_rounds=3)
    assert np.array_equal(scales, jplan.engine_scales(addrs, n_rounds=3))
    jeng, teng, jp, tp = _engines(n, model)
    xs, ys = _data(n, MODELS[model][2])
    teng.run_rounds(tp, xs, ys, n_rounds=3, attack_scales=scales)
    jeng.run_rounds(jp, *jeng.shard_data(xs, ys), n_rounds=3, attack_scales=scales,
                    donate=False)
    det, jdet = ledger.contrib.detections(), jax_ledger.contrib.detections()
    truth = set(plan.adversary_map(addrs))
    assert truth == {"engine-node-2", "engine-node-5"}
    assert set(det["flagged"]) == set(jdet["flagged"]) == truth
    for peer in truth:
        assert "sign_flip" in det["flagged"][peer]["reasons"]
    actions = quarantine.replay_decisions(det)
    assert actions == jax_quarantine.replay_decisions(jdet)
    assert quarantine.quarantined_from_replay(actions) == truth


def test_attack_scales_match_host_side_sign_flip():
    Settings.LEDGER_ENABLED = True
    scales = np.ones((2, 8), np.float32)
    scales[:, 3] = -1.0
    _run_windowed(rounds=2, scales=scales)
    for e in ledger.contrib.entries():
        if e["peer"] == "engine-node-3":
            assert e["cos_ref"] < -0.9 and e["flagged"] and "sign_flip" in e["reasons"]
        else:
            assert e["cos_ref"] > 0.9


def test_engine_scales_validation():
    plan = AttackPlan({0: AttackSpec("additive_noise")}, seed=1)
    with pytest.raises(ValueError, match="sign_flip"):
        plan.engine_scales(["a"], n_rounds=2)
    _, teng, _, tp = _engines(6)
    with pytest.raises(ValueError, match="attack_scales"):
        teng.pad_attack_scales(np.ones((4,), np.float32))
    assert teng.pad_attack_scales(np.ones((6,), np.float32)).shape == (teng.padded_nodes,)
    with pytest.raises(ValueError, match="per-round attack_scales"):
        teng.run_rounds(tp, *_data(6), n_rounds=3, attack_scales=np.ones((2, 6), np.float32))


def test_replay_window_same_carry_same_verdicts():
    """One host carry (the JAX program's, with a flipped node, a
    non-elected node and a fedbuff staleness row) replayed by both
    packages: the same ledger entries, detections, quarantine replay and
    summary, exactly."""
    _set_both(LEDGER_ENABLED=True, ASYNC_STALENESS_MAX=1)
    n, rounds = 8, 4
    jeng, _, jp, _ = _engines(n)
    xs, ys = _data(n)
    w = np.ones((n,), np.float32)
    w[6] = 0.0
    scales = np.ones((n,), np.float32)
    scales[1] = -1.0
    fn = jeng.program("plain", 1, rounds, 1, donate=False, telemetry=True, a_ndim=1)
    out = fn(jp, {}, {}, {}, *jeng.shard_data(xs, ys), jeng.pad_weights(w), jeng.valid,
             jnp.asarray(scales))
    carry = {k: np.asarray(v) for k, v in out[5].items()}
    carry["staleness"] = np.zeros((rounds, n), np.float32)
    carry["staleness"][:, 4] = [-1.0, 2.0, -1.0, 2.0]
    kw = dict(weights=w, wall_seconds=0.5, dispatch_seconds=0.1)
    got = engine_obs.replay_window("engine:same", "m", 10, carry, n, **kw)
    want = jax_engine_obs.replay_window("engine:same", "m", 10, carry, n, **kw)
    assert {k: got[k] for k in ("rounds", "recorded", "flagged")} == {
        k: want[k] for k in ("rounds", "recorded", "flagged")}
    keys = ("peer", "round", "staleness", "version", "update_norm", "cos_ref", "z_norm",
            "flagged", "reasons", "num_samples")
    assert [{k: e[k] for k in keys} for e in ledger.contrib.entries()] == [
        {k: e[k] for k in keys} for e in jax_ledger.contrib.entries()]
    det, jdet = ledger.contrib.detections(), jax_ledger.contrib.detections()
    assert det == jdet and "engine-node-1" in det["flagged"]
    assert "stale_flood" in det["flagged"]["engine-node-4"]["reasons"]
    assert quarantine.replay_decisions(det) == jax_quarantine.replay_decisions(jdet)


# --- a failed dispatch -----------------------------------------------------


def test_engine_failure_dumps_flight_ring(tmp_path, monkeypatch):
    Settings.TELEMETRY_DUMP_DIR = str(tmp_path)
    flight.clear("engine")
    _, teng, _, tp = _engines()

    def boom(*args, **kwargs):
        raise RuntimeError("injected dispatch failure")

    monkeypatch.setattr(teng, "_run_window", boom)
    with pytest.raises(RuntimeError, match="injected dispatch failure"):
        teng.run_rounds(tp, *_data(8), n_rounds=2)
    dumps = list(tmp_path.glob("flight-engine-runtimeerror.json"))
    assert dumps, list(tmp_path.iterdir())
    doc = json.loads(dumps[0].read_text())
    events = [e for e in doc["events"] if e["name"] == "engine_failure"]
    assert events and "injected dispatch failure" in events[-1]["error"]
    assert events[-1]["program"] == "plainx2"
    flight.clear("engine")


# --- the planes' entry points ------------------------------------------------


def test_ledger_record_external_scores_like_intake():
    _set_both(LEDGER_ENABLED=True)
    node = "engine:unit"
    for lg in (ledger, jax_ledger):
        for r in range(4):
            e = lg.contrib.record_external(node, "p-honest", r, 1.0 + 0.01 * r, 0.99)
            assert e is not None and not e["flagged"]
    bad = ledger.contrib.record_external(node, "p-evil", 4, 500.0, -0.98)
    jbad = jax_ledger.contrib.record_external(node, "p-evil", 4, 500.0, -0.98)
    assert bad["flagged"] and set(bad["reasons"]) == {"sign_flip", "norm_outlier"}
    keys = ("peer", "round", "version", "z_norm", "flagged", "reasons", "contributors")
    assert {k: bad[k] for k in keys} == {k: jbad[k] for k in keys}
    again = ledger.contrib.record_external(node, "p-evil", 4, 1.0, 0.9)
    assert again is bad or again["t"] == bad["t"]
    assert ledger.contrib.detections() == jax_ledger.contrib.detections()


def test_ledger_record_external_off_records_nothing():
    assert not Settings.LEDGER_ENABLED and not Settings.QUARANTINE_ENABLED
    assert ledger.contrib.record_external("engine:unit", "p", 0, 1.0, 1.0) is None
    assert ledger.contrib.entries() == []


def test_convergence_observe_delta_events():
    _set_both(LEDGER_ENABLED=True, LEDGER_CONVERGENCE_WINDOW=3)
    node = "engine:unit"
    for seq, event in (((1.0, 2.0, 3.0), "divergence"), ((1e-5,) * 3, "plateau")):
        for lg in (ledger, jax_ledger):
            lg.convergence.reset()
        for r, d in enumerate(seq):
            out = ledger.convergence.observe_delta(node, r, d, 10.0)
            jout = jax_ledger.convergence.observe_delta(node, r, d, 10.0)
            assert (out is None) == (jout is None)
        assert out.get("event") == jout.get("event") == event


def test_profiler_record_external_gated_and_emitting():
    assert not Settings.PROFILING_ENABLED
    assert profiling.rounds.record_external("n", 0, {"train": 0.1}, 0.2) is None
    Settings.PROFILING_ENABLED = True
    flight.clear("n")
    rec = profiling.rounds.record_external("n", 7, {"train": 0.1, "dispatch": 0.05}, 0.2)
    assert rec["round"] == 7 and rec["external"]
    assert rec["parts"]["host_other"] == pytest.approx(0.05)
    assert rec["coverage"] == pytest.approx(1.0)
    assert profiling.rounds.attribution("n") == [rec]
    spans = [e for e in flight.snapshot("n") if e["name"] == "round"]
    assert spans and spans[-1]["round"] == 7 and spans[-1]["s_train"] == 0.1
    flight.clear("n")


def test_module_tag_is_the_reference_rule():
    from tpfl.management.profiling import module_tag as jax_tag

    class Named:
        def __repr__(self):
            return "CNN(channels=(32, 64))"

    assert profiling.module_tag(Named()) == jax_tag(Named())
    assert len(profiling.module_tag(MLP())) == 4
