"""The port's adaptive async control plane
(``tpfl_torch.learning.async_control``) and the staleness-aware defense
against the JAX package's, on the CPU — the cases of
``tests/test_async_control.py``, each on both packages with the same
inputs:

- the controller: every ``round_open`` decision and the whole
  trajectory equal to the JAX controller's for the same observation
  sequences (exact dicts) — passthrough, bounds and fleet clamp, the
  deadline shrink, the fast-fill growth, staleness pressure, order
  invariance, reset;
- ``ASYNC_UNTAGGED_POLICY``: the resolution, the max-stale fold (the
  port's aggregate within rtol 1e-6 of JAX's), reject at intake, ignored
  in sync rounds;
- the deadline's re-arm attempt ordinals in the flight ring and its
  counter, reset per round;
- the ledger's ``stale_flood`` class (implausible τ, a version
  regression), live through ``score_now``;
- a stale-flooding peer quarantined and readmitted through the
  aggregator, with the same decisions as the JAX engine's;
- federations through ``run_seeded_experiment`` (3 MLP Nodes): two
  serialized same-seed runs with the controller on give identical,
  non-empty trajectories at every node, equal to the JAX federation's;
  a 5-node stale-flooding fleet whose quarantine decisions equal the
  JAX fleet's and name exactly the flooder, for ``stale_flood``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpfl.attacks import AttackPlan as JaxPlan
from tpfl.attacks import AttackSpec as JaxSpec
from tpfl.attacks import adversary_map as jax_adversary_map
from tpfl.attacks import controller_trajectories as jax_trajectories
from tpfl.attacks import run_seeded_experiment as jax_run
from tpfl.communication.faults import TrainerSpeedPlan as JaxSpeedPlan
from tpfl.communication.memory import clear_registry as jax_clear_registry
from tpfl.learning.aggregators import FedAvg as JaxFedAvg
from tpfl.learning.aggregators.aggregator import untagged_staleness as jax_untagged
from tpfl.learning.async_control import AsyncController as JaxController
from tpfl.learning.dataset import synthetic_mnist as jax_synthetic_mnist
from tpfl.learning.model import TpflModel as JaxModel
from tpfl.management import ledger as jax_ledger
from tpfl.management import quarantine as jax_quarantine
from tpfl.management.ledger import AnomalyScorer as JaxScorer
from tpfl.management.logger import logger as jax_logger
from tpfl.management.quarantine import QuarantineEngine as JaxQuarantine
from tpfl.management.telemetry import flight as jax_flight
from tpfl.models import create_model as jax_create_model
from tpfl.settings import Settings as JaxSettings
from tpfl_torch.attacks import (AttackPlan, AttackSpec, adversary_map, controller_trajectories,
                                final_model_digests, run_seeded_experiment)
from tpfl_torch.communication.faults import TrainerSpeedPlan
from tpfl_torch.communication.memory import clear_registry
from tpfl_torch.interop import model_state_from_jax
from tpfl_torch.learning.aggregators import FedAvg
from tpfl_torch.learning.aggregators.aggregator import staleness_weight, untagged_staleness
from tpfl_torch.learning.async_control import AsyncController, _quantile
from tpfl_torch.learning.dataset.synthetic import synthetic_mnist
from tpfl_torch.learning.model import TpflModel
from tpfl_torch.management import ledger, quarantine
from tpfl_torch.management.ledger import AnomalyScorer
from tpfl_torch.management.logger import logger
from tpfl_torch.management.quarantine import QuarantineEngine
from tpfl_torch.management.telemetry import flight
from tpfl_torch.models import MLP
from tpfl_torch.settings import Settings

RTOL, ATOL = 1e-6, 1e-7


@pytest.fixture(autouse=True)
def _settings():
    snaps = (Settings.snapshot(), JaxSettings.snapshot())
    for s in (Settings, JaxSettings):
        s.set_test_settings()
        s.DISABLE_SIMULATION = True
        s.ELECTION = "hash"
    levels = logger.get_level(), jax_logger.get_level()
    logger.set_level("ERROR")
    jax_logger.set_level("ERROR")
    clear_registry()
    jax_clear_registry()
    ledger.contrib.reset()
    jax_ledger.contrib.reset()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    clear_registry()
    jax_clear_registry()
    ledger.contrib.reset()
    jax_ledger.contrib.reset()
    logger.set_level(levels[0])
    jax_logger.set_level(levels[1])
    Settings.restore(snaps[0])
    JaxSettings.restore(snaps[1])


def _set_both(**knobs):
    for s in (Settings, JaxSettings):
        for k, v in knobs.items():
            setattr(s, k, v)


def mk(value, n_samples, contributors):
    tree = {"w": np.full((3, 3), value, np.float32), "b": np.full((3,), value, np.float32)}
    return (JaxModel(params=jax.tree_util.tree_map(jnp.asarray, tree), num_samples=n_samples,
                     contributors=contributors),
            TpflModel(params=tree, num_samples=n_samples, contributors=contributors,
                      device="cpu"))


def leaf(model):
    return float(np.asarray(model.get_parameters()["w"])[0, 0])


class Ctl:
    """A JAX and a port controller fed the same calls; every decision and
    the trajectories must be equal."""

    def __init__(self, node="n"):
        self.j, self.t = JaxController(node), AsyncController(node)

    def open(self, rnd, fleet):
        got, want = self.t.round_open(rnd, fleet), self.j.round_open(rnd, fleet)
        assert got == want
        assert self.t.trajectory() == self.j.trajectory()
        return got

    def observe(self, rnd, arrivals, reason, armed):
        self.t.observe_round(rnd, arrivals, reason, armed)
        self.j.observe_round(rnd, arrivals, reason, armed)
        assert self.t.state_export() == self.j.state_export()


class Both:
    def __init__(self, node="n"):
        self.j, self.t = JaxFedAvg(node), FedAvg(node, device="cpu")

    def open(self, *args, **kw):
        self.j.set_nodes_to_aggregate(*args, **kw)
        self.t.set_nodes_to_aggregate(*args, **kw)

    def add(self, pair, **kw):
        want, got = self.j.add_model(pair[0], **kw), self.t.add_model(pair[1], **kw)
        assert got == want
        return got

    def result(self):
        jout = self.j.wait_and_get_aggregation(timeout=1.0)
        tout = self.t.wait_and_get_aggregation(timeout=1.0)
        for k, v in tout.get_parameters().items():
            np.testing.assert_allclose(v.numpy(), np.asarray(jout.get_parameters()[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
        assert tout.get_contributors() == jout.get_contributors()
        return tout

    def clear(self):
        self.j.clear()
        self.t.clear()


def _counter(log, name, node):
    return sum(v for (n, labels), v in log.metrics.fold()["counters"].items()
               if n == name and dict(labels).get("node") == node)


# --- controller tuning -----------------------------------------------------


def test_controller_passthrough_when_disabled():
    _set_both(ASYNC_ADAPTIVE=False, ASYNC_BUFFER_K=7, ASYNC_ROUND_DEADLINE=33.0)
    ctl = Ctl()
    assert ctl.open(0, 100) == (7, 33.0)
    ctl.observe(0, [(0, 1.0), (0, 2.0)], "buffer_full", 33.0)
    assert ctl.open(1, 100) == (7, 33.0)
    assert ctl.t.trajectory() == []


def test_controller_bounds_and_fleet_clamp():
    _set_both(ASYNC_ADAPTIVE=True, ASYNC_BUFFER_K=64, ASYNC_K_MIN=2, ASYNC_K_MAX=16)
    ctl = Ctl()
    k, deadline = ctl.open(0, 5)
    assert 2 <= k <= 5 and 0.0 < deadline <= Settings.ASYNC_ROUND_DEADLINE
    assert ctl.open(1, 1000)[0] <= 16


def test_controller_shrinks_k_on_deadline_close():
    _set_both(ASYNC_ADAPTIVE=True, ASYNC_BUFFER_K=8)
    ctl = Ctl()
    k0, dl = ctl.open(0, 20)
    assert k0 == 8
    ctl.observe(0, [(0, 1.0), (0, 2.0), (0, 3.0)], "deadline", dl)
    assert ctl.open(1, 20)[0] == 3
    ctl.observe(1, [(0, 1.0)], "deadline", dl)
    assert ctl.open(2, 20)[0] == Settings.ASYNC_K_MIN


def test_controller_grows_k_when_buffer_fills_fast():
    _set_both(ASYNC_ADAPTIVE=True, ASYNC_BUFFER_K=4, ASYNC_SERIALIZED=False)
    ctl = Ctl()
    k0, dl = ctl.open(0, 20)
    ctl.observe(0, [(0, 0.1), (0, 0.2), (0, 0.3), (0, 0.4)], "buffer_full", dl)
    k1, dl1 = ctl.open(1, 20)
    assert k1 == k0 + 1 and dl1 < Settings.ASYNC_ROUND_DEADLINE


def test_controller_staleness_pressure_sheds_k():
    _set_both(ASYNC_ADAPTIVE=True, ASYNC_BUFFER_K=8)
    ctl = Ctl()
    _, dl = ctl.open(0, 20)
    ctl.observe(0, [(6, 0.1), (8, 0.2), (7, 0.3)], "buffer_full", dl)
    assert ctl.open(1, 20)[0] == 7


def test_controller_observations_are_order_invariant():
    _set_both(ASYNC_ADAPTIVE=True)
    rounds = [([(0, 1.0), (1, 3.0), (0, 2.0)], "buffer_full"),
              ([(2, 5.0), (0, 4.5)], "deadline"),
              ([(0, 6.0), (0, 6.5), (1, 7.0)], "buffer_full")]
    a, b = Ctl("a"), Ctl("b")
    for rnd, (arrivals, reason) in enumerate(rounds):
        _, dla = a.open(rnd, 10)
        _, dlb = b.open(rnd, 10)
        a.observe(rnd, arrivals, reason, dla)
        b.observe(rnd, list(reversed(arrivals)), reason, dlb)
    assert a.t.trajectory() == b.t.trajectory() == a.j.trajectory()
    assert _quantile([1.0, 2.0, 3.0, 4.0], 0.9) == 4.0 and _quantile([], 0.5) == 0.0


def test_controller_reset_drops_learned_state():
    _set_both(ASYNC_ADAPTIVE=True)
    ctl = Ctl()
    _, dl = ctl.open(0, 10)
    ctl.observe(0, [(0, 1.0), (0, 2.0)], "deadline", dl)
    kept = ctl.t.trajectory()
    ctl.t.reset()
    ctl.j.reset()
    assert ctl.t.trajectory() == [] and ctl.t.last_trajectory() == kept
    assert ctl.open(0, 10) == (Settings.ASYNC_BUFFER_K, Settings.ASYNC_ROUND_DEADLINE)
    restored = AsyncController("r")
    restored.state_import(ctl.t.state_export())
    assert restored.state_export() == ctl.t.state_export()


# --- untagged freshness policy ---------------------------------------------


def test_untagged_policy_resolution():
    _set_both(ASYNC_STALENESS_MAX=16)
    for policy, want in (("fresh", 0), ("max-stale", 16), ("reject", None)):
        _set_both(ASYNC_UNTAGGED_POLICY=policy)
        assert untagged_staleness() == jax_untagged() == want


def test_untagged_max_stale_discounts_fold_weight():
    _set_both(ASYNC_UNTAGGED_POLICY="max-stale", ASYNC_STALENESS_MAX=8, ASYNC_STALENESS_EXP=0.5)
    agg = Both()
    agg.open(["a", "b"], async_k=2, round_ordinal=50)
    agg.add(mk(1.0, 10, ["a"]), start_version=50)
    agg.add(mk(3.0, 10, ["b"]))
    w = 10 * staleness_weight(8)
    assert leaf(agg.result()) == pytest.approx((1.0 * 10 + 3.0 * w) / (10 + w), rel=1e-5)
    agg.clear()


def test_untagged_reject_refuses_at_intake():
    _set_both(ASYNC_UNTAGGED_POLICY="reject")
    agg = Both("rej-n")
    agg.open(["a", "b"], async_k=2, round_ordinal=5)
    before = (_counter(logger, "tpfl_agg_untagged_rejected_total", "rej-n"),
              _counter(jax_logger, "tpfl_agg_untagged_rejected_total", "rej-n"))
    assert agg.add(mk(3.0, 10, ["b"])) == []
    assert _counter(logger, "tpfl_agg_untagged_rejected_total", "rej-n") == before[0] + 1
    assert _counter(jax_logger, "tpfl_agg_untagged_rejected_total", "rej-n") == before[1] + 1
    assert agg.t.get_aggregated_models() == agg.j.get_aggregated_models() == []
    assert agg.add(mk(1.0, 10, ["a"]), start_version=5) == ["a"]
    agg.clear()


def test_untagged_policy_ignored_in_sync_rounds():
    _set_both(ASYNC_UNTAGGED_POLICY="reject")
    agg = Both()
    agg.open(["a"])
    assert agg.add(mk(1.0, 10, ["a"])) == ["a"]
    agg.clear()


# --- deadline re-arm observability -----------------------------------------


def _deadline_events(fl, node):
    return [(e["attempt"], e["outcome"]) for e in fl.snapshot(node)
            if e.get("name") == "round_deadline"]


def test_deadline_rearm_attempt_field_and_counter():
    _set_both(TELEMETRY_ENABLED=True)
    flight.clear("rearm-n")
    jax_flight.clear("rearm-n")
    try:
        agg = Both("rearm-n")
        agg.open(["a", "b"], async_k=2, round_ordinal=0)
        before = _counter(logger, "tpfl_agg_deadline_rearm_total", "rearm-n")
        for _ in range(2):
            assert agg.t.async_deadline_close() is agg.j.async_deadline_close() is False
        assert _counter(logger, "tpfl_agg_deadline_rearm_total", "rearm-n") == before + 2
        assert _deadline_events(flight, "rearm-n") == [(1, "empty"), (2, "empty")]
        agg.add(mk(1.0, 10, ["a"]), start_version=0)
        assert agg.t.async_deadline_close() is agg.j.async_deadline_close() is True
        assert _deadline_events(flight, "rearm-n") == _deadline_events(jax_flight, "rearm-n") == [
            (1, "empty"), (2, "empty"), (3, "closed")]
        agg.clear()
    finally:
        flight.clear("rearm-n")
        jax_flight.clear("rearm-n")


def test_deadline_attempt_resets_per_round():
    agg = Both()
    agg.open(["a"], async_k=1, round_ordinal=0)
    agg.t.async_deadline_close()
    agg.j.async_deadline_close()
    agg.add(mk(1.0, 10, ["a"]), start_version=0)
    agg.result()
    agg.clear()
    agg.open(["a"], async_k=1, round_ordinal=1)
    assert agg.t._deadline_attempt == agg.j._deadline_attempt == 0
    agg.clear()


# --- the stale_flood anomaly class -----------------------------------------


@pytest.mark.parametrize("max_tau,tau,regressed", [(4, 5, False), (4, 4, False), (-1, 500, False),
                                                   (16, 0, True)])
def test_scorer_flags_implausible_staleness(max_tau, tau, regressed):
    _set_both(ASYNC_STALENESS_MAX=max_tau)
    got = AnomalyScorer.score(1.0, 1.0, [], staleness=tau, version_regressed=regressed)
    assert got == JaxScorer.score(1.0, 1.0, [], staleness=tau, version_regressed=regressed)
    assert got[0] == (tau > max_tau >= 0 or regressed)


def test_scorer_flags_version_regression():
    _set_both(ASYNC_STALENESS_MAX=16)
    got = AnomalyScorer.score(1.0, 1.0, [], staleness=0, version_regressed=True)
    assert got == JaxScorer.score(1.0, 1.0, [], staleness=0, version_regressed=True)
    assert got[0] and got[1] == ["stale_flood"]


def test_score_now_stale_flood_and_regression_end_to_end():
    _set_both(QUARANTINE_ENABLED=True, LEDGER_ENABLED=True, ASYNC_STALENESS_MAX=3)
    ref = mk(1.0, 1, ["ref"])
    calls = [(10, "good", 1.01, 1), (10, "evil", 1.02, 10), (11, "good", 1.01, 6)]
    got, want = [], []
    for rnd in (10, 11):
        ledger.contrib.open_round("n", rnd, ref[1].get_parameters())
        jax_ledger.contrib.open_round("n", rnd, ref[0].get_parameters())
        for r, peer, value, tau in calls:
            if r == rnd:
                pair = mk(value, 10, [peer])
                got.append(ledger.contrib.score_now("n", pair[1], staleness=tau))
                want.append(jax_ledger.contrib.score_now("n", pair[0], staleness=tau))
        ledger.contrib.close_round("n")
        jax_ledger.contrib.close_round("n")
    assert [(e["flagged"], e["reasons"]) for e in got] == [
        (e["flagged"], e["reasons"]) for e in want] == [
        (False, []), (True, ["stale_flood"]), (True, ["stale_flood"])]
    det, jdet = ledger.contrib.detections(), jax_ledger.contrib.detections()
    assert sorted(det["flagged"]) == sorted(jdet["flagged"]) == ["evil", "good"]
    assert all("stale_flood" in det["flagged"][p]["reasons"] for p in det["flagged"])


# --- replay adversaries drive the detection ---------------------------------


def test_stale_flood_quarantined_and_readmitted_via_aggregator():
    _set_both(QUARANTINE_ENABLED=True, LEDGER_ENABLED=True, ASYNC_STALENESS_MAX=2,
              QUARANTINE_PROBATION_ROUNDS=1)
    agg = Both()
    eng, jeng = QuarantineEngine("n"), JaxQuarantine("n")
    agg.t.set_quarantine(eng)
    agg.j.set_quarantine(jeng)
    ref = mk(1.0, 1, ["ref"])
    for rnd in range(7):
        agg.open(["good", "evil"], async_k=2, round_ordinal=rnd)
        ledger.contrib.open_round("n", rnd, ref[1].get_parameters())
        jax_ledger.contrib.open_round("n", rnd, ref[0].get_parameters())
        agg.add(mk(1.0, 10, ["good"]), start_version=rnd)
        # Rounds 0..3: "evil" replays version 0 (τ crosses 2 at round 3),
        # then contributes fresh.
        agg.add(mk(5.0 if rnd < 4 else 1.0, 10, ["evil"]), start_version=0 if rnd < 4 else rnd)
        out = agg.result()
        if rnd < 3:
            assert leaf(out) > 1.0
        elif rnd == 3:
            assert leaf(out) == pytest.approx(1.0)
            assert eng.quarantined() == jeng.quarantined() == {"evil"}
        agg.clear()
    assert eng.quarantined() == jeng.quarantined() == set()
    assert eng.actions() == jeng.actions()
    assert any(a["action"] == "readmit" and a["peer"] == "evil" for a in eng.actions())


# --- e2e: controller determinism + the stale-flooding fleet ----------------


def jax_model_fn(seed):
    return jax_create_model("mlp", (28, 28), seed=seed, hidden_sizes=(32,),
                            compute_dtype=jnp.float32)


def port_model_fn(seed):
    return TpflModel(MLP(hidden_sizes=(32,), out_channels=10, compute_dtype=torch.float32),
                     **model_state_from_jax(jax_model_fn(seed), device="cpu"))


def jax_data_fn(seed):
    return jax_synthetic_mnist(n_train=360, n_test=60, seed=seed, noise=0.4)


def port_data_fn(seed):
    return synthetic_mnist(n_train=360, n_test=60, seed=seed, noise=0.4)


def test_controller_serialized_same_seed_identical_trajectories():
    _set_both(ASYNC_ROUNDS=True, ASYNC_BUFFER_K=2, ASYNC_SERIALIZED=True, ASYNC_ADAPTIVE=True,
              TRAIN_SET_SIZE=3)
    kw = dict(epochs=1, samples_per_node=120, batch_size=20, timeout=60.0)

    def plan(cls):
        return cls.skewed([f"seed151-n{i}" for i in range(3)], slow_frac=0.34, base_delay=0.05,
                          skew=5.0, seed=151)

    runs = []
    for _ in range(2):
        exp = run_seeded_experiment(151, 3, 4, speed_plan=plan(TrainerSpeedPlan),
                                    data_fn=port_data_fn, model_fn=port_model_fn, device="cpu",
                                    **kw)
        runs.append((final_model_digests(exp), controller_trajectories(exp)))
    (d1, t1), (d2, t2) = runs
    assert t1 == t2 and d1 == d2
    assert all(len(traj) == 4 for traj in t1.values())
    jexp = jax_run(151, 3, 4, speed_plan=plan(JaxSpeedPlan), data_fn=jax_data_fn,
                   model_fn=jax_model_fn, **kw)
    assert t1 == jax_trajectories(jexp)


def test_stale_flood_fleet_quarantined_and_readmitted_e2e():
    """5 serialized Nodes, K = 5, one flooder replaying its round-0
    contribution until round 6: quarantined for ``stale_flood`` once τ
    passes 2, readmitted after probation, exactly as in the JAX fleet."""
    _set_both(ASYNC_ROUNDS=True, ASYNC_BUFFER_K=5, ASYNC_SERIALIZED=True, ASYNC_STALENESS_MAX=2,
              QUARANTINE_PROBATION_ROUNDS=1, QUARANTINE_ENABLED=True, LEDGER_ENABLED=True,
              TRAIN_SET_SIZE=5)
    kw = dict(epochs=1, samples_per_node=60, batch_size=20, timeout=120.0)
    exp = run_seeded_experiment(77, 5, 9, attack_plan=AttackPlan(
        {1: AttackSpec("stale_flood", end=6)}, seed=77), data_fn=port_data_fn,
        model_fn=port_model_fn, device="cpu", **kw)
    truth, replay = adversary_map(exp), quarantine.replay_decisions()
    ledger.contrib.reset()
    jexp = jax_run(77, 5, 9, attack_plan=JaxPlan({1: JaxSpec("stale_flood", end=6)}, seed=77),
                   data_fn=jax_data_fn, model_fn=jax_model_fn, **kw)
    assert truth == jax_adversary_map(jexp) == {"seed77-n1": "stale_flood"}
    assert replay == jax_quarantine.replay_decisions()
    flagged = {a["peer"] for a in replay if a["action"] == "quarantine"}
    assert flagged == set(truth)
    assert all("stale_flood" in a["reasons"] for a in replay if a["action"] == "quarantine")
    assert any(a["action"] == "readmit" and a["peer"] in truth for a in replay)
    assert quarantine.quarantined_from_replay(replay) == set()
