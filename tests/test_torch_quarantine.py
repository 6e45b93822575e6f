"""The port's active defense (tpfl_torch.management.quarantine and the
aggregator's intake) against the JAX package's, on the CPU: each scenario
of ``tests/test_quarantine.py`` runs on both packages with the same
contributions, and gives the same verdicts (quarantined sets, live action
logs, ``record_for``), the same aggregates (rtol 1e-6, atol 1e-7: the
same f32 folds), contributors and sample counts, and the same
``replay_decisions`` / ``quarantined_from_replay``. Also the engine's
``state_export`` / ``state_import`` round trip.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpfl.learning.aggregators import FedAvg as JaxFedAvg
from tpfl.learning.model import TpflModel as JaxModel
from tpfl.management import ledger as jledger
from tpfl.management import quarantine as jquarantine
from tpfl.settings import Settings as JaxSettings
from tpfl_torch.learning.aggregators import FedAvg
from tpfl_torch.learning.model import TpflModel
from tpfl_torch.management import ledger, quarantine
from tpfl_torch.settings import Settings
from tpfl_torch.utils.tree import tree_items

RTOL, ATOL = 1e-6, 1e-7


class Side:
    """One package's defended FedAvg node "obs"."""

    def __init__(self, jax_side: bool, eager: bool):
        self.jax = jax_side
        self.settings = JaxSettings if jax_side else Settings
        self.ledger = jledger if jax_side else ledger
        self.q = jquarantine if jax_side else quarantine
        self.settings.QUARANTINE_ENABLED = True
        self.settings.LEDGER_ENABLED = True
        self.settings.AGG_STREAM_EAGER = eager
        self.eng = self.q.QuarantineEngine("obs")
        self.agg = JaxFedAvg("obs") if jax_side else FedAvg("obs", device="cpu")
        self.agg.set_quarantine(self.eng)

    def model(self, value, n_samples, contributors):
        w = np.full((3, 3), float(value), np.float32)
        b = np.full((3,), float(value), np.float32)
        if self.jax:
            return JaxModel(params={"w": jnp.asarray(w), "b": jnp.asarray(b)},
                            num_samples=n_samples, contributors=contributors)
        return TpflModel(params={"w": w, "b": b}, num_samples=n_samples,
                         contributors=contributors, device="cpu")

    def open_round(self, rnd):
        ref = {"w": np.ones((3, 3), np.float32), "b": np.ones((3,), np.float32)}
        if self.jax:
            ref = {k: jnp.asarray(v) for k, v in ref.items()}
        self.ledger.contrib.open_round("obs", rnd, ref)


def _params(model):
    return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in tree_items(model.get_parameters())}


def _summary(side, out=None):
    s = {"quarantined": sorted(side.eng.quarantined()), "actions": side.eng.actions(),
         "replay": side.q.replay_decisions(),
         "records": {p: side.eng.record_for(p) for p in ("a", "b", "evil", "evil1", "noisy")}}
    s["replay_set"] = sorted(side.q.quarantined_from_replay(s["replay"]))
    if out is not None:
        s["contributors"] = out.get_contributors()
        s["num_samples"] = out.get_num_samples()
    return s


def _run_both(scenario, eager=False, **knobs):
    """``scenario(side)`` on both packages (knobs set on both); returns
    (JAX observables, port observables) after checking they agree."""
    results = []
    for jax_side in (True, False):
        side = Side(jax_side, eager)
        for k, v in knobs.items():
            setattr(side.settings, k, v)
        results.append(scenario(side))
    want, got = results
    _assert_same(got, want)
    return want, got


def _assert_same(got, want, path="."):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)) and not isinstance(want, str):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=path)
    else:
        assert got == want, path


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


@pytest.mark.parametrize("eager", [False, True])
def test_flagged_contribution_excluded_but_covered(eager):
    def scenario(side):
        side.open_round(0)
        side.agg.set_nodes_to_aggregate(["a", "b", "evil"])
        covered = [side.agg.add_model(side.model(1.1, 4, ["a"])),
                   side.agg.add_model(side.model(1.3, 4, ["b"])),
                   side.agg.add_model(side.model(-1.2, 4, ["evil"]))]
        is_open = not side.agg._finish_aggregation_event.is_set()
        out = side.agg.wait_and_get_aggregation(timeout=1)
        entry = [e for e in side.ledger.contrib.entries("obs") if e["peer"] == "evil"][0]
        return {"covered": covered, "open": is_open, "params": _params(out),
                "entry": (entry["quarantined"], entry["reasons"]), **_summary(side, out)}

    _, got = _run_both(scenario, eager=eager)
    np.testing.assert_allclose(got["params"]["w"], 1.2, rtol=RTOL)
    assert got["contributors"] == ["a", "b", "evil"] and got["num_samples"] == 8
    assert got["quarantined"] == ["evil"] and not got["open"]


def test_partial_carries_passenger_metadata():
    def scenario(side):
        side.open_round(0)
        side.agg.set_nodes_to_aggregate(["a", "b", "evil"])
        for v, p in ((2.0, "a"), (-1.5, "evil"), (4.0, "b")):
            side.agg.add_model(side.model(v, 4, [p]))
        partial = side.agg.get_model(except_nodes=[])
        lone = side.agg.get_model(except_nodes=["a", "b"])
        return {"params": _params(partial), "lone": lone.get_contributors(),
                **_summary(side, partial)}

    _, got = _run_both(scenario)
    assert got["contributors"] == ["a", "b", "evil"] and got["num_samples"] == 8
    np.testing.assert_allclose(got["params"]["w"], 3.0, rtol=RTOL)
    assert got["lone"] == ["evil"]


def test_mixture_of_only_quarantined_is_rejected():
    def scenario(side):
        side.open_round(0)
        side.agg.set_nodes_to_aggregate(["a", "evil1", "evil2"])
        side.agg.add_model(side.model(-1.2, 4, ["evil1"]))
        side.agg.add_model(side.model(-1.4, 4, ["evil2"]))
        return {"mixture": side.agg.add_model(side.model(-1.3, 8, ["evil1", "evil2"])),
                **_summary(side)}

    _, got = _run_both(scenario)
    assert got["mixture"] == [] and got["quarantined"] == ["evil1", "evil2"]


def _rounds(side, plan, peers=("a", "evil"), honest=1.2):
    values = []
    for rnd, evil in plan:
        side.open_round(rnd)
        side.agg.set_nodes_to_aggregate(list(peers))
        side.agg.add_model(side.model(honest, 4, [peers[0]]))
        side.agg.add_model(side.model(evil, 4, [peers[1]]))
        out = side.agg.wait_and_get_aggregation(timeout=1)
        side.agg.clear()
        values.append(_params(out))
    return values


@pytest.mark.parametrize("eager", [False, True])
def test_probation_then_readmission(eager):
    def scenario(side):
        vals = _rounds(side, [(0, -1.2), (1, 1.4), (2, 1.4)])
        return {"values": vals, **_summary(side)}

    _, got = _run_both(scenario, eager=eager, QUARANTINE_PROBATION_ROUNDS=1)
    assert [round(float(v["w"][0, 0]), 5) for v in got["values"]] == [1.2, 1.2, 1.3]
    assert [a["action"] for a in got["actions"]] == ["quarantine", "reject", "readmit"]
    assert got["quarantined"] == [] and got["replay_set"] == []


def test_flag_during_probation_rearms_window():
    def scenario(side):
        vals = _rounds(side, [(0, -1.2), (1, -1.2), (2, 1.4)])
        mid = sorted(side.eng.quarantined())
        vals += _rounds(side, [(3, 1.4)])
        return {"values": vals, "mid": mid, **_summary(side)}

    _, got = _run_both(scenario, QUARANTINE_PROBATION_ROUNDS=1, LEDGER_ANOMALY_MIN_N=99)
    assert got["mid"] == ["evil"] and got["quarantined"] == []


def test_norm_outlier_uses_prior_round_window():
    def scenario(side):
        out = {}
        for rnd in (0, 1):
            side.open_round(rnd)
            peers = ["a", "b", "c", "d", "noisy"]
            side.agg.set_nodes_to_aggregate(peers)
            for i, p in enumerate(peers[:-1]):
                side.agg.add_model(side.model(1.1 + 0.01 * i, 4, [p]))
            side.agg.add_model(side.model(90.0, 4, ["noisy"]))
            out[f"agg{rnd}"] = _params(side.agg.wait_and_get_aggregation(timeout=1))
            side.agg.clear()
            out[f"q{rnd}"] = sorted(side.eng.quarantined())
        return {**out, **_summary(side)}

    _, got = _run_both(scenario, LEDGER_ANOMALY_MIN_N=4)
    assert got["q0"] == [] and got["q1"] == ["noisy"]
    assert "norm_outlier" in got["records"]["noisy"]["reasons"]


@pytest.mark.parametrize("eager", [False, True])
def test_all_flagged_fails_open(eager):
    def scenario(side):
        side.open_round(0)
        side.agg.set_nodes_to_aggregate(["evil1", "evil2"])
        side.agg.add_model(side.model(-1.0, 4, ["evil1"]))
        side.agg.add_model(side.model(-3.0, 4, ["evil2"]))
        out = side.agg.wait_and_get_aggregation(timeout=1)
        return {"params": _params(out), **_summary(side, out)}

    _, got = _run_both(scenario, eager=eager)
    np.testing.assert_allclose(got["params"]["w"], -2.0, rtol=RTOL)
    assert Settings and ledger.metrics.value("tpfl_quarantine_fail_open_total",
                                             {"node": "obs"}) >= 1


def test_disabled_defense_is_inert():
    def scenario(side):
        side.settings.QUARANTINE_ENABLED = False
        side.open_round(0)
        side.agg.set_nodes_to_aggregate(["a", "evil"])
        side.agg.add_model(side.model(2.0, 4, ["a"]))
        side.agg.add_model(side.model(-2.0, 4, ["evil"]))
        out = side.agg.wait_and_get_aggregation(timeout=1)
        return {"params": _params(out), **_summary(side, out)}

    _, got = _run_both(scenario)
    np.testing.assert_allclose(got["params"]["w"], 0.0, atol=ATOL)
    assert got["quarantined"] == []


def test_replay_decisions_matches_live_and_is_stable():
    def scenario(side):
        _rounds(side, [(0, -1.2), (1, 1.4), (2, 1.4)])
        replay = side.q.replay_decisions()
        assert json.dumps(replay, sort_keys=True) == json.dumps(side.q.replay_decisions(),
                                                                sort_keys=True)
        return _summary(side)

    _, got = _run_both(scenario, QUARANTINE_PROBATION_ROUNDS=1)
    assert [a["action"] for a in got["replay"] if a["peer"] == "evil"] == [
        "quarantine", "reject", "readmit"]
    assert [a["action"] for a in got["actions"] if a["peer"] == "evil"] == [
        a["action"] for a in got["replay"] if a["peer"] == "evil"]


def test_repush_scores_once():
    def scenario(side):
        side.open_round(0)
        side.agg.set_nodes_to_aggregate(["a", "evil"])
        m = side.model(-1.2, 4, ["evil"])
        side.agg.add_model(m)
        side.agg.add_model(m)
        side.agg.add_model(side.model(-1.2, 4, ["evil"]))
        n = len([e for e in side.ledger.contrib.entries("obs") if e["peer"] == "evil"])
        return {"entries": n, **_summary(side)}

    _, got = _run_both(scenario)
    assert got["entries"] == 1 and [a["action"] for a in got["actions"]] == ["quarantine"]


def test_state_export_import_round_trip():
    side = Side(False, eager=False)
    Settings.QUARANTINE_PROBATION_ROUNDS = 3
    _rounds(side, [(0, -1.2), (1, 1.4)])
    snap = side.eng.state_export()
    jside = Side(True, eager=False)
    JaxSettings.QUARANTINE_PROBATION_ROUNDS = 3
    _rounds(jside, [(0, -1.2), (1, 1.4)])
    assert json.dumps(snap, sort_keys=True) == json.dumps(jside.eng.state_export(),
                                                          sort_keys=True)
    fresh = quarantine.QuarantineEngine("obs")
    fresh.state_import(json.loads(json.dumps(snap)))
    assert fresh.quarantined() == {"evil"} and fresh.actions() == side.eng.actions()
    assert fresh.state_export() == snap
    fresh.reset()
    assert fresh.quarantined() == set() and fresh.actions() == []
