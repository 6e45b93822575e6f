"""The port's fault injection (``tpfl_torch.communication.faults`` and the
chaos hooks of the shared transport) against the JAX package's, on the
CPU:

- for a fixed ``(seed, plan, sequence of (src, dst))`` the port's
  ``FaultInjector.decide`` gives the reference's ``Decision``s, and its
  ``stats()`` equal the reference's, exactly;
- ``FaultPlan.from_dict``, the crash and partition windows,
  ``Partition.blocks`` and ``TrainerSpeedPlan.skewed`` equal the
  reference's (``tests/test_communication.py:513-572``);
- on the in-memory transport of both packages: retry recovers from a
  transient drop, a corrupted send is rejected (the in-memory hook
  simulates the receiver's integrity check, which the reference's gRPC
  test exercises through its chunk CRC) and retried, a crashed node
  hears nothing; crashes are driven with ``fi.crash``, never wall-clock
  windows;
- the slice end to end: a 4-node traced MLP federation under 10% drop on
  every link, in both packages with the same addresses, seeds, data and
  params: every node's final params allclose to the JAX federation's
  (rtol 1e-4, atol 1e-5), and each package's live per-link decisions
  equal to the other package's injector fed the same number of attempts
  per link (how many attempts a link sees depends on thread timing in
  both packages: heartbeats and gossip polls).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpfl.communication.faults as jax_faults
import tpfl.node as jax_node
from tpfl.communication.memory import InMemoryCommunicationProtocol as JaxInMemory
from tpfl.communication.memory import clear_registry as jax_clear_registry
from tpfl.learning.dataset import RandomIIDPartitionStrategy as JaxRandomIID
from tpfl.learning.dataset import synthetic_mnist as jax_synthetic_mnist
from tpfl.management.logger import logger as jax_logger
from tpfl.management.telemetry import flight as jax_flight
from tpfl.models import create_model as jax_create_model
from tpfl.settings import Settings as JaxSettings
from tpfl.utils import TopologyFactory as JaxTopologyFactory
from tpfl.utils import TopologyType as JaxTopologyType
from tpfl.utils import wait_convergence as jax_wait_convergence
from tpfl.utils import wait_to_finish as jax_wait_to_finish
from tpfl_torch.communication import faults
from tpfl_torch.communication.memory import InMemoryCommunicationProtocol
from tpfl_torch.communication.memory import clear_registry
from tpfl_torch.exceptions import CommunicationError
from tpfl_torch.interop import model_state_from_jax
from tpfl_torch.learning.dataset import RandomIIDPartitionStrategy
from tpfl_torch.learning.dataset.synthetic import synthetic_mnist
from tpfl_torch.learning.model import TpflModel
from tpfl_torch.management import telemetry
from tpfl_torch.management.logger import logger
from tpfl_torch.models import MLP
from tpfl_torch.node import Node
from tpfl_torch.settings import Settings
from tpfl_torch.utils import TopologyFactory, TopologyType, wait_convergence, wait_to_finish
from tpfl_torch.utils.tree import tree_items

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _runtime_settings():
    snaps = (Settings.snapshot(), JaxSettings.snapshot())
    for s in (Settings, JaxSettings):
        s.set_test_settings()
        s.DISABLE_SIMULATION = True
    clear_registry()
    jax_clear_registry()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    clear_registry()
    jax_clear_registry()
    Settings.restore(snaps[0])
    JaxSettings.restore(snaps[1])


# --- the decision function --------------------------------------------------

PLANS = {
    "drop, corrupt, duplicate on every link": (7, {"links": {
        "*->*": {"drop": 0.25, "corrupt": 0.1, "duplicate": 0.1}}}),
    "most specific match, limits, delay jitter": (3, {"links": {
        "a->b": {"drop": 0.5, "drop_limit": 2},
        "a->*": {"corrupt": 0.3, "corrupt_limit": 1, "duplicate": 0.5},
        "*->c": {"delay": 0.01, "delay_jitter": 0.02}}}),
    "no rule for some links": (11, {"links": {"b->a": {"drop": 0.9}}}),
}
LINKS = [("a", "b"), ("b", "a"), ("a", "c"), ("c", "a"), ("b", "c")]


def _drive(mod, seed, spec, sequence):
    fi = mod.FaultInjector(mod.FaultPlan.from_dict(spec), seed=seed)
    out = []
    for i, link in enumerate(sequence):
        if i == 150:
            fi.crash("c")
        if i == 200:
            fi.revive("c")
        if i == 250:
            fi.reset_stats()
        d = fi.decide(*link)
        out.append(dataclasses.astuple(d))
        if d.action == "deliver":
            fi.count(*link, "delivered", d.copies)
    return out, fi.stats()


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_decisions_and_stats_equal_the_reference(plan):
    seed, spec = PLANS[plan]
    rng = np.random.default_rng(5)
    sequence = [LINKS[i] for i in rng.integers(0, len(LINKS), 400)]
    got, got_stats = _drive(faults, seed, spec, sequence)
    want, want_stats = _drive(jax_faults, seed, spec, sequence)
    assert got == want
    assert got_stats == want_stats
    assert {a for a, _, _ in got} >= {"deliver", "block"}


def test_default_seed_follows_settings_seed():
    for seed in (None, 42):
        Settings.SEED = JaxSettings.SEED = seed
        plan = {"links": {"*->*": {"drop": 0.5}}}
        got = faults.FaultInjector(faults.FaultPlan.from_dict(plan))
        want = jax_faults.FaultInjector(jax_faults.FaultPlan.from_dict(plan))
        assert got.seed == want.seed
        assert [got.decide("x", "y").action for _ in range(50)] == [
            want.decide("x", "y").action for _ in range(50)]


# --- plans, windows, partitions, speed plans --------------------------------

SPEC = {
    "links": {"a->b": {"drop": 0.5, "drop_limit": 2}, " * -> c ": {"corrupt": 0.1}},
    "crashes": [{"addr": "c", "start": 0.0}, {"addr": "d", "start": 1.0, "end": 2.0}],
    "partitions": [{"groups": [["a"], ["b", "e"]], "start": 0.5, "end": 1.5}],
}


def test_fault_plan_from_dict_equals_the_reference():
    got, want = faults.FaultPlan.from_dict(SPEC), jax_faults.FaultPlan.from_dict(SPEC)
    for src, dst in [("a", "b"), ("x", "c"), ("a", "c"), ("x", "y")]:
        g, w = got.faults_for(src, dst), want.faults_for(src, dst)
        assert (g and dataclasses.asdict(g)) == (w and dataclasses.asdict(w))
    assert [dataclasses.asdict(c) for c in got.crashes] == [
        dataclasses.asdict(c) for c in want.crashes]
    for t in (0.0, 0.5, 1.0, 1.49, 1.5, 2.0, 10.0):
        assert [c.active(t) for c in got.crashes] == [c.active(t) for c in want.crashes]
        assert [p.active(t) for p in got.partitions] == [p.active(t) for p in want.partitions]
    for src in "abcex":
        for dst in "abcex":
            assert got.partitions[0].blocks(src, dst) == want.partitions[0].blocks(src, dst)
    with pytest.raises(ValueError, match="src->dst"):
        faults.FaultPlan.from_dict({"links": {"ab": {}}})


def test_crash_windows_and_manual_crash_gate_links():
    fi = faults.FaultInjector(faults.FaultPlan.from_dict(
        {"links": {"a->b": {"drop": 0.5}}, "crashes": [{"addr": "c", "start": 0.0}]}),
        seed=0).start()
    assert fi.is_down("c") and fi.link_blocked("c", "a") and fi.link_blocked("a", "c")
    assert not fi.link_blocked("a", "b")
    fi.crash("a")
    assert fi.decide("a", "b").action == "block" and fi.stats()["a->b"] == {"blocked": 1}
    fi.revive("a")
    assert fi.decide("b", "a").action == "deliver"  # no rule for b->a: clean
    assert fi.stats()["b->a"] == {"clean": 1}


@pytest.mark.parametrize("seed", [None, 9])
def test_trainer_speed_plan_equals_the_reference(seed):
    addrs = [f"n{i}" for i in range(10)]
    got = faults.TrainerSpeedPlan.skewed(addrs, slow_frac=0.3, base_delay=0.01, seed=seed)
    want = jax_faults.TrainerSpeedPlan.skewed(addrs, slow_frac=0.3, base_delay=0.01, seed=seed)
    assert got.delays == want.delays and got.seed == want.seed
    assert got.delay_for("n3") == want.delay_for("n3") and got.delay_for("zz") == 0.0


def test_async_schedule_orders_as_the_reference():
    """The plan-seeded schedule and every fork give the JAX package's
    order, virtual times included; ``skip`` passes the head over."""
    addrs = [f"n{i}" for i in range(6)]
    plan = faults.TrainerSpeedPlan.skewed(addrs, slow_frac=0.34, base_delay=0.1, seed=21)
    jplan = jax_faults.TrainerSpeedPlan.skewed(addrs, slow_frac=0.34, base_delay=0.1, seed=21)
    got, want = faults.AsyncSchedule.for_plan(plan), jax_faults.AsyncSchedule.for_plan(jplan)
    for sched, ref in ((got, want), (got.fork(), want.fork())):
        seq, ref_seq = [], []
        for _ in range(40):
            seq.append((sched.expected(), sched.expected_time()))
            ref_seq.append((ref.expected(), ref.expected_time()))
            sched.advance()
            ref.advance()
        assert seq == ref_seq
    assert got.skip() == want.skip() and got.expected() == want.expected()
    assert got.knows("n0") and not got.knows("zz")
    empty = faults.AsyncSchedule({})
    assert empty.expected() is None and empty.expected_time() is None and empty.skip() is None


# --- the chaos hooks of the in-memory transport -----------------------------


def _pair(proto_cls, prefix):
    a, b = proto_cls(f"{prefix}-a"), proto_cls(f"{prefix}-b")
    for p in (a, b):
        p.start()
    a.connect(b.get_address())
    return a, b


@pytest.mark.parametrize("mod,proto_cls", [(faults, InMemoryCommunicationProtocol),
                                           (jax_faults, JaxInMemory)])
def test_retry_recovers_from_a_transient_drop(mod, proto_cls):
    Settings.HEARTBEAT_PERIOD = JaxSettings.HEARTBEAT_PERIOD = 30.0
    Settings.RETRY_MAX_ATTEMPTS = JaxSettings.RETRY_MAX_ATTEMPTS = 2
    a, b = _pair(proto_cls, "retry")
    try:
        fi = mod.FaultInjector(mod.FaultPlan(links={("*", "*"): mod.LinkFaults(
            drop=1.0, drop_limit=1)}), seed=3)
        fi.attach(a)
        got = []
        b.add_command("probe", lambda source, round, args: got.append(args))
        a.send(b.get_address(), a.build_msg("probe", ["x"]), raise_error=True)
        assert got == [["x"]]
        assert fi.stats()["retry-a->retry-b"] == {"dropped": 1, "delivered": 1}
        stats = a.get_transport_stats()[b.get_address()]
        assert stats["sends_ok"] == 1 and stats["retries"] >= 1
        assert stats["breaker_state"] == "closed"
    finally:
        a.stop()
        b.stop()


@pytest.mark.parametrize("mod,proto_cls", [(faults, InMemoryCommunicationProtocol),
                                           (jax_faults, JaxInMemory)])
def test_corruption_is_rejected_and_retried(mod, proto_cls):
    Settings.HEARTBEAT_PERIOD = JaxSettings.HEARTBEAT_PERIOD = 30.0
    Settings.RETRY_MAX_ATTEMPTS = JaxSettings.RETRY_MAX_ATTEMPTS = 2
    a, b = _pair(proto_cls, "corrupt")
    try:
        fi = mod.FaultInjector(mod.FaultPlan(links={("*", "*"): mod.LinkFaults(
            corrupt=1.0, corrupt_limit=1)}), seed=5)
        fi.attach(a)
        got = []
        b.add_command("model", lambda source, round, weights, contributors, num_samples, **kw:
                      got.append(weights))
        payload = bytes(range(256)) * 64
        a.send(b.get_address(), a.build_weights("model", 1, payload, ["a"], 1),
               raise_error=True)
        assert got == [payload]  # delivered intact exactly once
        assert fi.stats()["corrupt-a->corrupt-b"] == {
            "corrupted": 1, "corrupt_rejected": 1, "delivered": 1}  # never corrupt_accepted
    finally:
        a.stop()
        b.stop()


def test_a_crashed_node_hears_nothing():
    Settings.HEARTBEAT_PERIOD = 30.0
    a, b = _pair(InMemoryCommunicationProtocol, "crash")
    try:
        fi = faults.FaultInjector(faults.FaultPlan(), seed=1)
        fi.attach(a)
        fi.attach(b)
        got = []
        b.add_command("probe", lambda source, round, args: got.append(args))
        fi.crash(b.get_address())
        with pytest.raises(CommunicationError):
            a.send(b.get_address(), a.build_msg("probe", ["lost"]), raise_error=True)
        b.handle_message(a.build_msg("probe", ["direct"]))  # inbound side drops it too
        assert got == []
        assert fi.stats()["crash-a->crash-b"] == {"blocked": Settings.RETRY_MAX_ATTEMPTS}
        fi.revive(b.get_address())
        a.send(b.get_address(), a.build_msg("probe", ["back"]), raise_error=True)
        assert got == [["back"]]
    finally:
        a.stop()
        b.stop()


# --- the slice end to end ---------------------------------------------------


def _logged(mod):
    class Logged(mod.FaultInjector):
        """Keeps every decision's action, per link."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.log = {}

        def decide(self, src, dst):
            d = super().decide(src, dst)
            self.log.setdefault((src, dst), []).append(d.action)
            return d

    return Logged


def _replayed(mod, seed, spec, log):
    """The per-link actions of ``mod``'s injector fed ``log``'s attempt
    counts per link."""
    fi = mod.FaultInjector(mod.FaultPlan.from_dict(spec), seed=seed)
    return {link: [fi.decide(*link).action for _ in acts] for link, acts in log.items()}


CHAOS_SEED, CHAOS = 1234, {"links": {"*->*": {"drop": 0.1}}}


def _federate(node_cls, models, parts, fi, topo, wait_conv, wait_done, **kw):
    nodes = [node_cls(models[i], parts[i], addr=f"chaos-{i}", learning_rate=0.05,
                      batch_size=32, **kw) for i in range(4)]
    for nd in nodes:
        fi.attach(nd.communication)
    fi.start()
    try:
        for nd in nodes:
            nd.start()
        topo.connect_nodes(topo.generate_matrix(
            (TopologyType if topo is TopologyFactory else JaxTopologyType).STAR, 4), nodes)
        wait_conv(nodes, 3, only_direct=False, wait=10)
        nodes[0].set_start_learning(rounds=2, epochs=1)
        wait_done(nodes, timeout=120)
        return [{p: np.asarray(v) for p, v in tree_items(nd.learner.get_model().get_parameters())}
                for nd in nodes], [list(nd.learning_workflow.history) for nd in nodes]
    finally:
        for nd in nodes:
            nd.stop()


def test_traced_chaos_federation_matches_jax():
    for s in (Settings, JaxSettings):
        s.ELECTION, s.TRAIN_SET_SIZE, s.SEED, s.TELEMETRY_ENABLED = "hash", 4, CHAOS_SEED, True
    levels = logger.get_level(), jax_logger.get_level()
    logger.set_level("ERROR")
    jax_logger.set_level("ERROR")

    def jax_model():
        return jax_create_model("mlp", (28, 28), seed=7, hidden_sizes=(32,),
                                compute_dtype=jnp.float32)

    jds = jax_synthetic_mnist(n_train=800, n_test=160, seed=0, noise=0.4)
    pds = synthetic_mnist(n_train=800, n_test=160, seed=0, noise=0.4)
    jfi = _logged(jax_faults)(jax_faults.FaultPlan.from_dict(CHAOS), seed=CHAOS_SEED)
    pfi = _logged(faults)(faults.FaultPlan.from_dict(CHAOS), seed=CHAOS_SEED)
    try:
        want, jax_hist = _federate(
            jax_node.Node, [jax_model() for _ in range(4)],
            jds.generate_partitions(4, JaxRandomIID, seed=1), jfi, JaxTopologyFactory,
            jax_wait_convergence, jax_wait_to_finish)
        module = MLP(hidden_sizes=(32,), out_channels=10, compute_dtype=torch.float32)
        got, port_hist = _federate(
            Node, [TpflModel(module, **model_state_from_jax(jax_model(), device="cpu"))
                   for _ in range(4)],
            pds.generate_partitions(4, RandomIIDPartitionStrategy, seed=1), pfi,
            TopologyFactory, wait_convergence, wait_to_finish, device="cpu")
    finally:
        logger.set_level(levels[0])
        jax_logger.set_level(levels[1])
    assert port_hist == jax_hist and all(len(h) == 1 + 4 * 2 for h in port_hist)
    for node_got, node_want in zip(got, want):
        for path in node_want:
            np.testing.assert_allclose(node_got[path], node_want[path], rtol=RTOL, atol=ATOL,
                                       err_msg=path)
    for live, other in ((pfi, jax_faults), (jfi, faults)):
        assert live.log == _replayed(other, CHAOS_SEED, CHAOS, live.log)
        stats = live.stats()
        assert sum(s.get("dropped", 0) for s in stats.values()) > 0
        assert not any("corrupt_accepted" in s for s in stats.values())
    # The traced run reconstructs weights hops, dropped attempts and all.
    traced = [e for e in telemetry.flight.snapshot() if e.get("node", "").startswith("chaos-")]
    assert {"encode", "send", "recv", "decode", "retry"} <= {e["name"] for e in traced}
    for i in range(4):
        telemetry.flight.clear(f"chaos-{i}")
        jax_flight.clear(f"chaos-{i}")
