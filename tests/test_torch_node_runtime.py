"""The port's node runtime (tpfl_torch.node and the stage workflow) on the
paths beyond the plain synchronous round, on the CPU:

- ``ELECTION = "hash"``: no vote traffic, the same train sets as a JAX
  federation with the same experiment name (``uuid.uuid4`` patched in
  both node modules) and beacon, and the same final params; the beacon
  itself (sha256 of the initiator's v3 payload) equal to the JAX
  package's for the carried-across MLP and CNN;
- ``INPROC_ZERO_COPY`` on and off giving the same aggregate;
- the round profiler's vote / train / fold / gossip attribution;
- ``stop_learning`` mid-experiment, a node that crashes mid-learning
  (no disconnect: the heartbeat timeout drops it and the survivors
  finish every round), the lifecycle errors;
- the planes node runtime B opened: tracing on (spans in the flight
  ring, a node starting and stopping with it on, a stop dump), the
  fault names of ``tpfl_torch.communication``;
- the planes node runtime C opened (``ASYNC_ROUNDS``, ``WIRE_DELTA``,
  ``AsyncSchedule``, the speed plan's schedule forks) run where they
  were refused;
- the refusals: each unported plane raises ``NotImplementedError``
  naming its ``ROADMAP.md`` item; each switch of
  ``settings.UNPORTED_SWITCHES`` is refused where a Node or an engine
  starts, and each entry point of ``settings.UNPORTED_KNOBS`` is closed.
"""

import hashlib
import importlib.util
import inspect
import json
import threading
import time
import uuid

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpfl.node as jax_node
import tpfl_torch.communication as communication
from tpfl.communication.memory import clear_registry as jax_clear_registry
from tpfl.learning.dataset import RandomIIDPartitionStrategy as JaxRandomIID
from tpfl.learning.dataset import synthetic_mnist as jax_synthetic_mnist
from tpfl.management.logger import logger as jax_logger
from tpfl.models import CNN as JaxCNN
from tpfl.models import create_model as jax_create_model
from tpfl.settings import Settings as JaxSettings
from tpfl.utils import TopologyFactory as JaxTopologyFactory
from tpfl.utils import TopologyType as JaxTopologyType
from tpfl.utils import wait_convergence as jax_wait_convergence
from tpfl.utils import wait_to_finish as jax_wait_to_finish
from tpfl_torch.attacks import apply_speed_plan, run_seeded_experiment
from tpfl_torch.communication import faults
from tpfl_torch.communication.faults import AsyncSchedule, TrainerSpeedPlan
from tpfl_torch.communication.memory import clear_registry
from tpfl_torch.exceptions import LearnerRunningException, NodeRunningException, ZeroRoundsException
from tpfl_torch.interop import model_state_from_jax
from tpfl_torch.learning.dataset import RandomIIDPartitionStrategy
from tpfl_torch.learning.dataset.synthetic import synthetic_mnist
from tpfl_torch.learning.model import TpflModel
from tpfl_torch.management import profiling, tracing
from tpfl_torch.management.logger import logger
from tpfl_torch.management.telemetry import flight
from tpfl_torch.models import CNN, MLP
from tpfl_torch.node import Node
from tpfl_torch.parallel.engine import FederationEngine
from tpfl_torch.settings import UNPORTED_KNOBS, UNPORTED_SWITCHES, Settings
from tpfl_torch.stages.base_node import election_rank
from tpfl_torch.utils import (
    TopologyFactory,
    TopologyType,
    check_equal_models,
    full_connection,
    wait_convergence,
    wait_to_finish,
)
from tpfl_torch.utils.tree import tree_items


@pytest.fixture(autouse=True)
def _runtime_settings():
    snaps = (Settings.snapshot(), JaxSettings.snapshot())
    Settings.set_test_settings()
    Settings.DISABLE_SIMULATION = JaxSettings.DISABLE_SIMULATION = True
    clear_registry()
    jax_clear_registry()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.rounds.reset()
    yield
    profiling.rounds.reset()
    torch.set_num_threads(threads)
    clear_registry()
    jax_clear_registry()
    Settings.restore(snaps[0])
    JaxSettings.restore(snaps[1])


def jax_mlp():
    return jax_create_model("mlp", (28, 28), seed=7, hidden_sizes=(32,),
                            compute_dtype=jnp.float32)


def port_mlp(device="cpu"):
    return TpflModel(MLP(hidden_sizes=(32,), out_channels=10, compute_dtype=torch.float32),
                     **model_state_from_jax(jax_mlp(), device=device))


def port_nodes(n, prefix, lr=0.1, **kw):
    ds = synthetic_mnist(n_train=200 * n, n_test=40 * n, seed=0, noise=0.4)
    parts = ds.generate_partitions(n, RandomIIDPartitionStrategy, seed=1)
    nodes = [Node(port_mlp(), parts[i], addr=f"{prefix}-{i}", device="cpu", learning_rate=lr,
                  batch_size=32, **kw) for i in range(n)]
    for nd in nodes:
        nd.start()
    return nodes


def connect(nodes, topology="FULL"):
    n = len(nodes)
    TopologyFactory.connect_nodes(TopologyFactory.generate_matrix(TopologyType[topology], n),
                                  nodes)
    wait_convergence(nodes, n - 1, only_direct=False, wait=10)


def stop_all(nodes):
    for nd in nodes:
        nd.stop()


def params_of(node):
    return {p: v.detach().cpu().numpy() for p, v in
            tree_items(node.learner.get_model().get_parameters())}


def trained_sets(local_logs, exp, rounds):
    """Per round, the nodes that ran TrainStage (their train_loss)."""
    return [{a for a, metrics in local_logs[exp][r].items() if "train_loss" in metrics}
            for r in range(rounds)]


# --- hash election and the beacon ---------------------------------------------


def test_hash_election_matches_jax_without_vote_traffic(monkeypatch):
    n, rounds = 3, 2
    for S in (Settings, JaxSettings):
        S.ELECTION = "hash"
        S.TRAIN_SET_SIZE = 2
    fixed = uuid.UUID(int=0x5EED_0000_0000_0000_0000_0000_0000_0011)
    monkeypatch.setattr(uuid, "uuid4", lambda: fixed)
    addrs = [f"hash-{i}" for i in range(n)]

    ds = jax_synthetic_mnist(n_train=200 * n, n_test=40 * n, seed=0, noise=0.4)
    parts = ds.generate_partitions(n, JaxRandomIID, seed=1)
    jnodes = [jax_node.Node(jax_mlp(), parts[i], addr=addrs[i], learning_rate=0.1,
                            batch_size=32) for i in range(n)]
    try:
        for nd in jnodes:
            nd.start()
        JaxTopologyFactory.connect_nodes(
            JaxTopologyFactory.generate_matrix(JaxTopologyType.FULL, n), jnodes)
        jax_wait_convergence(jnodes, n - 1, only_direct=False, wait=10)
        jexp = jnodes[0].set_start_learning(rounds=rounds, epochs=1)
        jax_wait_to_finish(jnodes, timeout=120)
        jbeacon = jnodes[0].beacon
        jtrained = trained_sets(jax_logger.get_local_logs(), jexp, rounds)
        jparams = [{p: np.asarray(v) for p, v in
                    tree_items(nd.learner.get_model().get_parameters())} for nd in jnodes]
    finally:
        stop_all(jnodes)

    nodes = port_nodes(n, "hash")
    try:
        connect(nodes)
        exp = nodes[0].set_start_learning(rounds=rounds, epochs=1)
        wait_to_finish(nodes, timeout=120)
        assert exp == jexp == f"experiment_{fixed.hex[:8]}"
        beacon = nodes[0].beacon
        assert beacon == jbeacon and all(nd.beacon == beacon for nd in nodes)
        want = [set(sorted(addrs, key=lambda a: election_rank(exp, beacon, r, a))[:2])
                for r in range(rounds)]
        assert trained_sets(logger.get_local_logs(), exp, rounds) == jtrained == want
        for nd, jp in zip(nodes, jparams):
            assert not nd.state.train_set_votes  # no vote was ever cast
            got = params_of(nd)
            for path in jp:
                np.testing.assert_allclose(got[path], jp[path], rtol=1e-4, atol=1e-5)
    finally:
        stop_all(nodes)


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_election_beacon_equals_the_jax_one(kind):
    """The beacon is the sha256 of the initiator's encoded init model
    (v3 bytes): the carried-across model gives the JAX package's."""
    if kind == "mlp":
        jm, tm = jax_mlp(), port_mlp()
    else:
        jm = jax_create_model(JaxCNN(channels=(4, 8), dense=16, out_channels=10,
                                     compute_dtype=jnp.float32, conv_impl="pallas"),
                              (8, 8, 3), seed=7)
        tm = TpflModel(CNN(channels=(4, 8), dense=16, out_channels=10,
                           compute_dtype=torch.float32, conv_impl="pallas"),
                       **model_state_from_jax(jm, device="cpu"))
    assert (hashlib.sha256(tm.encode_parameters()).hexdigest()
            == hashlib.sha256(jm.encode_parameters()).hexdigest())


# --- zero-copy handoff and the round profiler ---------------------------------


def test_inproc_zero_copy_gives_the_same_aggregate():
    finals = []
    for zero_copy in (False, True):
        Settings.INPROC_ZERO_COPY = zero_copy
        nodes = port_nodes(2, "zc")
        try:
            connect(nodes, "LINE")
            nodes[0].set_start_learning(rounds=2, epochs=1)
            wait_to_finish(nodes, timeout=60)
            finals.append([params_of(nd) for nd in nodes])
        finally:
            stop_all(nodes)
    for off, on in zip(*finals):
        for path in off:
            np.testing.assert_array_equal(on[path], off[path])


def test_round_profiler_attributes_vote_train_fold_and_gossip():
    Settings.PROFILING_ENABLED = True
    nodes = port_nodes(2, "prof")
    try:
        full_connection(nodes[0], nodes[1:])
        wait_convergence(nodes, 1, only_direct=True, wait=10)
        nodes[0].set_start_learning(rounds=2, epochs=1)
        wait_to_finish(nodes, timeout=60)
    finally:
        stop_all(nodes)
    for nd in nodes:
        records = profiling.rounds.attribution(nd.addr)
        assert [r["round"] for r in records] == [0, 1]
        for rec in records:
            assert set(rec["parts"]) == set(profiling.COMPONENTS)
            assert rec["parts"]["train"] > 0 and rec["parts"]["vote"] > 0
            assert rec["parts"]["gossip"] > 0 and rec["wall"] > 0
    # Some node folded every round (the trainers' aggregations).
    assert all(sum(r["parts"]["fold"] for n in nodes
                   for r in profiling.rounds.attribution(n.addr) if r["round"] == k) > 0
               for k in (0, 1))


def test_profiler_trace_start_and_stop(tmp_path):
    """The run-wide trace an experiment's ``PROFILING_TRACE_DIR`` asks
    for: one start (a second is a no-op, as in-process peers share one
    profiler), one stop writing ``trace.json``, a second stop a no-op."""
    directory = str(tmp_path / "trace")
    assert profiling.start_trace(directory)
    assert not profiling.start_trace(directory)
    torch.ones(8).add_(1)
    assert profiling.stop_trace()
    assert not profiling.stop_trace()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert not profiling.start_trace("")


# --- interruption, failures, lifecycle ----------------------------------------


def test_stop_learning_mid_experiment():
    nodes = port_nodes(2, "stop")
    try:
        connect(nodes, "LINE")
        nodes[0].set_start_learning(rounds=50, epochs=1)
        time.sleep(1.0)
        for nd in nodes:
            nd.stop_learning()
        wait_to_finish(nodes, timeout=30)
        assert all(nd.state.status == "Idle" for nd in nodes)
        assert all(nd.learning_workflow.history.count("RoundFinishedStage") < 50
                   for nd in nodes)
    finally:
        stop_all(nodes)


def test_node_down_mid_learning():
    n, rounds = 3, 3
    nodes = port_nodes(n, "down")
    try:
        connect(nodes)
        nodes[0].set_start_learning(rounds=rounds, epochs=1)

        def crash_late():
            # A crash, not a leave: no disconnect message goes out, so the
            # survivors find out by heartbeat timeout (and failed sends).
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline and (nodes[2].state.round or 0) < 1:
                time.sleep(0.05)
            victim = nodes[2]
            victim.stop_learning()
            comm = victim.communication
            for t in (comm._heartbeater, comm._gossiper):
                t.stop()
                t.join(timeout=3)
            comm._server_stop()
            comm._started = False

        killer = threading.Thread(target=crash_late)
        killer.start()
        wait_to_finish(nodes[:2], timeout=120)
        killer.join(timeout=10)
        for nd in nodes[:2]:
            h = nd.learning_workflow.history
            assert h.count("RoundFinishedStage") == rounds, h
            assert nodes[2].addr not in nd.get_neighbors()
        check_equal_models(nodes[:2], atol=1e-5)
    finally:
        stop_all(nodes)


def test_node_lifecycle_errors():
    ds = synthetic_mnist(n_train=64, n_test=16, seed=0)
    node = Node(port_mlp(), ds, addr="life-0", device="cpu")
    with pytest.raises(NodeRunningException):
        node.connect("x")
    with pytest.raises(NodeRunningException):
        node.set_start_learning(1, 1)
    node.start()
    try:
        # The buffer pool publishes through a pull-style collector.
        gauges = logger.metrics.fold()["gauges"]
        assert ("tpfl_bufferpool_hits", (("node", "life-0"),)) in gauges
        with pytest.raises(NodeRunningException):
            node.start()
        with pytest.raises(ZeroRoundsException):
            node.set_start_learning(0, 1)
        node.set_start_learning(rounds=50, epochs=1)
        with pytest.raises(LearnerRunningException):
            node.set_start_learning(1, 1)
        node.stop_learning()
        wait_to_finish([node], timeout=30)
    finally:
        node.stop()
    node.stop()  # idempotent
    assert node._pool_collector not in logger.metrics._collectors  # left with the node


# --- refusals -----------------------------------------------------------------


_made: list = []  # nodes a refusal case built, stopped after it


def _node(addr):
    node = Node(port_mlp(), synthetic_mnist(n_train=32, n_test=8, seed=0), addr=addr,
                device="cpu")
    _made.append(node)
    return node


def _started(addr):
    node = _node(addr)
    node.start()
    return node


def _one_node_experiment(addr, **knobs):
    """A lone running node's one-round experiment with ``knobs`` on, to
    its end; returns its stage history."""
    node = _started(addr)
    for k, v in knobs.items():
        setattr(Settings, k, v)
    node.set_start_learning(1, 1)
    wait_to_finish([node], timeout=30)
    return node.learning_workflow.history


def _starts_with(knob):
    """A Node and a FederationEngine start with ``knob`` on."""
    setattr(Settings, knob, True)
    _started(f"sw-{knob.lower()}")
    _engine()
    return True


def _knobs_read():
    """The async knobs, once only parity, are read by the port's code."""
    import ast
    import pathlib

    root = pathlib.Path(__file__).resolve().parent.parent / "tpfl_torch"
    read = {n.attr for f in root.rglob("*.py") if f.name != "settings.py"
            for n in ast.walk(ast.parse(f.read_text())) if isinstance(n, ast.Attribute)
            and isinstance(n.value, ast.Name) and n.value.id == "Settings"}
    knobs = {"ASYNC_BUFFER_K", "ASYNC_STALENESS_EXP", "ASYNC_ROUND_DEADLINE",
             "ASYNC_SERIALIZED", "ASYNC_ADAPTIVE", "ASYNC_K_MIN", "ASYNC_K_MAX",
             "ASYNC_CTL_EWMA", "ASYNC_CTL_QUANTILE", "ASYNC_UNTAGGED_POLICY"}
    return knobs <= read and not knobs & set(UNPORTED_KNOBS)


def _speed_plan_forks():
    Settings.ASYNC_ROUNDS = True
    nodes = [_node(f"ported-sp{i}") for i in range(2)]
    apply_speed_plan(nodes, TrainerSpeedPlan({nodes[0].addr: 0.01}, seed=1))
    scheds = [nd.aggregator._async_sched for nd in nodes]
    return scheds[0] is not scheds[1] and scheds[0].expected() == scheds[1].expected()


# Each replaces the refusal case of the same name: the ported plane runs.
PORTED = {
    "async rounds": lambda: (setattr(Settings, "ASYNC_ROUNDS", True),
                             _started("ported-async"))[1]._running,
    "residual gossip": lambda: _one_node_experiment("ported-delta", WIRE_DELTA=True) == [
        "StartLearningStage", "VoteTrainSetStage", "TrainStage", "GossipModelStage",
        "RoundFinishedStage"],
    "async rounds at learning": lambda: _one_node_experiment(
        "ported-async2", ASYNC_ROUNDS=True, ASYNC_BUFFER_K=1) == [
        "StartLearningStage", "AsyncRoundStage", "RoundFinishedStage"],
    "async schedule": lambda: AsyncSchedule.for_plan(
        TrainerSpeedPlan({"a": 0.1})).expected() == "a",
    "speed plan under async rounds": _speed_plan_forks,
    "switch ASYNC_ROUNDS": lambda: _starts_with("ASYNC_ROUNDS"),
    "switch WIRE_DELTA": lambda: _starts_with("WIRE_DELTA"),
    "gate Settings.ASYNC_ROUNDS": _knobs_read,
}


@pytest.mark.parametrize("seam", sorted(PORTED))
def test_ported_seams_run(seam):
    snap = Settings.snapshot()
    try:
        assert PORTED[seam]() is True
    finally:
        Settings.restore(snap)
        while _made:
            _made.pop().stop()
        assert not [a for a in logger.get_nodes() if a.startswith(("ported-", "sw-"))]


REFUSALS = {
    "simulation pool": ("item 5", lambda: setattr(Settings, "DISABLE_SIMULATION", False),
                        lambda: _node("ref-sim")),
    "telemetry dump dir at the engine": ("item 4", lambda: setattr(
        Settings, "TELEMETRY_DUMP_DIR", "armed-dir"), lambda: _engine()),
    "harness default data": ("item 8", lambda: None, lambda: run_seeded_experiment(
        1, 2, 1, device="cpu")),
    "save checkpoint": ("item 4", lambda: None, lambda: _node("ref-ck").save_checkpoint("d")),
    "load checkpoint": ("item 4", lambda: None, lambda: _node("ref-lk").load_checkpoint("d")),
    "grpc": ("item 8", lambda: None, lambda: communication.GrpcCommunicationProtocol),
}


@pytest.mark.parametrize("seam", sorted(REFUSALS))
def test_unported_seams_raise_naming_their_item(seam):
    item, arm, call = REFUSALS[seam]
    snap = Settings.snapshot()
    arm()
    try:
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md §1 {item}"):
            call()
    finally:
        Settings.restore(snap)
        while _made:
            _made.pop().stop()
        assert not [a for a in logger.get_nodes() if a.startswith("ref-")]


def _armed(value):
    """A value that turns a switch of UNPORTED_SWITCHES on."""
    return True if isinstance(value, bool) else "armed-dir"


def _engine():
    return FederationEngine(MLP(hidden_sizes=(8,), out_channels=10), 2, device="cpu")


@pytest.mark.parametrize("knob", sorted(UNPORTED_SWITCHES))
def test_unported_switch_refused_where_its_plane_starts(knob):
    """On, each switch stops a Node and/or a FederationEngine where it
    starts, naming its item; a site that does not enter the plane runs."""
    item, off, sites = UNPORTED_SWITCHES[knob]
    snap = Settings.snapshot()
    setattr(Settings, knob, _armed(off))
    starts = {"node": lambda: _node(f"sw-{knob.lower()}").start(), "engine": _engine}
    try:
        for site, start in starts.items():
            if site in sites:
                with pytest.raises(NotImplementedError, match=f"Settings.{knob}=.*{item}"):
                    start()
            else:
                start()
    finally:
        Settings.restore(snap)
        while _made:
            _made.pop().stop()


def _closed_module(name):
    return lambda: importlib.util.find_spec(f"tpfl_torch.{name}") is None


def _raises(call):
    def check():
        with pytest.raises(NotImplementedError):
            call()
        return True
    return check


def _simulation_refused():
    snap = Settings.snapshot()
    Settings.DISABLE_SIMULATION = False
    try:
        return _raises(lambda: _node("gate-sim"))()
    finally:
        Settings.restore(snap)
        while _made:
            _made.pop().stop()


# How each entry point of UNPORTED_KNOBS is closed to a caller of the port.
GATES = {
    "Settings.DISABLE_SIMULATION": _simulation_refused,
    "communication.GrpcCommunicationProtocol": _raises(
        lambda: communication.GrpcCommunicationProtocol),
    "parallel.FederationEngine(mesh=)": _raises(lambda: FederationEngine(
        MLP(hidden_sizes=(8,), out_channels=10), 2, mesh="auto", device="cpu")),
    "parallel.FederationEngine.run_rounds(donate=)": lambda: "donate" not in inspect.signature(
        FederationEngine.run_rounds).parameters,
    "management.profiling.CompileObservatory": lambda: not hasattr(profiling,
                                                                   "CompileObservatory"),
    **{m: _closed_module(m) for m in (
        "parallel.federation_learner", "management.fleetobs", "management.checkpoint",
        "parallel.population", "parallel.membership", "parallel.ranksafe",
        "management.node_monitor")},
}


@pytest.mark.parametrize("gate", sorted(GATES))
def test_unported_knob_gate_is_closed(gate):
    """Every knob of UNPORTED_KNOBS tunes a plane whose entry point the
    port refuses or lacks, and names that plane's item."""
    knobs = {k: v for k, v in UNPORTED_KNOBS.items() if v is not None and v[0] == gate}
    assert knobs
    assert all(v[1].startswith("ROADMAP.md §1 item") for v in knobs.values())
    assert GATES[gate]() is True


def test_every_unported_knob_gate_has_a_check():
    gates = {v[0] for v in UNPORTED_KNOBS.values() if v is not None}
    assert gates == set(GATES)


def test_tracing_gate_is_a_no_op_while_off():
    """Off (the default), spans and events record nothing; ids still
    mint (the reference's ``mint`` is not gated) and an unparsable
    payload peeks empty."""
    assert not Settings.TELEMETRY_ENABLED
    flight.clear("gate-off")
    with tracing.maybe_span("encode", "gate-off", trace="", byref=False) as span:
        span.set(bytes=3)
    tracing.event("retry", "gate-off", peer="p")
    assert flight.snapshot("gate-off") == []
    assert len(tracing.mint("gate-off")) == 32 and tracing.payload_trace_id(b"x") == ""
    with pytest.raises(AttributeError):
        communication.NoSuchThing  # noqa: B018


def test_telemetry_on_records_spans_and_events():
    """Replaces the "telemetry" refusal case: with the knob on, a span and
    an event land in the node's flight ring."""
    Settings.TELEMETRY_ENABLED = True
    flight.clear("tel-on")
    with tracing.maybe_span("stage:x", "tel-on", trace="t1") as span:
        span.set(bytes=3)
    tracing.event("retry", "tel-on", peer="p")
    got = flight.snapshot("tel-on")
    assert [(e["kind"], e["name"]) for e in got] == [("span", "stage:x"), ("event", "retry")]
    assert got[0]["trace"] == "t1" and got[0]["bytes"] == 3 and got[0]["t1"] >= got[0]["t0"]
    flight.clear("tel-on")


def test_node_starts_and_stops_with_telemetry_on(tmp_path):
    """Replaces the "telemetry at start" refusal case: a Node starts with
    the knob on, and its stop dumps its flight ring to the dump
    directory as the document ``tools/traceview.py`` reads."""
    Settings.TELEMETRY_ENABLED = True
    Settings.TELEMETRY_DUMP_DIR = str(tmp_path)
    node = Node(port_mlp(), synthetic_mnist(n_train=32, n_test=8, seed=0), addr="tel-start",
                device="cpu")
    node.start()
    tracing.event("probe", node.addr)
    node.stop()
    doc = json.loads((tmp_path / "flight-tel-start-stop.json").read_text())
    assert sorted(doc) == ["events", "node", "reason", "wall_anchor"]
    assert doc["node"] == "tel-start" and doc["events"][-1]["name"] == "probe"
    flight.clear("tel-start")


@pytest.mark.parametrize("name", ["FaultInjector", "FaultPlan"])
def test_fault_names_are_exported(name):
    """Replaces the "faults" / "fault plan" refusal cases: the names are
    the fault module's classes, and an injector attaches to a protocol."""
    cls = getattr(communication, name)
    assert cls is getattr(faults, name)
    plan = communication.FaultPlan.from_dict({"links": {"*->*": {"drop": 0.5}}})
    proto = communication.InMemoryCommunicationProtocol("fault-names")
    assert communication.FaultInjector(plan, seed=1).attach(proto)._fault_injector is not None
