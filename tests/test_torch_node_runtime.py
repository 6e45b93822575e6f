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
  ``AsyncSchedule``, the speed plan's schedule forks) and the simulation
  plane (a pooled Node, a population at the engine, the knobs of the pool,
  the population and ``FederationLearner`` read) run where they were
  refused;
- the refusals: each unported plane raises ``NotImplementedError``
  naming its ``ROADMAP.md`` item (the reference's gRPC transport names
  its counterpart, ``TcpCommunicationProtocol``, whose knobs the port now
  reads); each switch of
  ``settings.UNPORTED_SWITCHES`` is refused where a Node or an engine
  starts (the table is empty since ``TRACE_CONTRACTS`` was ported; a
  stand-in switch holds the mechanism), and each entry point of
  ``settings.UNPORTED_KNOBS`` is closed;
- ``TRACE_CONTRACTS`` (the counterparts of
  ``tests/test_analysis.py:1021-1097``): the stamp and check, off by
  default, and the engine's dispatch witness naming ``ENGINE_DONATE``,
  with the reference's message and contract;
- the harness's default data (``rendered_digits``) in both packages, and
  the reference's accuracy contract (``tests/test_node.py:544-577``) on
  three port Nodes.
"""

import hashlib
import importlib.util
import json
import threading
import time
import uuid

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpfl.attacks.harness as jax_harness
import tpfl.node as jax_node
import tpfl_torch.attacks.harness as harness
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
from tpfl_torch.concurrency import (ContractedProgram, TraceContractError, check_contract,
                                    stamp_contract)
from tpfl_torch.exceptions import LearnerRunningException, NodeRunningException, ZeroRoundsException
from tpfl_torch.interop import model_state_from_jax
from tpfl_torch.learning.dataset import RandomIIDPartitionStrategy, TpflDataset
from tpfl_torch.learning.dataset.synthetic import synthetic_mnist
from tpfl_torch.learning.model import TpflModel
from tpfl_torch.management import fleetobs, profiling, tracing
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


def _read_by_port(knobs):
    """The knobs, once only parity, are read by the port's code."""
    import ast
    import pathlib

    root = pathlib.Path(__file__).resolve().parent.parent / "tpfl_torch"
    read = {n.attr for f in root.rglob("*.py") if f.name != "settings.py"
            for n in ast.walk(ast.parse(f.read_text())) if isinstance(n, ast.Attribute)
            and isinstance(n.value, ast.Name) and n.value.id == "Settings"}
    return set(knobs) <= read and not set(knobs) & set(UNPORTED_KNOBS)


def _knobs_read():
    return _read_by_port({
        "ASYNC_BUFFER_K", "ASYNC_STALENESS_EXP", "ASYNC_ROUND_DEADLINE", "ASYNC_SERIALIZED",
        "ASYNC_ADAPTIVE", "ASYNC_K_MIN", "ASYNC_K_MAX", "ASYNC_CTL_EWMA", "ASYNC_CTL_QUANTILE",
        "ASYNC_UNTAGGED_POLICY"})


def _pooled_node():
    """With DISABLE_SIMULATION off, a Node's learner is a
    VirtualNodeLearner and its one-round experiment fits through the
    process's SuperLearnerPool."""
    from tpfl_torch.simulation import SuperLearnerPool, VirtualNodeLearner

    SuperLearnerPool.reset()
    Settings.DISABLE_SIMULATION = False
    try:
        history = _one_node_experiment("ported-sim")
        pool = SuperLearnerPool.instance()
        return (isinstance(_made[-1].learner, VirtualNodeLearner) and pool.singles == 1
                and pool.fallbacks == 0 and history == [
                    "StartLearningStage", "VoteTrainSetStage", "TrainStage",
                    "GossipModelStage", "RoundFinishedStage"])
    finally:
        SuperLearnerPool.reset()


def _engine_population():
    """An attached ClientPopulation is bound and rides export_state."""
    from tpfl_torch.parallel import ClientPopulation

    eng = _engine()
    pop = ClientPopulation(registered=64, sample=2, seed=1)
    eng.attach_population(pop)
    ids = pop.begin_round()
    pop.complete_round(ids)
    state = eng.export_state(eng.init_params((28, 28)))
    return eng.population is pop and pop._engine is eng and state["population"] == (
        pop.state_export()) and pop.touched == 2


def _speed_plan_forks():
    Settings.ASYNC_ROUNDS = True
    nodes = [_node(f"ported-sp{i}") for i in range(2)]
    apply_speed_plan(nodes, TrainerSpeedPlan({nodes[0].addr: 0.01}, seed=1))
    scheds = [nd.aggregator._async_sched for nd in nodes]
    return scheds[0] is not scheds[1] and scheds[0].expected() == scheds[1].expected()


def _node_checkpoint_round_trip(which):
    """A node's checkpoint published by ``save_checkpoint`` loads back
    through ``load_checkpoint``; ``which`` picks the side checked."""
    import os
    import tempfile

    src, dst = _node("ported-ck-src"), _node("ported-ck-dst")
    with tempfile.TemporaryDirectory() as d:
        src.save_checkpoint(d)
        published = "LATEST" in os.listdir(d)
        meta = dst.load_checkpoint(d)
    got = dict(tree_items(dst.learner.get_model().get_parameters()))
    same = all(torch.equal(v, got[k])
               for k, v in tree_items(src.learner.get_model().get_parameters()))
    return published if which == "save" else (meta["round"] == src.state.round and same)


def _donation_report_clean():
    """The engine's donation report runs: a clean report, one donated
    leaf per params leaf, the caller's params unchanged."""
    eng = _engine()
    params = eng.init_params((4,))
    before = [t.clone() for layer in params.values() for t in layer.values()]
    report = eng.donation_report(params, np.ones((2, 1, 4, 4), np.float32),
                                 np.zeros((2, 1, 4), np.int32))
    after = [t for layer in params.values() for t in layer.values()]
    return report["clean"] and report["donated_leaves"] == len(after) and all(
        torch.equal(a, b) for a, b in zip(after, before))


def _donate_knob_read():
    """``ENGINE_DONATE`` is read at dispatch: off, the window leaves its
    input intact; on, it writes the input and returns it."""
    eng = _engine()
    xs, ys = np.ones((2, 1, 4, 4), np.float32), np.zeros((2, 1, 4), np.int32)
    out = {}
    for knob in (False, True):
        Settings.ENGINE_DONATE = knob
        params = eng.init_params((4,))
        start = params["Dense_0"]["kernel"].clone()
        res = eng.run_rounds(params, xs, ys)
        out[knob] = (res[0]["Dense_0"]["kernel"] is params["Dense_0"]["kernel"],
                     torch.equal(params["Dense_0"]["kernel"], start))
    return _read_by_port({"ENGINE_DONATE"}) and out == {False: (False, True),
                                                       True: (True, False)}


def _dump_dir_engine():
    Settings.TELEMETRY_DUMP_DIR = "armed-dir"
    return _engine().n_nodes == 2


def _compile_cache_engine():
    """COMPILE_CACHE_DIR points the kernel build at its directory."""
    import os

    from tpfl_torch.parallel import _build

    default = _build.BUILD_DIR
    Settings.COMPILE_CACHE_DIR = "armed-dir"
    try:
        return _engine().n_nodes == 2 and _build.BUILD_DIR == _build.Path(
            os.path.abspath("armed-dir"))
    finally:
        _build.use_build_dir(default)


def _default_data_experiment():
    """``data_fn=None``: two Nodes of the default model on the default
    data, to the end, every node on one digest."""
    Settings.ELECTION = "hash"
    Settings.TRAIN_SET_SIZE = 2
    exp = run_seeded_experiment(1, 2, 1, samples_per_node=100, device="cpu")
    digests = harness.final_model_digests(exp)
    return len(digests) == 2 and len(set(digests.values())) == 1


# Each replaces the refusal case of the same name: the ported plane runs.
PORTED = {
    "engine donation report": _donation_report_clean,
    "gate parallel.FederationEngine.donation_report": _donate_knob_read,
    "harness default data": _default_data_experiment,
    "save checkpoint": lambda: _node_checkpoint_round_trip("save"),
    "load checkpoint": lambda: _node_checkpoint_round_trip("load"),
    "telemetry dump dir at the engine": _dump_dir_engine,
    "switch ENGINE_TELEMETRY": lambda: _starts_with("ENGINE_TELEMETRY"),
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
    "simulation pool": _pooled_node,
    "client population at the engine": _engine_population,
    "gate Settings.DISABLE_SIMULATION": lambda: _read_by_port({
        "DISABLE_SIMULATION", "SIM_WORKERS", "SIM_BATCH_WINDOW", "SIM_BATCH_MAX_WAIT",
        "SIM_MAX_BATCH_NODES", "SIM_PROCESS_ISOLATION"}),
    "gate parallel.federation_learner": lambda: _read_by_port({
        "CHECKPOINT_DIR", "CHECKPOINT_EVERY_WINDOWS", "CHECKPOINT_ON_SIGTERM"})
    and importlib.util.find_spec("tpfl_torch.parallel.federation_learner") is not None,
    "switch COMPILE_CACHE_DIR": _compile_cache_engine,
    "gate management.fleetobs": lambda: _read_by_port({
        "FLEETOBS_SNAPSHOT_PERIOD", "FLEETOBS_DIR", "SLO_TARGETS", "SLO_EWMA",
        "SLO_BREACH_WINDOWS"}) and fleetobs.SLOWatchdog("gauge(tpfl_x) <= 1").healthy(),
    "gate management.node_monitor": lambda: _read_by_port({"RESOURCE_MONITOR_PERIOD"})
    and importlib.util.find_spec("tpfl_torch.management.node_monitor") is not None,
    "gate management.profiling.CompileObservatory": lambda: _read_by_port({
        "PROFILING_RECOMPILE_WARN"}) and hasattr(profiling, "CompileObservatory"),
    "gate parallel.population": lambda: _read_by_port({
        "POPULATION_CLIENTS", "POPULATION_SAMPLE"})
    and importlib.util.find_spec("tpfl_torch.parallel.population") is not None,
    "gate parallel.FederationEngine(mesh=)": lambda: _read_by_port({
        "SHARD_NODES", "SHARD_DEVICES", "SHARD_MODEL", "SHARD_LAYOUT", "SHARD_HOSTS"})
    and FederationEngine(MLP(hidden_sizes=(8,), out_channels=10), 2, mesh="auto",
                         device="cpu").mesh is None,
    "gate parallel.ranksafe": lambda: _read_by_port({"RANK_CONTRACTS"})
    and importlib.util.find_spec("tpfl_torch.parallel.ranksafe") is not None,
    # The reference's gRPC knobs tune the port's TCP transport.
    "gate communication.TcpCommunicationProtocol": lambda: _read_by_port({
        "GRPC_TIMEOUT", "MAX_MESSAGE_SIZE", "GRPC_SERVER_WORKERS", "WIRE_CHUNK_SIZE", "USE_SSL",
        "CA_CRT", "SERVER_CRT", "SERVER_KEY", "CLIENT_CRT", "CLIENT_KEY"})
    and communication.TcpCommunicationProtocol().get_address().startswith("127.0.0.1:"),
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


# Each refused seam's message names its ROADMAP.md item.
REFUSALS = {
    "hub": ("ROADMAP.md §1, Hub downloads", lambda: None,
            lambda: TpflDataset.from_huggingface("tpfl-no-such-org/no-such-dataset")),
}


@pytest.mark.parametrize("seam", sorted(REFUSALS))
def test_unported_seams_raise_naming_their_item(seam):
    names, arm, call = REFUSALS[seam]
    snap = Settings.snapshot()
    arm()
    try:
        with pytest.raises(NotImplementedError, match=names):
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


def test_refuse_unported_still_refuses_a_registered_switch(monkeypatch):
    """``Settings.refuse_unported`` stays for later switches: a stand-in
    entry of the table is refused at its site (the engine), named with its
    item, and the other site (a Node) starts."""
    monkeypatch.setitem(UNPORTED_SWITCHES, "LOCK_TRACING", ("ROADMAP.md §1 item 99", False,
                                                            ("engine",)))
    snap = Settings.snapshot()
    Settings.LOCK_TRACING = True
    try:
        with pytest.raises(NotImplementedError, match="Settings.LOCK_TRACING=True.*item 99"):
            _engine()
        _node("sw-standin").start()
    finally:
        Settings.restore(snap)
        while _made:
            _made.pop().stop()


def _raises(call):
    def check():
        with pytest.raises(NotImplementedError):
            call()
        return True
    return check


# How each entry point of UNPORTED_KNOBS is closed to a caller of the port
# (none is left: ENGINE_DONATE's entry point runs, PORTED above).
GATES: dict = {}


def test_unported_knob_gate_is_closed(monkeypatch):
    """Every knob of UNPORTED_KNOBS tunes a plane whose entry point the
    port refuses or lacks, and names that plane's item: with the table
    empty of such knobs, a stand-in entry and its gate hold the check."""
    from tpfl_torch.exceptions import not_ported

    def entry():
        raise not_ported("parallel.StandIn.entry", "ROADMAP.md §1 item 99")

    gate = "parallel.StandIn.entry"
    monkeypatch.setitem(UNPORTED_KNOBS, "STAND_IN", (gate, "ROADMAP.md §1 item 99"))
    monkeypatch.setitem(GATES, gate, _raises(entry))
    for gate in sorted(GATES):
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


# --- TRACE_CONTRACTS (tests/test_analysis.py:1021-1097) -------------------------


@pytest.fixture
def _trace_contracts():
    Settings.TRACE_CONTRACTS = JaxSettings.TRACE_CONTRACTS = True
    yield  # the autouse fixture restores both packages' Settings


def test_check_contract_unit(_trace_contracts):
    from tpfl.concurrency import TraceContractError as JaxTraceContractError
    from tpfl.concurrency import check_contract as jax_check_contract
    from tpfl.concurrency import stamp_contract as jax_stamp_contract

    calls = []
    fn = stamp_contract(lambda *a: calls.append(a) or "out", {"K": 1})
    assert fn(3) == "out" and calls == [(3,)]  # a transparent callable
    assert isinstance(fn, ContractedProgram) and fn.contract == {"K": 1}
    check_contract(fn, {"K": 1})  # matching values pass
    check_contract(fn, {"OTHER": 9})  # unrelated knobs are ignored
    with pytest.raises(TraceContractError) as exc:
        check_contract(fn, {"K": 2})
    with pytest.raises(JaxTraceContractError) as jexc:
        jax_check_contract(jax_stamp_contract(lambda: None, {"K": 1}), {"K": 2})
    # The reference's message, less its pointer to the JAX package's
    # static pass.
    assert str(exc.value) == str(jexc.value).replace(
        "; see tools/tpflcheck capture pass / docs/static_analysis.md", "")
    assert "K: compiled under 1, live value 2" in str(exc.value)
    check_contract(lambda: None, {"K": 5})  # unstamped: contracts off at build time


def test_contract_stamp_is_off_by_default():
    assert Settings.TRACE_CONTRACTS is False

    def fn():
        return 1

    assert stamp_contract(fn, {"K": 1}) is fn  # no wrapper while off
    eng = _engine()
    eng.run_rounds(eng.init_params((4,)), np.zeros((2, 1, 4, 4), np.float32),
                   np.zeros((2, 1, 4), np.int32))
    assert eng._programs and not any(isinstance(p, ContractedProgram)
                                     for p in eng._programs.values())


def test_trace_contracts_engine_dispatch_witness(_trace_contracts):
    """The witness fires on the engine's dispatch and names the knob: a
    cache key that lost its ENGINE_DONATE axis (the donate=True slot
    serving the donate=False program). The stamp is the reference
    engine's contract for the same window."""
    import jax.numpy as jnp

    from tpfl.parallel.engine import FederationEngine as JaxEngine

    eng = FederationEngine(MLP(hidden_sizes=(8,), out_channels=10), 2, learning_rate=0.1,
                           seed=0, device="cpu")
    xs, ys = np.zeros((2, 1, 4, 4), np.float32), np.zeros((2, 1, 4), np.int32)
    out = eng.run_rounds(eng.init_params((4,)), xs, ys, epochs=1, donate=False)
    codec = (0, float(Settings.WIRE_TOPK_FRAC))
    key_false = eng._program_key("plain", 1, 1, 1, False, False, 0, codec, False, 0.0)
    key_true = eng._program_key("plain", 1, 1, 1, True, False, 0, codec, False, 0.0)
    assert set(eng._programs) == {key_false}

    jeng = JaxEngine(jax_create_model("mlp", (4,), seed=0, hidden_sizes=(8,)).module, 2,
                     learning_rate=0.1, seed=0)
    jeng.run_rounds(jeng.init_params((4,)), jnp.asarray(xs), jnp.asarray(ys), epochs=1,
                    donate=False)
    (jax_key, jax_fn), = jeng._wrapped.items()
    assert jax_key == key_false
    assert eng._programs[key_false].contract == jax_fn.contract

    eng._programs[key_true] = eng._programs[key_false]
    with pytest.raises(TraceContractError) as exc:
        eng.run_rounds(out[0], xs, ys, epochs=1, donate=True)
    assert "ENGINE_DONATE: compiled under False, live value True" in str(exc.value)


# --- the harness's default data and the accuracy contract ---------------------


def test_harness_default_data_matches_jax(monkeypatch):
    """``run_seeded_experiment(data_fn=None)`` in both packages at the same
    seed: the same ``rendered_digits`` call and arrays, each package's
    nodes on one final digest, the metric tables allclose (atol 1e-5, as
    ``tests/test_torch_harness.py``). The two packages' digests are not
    compared for equality: trained f32 params differ in their last bits
    between XLA and PyTorch."""
    from tpfl.attacks import metric_table as jax_metric_table
    from tpfl_torch.attacks import assert_tables_allclose, metric_table

    calls = {}

    def recording(module, key):
        inner = module.rendered_digits

        def wrapped(**kw):
            ds = inner(**kw)
            calls[key] = (kw, ds)
            return ds
        monkeypatch.setattr(module, "rendered_digits", wrapped)

    recording(jax_harness, "jax")
    recording(harness, "port")
    for s in (Settings, JaxSettings):
        s.ELECTION = "hash"
        s.TRAIN_SET_SIZE = 2
        s.HEARTBEAT_TIMEOUT = 30.0

    def jax_model_fn(seed):
        return jax_create_model("mlp", (28, 28), seed=seed, hidden_sizes=(32,),
                                compute_dtype=jnp.float32)

    def port_model_fn(seed):
        return TpflModel(MLP(hidden_sizes=(32,), out_channels=10, compute_dtype=torch.float32),
                         **model_state_from_jax(jax_model_fn(seed), device="cpu"))

    je = jax_harness.run_seeded_experiment(11, 2, 1, model_fn=jax_model_fn, samples_per_node=100)
    pe = run_seeded_experiment(11, 2, 1, model_fn=port_model_fn, samples_per_node=100,
                               device="cpu")
    assert calls["port"][0] == calls["jax"][0] == {"n_train": 200, "n_test": 100, "seed": 11}
    for train in (True, False):
        for name in ("image", "label"):
            want = np.asarray(calls["jax"][1].get_split(train).with_format("numpy")[name])
            assert np.array_equal(calls["port"][1].get_split(train)[name], want)
    for digests in (harness.final_model_digests(pe), jax_harness.final_model_digests(je)):
        assert len(digests) == 2 and len(set(digests.values())) == 1
    got, want = metric_table(pe), jax_metric_table(je)
    assert sorted(got) == sorted(want) == ["seed11-n0", "seed11-n1"]
    assert_tables_allclose(got, want, atol=1e-5)


def test_accuracy_contract_on_rendered_images():
    """The reference's real-data gate on three port Nodes: accuracy > 0.5
    on every node and equal models after 2 rounds of 2 epochs."""
    from tpfl_torch.learning.dataset import rendered_digits
    from tpfl_torch.models import create_model

    n, rounds = 3, 2
    ds = rendered_digits(n_train=1000 * n, n_test=150 * n, seed=5)
    parts = ds.generate_partitions(n, RandomIIDPartitionStrategy, seed=2)
    nodes = [Node(TpflModel(*create_model("mlp", (28, 28), seed=7, hidden_sizes=(64,),
                                          device="cpu"), device="cpu"),
                  parts[i], addr=f"rendered-e2e-{i}", learning_rate=0.1, batch_size=50,
                  device="cpu") for i in range(n)]
    for nd in nodes:
        nd.start()
    try:
        connect(nodes)
        nodes[0].set_start_learning(rounds=rounds, epochs=2)
        wait_to_finish(nodes, timeout=240)
        check_equal_models(nodes)
        accs = [nd.learner.evaluate()["test_metric"] for nd in nodes]
        assert all(a > 0.5 for a in accs), accs
    finally:
        stop_all(nodes)
