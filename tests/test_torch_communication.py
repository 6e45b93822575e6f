"""The port's communication layer (tpfl_torch.communication) and its
pure functions against the JAX package's, on the CPU.

- Wire and pure-function parity, exact: ``Message`` envelopes byte-equal
  to the JAX package's for every command's arguments (and each decodes
  the other's bytes), ``election_rank``, ``backoff_delay``'s schedule
  for the same seed, ``TopologyFactory.generate_matrix`` for every
  ``TopologyType`` at n = 2…6.
- Transport behaviour: the in-memory cases of ``tests/test_communication.py``
  on the port (connect / disconnect, dispatch and dedup, heartbeat
  discovery and timeout, TTL floods, the model-gossip loop), the dedup
  ring's ``AMOUNT_LAST_MESSAGES_SAVED`` bound, the circuit breaker's
  open / probe / close cycle and the eviction it drives, the FullModel
  relay and the coverage announcements.
"""

import random
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from tpfl.communication.memory import clear_registry as jax_clear_registry
from tpfl.communication.message import Message as JaxMessage
from tpfl.communication.resilience import backoff_delay as jax_backoff_delay
from tpfl.settings import Settings as JaxSettings
from tpfl.stages.base_node import election_rank as jax_election_rank
from tpfl.utils.topologies import TopologyFactory as JaxTopologyFactory
from tpfl.utils.topologies import TopologyType as JaxTopologyType
from tpfl_torch.communication import InMemoryCommunicationProtocol
from tpfl_torch.communication.commands import (
    ALL_COMMANDS,
    FullModelCommand,
    send_models_aggregated,
)
from tpfl_torch.communication.gossiper import Gossiper
from tpfl_torch.communication.memory import clear_registry
from tpfl_torch.communication.message import Message
from tpfl_torch.communication.neighbors import Neighbors
from tpfl_torch.communication.resilience import CircuitBreaker, backoff_delay
from tpfl_torch.exceptions import CommunicationError
from tpfl_torch.management.logger import logger
from tpfl_torch.settings import Settings
from tpfl_torch.stages.base_node import election_rank
from tpfl_torch.utils.topologies import TopologyFactory, TopologyType


@pytest.fixture(autouse=True)
def _runtime_settings():
    snaps = (Settings.snapshot(), JaxSettings.snapshot())
    Settings.set_test_settings()
    Settings.DISABLE_SIMULATION = JaxSettings.DISABLE_SIMULATION = True
    clear_registry()
    jax_clear_registry()
    yield
    clear_registry()
    jax_clear_registry()
    Settings.restore(snaps[0])
    JaxSettings.restore(snaps[1])


def make_nodes(n):
    nodes = [InMemoryCommunicationProtocol() for _ in range(n)]
    for nd in nodes:
        nd.start()
    return nodes


def stop_all(nodes):
    for nd in nodes:
        nd.stop()


def wait_for(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return pred()


# --- wire and pure-function parity ------------------------------------------

# Every command's arguments as the runtime sends them (StartLearning's
# rounds/epochs/exp/beacon, votes as flattened pairs, coverage lists,
# metrics pairs, the init request's exp name; heartbeat digests), and a
# weights message of each weights verb.
CONTROL_ARGS = {
    "start_learning": ["2", "1", "experiment_1a2b3c4d", "ab" * 32],
    "stop_learning": [],
    "model_initialized": [],
    "init_model_request": ["experiment_1a2b3c4d"],
    "vote_train_set": ["node-0", "512", "node-1", "7"],
    "models_aggregated": ["node-0", "node-1"],
    "models_ready": [],
    "metrics": ["test_loss", "0.25", "test_metric", "0.875"],
    "codec_nack": [],
    "beat": ["12.5", "node-1", "0.125", "node-2", "1.500"],
}


def test_every_command_has_wire_cases():
    names = {c.get_name() for c in ALL_COMMANDS}
    assert names - {"init_model", "partial_model", "full_model"} <= set(CONTROL_ARGS)


@pytest.mark.parametrize("cmd", sorted(CONTROL_ARGS))
@pytest.mark.parametrize("ttl,rnd", [(10, 3), (1, -1)])
def test_control_message_bytes_equal_the_reference(cmd, ttl, rnd):
    kw = dict(source="node-0", cmd=cmd, round=rnd, args=CONTROL_ARGS[cmd], ttl=ttl,
              msg_hash="node-0#17", via="node-1")
    raw = Message(**kw).to_bytes()
    assert raw == JaxMessage(**kw).to_bytes()
    assert JaxMessage.from_bytes(raw) == JaxMessage(**kw)
    assert Message.from_bytes(raw) == Message(**kw)


@pytest.mark.parametrize("cmd", ["init_model", "partial_model", "full_model"])
@pytest.mark.parametrize("size", [0, 200, 70_000])
def test_weights_message_bytes_equal_the_reference(cmd, size):
    payload = np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8).tobytes()
    kw = dict(source="node-2", cmd=cmd, round=5, payload=payload,
              contributors=["node-0", "node-2"], num_samples=400, trace="", version=-1)
    raw = Message(**kw).to_bytes()
    assert raw == JaxMessage(**kw).to_bytes()
    assert Message.from_bytes(JaxMessage(**kw).to_bytes()) == Message(**kw)


def test_byref_payload_is_never_wire_framed():
    with pytest.raises(TypeError, match="by-reference"):
        Message(source="a", cmd="full_model", payload=object()).to_bytes()


@pytest.mark.parametrize("rnd", [0, 1, 7])
def test_election_rank_equals_the_reference(rnd):
    for addr in ("node-0", "fed-3", "127.0.0.1:5000"):
        for beacon in ("", "ab" * 32):
            assert (election_rank("experiment_x", beacon, rnd, addr)
                    == jax_election_rank("experiment_x", beacon, rnd, addr))


@pytest.mark.parametrize("seed", [0, 11])
def test_backoff_schedule_equals_the_reference(seed):
    for base, cap in ((None, None), (0.2, 2.0)):
        mine, ref = random.Random(seed), random.Random(seed)
        got = [backoff_delay(a, mine, base, cap) for a in range(8)]
        want = [jax_backoff_delay(a, ref, base, cap) for a in range(8)]
        assert got == want
        limit = cap if cap is not None else Settings.RETRY_MAX_DELAY
        assert all(0 < d <= limit for d in got)


@pytest.mark.parametrize("n", [2, 3, 4, 5, 6])
def test_topology_matrices_equal_the_reference(n):
    for topo in TopologyType:
        got = TopologyFactory.generate_matrix(topo, n)
        want = JaxTopologyFactory.generate_matrix(JaxTopologyType[topo.name], n)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


# --- transport behaviour (tests/test_communication.py, in-memory) ----------


def test_not_started_errors():
    p = InMemoryCommunicationProtocol()
    with pytest.raises(CommunicationError):
        p.connect("nowhere")
    p.start()
    with pytest.raises(CommunicationError):
        p.start()
    p.stop()


def test_invalid_connect_and_address_in_use():
    (a,) = make_nodes(1)
    assert not a.connect(a.get_address())
    assert not a.connect("ghost-address")
    assert a.get_neighbors() == {}
    twin = InMemoryCommunicationProtocol(a.get_address())
    with pytest.raises(CommunicationError, match="in use"):
        twin.start()
    stop_all([a])


def test_handshake_symmetry_and_disconnect_propagation():
    a, b = make_nodes(2)
    assert a.connect(b.get_address())
    assert b.get_address() in a.get_neighbors(only_direct=True)
    assert a.get_address() in b.get_neighbors(only_direct=True)
    assert not a.connect(b.get_address())
    a.disconnect(b.get_address())
    assert b.get_address() not in a.get_neighbors()
    assert a.get_address() not in b.get_neighbors()
    stop_all([a, b])


def test_message_dispatch_and_dedup():
    a, b = make_nodes(2)
    a.connect(b.get_address())
    got = []
    b.add_command("probe", lambda source, round, args: got.append((source, round, args)))
    msg = a.build_msg("probe", ["x", "y"], round=3)
    a.send(b.get_address(), msg)
    a.send(b.get_address(), msg)  # same hash: dropped by dedup
    assert got == [(a.get_address(), 3, ["x", "y"])]
    b.handle_message(Message(source="x", cmd="no-such-verb").new_hash())  # logged, ignored
    stop_all([a, b])


def test_weights_dispatch_is_never_deduplicated():
    a, b = make_nodes(2)
    a.connect(b.get_address())
    got = []
    b.add_command("model", lambda source, round, weights, contributors, num_samples, **kw:
                  got.append((weights, contributors, num_samples, round)))
    msg = a.build_weights("model", 2, b"\x01\x02", ["a"], 7)
    a.send(b.get_address(), msg)
    a.send(b.get_address(), msg)
    assert got == [(b"\x01\x02", ["a"], 7, 2)] * 2
    stop_all([a, b])


def test_dedup_ring_keeps_the_last_amount_of_hashes():
    Settings.AMOUNT_LAST_MESSAGES_SAVED = 3
    g = Gossiper("me", lambda nei, m: None, lambda direct: {})
    assert all(g.check_and_set_processed(f"h{i}") for i in range(4))
    assert not g.check_and_set_processed("h3")
    assert g.check_and_set_processed("h0")  # evicted from the ring: unseen again
    assert g.check_and_set_processed("")  # unhashed messages always pass


def test_heartbeats_discover_indirect_peers():
    a, b, c = make_nodes(3)
    a.connect(b.get_address())
    b.connect(c.get_address())
    assert wait_for(lambda: c.get_address() in a.get_neighbors()
                    and a.get_address() in c.get_neighbors())
    assert c.get_address() not in a.get_neighbors(only_direct=True)
    stop_all([a, b, c])


def test_heartbeat_timeout_evicts_a_dead_peer():
    a, b = make_nodes(2)
    a.connect(b.get_address())
    # A crash, not a leave: b's threads and server go, no disconnect.
    for t in (b._heartbeater, b._gossiper):
        t.stop()
        t.join(timeout=3)
    b._server_stop()
    b._started = False
    assert wait_for(lambda: b.get_address() not in a.get_neighbors(),
                    Settings.HEARTBEAT_TIMEOUT + 3)
    stop_all([a])


def test_broadcast_reaches_all_direct_neighbors():
    hub, s1, s2 = make_nodes(3)
    hub.connect(s1.get_address())
    hub.connect(s2.get_address())
    got = []
    for nd in (s1, s2):
        nd.add_command("ping", lambda source, round, args, _n=nd: got.append(_n.get_address()))
    hub.broadcast(hub.build_msg("ping"))
    assert sorted(got) == sorted([s1.get_address(), s2.get_address()])
    stop_all([hub, s1, s2])


@pytest.mark.parametrize("ttl,reaches_end", [(None, True), (2, False)])
def test_ttl_flood_on_a_line(ttl, reaches_end):
    """a-b-c-d: a control message floods to d under the default TTL;
    with ttl=2 it stops at c (one re-flood)."""
    nodes = make_nodes(4)
    for x, y in zip(nodes, nodes[1:]):
        x.connect(y.get_address())
    seen = {nd.get_address(): threading.Event() for nd in nodes[1:]}
    for nd in nodes[1:]:
        nd.add_command("flood", lambda source, round, args, _a=nd.get_address(): seen[_a].set())
    nodes[0].broadcast(nodes[0].build_msg("flood", ttl=ttl))
    assert seen[nodes[2].get_address()].wait(5)
    assert seen[nodes[3].get_address()].wait(1.0 if not reaches_end else 5) == reaches_end
    stop_all(nodes)


def test_gossip_weights_until_early_stop_and_static_exit():
    a, b = make_nodes(2)
    a.connect(b.get_address())
    received = []
    b.add_command("part", lambda source, round, weights, contributors, num_samples, **kw:
                  received.append(weights))
    a.gossip_weights(
        early_stopping_fn=lambda: len(received) >= 2,
        get_candidates_fn=lambda: [b.get_address()],
        status_fn=lambda: len(received),
        model_fn=lambda nei: a.build_weights("part", 0, b"w", ["a"], 1),
        period=0.01,
    )
    assert len(received) >= 2
    t0 = time.monotonic()
    a.gossip_weights(
        early_stopping_fn=lambda: False,
        get_candidates_fn=lambda: [b.get_address()],
        status_fn=lambda: "static",
        model_fn=lambda nei: a.build_weights("part", 0, b"w", ["a"], 1),
        period=0.01,
    )
    assert time.monotonic() - t0 < 5  # GOSSIP_EXIT_ON_X_EQUAL_ROUNDS, not hung
    stop_all([a, b])


def test_heartbeat_priority_relay_order():
    sent = []
    g = Gossiper("relay", lambda nei, m: sent.append(m.cmd), lambda direct: {"peer": None})
    for i in range(5):
        g.add_message(Message(source=f"s{i}", cmd="vote", msg_hash=f"v{i}"))
    g.add_message(Message(source="s9", cmd="beat", msg_hash="b1"), priority=True)
    with g._pending_lock:
        budget = Settings.GOSSIP_MESSAGES_PER_PERIOD
        batch = [g._priority.popleft() for _ in range(min(len(g._priority), budget))]
        batch += [g._pending.popleft()
                  for _ in range(min(len(g._pending), budget - len(batch)))]
    for m in batch:
        g._send("peer", m)
    assert sent[0] == "beat" and sent.count("vote") == 5


def test_digest_merge_does_not_resurrect_dead_peers():
    n = Neighbors("me")
    now = time.monotonic()
    n.merge_digest([("stale-peer", now - 500.0), ("recent-peer", now - 3.0)], max_age=120.0)
    assert "stale-peer" not in n.get_all()
    assert abs((now - 3.0) - n.get_all()["recent-peer"].last_beat) < 0.5
    n.merge_digest([("recent-peer", now - 50.0)], max_age=120.0)
    assert abs((now - 3.0) - n.get_all()["recent-peer"].last_beat) < 0.5


def test_circuit_breaker_opens_probes_and_closes():
    Settings.BREAKER_THRESHOLD = 3
    Settings.BREAKER_PROBE_PERIOD = 0.0
    br = CircuitBreaker("me")
    assert not br.record_failure("peer") and not br.record_failure("peer")
    assert br.record_failure("peer")  # the third consecutive failure opens it
    assert br.is_open("peer")
    assert not br.record_failure("peer")  # already open: no second opening
    assert br.probe_due() == ["peer"]
    br.on_peer_alive("peer")
    assert not br.is_open("peer")
    br.record_failure("peer")
    br.record_success("peer", attempts=2)  # a success resets the streak
    snap = br.snapshot()["peer"]
    assert snap == {"breaker_state": "closed", "consecutive_failures": 0, "sends_ok": 1,
                    "sends_failed": 5, "retries": 1, "breaker_opens": 1}


def test_failed_sends_open_the_breaker_and_evict_the_peer():
    Settings.BREAKER_THRESHOLD = 2
    Settings.RETRY_MAX_ATTEMPTS = 2
    Settings.RETRY_BASE_DELAY = Settings.RETRY_MAX_DELAY = 0.001
    a, b = make_nodes(2)
    a.connect(b.get_address())
    b._started = False  # b's server stops answering; a still lists it
    for _ in range(2):
        a.send(b.get_address(), a.build_msg("probe"))
    assert b.get_address() not in a.get_neighbors()
    stats = a.get_transport_stats()[b.get_address()]
    assert stats["breaker_state"] == "open" and stats["sends_failed"] == 2
    assert stats["retries"] == 2  # one retry per failed send
    mirrored = logger.get_transport_logs()[a.get_address()][b.get_address()]
    assert mirrored == {"sends_ok": 0, "sends_failed": 2, "retries": 2,
                        "breaker_state": "open", "breaker_opens": 1}
    with pytest.raises(Exception, match="circuit open"):
        a.send(b.get_address(), a.build_msg("probe"), raise_error=True)
    b._started = True
    a._breaker.on_peer_alive(b.get_address())  # a beat from b closes it
    assert not a._breaker.is_open(b.get_address())
    stop_all([a, b])


def test_full_model_relay_on_first_adoption():
    sent = []

    class FakeComm:
        def get_neighbors(self, only_direct=False):
            return ["nb-lag", "nb-done", "nb-src"]

        def build_weights(self, cmd, round, weights, contributors=None, num_samples=0):
            return {"cmd": cmd, "round": round, "weights": weights}

        def send(self, dest, payload):
            sent.append((dest, payload))

    class FakeLearner:
        def set_model(self, weights):
            self.last = weights

        def get_model(self):
            return SimpleNamespace(get_parameters=lambda: {})

    from tpfl_torch.node_state import NodeState

    state = NodeState("me")
    state.experiment = SimpleNamespace(round=3)
    state.model_initialized_event.set()
    state.set_nei_status("nb-done", 3)
    cmd = FullModelCommand(SimpleNamespace(state=state, learner=FakeLearner(),
                                           communication=FakeComm()))
    cmd.execute("nb-src", 3, b"payload", ["a"], 10)
    assert wait_for(lambda: len(sent) >= 1, 10)
    assert [d for d, _ in sent] == ["nb-lag"]
    assert sent[0][1] == {"cmd": "full_model", "round": 3, "weights": b"payload"}
    assert state.last_full_model_round == 3 and state.model_version == 1
    cmd.execute("nb-other", 3, b"payload", ["a"], 10)  # adopted, not relayed again
    time.sleep(0.3)
    assert len(sent) == 1 and state.model_version == 2


def test_models_aggregated_targets_train_set_only():
    sent, broadcasts = [], []

    class FakeComm:
        def build_msg(self, cmd, args, round=None):
            return {"cmd": cmd, "args": args, "round": round}

        def send(self, dest, msg, create_connection=False):
            sent.append((dest, msg, create_connection))

        def broadcast(self, msg, node_list=None):
            broadcasts.append(msg)

    node = SimpleNamespace(state=SimpleNamespace(addr="me", round=2,
                                                 train_set=["me", "peer-a", "peer-b"]),
                           communication=FakeComm())
    send_models_aggregated(node, ["me", "peer-a"])
    assert broadcasts == []
    assert sorted(d for d, _, _ in sent) == ["peer-a", "peer-b"]
    assert all(m == {"cmd": "models_aggregated", "args": ["me", "peer-a"], "round": 2} and c
               for _, m, c in sent)
