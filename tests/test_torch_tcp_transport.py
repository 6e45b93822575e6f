"""The port's TCP transport (tpfl_torch.communication.tcp_transport)
against the JAX package's gRPC transport, on the CPU.

- Bytes, exact: chunk frames byte-equal to
  ``tpfl.communication.grpc_transport.chunk_frames`` at sizes 0, 1,
  chunk - 1, chunk and 3.5 chunks, each side reassembling the other's;
  every malformed, CRC, gap, stream-id and truncation case raising both
  packages' ``ChunkIntegrityError``; ``AddressParser`` equal on every
  address form, invalid ports raising in both.
- Behaviour: the transport cases of ``tests/test_communication.py``
  (connect / disconnect, dispatch and dedup, weights, heartbeat
  discovery and eviction, broadcast, TTL flood, the model-gossip loop,
  a retried drop), each over ``memory``, ``tcp`` and ``grpc`` (the
  port's gRPC wire, ``tests/test_torch_grpc_transport.py``); mTLS with
  certificates from ``generate_certificates`` and an unauthenticated
  client refused; unix sockets; a corrupted stream rejected by the CRC
  and retried; typed deadlines (a dial that hangs, an RPC left
  unanswered, a refusal); ``MAX_MESSAGE_SIZE`` refused before the body
  is read; more sending threads than cores on one peer handle, the
  switch interval shortened (each payload delivered once, the handler
  and socket bounds kept); the seeded-drop two-node federation and the
  quantized delta-gossip run over TCP.
- Federations: a 2-node TCP federation bit-identical to the same
  federation over the in-memory transport (same addresses), and
  allclose (rtol 1e-4, atol 1e-5: f32 compute, as
  ``tests/test_torch_node.py``) to the JAX package's 2-node gRPC
  federation with the same addresses, seeds, data and initial params.
  Both packages run at a ``HEARTBEAT_TIMEOUT`` of 30 s there.

Every wait is bounded (``wait_for``, the transport's own deadlines, the
federations' ``wait_to_finish`` timeouts).
"""

import socket
import struct
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpfl.node as jax_node
from tpfl.communication import grpc_transport as jax_grpc
from tpfl.communication.memory import clear_registry as jax_clear_registry
from tpfl.exceptions import ChunkIntegrityError as JaxChunkIntegrityError
from tpfl.learning.dataset import RandomIIDPartitionStrategy as JaxRandomIID
from tpfl.learning.dataset import synthetic_mnist as jax_synthetic_mnist
from tpfl.models import create_model as jax_create_model
from tpfl.settings import Settings as JaxSettings
from tpfl.utils import wait_convergence as jax_wait_convergence
from tpfl.utils import wait_to_finish as jax_wait_to_finish
from tpfl_torch.communication import (FaultInjector, FaultPlan, GrpcCommunicationProtocol,
                                      InMemoryCommunicationProtocol, LinkFaults,
                                      TcpCommunicationProtocol)
from tpfl_torch.communication import tcp_transport as tt
from tpfl_torch.communication.memory import clear_registry
from tpfl_torch.exceptions import (ChunkIntegrityError, CommunicationError,
                                   ConnectionTimeoutError)
from tpfl_torch.interop import model_state_from_jax
from tpfl_torch.learning import _msgpack, compression
from tpfl_torch.learning.dataset import RandomIIDPartitionStrategy
from tpfl_torch.learning.dataset.synthetic import synthetic_mnist
from tpfl_torch.learning.model import TpflModel
from tpfl_torch.management.logger import logger
from tpfl_torch.models import MLP, create_model
from tpfl_torch.node import Node
from tpfl_torch.settings import Settings
from tpfl_torch.utils import check_equal_models, wait_convergence, wait_to_finish
from tpfl_torch.utils.certificates import enable_mtls, generate_certificates
from tpfl_torch.utils.tree import tree_items

RTOL, ATOL = 1e-4, 1e-5
HEARTBEAT_TIMEOUT = 30.0
CHUNK = 1024
PROTOCOLS = {"memory": InMemoryCommunicationProtocol, "tcp": TcpCommunicationProtocol,
             "grpc": GrpcCommunicationProtocol}


@pytest.fixture(autouse=True)
def _runtime_settings():
    snaps = (Settings.snapshot(), JaxSettings.snapshot())
    Settings.set_test_settings()
    Settings.DISABLE_SIMULATION = JaxSettings.DISABLE_SIMULATION = True
    clear_registry()
    jax_clear_registry()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # one intra-op thread per node thread
    yield
    torch.set_num_threads(threads)
    clear_registry()
    jax_clear_registry()
    Settings.restore(snaps[0])
    JaxSettings.restore(snaps[1])


def make_nodes(kind, n):
    nodes = [PROTOCOLS[kind]() for _ in range(n)]
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


def free_ports(n):
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


# --- bytes ------------------------------------------------------------------


@pytest.mark.parametrize("size", [0, 1, CHUNK - 1, CHUNK, CHUNK * 7 // 2])
def test_chunk_frames_equal_the_reference(size):
    data = np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8).tobytes()
    ours = list(tt.chunk_frames(data, CHUNK, sid=41))
    theirs = list(jax_grpc.chunk_frames(data, CHUNK, sid=41))
    assert ours == theirs
    assert len(ours) == max(1, -(-size // CHUNK))
    assert tt.reassemble_frames(theirs) == jax_grpc.reassemble_frames(iter(ours)) == data


def _bad_streams():
    data = bytes(range(256)) * 13
    frames = list(jax_grpc.chunk_frames(data, 1000, sid=5))
    other = list(jax_grpc.chunk_frames(data, 1000, sid=6))
    shorter = list(jax_grpc.chunk_frames(data[:2000], 1000, sid=5))
    bad = bytearray(frames[1])
    bad[-1] ^= 0x5A
    return {
        "malformed": ([b"not msgpack"], "Malformed"),
        "not a frame": ([_msgpack.packb({"sid": 5})], "Malformed"),
        "crc": ([frames[0], bytes(bad), *frames[2:]], "CRC"),
        "gap": ([frames[0], frames[2], frames[3]], "gap"),
        "reorder": ([frames[1], frames[0]], "gap"),
        "stream id": ([frames[0], other[1], *frames[2:]], "Stream id"),
        "total": ([frames[0], shorter[1]], "Stream id"),
        "truncated": (frames[:-1], "Truncated"),
        "empty": ([], "Truncated"),
    }


@pytest.mark.parametrize("case", sorted(_bad_streams()))
def test_reassembly_rejects_what_the_reference_rejects(case):
    frames, match = _bad_streams()[case]
    with pytest.raises(JaxChunkIntegrityError, match=match):
        jax_grpc.reassemble_frames(iter(frames))
    with pytest.raises(ChunkIntegrityError, match=match):
        tt.reassemble_frames(iter(frames))


@pytest.mark.parametrize("addr", ["127.0.0.1:5000", "localhost:6001", "[::1]:5000",
                                  "[fe80::1]:65535", "unix:/tmp/tpfl-a.sock",
                                  "unix:relative.sock"])
def test_address_parser_equals_the_reference(addr):
    ours, theirs = tt.AddressParser(addr), jax_grpc.AddressParser(addr)
    assert vars(ours) == vars(theirs)


@pytest.mark.parametrize("addr", [None, "127.0.0.1", "localhost", "::1"])
def test_address_parser_random_port_forms(addr):
    ours, theirs = tt.AddressParser(addr), jax_grpc.AddressParser(addr)
    assert (ours.host, ours.is_unix) == (theirs.host, theirs.is_unix)
    assert 0 < ours.port < 65536 and ours.address == f"{ours.host}:{ours.port}"


@pytest.mark.parametrize("addr", ["127.0.0.1:0", "127.0.0.1:65536", "127.0.0.1:-1",
                                  "[::1]:70000", "127.0.0.1:port"])
def test_address_parser_invalid_ports_raise(addr):
    with pytest.raises(ValueError):
        jax_grpc.AddressParser(addr)
    with pytest.raises(ValueError):
        tt.AddressParser(addr)


# --- transport behaviour, memory, tcp and grpc ---------------------------------
# The cases of tests/test_communication.py:58-240 and :573.


@pytest.mark.parametrize("kind", sorted(PROTOCOLS))
def test_not_started_errors(kind):
    p = PROTOCOLS[kind]()
    with pytest.raises(CommunicationError):
        p.connect("nowhere")
    p.start()
    try:
        with pytest.raises(CommunicationError):
            p.start()  # double start
    finally:
        p.stop()


@pytest.mark.parametrize("kind", sorted(PROTOCOLS))
def test_invalid_connect(kind):
    (a,) = make_nodes(kind, 1)
    ghost = "ghost-address" if kind == "memory" else f"127.0.0.1:{free_ports(1)[0]}"
    try:
        assert not a.connect(a.get_address())  # self
        assert not a.connect(ghost)  # unreachable
        assert a.get_neighbors() == {}
    finally:
        stop_all([a])


@pytest.mark.parametrize("kind", sorted(PROTOCOLS))
def test_handshake_symmetry_and_disconnect(kind):
    a, b = make_nodes(kind, 2)
    try:
        assert a.connect(b.get_address())
        assert b.get_address() in a.get_neighbors(only_direct=True)
        assert a.get_address() in b.get_neighbors(only_direct=True)
        assert not a.connect(b.get_address())  # double connect refused
        a.disconnect(b.get_address())
        assert b.get_address() not in a.get_neighbors()
        assert wait_for(lambda: a.get_address() not in b.get_neighbors())
    finally:
        stop_all([a, b])


@pytest.mark.parametrize("kind", sorted(PROTOCOLS))
def test_message_dispatch_and_dedup(kind):
    a, b = make_nodes(kind, 2)
    try:
        a.connect(b.get_address())
        got = []
        b.add_command("probe", lambda source, round, args: got.append((source, args)))
        msg = a.build_msg("probe", ["x", "y"], round=3)
        a.send(b.get_address(), msg)
        a.send(b.get_address(), msg)  # same hash -> dropped by dedup
        assert got == [(a.get_address(), ["x", "y"])]
    finally:
        stop_all([a, b])


@pytest.mark.parametrize("kind", sorted(PROTOCOLS))
@pytest.mark.parametrize("size", [2, 70_000])
def test_weights_dispatch(kind, size):
    """Under and over WIRE_CHUNK_SIZE: a unary Send and a SendStream."""
    Settings.WIRE_CHUNK_SIZE = 16 * 1024
    a, b = make_nodes(kind, 2)
    payload = np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8).tobytes()
    try:
        a.connect(b.get_address())
        got = {}
        b.add_command("model", lambda source, round, weights, contributors, num_samples, **kw:
                      got.update(dict(w=weights, c=contributors, n=num_samples, r=round)))
        before = logger.metrics.value("tpfl_wire_chunks_total", {"node": a.get_address()})
        a.send(b.get_address(), a.build_weights("model", 2, payload, ["a"], 7),
               raise_error=True)
        assert got == {"w": payload, "c": ["a"], "n": 7, "r": 2}
        if kind != "memory":
            chunks = logger.metrics.value("tpfl_wire_chunks_total",
                                          {"node": a.get_address()}) - before
            assert chunks == (0 if size < 16 * 1024 else -(-len(
                a.build_weights("model", 2, payload, ["a"], 7).to_bytes()) // (16 * 1024)))
            assert logger.metrics.value("tpfl_wire_bytes_total", {"node": a.get_address()}) > size
    finally:
        stop_all([a, b])


@pytest.mark.parametrize("kind", sorted(PROTOCOLS))
def test_gossip_discovers_indirect_peers(kind):
    a, b, c = make_nodes(kind, 3)
    try:
        a.connect(b.get_address())
        b.connect(c.get_address())
        assert wait_for(lambda: c.get_address() in a.get_neighbors()
                        and a.get_address() in c.get_neighbors())
        assert c.get_address() not in a.get_neighbors(only_direct=True)
    finally:
        stop_all([a, b, c])


@pytest.mark.parametrize("kind", sorted(PROTOCOLS))
def test_abrupt_death_eviction(kind):
    a, b = make_nodes(kind, 2)
    try:
        a.connect(b.get_address())
        b.stop()
        assert wait_for(lambda: b.get_address() not in a.get_neighbors(),
                        timeout=Settings.HEARTBEAT_TIMEOUT + 3)
    finally:
        stop_all([a])


@pytest.mark.parametrize("kind", sorted(PROTOCOLS))
def test_broadcast_reaches_all_direct_neighbors(kind):
    hub, s1, s2 = make_nodes(kind, 3)
    try:
        hub.connect(s1.get_address())
        hub.connect(s2.get_address())
        got = []
        for nd in (s1, s2):
            nd.add_command("ping", lambda source, round, args, _n=nd: got.append(_n.get_address()))
        hub.broadcast(hub.build_msg("ping"))
        assert sorted(got) == sorted([s1.get_address(), s2.get_address()])
    finally:
        stop_all([hub, s1, s2])


@pytest.mark.parametrize("kind", sorted(PROTOCOLS))
def test_ttl_flood_reaches_line_ends(kind):
    nodes = make_nodes(kind, 4)
    try:
        for x, y in zip(nodes, nodes[1:]):
            x.connect(y.get_address())
        got = threading.Event()
        for nd in nodes[1:3]:
            nd.add_command("flood", lambda source, round, args: None)
        nodes[3].add_command("flood", lambda source, round, args: got.set())
        nodes[0].broadcast(nodes[0].build_msg("flood"))
        assert got.wait(timeout=5)
    finally:
        stop_all(nodes)


@pytest.mark.parametrize("kind", sorted(PROTOCOLS))
def test_gossip_weights_until_early_stop_and_static_exit(kind):
    a, b = make_nodes(kind, 2)
    try:
        a.connect(b.get_address())
        received = []
        b.add_command("part", lambda source, round, weights, contributors, num_samples, **kw:
                      received.append(weights))
        a.gossip_weights(early_stopping_fn=lambda: len(received) >= 2,
                         get_candidates_fn=lambda: [b.get_address()],
                         status_fn=lambda: len(received),
                         model_fn=lambda nei: a.build_weights("part", 0, b"w", ["a"], 1),
                         period=0.01)
        assert len(received) >= 2
        t0 = time.monotonic()
        a.gossip_weights(early_stopping_fn=lambda: False,
                         get_candidates_fn=lambda: [b.get_address()],
                         status_fn=lambda: "static",
                         model_fn=lambda nei: a.build_weights("part", 0, b"w", ["a"], 1),
                         period=0.01)
        assert time.monotonic() - t0 < 5  # GOSSIP_EXIT_ON_X_EQUAL_ROUNDS, not hung
    finally:
        stop_all([a, b])


@pytest.mark.parametrize("kind", sorted(PROTOCOLS))
def test_retry_recovers_from_transient_drop(kind):
    Settings.HEARTBEAT_PERIOD = 30.0  # keep the link quiet for the test
    Settings.RETRY_MAX_ATTEMPTS = 2
    a, b = make_nodes(kind, 2)
    try:
        a.connect(b.get_address())
        fi = FaultInjector(FaultPlan(links={("*", "*"): LinkFaults(drop=1.0, drop_limit=1)}),
                           seed=3)
        fi.attach(a)
        got = []
        b.add_command("probe", lambda source, round, args: got.append(args))
        a.send(b.get_address(), a.build_msg("probe", ["x"]), raise_error=True)
        assert got == [["x"]]
        link = f"{a.get_address()}->{b.get_address()}"
        assert fi.stats()[link]["dropped"] == 1 and fi.stats()[link]["delivered"] == 1
        stats = a.get_transport_stats()[b.get_address()]
        assert stats["sends_ok"] == 1 and stats["retries"] >= 1
        assert stats["breaker_state"] == "closed"
    finally:
        stop_all([a, b])


# --- tcp only ---------------------------------------------------------------


def _ping_pair(a, b):
    got = []
    a.add_command("ping", lambda source, round, **kw: got.append(source))
    assert b.connect(a.get_address())
    assert b.get_address() in a.get_neighbors(only_direct=True)
    b.send(a.get_address(), b.build_msg("ping"), raise_error=True)
    assert wait_for(lambda: got == [b.get_address()], timeout=10)


def test_mtls_handshake_and_send(tmp_path):
    paths = generate_certificates(str(tmp_path))
    assert sorted(paths) == ["CA_CRT", "CLIENT_CRT", "CLIENT_KEY", "SERVER_CRT", "SERVER_KEY"]
    enable_mtls(str(tmp_path), paths)
    assert Settings.USE_SSL
    a, b = make_nodes("tcp", 2)
    try:
        _ping_pair(a, b)
    finally:
        stop_all([a, b])


def _raw_request(addr, route, body, wrap=None):
    """One raw request; the reply dict (``None`` when the connection
    closed without one)."""
    host, port = addr.rsplit(":", 1)
    with socket.create_connection((host, int(port)), timeout=5) as s:
        s = wrap(s) if wrap else s
        s.sendall(route + struct.pack(">Q", len(body)) + body)
        head = s.recv(8)
        if len(head) < 8:
            return None
        (n,) = struct.unpack(">Q", head)
        return _msgpack.unpackb(s.recv(n))


def test_mtls_rejects_unauthenticated_client(tmp_path):
    """A TLS client that trusts the CA but presents no certificate is
    refused (the mutual part of mTLS; a plaintext dial failing would not
    prove it), and never registers."""
    import ssl

    enable_mtls(str(tmp_path))
    (server,) = make_nodes("tcp", 1)
    try:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.load_verify_locations(Settings.CA_CRT)
        with pytest.raises((ssl.SSLError, ConnectionError)):
            reply = _raw_request(server.get_address(), tt.HANDSHAKE,
                                 _msgpack.packb({"addr": "mallory"}),
                                 lambda s: ctx.wrap_socket(s, server_hostname="127.0.0.1"))
            if reply is None:
                raise ConnectionError("closed without a reply")
        assert "mallory" not in server.get_neighbors()
        # ...and a plaintext client gets nothing either.
        with pytest.raises((ssl.SSLError, ConnectionError, socket.timeout)):
            if _raw_request(server.get_address(), tt.HANDSHAKE,
                            _msgpack.packb({"addr": "mallory"})) is None:
                raise ConnectionError("closed without a reply")
        assert "mallory" not in server.get_neighbors()
    finally:
        stop_all([server])


def test_unix_socket_transport(tmp_path):
    a = TcpCommunicationProtocol(f"unix:{tmp_path}/a.sock")
    b = TcpCommunicationProtocol(f"unix:{tmp_path}/b.sock")
    a.start()
    b.start()
    try:
        _ping_pair(a, b)
    finally:
        stop_all([a, b])
    assert not (tmp_path / "a.sock").exists()  # unlinked at stop


def test_corruption_rejected_by_chunk_crc_and_retried():
    Settings.HEARTBEAT_PERIOD = 30.0
    Settings.RETRY_MAX_ATTEMPTS = 2
    a, b = make_nodes("tcp", 2)
    try:
        a.connect(b.get_address())
        fi = FaultInjector(FaultPlan(links={("*", "*"): LinkFaults(corrupt=1.0,
                                                                   corrupt_limit=1)}), seed=5)
        fi.attach(a)
        got = []
        b.add_command("model", lambda source, round, weights, contributors, num_samples, **kw:
                      got.append(weights))
        payload = bytes(range(256)) * 64
        a.send(b.get_address(), a.build_weights("model", 1, payload, ["a"], 1),
               raise_error=True)
        assert got == [payload]  # delivered intact exactly once
        stats = fi.stats()[f"{a.get_address()}->{b.get_address()}"]
        assert stats["corrupted"] == 1 and stats["corrupt_rejected"] == 1
        assert "corrupt_accepted" not in stats
        assert stats["delivered"] == 1
    finally:
        stop_all([a, b])


def test_dial_timeout_is_typed():
    """A peer whose accept queue is full never completes the dial:
    ConnectionTimeoutError (slow or silent), within the dial deadline."""
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(0)
    filler = socket.create_connection(listener.getsockname(), timeout=2)
    p = TcpCommunicationProtocol()
    try:
        t0 = time.monotonic()
        with pytest.raises(ConnectionTimeoutError) as e:
            p._dial("127.0.0.1:%d" % listener.getsockname()[1])
        assert isinstance(e.value, CommunicationError)  # still caught broadly
        assert time.monotonic() - t0 < max(Settings.GRPC_TIMEOUT * 4, 2.0) + 2
    finally:
        filler.close()
        listener.close()


def test_refused_dial_is_not_a_timeout():
    p = TcpCommunicationProtocol()
    with pytest.raises(CommunicationError) as e:
        p._dial(f"127.0.0.1:{free_ports(1)[0]}")
    assert not isinstance(e.value, ConnectionTimeoutError)


def test_unanswered_rpc_times_out_typed():
    """A peer that accepts but never answers: the RPC's deadline
    (GRPC_TIMEOUT) expires as ConnectionTimeoutError."""
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(4)
    addr = "127.0.0.1:%d" % listener.getsockname()[1]
    p = TcpCommunicationProtocol()
    conn = p._dial(addr)
    try:
        t0 = time.monotonic()
        with pytest.raises(ConnectionTimeoutError):
            p._transport_send(addr, conn, p.build_msg("probe"))
        assert Settings.GRPC_TIMEOUT - 0.1 < time.monotonic() - t0 < Settings.GRPC_TIMEOUT + 2
    finally:
        conn.close()
        listener.close()


def test_max_message_size_is_enforced():
    """The server refuses a body over MAX_MESSAGE_SIZE from its length
    alone (no byte of it is sent) and closes the connection; the client
    refuses to send one."""
    Settings.MAX_MESSAGE_SIZE = 4096
    Settings.WIRE_CHUNK_SIZE = 0  # always unary
    a, b = make_nodes("tcp", 2)
    try:
        host, port = b.get_address().rsplit(":", 1)
        with socket.create_connection((host, int(port)), timeout=5) as s:
            s.sendall(tt.SEND + struct.pack(">Q", 1 << 40))  # 1 TiB announced
            (n,) = struct.unpack(">Q", s.recv(8))
            reply = _msgpack.unpackb(s.recv(n))
            assert reply["ok"] is False and "MAX_MESSAGE_SIZE" in reply["error"]
            assert s.recv(1) == b""  # closed
        a.connect(b.get_address())
        with pytest.raises(CommunicationError, match="MAX_MESSAGE_SIZE"):
            a._transport_send(b.get_address(), a._dial(b.get_address()),
                              a.build_weights("model", 1, b"x" * 8192, ["a"], 1))
        # Under the cap the same route delivers.
        got = []
        b.add_command("model", lambda source, round, weights, **kw: got.append(len(weights)))
        a.send(b.get_address(), a.build_weights("model", 1, b"x" * 1024, ["a"], 1),
               raise_error=True)
        assert got == [1024]
    finally:
        stop_all([a, b])


def test_server_threads_are_named_and_bounded():
    Settings.GRPC_SERVER_WORKERS = 2
    a, b = make_nodes("tcp", 2)
    try:
        a.connect(b.get_address())
        for i in range(8):
            a.send(b.get_address(), a.build_msg("noop"), raise_error=True)
        names = [t.name for t in threading.enumerate()
                 if t.name.startswith(f"tcp-{b.get_address()}_")]
        assert 1 <= len(names) <= 2
    finally:
        stop_all([a, b])
    assert not [t for t in threading.enumerate() if t.name.startswith("tcp-")
                and t.name[4:].startswith((a.get_address(), b.get_address()))]


def test_concurrent_senders_stress():
    """More sending threads than cores through one peer handle, the
    thread switch interval shortened: every payload (unary and streamed)
    delivered exactly once, at most GRPC_SERVER_WORKERS handler threads,
    at most IDLE_SOCKETS sockets kept, every thread gone after stop."""
    import os
    import sys

    Settings.GRPC_SERVER_WORKERS = 3
    Settings.WIRE_CHUNK_SIZE = 1024
    a, b = make_nodes("tcp", 2)
    got, errors = [], []
    b.add_command("model", lambda source, round, weights, **kw: got.append(weights))
    n_threads, per_thread = min(32, 2 * (os.cpu_count() or 4)), 6
    payloads = [[f"{t}-{i}-".encode() * (1 + 400 * (i % 2)) for i in range(per_thread)]
                for t in range(n_threads)]

    def sender(mine):
        try:
            for p in mine:
                a.send(b.get_address(), a.build_weights("model", 0, p, ["a"], 1),
                       raise_error=True)
        except Exception as e:  # reported by the assert below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        assert a.connect(b.get_address())
        threads = [threading.Thread(target=sender, args=(mine,)) for mine in payloads]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    try:
        assert errors == []
        assert sorted(got) == sorted(p for mine in payloads for p in mine)
        handlers = [t for t in threading.enumerate()
                    if t.name.startswith(f"tcp-{b.get_address()}_")]
        assert 1 <= len(handlers) <= 3
        assert len(a.get_neighbors()[b.get_address()].conn._idle) <= tt.IDLE_SOCKETS
    finally:
        stop_all([a, b])
    assert not [t for t in threading.enumerate()
                if t.name.startswith((f"tcp-{a.get_address()}", f"tcp-{b.get_address()}"))]


# --- federations --------------------------------------------------------------


def _mlp_nodes(protocol, addrs, parts, **kw):
    jax_init = jax_create_model("mlp", (28, 28), seed=7, hidden_sizes=(32,),
                                compute_dtype=jnp.float32)
    module = MLP(hidden_sizes=(32,), out_channels=10, compute_dtype=torch.float32)
    return [Node(TpflModel(module, **model_state_from_jax(jax_init, device="cpu")), parts[i],
                 addr=addrs[i], protocol=protocol, device="cpu", learning_rate=0.1,
                 batch_size=32, **kw) for i in range(len(addrs))]


def _port_parts(n):
    ds = synthetic_mnist(n_train=200 * n, n_test=40 * n, seed=0, noise=0.4)
    return ds.generate_partitions(n, RandomIIDPartitionStrategy, seed=1)


def _run(nodes, rounds=1, timeout=120):
    for nd in nodes:
        nd.start()
    try:
        for nd in nodes[1:]:
            nodes[0].connect(nd.addr)
        wait_convergence(nodes, len(nodes) - 1, only_direct=False, wait=10)
        nodes[0].set_start_learning(rounds=rounds, epochs=1)
        wait_to_finish(nodes, timeout=timeout)
        return [{p: v.numpy().copy() for p, v in
                 tree_items(nd.learner.get_model().get_parameters())} for nd in nodes]
    finally:
        for nd in nodes:
            nd.stop()


def test_two_node_tcp_federation_matches_memory_and_jax_grpc():
    """The 2-node federation of tests/test_node.py:104 over TCP: bit-
    identical to the port's in-memory federation with the same addresses,
    and allclose to the JAX package's gRPC federation."""
    Settings.HEARTBEAT_TIMEOUT = JaxSettings.HEARTBEAT_TIMEOUT = HEARTBEAT_TIMEOUT
    addrs = [f"127.0.0.1:{p}" for p in free_ports(2)]
    jds = jax_synthetic_mnist(n_train=400, n_test=80, seed=0, noise=0.4)
    jparts = jds.generate_partitions(2, JaxRandomIID, seed=1)
    jnodes = [jax_node.Node(jax_create_model("mlp", (28, 28), seed=7, hidden_sizes=(32,),
                                             compute_dtype=jnp.float32),
                            jparts[i], addr=addrs[i], protocol=jax_grpc.GrpcCommunicationProtocol,
                            learning_rate=0.1, batch_size=32) for i in range(2)]
    for nd in jnodes:
        nd.start()
    try:
        jnodes[0].connect(jnodes[1].addr)
        jax_wait_convergence(jnodes, 1, only_direct=False, wait=10)
        jnodes[0].set_start_learning(rounds=2, epochs=1)
        jax_wait_to_finish(jnodes, timeout=120)
        want = [{p: np.asarray(v) for p, v in tree_items(nd.learner.get_model().get_parameters())}
                for nd in jnodes]
    finally:
        for nd in jnodes:
            nd.stop()

    over_tcp = _run(_mlp_nodes(TcpCommunicationProtocol, addrs, _port_parts(2)), rounds=2)
    over_memory = _run(_mlp_nodes(InMemoryCommunicationProtocol, addrs, _port_parts(2)),
                       rounds=2)
    for got, mem, ref in zip(over_tcp, over_memory, want):
        assert got.keys() == mem.keys() == ref.keys()
        for path in ref:
            np.testing.assert_array_equal(got[path], mem[path], err_msg=path)
            np.testing.assert_allclose(got[path], ref[path], rtol=RTOL, atol=ATOL, err_msg=path)
    for path in over_tcp[0]:
        np.testing.assert_allclose(over_tcp[0][path], over_tcp[1][path], atol=ATOL)


def test_two_node_tcp_federation_under_seeded_drop():
    """tests/test_communication.py:764 over TCP: 30% per-attempt drop,
    retries and re-pushes absorb it."""
    Settings.RETRY_MAX_ATTEMPTS = 3
    nodes = _mlp_nodes(TcpCommunicationProtocol, [None, None], _port_parts(2))
    fi = FaultInjector(FaultPlan(links={("*", "*"): LinkFaults(drop=0.3)}), seed=42)
    for nd in nodes:
        fi.attach(nd.communication)
    _run(nodes, rounds=1, timeout=180)
    check_equal_models(nodes)
    assert sum(s.get("dropped", 0) for s in fi.stats().values()) > 0
    assert sum(s.get("delivered", 0) for s in fi.stats().values()) > 0


def test_tcp_quantized_delta_gossip():
    """tests/test_compression.py:360 over TCP: every weights payload a v2
    quant8+zlib payload through the streaming path, residuals from round
    1 on, both nodes ending on one aggregate within quantisation noise."""
    Settings.WIRE_CODEC = "quant8+zlib"
    Settings.WIRE_DELTA = True
    Settings.WIRE_CHUNK_SIZE = 2048  # force the streaming path
    Settings.TRAIN_SET_SIZE = 1  # a FullModel push every round
    n = 2
    parts = _port_parts(n)
    nodes = [Node(TpflModel(*create_model("mlp", (28, 28), seed=7, hidden_sizes=(32,),
                                          device="cpu"), device="cpu"),
                  parts[i], protocol=TcpCommunicationProtocol, device="cpu",
                  learning_rate=0.1, batch_size=32) for i in range(n)]
    seen = {"v2": 0, "delta": 0, "dense_v1": 0}
    for nd in nodes:
        orig_send = nd.communication.send

        def counting_send(nei, msg, *a, _orig=orig_send, **kw):
            payload = getattr(msg, "payload", None)
            if payload:
                if compression.payload_version(payload) == 2:
                    seen["v2"] += 1
                    seen["delta"] += compression.payload_is_delta(payload)
                else:
                    seen["dense_v1"] += 1
            return _orig(nei, msg, *a, **kw)

        nd.communication.send = counting_send
    chunks = sum(logger.metrics.value("tpfl_wire_chunks_total", {"node": nd.addr})
                 for nd in nodes)
    for nd in nodes:
        nd.start()
    try:
        nodes[0].connect(nodes[1].addr)
        wait_convergence(nodes, n - 1, only_direct=False, wait=10)
        nodes[0].set_start_learning(rounds=2, epochs=1)
        wait_to_finish(nodes, timeout=120)
        assert all(nd.state.round is None for nd in nodes)
        assert seen["v2"] > 0 and seen["dense_v1"] == 0, seen
        assert seen["delta"] >= 1, seen
        assert sum(logger.metrics.value("tpfl_wire_chunks_total", {"node": nd.addr})
                   for nd in nodes) > chunks
        wait_convergence(nodes, n - 1, only_direct=False, wait=10)
        nodes[1].set_start_learning(rounds=1, epochs=1)
        wait_to_finish(nodes, timeout=120)
        check_equal_models(nodes)
    finally:
        for nd in nodes:
            nd.stop()
