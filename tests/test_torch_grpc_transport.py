"""The port's gRPC wire (tpfl_torch.communication.grpc_transport, over
``http2`` and ``hpack``) against the JAX package's
``GrpcCommunicationProtocol`` and real ``grpcio``, on the CPU.

- Routes, in three directions (a JAX client to a port server, a port
  client to a JAX server, port to port): Handshake, Send, a SendStream
  of a 4 MB message at ``WIRE_CHUNK_SIZE`` 2048 (past every initial
  window) and Disconnect; each received ``Message`` byte-equal to the
  sent one. The same under mTLS, with certificates from
  ``generate_certificates``, and over unix sockets.
- grpcio's encoder against the port's HPACK decoder: every printable
  ASCII byte as call metadata (raw and then indexed, as grpcio sends
  plain values) and every byte as a ``-bin`` value (Huffman-coded).
- Failures, with the reference's types and status codes: a TLS client
  without a certificate refused; an unknown path ``UNIMPLEMENTED`` at a
  grpcio client; ``MAX_MESSAGE_SIZE`` refused (``RESOURCE_EXHAUSTED``)
  on both sides; a corrupted stream rejected by the chunk CRC and
  retried (port and JAX servers); an unanswered RPC ending in
  ``ConnectionTimeoutError`` and a ``CANCEL`` of the stream at the
  server; a dial to ``127.0.0.1:1`` raising ``ConnectionTimeoutError``
  after the ready wait.
- A unary call served on the connection while a SendStream on it is held
  open midway; a slow handler holding its sender (port and grpcio
  clients) to the stream window; concurrent senders both ways on one
  connection; no ``grpc-<addr>`` thread left after ``stop()``.
- Federations on one pair of addresses: the port's 2-node MLP federation
  over gRPC bit-identical to its in-memory one and allclose (rtol 1e-4,
  atol 1e-5) to the JAX package's gRPC federation; a mixed federation of
  one JAX and one port Node on one LINE over gRPC (same seeds, data and
  initial params, 2 rounds): both nodes end on one aggregate, allclose
  to the all-JAX one.

The behaviour cases of ``tests/test_torch_tcp_transport.py`` run over
``grpc`` too (its ``kind`` parametrisation). Every wait is bounded.
"""

import base64
import functools
import socket
import ssl
import threading
import time
from concurrent import futures

import grpc
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpfl.node as jax_node
from tpfl.communication import grpc_transport as jax_grpc
from tpfl.communication.memory import clear_registry as jax_clear_registry
from tpfl.learning.dataset import RandomIIDPartitionStrategy as JaxRandomIID
from tpfl.learning.dataset import synthetic_mnist as jax_synthetic_mnist
from tpfl.models import create_model as jax_create_model
from tpfl.settings import Settings as JaxSettings
from tpfl.utils import wait_convergence as jax_wait_convergence
from tpfl.utils import wait_to_finish as jax_wait_to_finish
from tpfl.utils.certificates import enable_mtls as jax_enable_mtls
from tpfl_torch.communication import (FaultInjector, FaultPlan, GrpcCommunicationProtocol,
                                      InMemoryCommunicationProtocol, LinkFaults)
from tpfl_torch.communication import grpc_transport as gt
from tpfl_torch.communication import hpack, http2
from tpfl_torch.communication.memory import clear_registry
from tpfl_torch.communication.message import Message
from tpfl_torch.exceptions import CommunicationError, ConnectionTimeoutError
from tpfl_torch.interop import model_state_from_jax
from tpfl_torch.learning import _msgpack
from tpfl_torch.learning.dataset import RandomIIDPartitionStrategy
from tpfl_torch.learning.dataset.synthetic import synthetic_mnist
from tpfl_torch.learning.model import TpflModel
from tpfl_torch.management.logger import logger
from tpfl_torch.models import MLP
from tpfl_torch.node import Node
from tpfl_torch.settings import Settings
from tpfl_torch.utils import wait_to_finish
from tpfl_torch.utils.certificates import enable_mtls, generate_certificates
from tpfl_torch.utils.tree import tree_items

RTOL, ATOL = 1e-4, 1e-5
HEARTBEAT_TIMEOUT = 30.0
KINDS = {"jax": jax_grpc.GrpcCommunicationProtocol, "port": GrpcCommunicationProtocol}
DIRECTIONS = ["jax->port", "port->jax", "port->port"]
IDENTITY = {"request_serializer": lambda b: b, "response_deserializer": lambda b: b}


@pytest.fixture(autouse=True)
def _runtime_settings():
    snaps = (Settings.snapshot(), JaxSettings.snapshot())
    Settings.set_test_settings()
    JaxSettings.set_test_settings()
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


def both(**knobs):
    for name, value in knobs.items():
        setattr(Settings, name, value)
        setattr(JaxSettings, name, value)


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


def _pair(direction, addrs=(None, None)):
    """Started client and server; heartbeats quiet, so that no beat in
    flight re-adds a peer right after its Disconnect."""
    both(HEARTBEAT_PERIOD=30.0, HEARTBEAT_TIMEOUT=60.0)
    client, server = direction.split("->")
    a, b = KINDS[client](addrs[0]), KINDS[server](addrs[1])
    a.start()
    b.start()
    return a, b


def _capture(node):
    """Every Message the node's server takes in, as bytes, in order."""
    got = []
    orig = node.handle_message

    def handle(msg):
        got.append(msg.to_bytes())
        orig(msg)

    node.handle_message = handle
    for cmd in ("probe", "model"):
        node.add_command(cmd, lambda *a, **kw: None)
    return got


def _exchange(a, b, size=4_000_000):
    """Handshake, Send, SendStream and Disconnect from ``a`` to ``b``."""
    got = _capture(b)
    assert a.connect(b.get_address())
    assert wait_for(lambda: a.get_address() in b.get_neighbors(only_direct=True))
    probe = a.build_msg("probe", ["x", "y"], round=3)
    a.send(b.get_address(), probe, raise_error=True)
    payload = np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8).tobytes()
    weights = a.build_weights("model", 2, payload, ["a", "b"], 7)
    a.send(b.get_address(), weights, raise_error=True)
    assert got == [probe.to_bytes(), weights.to_bytes()]
    assert Message.from_bytes(got[1]).payload == payload
    a.disconnect(b.get_address())
    assert wait_for(lambda: a.get_address() not in b.get_neighbors())


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_routes_across_packages(direction):
    both(WIRE_CHUNK_SIZE=2048)
    a, b = _pair(direction)
    try:
        if direction.startswith("port"):
            before = logger.metrics.value("tpfl_wire_chunks_total", {"node": a.get_address()})
        _exchange(a, b)
        if direction.startswith("port"):
            chunks = logger.metrics.value("tpfl_wire_chunks_total",
                                          {"node": a.get_address()}) - before
            assert chunks >= 4_000_000 // 2048
    finally:
        a.stop()
        b.stop()


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_mtls_across_packages(direction, tmp_path):
    paths = generate_certificates(str(tmp_path))
    enable_mtls(str(tmp_path), paths)
    jax_enable_mtls(str(tmp_path), paths)
    both(WIRE_CHUNK_SIZE=64 * 1024)
    a, b = _pair(direction)
    try:
        _exchange(a, b, size=1_000_000)
    finally:
        a.stop()
        b.stop()


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_unix_sockets_across_packages(direction, tmp_path):
    both(WIRE_CHUNK_SIZE=16 * 1024)
    a, b = _pair(direction, (f"unix:{tmp_path}/a.sock", f"unix:{tmp_path}/b.sock"))
    try:
        _exchange(a, b, size=200_000)
    finally:
        a.stop()
        b.stop()
    if direction.endswith("port"):
        assert not (tmp_path / "b.sock").exists()  # unlinked at stop


def test_grpcio_metadata_reaches_the_port_decoder(monkeypatch):
    """grpcio's HPACK encoder against the port's decoder. grpcio sends
    plain values as raw literals and indexes them incrementally, and
    Huffman-codes ``-bin`` values (their base64): every printable ASCII
    byte as a plain value and every byte 0-255 as a ``-bin`` value, on
    three calls (the repeats come from the dynamic table), arrive intact."""
    seen, coded = [], []
    decode = hpack.huffman_decode
    monkeypatch.setattr(hpack, "huffman_decode", lambda d: coded.append(d) or decode(d))
    server = gt.GrpcServer(f"127.0.0.1:{free_ports(1)[0]}", {
        "/t.S/Echo": (False, lambda req, call: seen.append(call.invocation_metadata()) or req)})
    printable, every_byte = "".join(map(chr, range(0x21, 0x7F))), bytes(range(256))
    try:
        with grpc.insecure_channel(server.addr) as channel:
            echo = channel.unary_unary("/t.S/Echo", **IDENTITY)
            for _ in range(3):
                assert echo(b"ping", timeout=5, metadata=[("x-ascii", f"a {printable} z"),
                                                          ("x-every-bin", every_byte)]) == b"ping"
    finally:
        server.stop()
    assert len(seen) == 3
    for md in map(dict, seen):
        assert md["x-ascii"] == f"a {printable} z"
        b64 = md["x-every-bin"]
        assert base64.b64decode(b64 + "=" * (-len(b64) % 4)) == every_byte
        assert md["content-type"] == "application/grpc"
    assert coded  # the -bin values came Huffman-coded


def test_tls_client_without_certificate_refused(tmp_path):
    """tests/test_communication.py:276 against the port's server: a grpcio
    client that trusts the CA but presents no certificate is refused, and
    never registers."""
    enable_mtls(str(tmp_path))
    server = GrpcCommunicationProtocol()
    server.start()
    try:
        with open(Settings.CA_CRT, "rb") as f:
            ca = f.read()
        channel = grpc.secure_channel(server.get_address(),
                                      grpc.ssl_channel_credentials(root_certificates=ca))
        stub = channel.unary_unary("/tpfl.NodeServices/Handshake", **IDENTITY)
        with pytest.raises(grpc.RpcError):
            stub(_msgpack.packb({"addr": "mallory"}), timeout=5)
        channel.close()
        # ...and a raw TLS client without a certificate gets no HTTP/2 either.
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.load_verify_locations(Settings.CA_CRT)
        ctx.set_alpn_protocols(["h2"])
        host, port = server.get_address().rsplit(":", 1)
        with pytest.raises((ssl.SSLError, ConnectionError)):
            with socket.create_connection((host, int(port)), timeout=5) as raw:
                with ctx.wrap_socket(raw, server_hostname=host) as s:
                    s.sendall(b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n")
                    if not s.recv(9):
                        raise ConnectionError("closed without SETTINGS")
        assert "mallory" not in server.get_neighbors()
    finally:
        server.stop()


def test_unknown_path_is_unimplemented_at_grpcio():
    server = GrpcCommunicationProtocol()
    server.start()
    try:
        with grpc.insecure_channel(server.get_address()) as channel:
            for path in ("/tpfl.NodeServices/Nope", "/other.Service/Send"):
                with pytest.raises(grpc.RpcError) as e:
                    channel.unary_unary(path, **IDENTITY)(b"x", timeout=5)
                assert e.value.code() == grpc.StatusCode.UNIMPLEMENTED
            # The connection stays usable after the refusals.
            ok = channel.unary_unary("/tpfl.NodeServices/Send", **IDENTITY)(
                Message(source="someone", cmd="noop").new_hash().to_bytes(), timeout=5)
            assert _msgpack.unpackb(ok) == {"ok": True}
    finally:
        server.stop()


def test_max_message_size_is_enforced():
    """A grpcio client sending past the port server's MAX_MESSAGE_SIZE gets
    RESOURCE_EXHAUSTED; the port's client refuses to send one; under the
    cap the same route delivers."""
    Settings.MAX_MESSAGE_SIZE = 4096
    Settings.WIRE_CHUNK_SIZE = 0  # always unary
    a, b = GrpcCommunicationProtocol(), GrpcCommunicationProtocol()
    a.start()
    b.start()
    try:
        with grpc.insecure_channel(b.get_address()) as channel:
            send = channel.unary_unary("/tpfl.NodeServices/Send", **IDENTITY)
            with pytest.raises(grpc.RpcError) as e:
                send(b"x" * 8192, timeout=5)
            assert e.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
        assert a.connect(b.get_address())
        with pytest.raises(CommunicationError, match="MAX_MESSAGE_SIZE") as e:
            a._transport_send(b.get_address(), a.get_neighbors()[b.get_address()].conn,
                              a.build_weights("model", 1, b"x" * 8192, ["a"], 1))
        assert e.value.code() == gt.RESOURCE_EXHAUSTED
        got = []
        b.add_command("model", lambda source, round, weights, **kw: got.append(len(weights)))
        a.send(b.get_address(), a.build_weights("model", 1, b"x" * 1024, ["a"], 1),
               raise_error=True)
        assert got == [1024]
    finally:
        a.stop()
        b.stop()


@pytest.mark.parametrize("server_kind", sorted(KINDS))
def test_corruption_rejected_by_chunk_crc_and_retried(server_kind):
    both(RETRY_MAX_ATTEMPTS=2)
    a, b = _pair(f"port->{server_kind}")
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
        assert "corrupt_accepted" not in stats and stats["delivered"] == 1
    finally:
        a.stop()
        b.stop()


def test_unanswered_rpc_times_out_typed_and_cancels():
    """A grpcio server whose handler never answers: the RPC's deadline
    (GRPC_TIMEOUT) expires as ConnectionTimeoutError, and the server sees
    the call cancelled (the client's RST_STREAM CANCEL)."""
    release, contexts = threading.Event(), []

    def hang(request, context):
        contexts.append(context)
        release.wait(10)
        return _msgpack.packb({"ok": True})

    server = grpc.server(futures.ThreadPoolExecutor(2))
    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
        "tpfl.NodeServices", {"Send": grpc.unary_unary_rpc_method_handler(
            hang, request_deserializer=lambda b: b, response_serializer=lambda b: b)}),))
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    p = GrpcCommunicationProtocol()
    addr = f"127.0.0.1:{port}"
    conn = p._dial(addr)
    try:
        t0 = time.monotonic()
        with pytest.raises(ConnectionTimeoutError):
            p._transport_send(addr, conn, p.build_msg("probe"))
        assert Settings.GRPC_TIMEOUT - 0.1 < time.monotonic() - t0 < Settings.GRPC_TIMEOUT + 2
        assert wait_for(lambda: contexts and not contexts[0].is_active())
    finally:
        release.set()
        conn.close()
        server.stop(0).wait(5)


def test_dial_to_a_closed_port_times_out_after_the_ready_wait():
    """tests/test_communication.py:698 for the port: the refused connect is
    re-tried until the ready wait ends, then ConnectionTimeoutError."""
    p = GrpcCommunicationProtocol()
    wait = max(Settings.GRPC_TIMEOUT * 4, 2.0)
    t0 = time.monotonic()
    with pytest.raises(ConnectionTimeoutError) as e:
        p._dial("127.0.0.1:1")
    assert isinstance(e.value, CommunicationError)
    assert wait - 0.05 <= time.monotonic() - t0 < wait + 2


def test_unary_call_served_while_a_stream_is_held_open():
    """One connection: a SendStream holds midway (its iterator waits) while
    a Send on the same channel completes and is handled first."""
    Settings.WIRE_CHUNK_SIZE = 4096
    b = GrpcCommunicationProtocol()
    b.start()
    order, half, release = [], threading.Event(), threading.Event()
    b.add_command("probe", lambda source, round, args: order.append("probe"))
    b.add_command("model", lambda source, round, weights, **kw: order.append(len(weights)))
    ch = gt.Channel(b.get_address(), "client")
    payload = bytes(range(256)) * 4096
    frames = list(gt.chunk_frames(Message(source="client", cmd="model", round=1,
                                          payload=payload, contributors=["c"],
                                          num_samples=1).to_bytes(), 4096))

    def held():
        yield from frames[:len(frames) // 2]
        half.set()
        release.wait(10)
        yield from frames[len(frames) // 2:]

    result = {}
    streamer = threading.Thread(target=lambda: result.update(r=ch.stream_unary(
        "/tpfl.NodeServices/SendStream", held(), 20.0)))
    streamer.start()
    try:
        assert half.wait(10)
        t0 = time.monotonic()
        reply = ch.unary("/tpfl.NodeServices/Send",
                         Message(source="client", cmd="probe").new_hash().to_bytes(), 5.0)
        assert _msgpack.unpackb(reply) == {"ok": True}
        assert time.monotonic() - t0 < 2.0 and order == ["probe"]
        release.set()
        streamer.join(20)
        assert _msgpack.unpackb(result["r"]) == {"ok": True}
        assert order == ["probe", len(payload)]
    finally:
        release.set()
        streamer.join(20)
        ch.close()
        b.stop()


@pytest.mark.parametrize("client", ["port", "grpcio"])
def test_slow_handler_holds_the_sender_to_the_stream_window(client, monkeypatch):
    """Receive flow control: a SendStream to a handler that sleeps before
    it reads gets no further ahead of the handler than the stream window
    and the message that crosses it, and then arrives whole; a unary
    message four windows long still arrives, since the rest of a message
    in progress is always granted."""
    window, size, n = 64 * 1024, 4096, 256  # 1 MiB against a 64 KiB window
    monkeypatch.setattr(http2, "STREAM_WINDOW", window)
    buffered, sent = [], [0]

    def slow(requests, call):
        time.sleep(0.5)
        with call.cv:
            buffered.append((call.parser.held + len(call.parser.buf), sent[0]))
        return b"%d" % sum(len(r) for r in requests)

    def chunks():
        for i in range(n):
            sent[0] += 1
            yield bytes([i % 256]) * size

    addr = f"127.0.0.1:{free_ports(1)[0]}"
    server = gt.GrpcServer(addr, {"/t.S/Slow": (True, slow),
                                  "/t.S/Echo": (False, lambda request, call: request)})
    big = bytes(range(256)) * (4 * window // 256)
    try:
        if client == "port":
            ch = gt.Channel(addr, "client")
            try:
                got = ch.stream_unary("/t.S/Slow", chunks(), 20.0)
                echo = ch.unary("/t.S/Echo", big, 20.0)
            finally:
                ch.close()
        else:
            with grpc.insecure_channel(addr) as channel:
                got = channel.stream_unary("/t.S/Slow", **IDENTITY)(chunks(), timeout=20)
                echo = channel.unary_unary("/t.S/Echo", **IDENTITY)(big, timeout=20)
        assert got == b"%d" % (n * size) and echo == big
        (held, at_wake), = buffered
        assert held <= window + size + 5
        if client == "port":  # the port's client sends only what the window allows
            assert at_wake * (size + 5) <= window + 2 * (size + 5)
    finally:
        server.stop()


def test_no_thread_left_after_stop():
    Settings.GRPC_SERVER_WORKERS = 2
    a, b = GrpcCommunicationProtocol(), GrpcCommunicationProtocol()
    a.start()
    b.start()
    try:
        a.connect(b.get_address())
        for _ in range(6):
            a.send(b.get_address(), a.build_msg("noop"), raise_error=True)
        names = [t.name for t in threading.enumerate()
                 if t.name.startswith(f"grpc-{b.get_address()}_")]
        assert 1 <= len(names) <= 2
        assert any(t.name.startswith(f"grpc-{a.get_address()}-read")
                   for t in threading.enumerate())
    finally:
        a.stop()
        b.stop()
    assert wait_for(lambda: not [
        t for t in threading.enumerate()
        if t.name.startswith((f"grpc-{a.get_address()}", f"grpc-{b.get_address()}"))], 5)


def test_concurrent_senders_both_ways_stress():
    """More sending threads than handler threads on one connection each
    way (a to b and b to a at once), unary sends and multi-chunk streams
    mixed: every payload delivered exactly once, at most
    GRPC_SERVER_WORKERS handler threads, every thread gone after stop."""
    both(GRPC_SERVER_WORKERS=3, WIRE_CHUNK_SIZE=4096, HEARTBEAT_PERIOD=30.0,
         HEARTBEAT_TIMEOUT=60.0, GRPC_TIMEOUT=10.0)
    a, b = GrpcCommunicationProtocol(), GrpcCommunicationProtocol()
    got = {a.get_address(): [], b.get_address(): []}
    for nd in (a, b):
        nd.add_command("model", lambda source, round, weights, _n=nd, **kw:
                       got[_n.get_address()].append(weights))
    a.start()
    b.start()
    n_threads, per_thread, errors = 4, 4, []
    payloads = {nd.get_address(): [[f"{nd.get_address()}-{t}-{i}-".encode()
                                     * (1 + 9000 * (i % 2)) for i in range(per_thread)]
                                    for t in range(n_threads)] for nd in (a, b)}

    def sender(src, dst, mine):
        try:
            for p in mine:
                src.send(dst.get_address(), src.build_weights("model", 0, p, ["x"], 1),
                         raise_error=True)
        except Exception as e:  # reported by the assert below
            errors.append(e)

    try:
        assert a.connect(b.get_address())
        assert wait_for(lambda: a.get_address() in b.get_neighbors(only_direct=True))
        threads = [threading.Thread(target=sender, args=(src, dst, mine))
                   for src, dst in ((a, b), (b, a)) for mine in payloads[src.get_address()]]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert errors == []
        for src, dst in ((a, b), (b, a)):
            assert sorted(got[dst.get_address()]) == sorted(
                p for mine in payloads[src.get_address()] for p in mine)
            handlers = [t for t in threading.enumerate()
                        if t.name.startswith(f"grpc-{dst.get_address()}_")]
            assert 1 <= len(handlers) <= 3
    finally:
        a.stop()
        b.stop()
    assert wait_for(lambda: not [
        t for t in threading.enumerate()
        if t.name.startswith((f"grpc-{a.get_address()}", f"grpc-{b.get_address()}"))], 5)


@pytest.mark.parametrize("timeout, wire", [(0.5, "500000u"), (2.0, "2000000u"),
                                           (1e-9, "1n"), (1000.0, "1000000m"),
                                           (1e7, "10000000S")])
def test_grpc_timeout_header(timeout, wire):
    assert gt.encode_timeout(timeout) == wire
    assert gt.parse_timeout(wire) == pytest.approx(timeout)
    for bad in ("", "5", "5x", "123456789S", "-1S"):
        with pytest.raises(ValueError):
            gt.parse_timeout(bad)


# --- federations ----------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _addrs():
    return tuple(f"127.0.0.1:{p}" for p in free_ports(2))


def _jax_nodes(which):
    """JAX Nodes ``which`` of a 2-node federation (data partitions, addresses)."""
    jds = jax_synthetic_mnist(n_train=400, n_test=80, seed=0, noise=0.4)
    jparts = jds.generate_partitions(2, JaxRandomIID, seed=1)
    return [jax_node.Node(jax_create_model("mlp", (28, 28), seed=7, hidden_sizes=(32,),
                                           compute_dtype=jnp.float32),
                          jparts[i], addr=_addrs()[i],
                          protocol=jax_grpc.GrpcCommunicationProtocol,
                          learning_rate=0.1, batch_size=32) for i in which]


def _port_nodes(protocol, which):
    """Port Nodes ``which`` of the same federation, from the JAX initial params."""
    parts = synthetic_mnist(n_train=400, n_test=80, seed=0, noise=0.4) \
        .generate_partitions(2, RandomIIDPartitionStrategy, seed=1)
    jax_init = jax_create_model("mlp", (28, 28), seed=7, hidden_sizes=(32,),
                                compute_dtype=jnp.float32)
    module = MLP(hidden_sizes=(32,), out_channels=10, compute_dtype=torch.float32)
    return [Node(TpflModel(module, **model_state_from_jax(jax_init, device="cpu")), parts[i],
                 addr=_addrs()[i], protocol=protocol, device="cpu", learning_rate=0.1,
                 batch_size=32) for i in which]


def _params(nd):
    return {p: np.array(v.numpy() if isinstance(v, torch.Tensor) else v)
            for p, v in tree_items(nd.learner.get_model().get_parameters())}


def _federate(nodes, rounds=2, timeout=120):
    """Start, connect node 0 to the others, run ``rounds`` and return each
    node's final params. Mixed lists wait on each package's own helpers."""
    for nd in nodes:
        nd.start()
    try:
        for nd in nodes[1:]:
            nodes[0].connect(nd.addr)
        jax_nodes = [nd for nd in nodes if isinstance(nd, jax_node.Node)]
        port_nodes = [nd for nd in nodes if isinstance(nd, Node)]
        assert wait_for(lambda: all(len(nd.get_neighbors()) == len(nodes) - 1 for nd in nodes),
                        10)
        nodes[0].set_start_learning(rounds=rounds, epochs=1)
        if jax_nodes and port_nodes:
            assert wait_for(lambda: all(nd.state.round is not None for nd in nodes), 30)
        if jax_nodes:
            jax_wait_to_finish(jax_nodes, timeout=timeout)
        if port_nodes:
            wait_to_finish(port_nodes, timeout=timeout)
        return [_params(nd) for nd in nodes]
    finally:
        for nd in nodes:
            nd.stop()


@functools.lru_cache(maxsize=1)
def _all_jax():
    snaps = JaxSettings.snapshot()
    JaxSettings.HEARTBEAT_TIMEOUT = HEARTBEAT_TIMEOUT
    try:
        nodes = _jax_nodes([0, 1])
        for nd in nodes:
            nd.start()
        try:
            nodes[0].connect(nodes[1].addr)
            jax_wait_convergence(nodes, 1, only_direct=False, wait=10)
            nodes[0].set_start_learning(rounds=2, epochs=1)
            jax_wait_to_finish(nodes, timeout=120)
            return tuple(_params(nd) for nd in nodes)
        finally:
            for nd in nodes:
                nd.stop()
    finally:
        JaxSettings.restore(snaps)


def _close(got, want, exact=None):
    for params, ref in zip(got, want):
        assert params.keys() == ref.keys()
        for path in ref:
            np.testing.assert_allclose(params[path], ref[path], rtol=RTOL, atol=ATOL,
                                       err_msg=path)
    if exact is not None:
        for params, other in zip(got, exact):
            for path in params:
                np.testing.assert_array_equal(params[path], other[path], err_msg=path)


def test_two_node_grpc_federation_matches_memory_and_jax_grpc():
    """The 2-node federation of tests/test_node.py:104 over the port's gRPC:
    bit-identical to the port's in-memory federation with the same
    addresses, and allclose to the JAX package's gRPC federation."""
    want = _all_jax()
    both(HEARTBEAT_TIMEOUT=HEARTBEAT_TIMEOUT)
    over_grpc = _federate(_port_nodes(GrpcCommunicationProtocol, [0, 1]))
    clear_registry()
    over_memory = _federate(_port_nodes(InMemoryCommunicationProtocol, [0, 1]))
    _close(over_grpc, want, exact=over_memory)
    for path in over_grpc[0]:
        np.testing.assert_allclose(over_grpc[0][path], over_grpc[1][path], atol=ATOL)


def test_mixed_jax_and_port_federation_over_grpc():
    """One JAX Node and one port Node on one LINE over gRPC, with the
    all-JAX federation's seeds, data, initial params and addresses: both
    end on one aggregate, allclose to the all-JAX one."""
    want = _all_jax()
    both(HEARTBEAT_TIMEOUT=HEARTBEAT_TIMEOUT)
    mixed = _jax_nodes([0]) + _port_nodes(GrpcCommunicationProtocol, [1])
    got = _federate(mixed)
    _close(got, want)
    for path in got[0]:
        np.testing.assert_allclose(got[0][path], got[1][path], rtol=RTOL, atol=ATOL)
