"""TCP transport — the reference's four routes over length-prefixed TCP,
beside :mod:`tpfl_torch.communication.grpc_transport`, which speaks the
reference's gRPC wire itself.

The same as the reference (and as the gRPC transport):

- the four routes, Handshake, Disconnect, Send and SendStream, with the
  reference's request bodies (``{"addr": ...}`` for the first two, the
  ``Message.to_bytes`` envelope for Send) and its ``{"ok": ...}``
  msgpack replies;
- the envelope bytes (:class:`~tpfl_torch.communication.message.Message`)
  and the CRC-tagged chunk frames of a SendStream
  (:mod:`~tpfl_torch.communication.wire`'s :func:`chunk_frames` and
  :func:`reassemble_frames`);
- the addresses (:class:`AddressParser`: IPv4, IPv6, a random port,
  ``unix:`` paths), the knobs (``GRPC_TIMEOUT``, ``MAX_MESSAGE_SIZE``,
  ``GRPC_SERVER_WORKERS``, ``WIRE_CHUNK_SIZE``, ``USE_SSL`` and the five
  certificate paths), the deadlines and the error types
  (:class:`~tpfl_torch.exceptions.ConnectionTimeoutError` when a deadline
  expires, :class:`~tpfl_torch.exceptions.CommunicationError` on a
  refusal), the ``tpfl_wire_bytes_total`` / ``tpfl_wire_chunks_total``
  counters and mutual TLS.

Different: the routes ride plain length-prefixed TCP, not HTTP/2. A
request is one route byte, an 8-byte big-endian length and the body; a
SendStream is the route byte, then each chunk frame as a length and its
bytes, then a zero length; every request gets one length-prefixed
reply. So only port nodes speak it: a JAX node talks to a port node over
:class:`~tpfl_torch.communication.GrpcCommunicationProtocol`. Where gRPC
multiplexes calls on one HTTP/2 connection, a connection here carries
one request at a time, and a peer's handle keeps a few idle sockets so
that a heartbeat never queues behind a model stream; a refused dial
raises at once, where gRPC waits for the channel to be ready.
"""

from __future__ import annotations

import queue
import selectors
import socket
import ssl
import struct
import threading
import time
from typing import Any, Iterable, Optional

from tpfl_torch.communication.base import ThreadedCommunicationProtocol
from tpfl_torch.communication.message import Message
from tpfl_torch.communication.wire import (AddressParser, chunk_frames, client_context,
                                           dial_timeout, endpoint, reassemble_frames,
                                           server_context, unlink_socket)
from tpfl_torch.concurrency import make_lock
from tpfl_torch.exceptions import (
    ChunkIntegrityError,
    CommunicationError,
    ConnectionTimeoutError,
)
from tpfl_torch.learning import _msgpack
from tpfl_torch.management.logger import logger
from tpfl_torch.settings import Settings

# Route bytes: one per RPC of the reference's generic service.
HANDSHAKE, DISCONNECT, SEND, SEND_STREAM = b"H", b"D", b"M", b"S"
ROUTES = {HANDSHAKE: "Handshake", DISCONNECT: "Disconnect", SEND: "Send",
          SEND_STREAM: "SendStream"}
_LEN = struct.Struct(">Q")
# Idle sockets a peer's handle keeps for reuse (more are dialed while
# they are all busy, and closed when they come back to a full pool).
IDLE_SOCKETS = 4

class _Deadline:
    """One call's deadline over every socket operation it makes."""

    def __init__(self, seconds: float, what: str) -> None:
        self.end = time.monotonic() + seconds
        self.seconds = seconds
        self.what = what

    def arm(self, sock: socket.socket) -> None:
        left = self.end - time.monotonic()
        if left <= 0:
            raise ConnectionTimeoutError(f"{self.what} exceeded its {self.seconds:.1f}s deadline")
        sock.settimeout(left)


def _recv_exact(sock: socket.socket, n: int, deadline: Optional[_Deadline] = None) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        if deadline is not None:
            deadline.arm(sock)
        k = sock.recv_into(view[got:], n - got)
        if k == 0:
            raise ConnectionError(f"connection closed after {got} of {n} bytes")
        got += k
    return bytes(buf)


def _send_all(sock: socket.socket, parts: Iterable[bytes], deadline: _Deadline) -> None:
    for part in parts:
        deadline.arm(sock)
        sock.sendall(part)


def _read_body(sock: socket.socket, deadline: Optional[_Deadline] = None) -> bytes:
    """One length-prefixed body, refused before allocating when its
    length exceeds ``MAX_MESSAGE_SIZE``."""
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size, deadline))
    if n > Settings.MAX_MESSAGE_SIZE:
        raise _Oversized(n)
    return _recv_exact(sock, n, deadline)


class _Oversized(Exception):
    def __init__(self, n: int) -> None:
        super().__init__(f"message of {n} bytes exceeds MAX_MESSAGE_SIZE "
                         f"({Settings.MAX_MESSAGE_SIZE})")


def _reply(ok: bool, error: str = "") -> bytes:
    body = _msgpack.packb({"ok": True} if ok else {"ok": False, "error": error})
    return _LEN.pack(len(body)) + body


class _Server:
    """The receiving side: a listening socket and one selector thread
    that hands each connection with a request waiting to a worker, at
    most ``GRPC_SERVER_WORKERS`` at once (threads started as needed and
    named ``tcp-<addr>_<i>``). A worker serves one request, then gives
    the connection back to the selector."""

    def __init__(self, proto: "TcpCommunicationProtocol") -> None:
        self.proto = proto
        self.addr = proto.get_address()
        family, where, _ = endpoint(self.addr)
        self.unix_path = where if family == socket.AF_UNIX else None
        self.listener = socket.socket(family, socket.SOCK_STREAM)
        try:
            if self.unix_path is not None:
                unlink_socket(self.unix_path)
            else:
                self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self.listener.bind(where)
            self.listener.listen(128)
        except OSError as e:
            self.listener.close()
            raise CommunicationError(f"Cannot bind {self.addr}: {e}") from e
        self.listener.setblocking(False)
        self.tls = server_context() if Settings.USE_SSL else None
        self.selector = selectors.DefaultSelector()
        self.wake_r, self.wake_w = socket.socketpair()
        self.wake_r.setblocking(False)
        self.selector.register(self.listener, selectors.EVENT_READ, "accept")
        self.selector.register(self.wake_r, selectors.EVENT_READ, "wake")
        self.returned: "queue.SimpleQueue[socket.socket]" = queue.SimpleQueue()
        self.ready: "queue.SimpleQueue[Optional[socket.socket]]" = queue.SimpleQueue()
        self.conns: set[socket.socket] = set()  # guarded-by: _lock
        self.workers: list[threading.Thread] = []  # guarded-by: _lock
        self.idle = 0  # guarded-by: _lock
        self.queued = 0  # guarded-by: _lock
        self._lock = make_lock("TcpServer._lock")
        self.stopping = threading.Event()
        self.loop = threading.Thread(target=self._select_loop, name=f"tcp-{self.addr}-accept",
                                     daemon=True)
        self.loop.start()

    # --- selector thread ---

    def _select_loop(self) -> None:
        while not self.stopping.is_set():
            for key, _ in self.selector.select(timeout=1.0):
                if key.data == "accept":
                    self._accept()
                elif key.data == "wake":
                    try:
                        self.wake_r.recv(4096)
                    except OSError:
                        pass
                else:
                    self.selector.unregister(key.fileobj)
                    self._dispatch(key.fileobj)
            while True:
                try:
                    conn = self.returned.get_nowait()
                except queue.Empty:
                    break
                try:
                    self.selector.register(conn, selectors.EVENT_READ, "conn")
                except (ValueError, OSError):  # closed meanwhile
                    self._forget(conn)

    def _accept(self) -> None:
        try:
            conn, _ = self.listener.accept()
        except (BlockingIOError, OSError):
            return
        conn.setblocking(True)
        if conn.family != socket.AF_UNIX:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if self.tls is not None:
            conn = self.tls.wrap_socket(conn, server_side=True, do_handshake_on_connect=False)
        with self._lock:
            self.conns.add(conn)
        self.selector.register(conn, selectors.EVENT_READ, "conn")

    def _dispatch(self, conn: socket.socket) -> None:
        with self._lock:
            self.queued += 1
            start = (self.queued > self.idle
                     and len(self.workers) < max(1, Settings.GRPC_SERVER_WORKERS))
            if start:
                t = threading.Thread(target=self._work, name=f"tcp-{self.addr}_{len(self.workers)}",
                                     daemon=True)
                self.workers.append(t)
        if start:
            t.start()
        self.ready.put(conn)

    # --- workers ---

    def _work(self) -> None:
        while True:
            with self._lock:
                self.idle += 1
            conn = self.ready.get()
            with self._lock:
                self.idle -= 1
                self.queued -= conn is not None
            if conn is None:
                return
            keep = False
            try:
                keep = self._serve_one(conn)
            except Exception as e:  # a broken peer must not kill the server
                logger.debug(self.addr, f"TCP connection dropped: {e}")
            if keep and not self.stopping.is_set():
                self.returned.put(conn)
                self._wake()
            else:
                self._forget(conn)

    def _serve_one(self, conn: socket.socket) -> bool:
        """Serve the request waiting on ``conn``; False when the peer
        closed it or it must be dropped."""
        conn.settimeout(dial_timeout())
        if isinstance(conn, ssl.SSLSocket) and not getattr(conn, "_tpfl_tls_done", False):
            conn.do_handshake()  # raises on a peer without a CA-signed certificate
            conn._tpfl_tls_done = True  # type: ignore[attr-defined]
            if not conn.pending():
                return True  # the request follows on the next readiness
        route = conn.recv(1)
        if not route:
            return False
        try:
            if route == SEND_STREAM:
                frames = []
                while True:
                    frame = _read_body(conn)
                    if not frame:
                        break
                    frames.append(frame)
                out = self.proto._on_stream(frames)
            elif route in ROUTES:
                out = self.proto._on_request(route, _read_body(conn))
            else:
                conn.sendall(_reply(False, f"unknown route {route!r}"))
                return False
        except _Oversized as e:
            # Refused before allocating; the unread body leaves the
            # connection out of step, so it is closed after the reply.
            logger.error(self.addr, f"TCP request refused: {e}")
            conn.sendall(_reply(False, str(e)))
            return False
        conn.sendall(out)
        return True

    def _wake(self) -> None:
        try:
            self.wake_w.send(b"\0")
        except OSError:
            pass

    def _forget(self, conn: socket.socket) -> None:
        with self._lock:
            self.conns.discard(conn)
        try:
            conn.close()
        except OSError:
            pass

    def stop(self) -> None:
        self.stopping.set()
        self._wake()
        self.loop.join(timeout=5)
        self.selector.close()
        self.listener.close()
        with self._lock:
            conns, self.conns = list(self.conns), set()
            workers = list(self.workers)
        for conn in conns:  # unblocks workers mid-request
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        for _ in workers:
            self.ready.put(None)
        for t in workers:
            t.join(timeout=5)
        for s in (self.wake_r, self.wake_w):
            s.close()
        if self.unix_path is not None:
            unlink_socket(self.unix_path)


class _Peer:
    """A dialed peer: its address and a small pool of open sockets, one
    request at a time on each."""

    def __init__(self, addr: str, sock: socket.socket) -> None:
        self.addr = addr
        self._idle = [sock]  # guarded-by: _lock
        self._lock = make_lock("TcpPeer._lock")
        self.closed = False

    def acquire(self) -> socket.socket:
        with self._lock:
            if self.closed:
                raise CommunicationError(f"connection to {self.addr} is closed")
            if self._idle:
                return self._idle.pop()
        return _open_socket(self.addr)

    def release(self, sock: socket.socket, ok: bool) -> None:
        with self._lock:
            if ok and not self.closed and len(self._idle) < IDLE_SOCKETS:
                self._idle.append(sock)
                return
        _close_socket(sock)

    def close(self) -> None:
        with self._lock:
            self.closed = True
            idle, self._idle = self._idle, []
        for sock in idle:
            _close_socket(sock)


def _close_socket(sock: socket.socket) -> None:
    try:
        sock.close()
    except OSError:
        pass


def _open_socket(addr: str) -> socket.socket:
    """Connect (and, under ``USE_SSL``, run the TLS handshake) within the
    dial deadline: an expired deadline raises
    :class:`ConnectionTimeoutError`, a refusal :class:`CommunicationError`."""
    family, where, server_name = endpoint(addr)
    deadline = _Deadline(dial_timeout(), f"Dial to {addr}")
    sock = socket.socket(family, socket.SOCK_STREAM)
    try:
        deadline.arm(sock)
        sock.connect(where)
        if family != socket.AF_UNIX:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if Settings.USE_SSL:
            sock = client_context().wrap_socket(sock, server_hostname=server_name,
                                                  do_handshake_on_connect=False)
            deadline.arm(sock)
            sock.do_handshake()
        return sock
    except socket.timeout as e:
        _close_socket(sock)
        raise ConnectionTimeoutError(
            f"Channel to {addr} not ready within {deadline.seconds:.1f}s") from e
    except ConnectionTimeoutError:
        _close_socket(sock)
        raise
    except OSError as e:
        _close_socket(sock)
        raise CommunicationError(f"Cannot reach {addr}: {e}") from e


class TcpCommunicationProtocol(ThreadedCommunicationProtocol):
    """Real-network transport (mTLS-capable) over TCP or unix sockets."""

    def __init__(self, addr: Optional[str] = None) -> None:
        super().__init__(AddressParser(addr).address)
        self._server: Optional[_Server] = None

    # --- server side ---

    def _server_start(self) -> None:
        self._server = _Server(self)

    def _server_stop(self) -> None:
        if self._server is not None:
            self._server.stop()
            self._server = None

    def _on_request(self, route: bytes, body: bytes) -> bytes:
        """One unary request's reply (the reference's RPC handlers)."""
        if route == SEND:
            try:
                self.handle_message(Message.from_bytes(body))
                return _reply(True)
            except Exception as e:  # handler errors must not kill the server
                logger.error(self._addr, f"RPC send failed: {e}")
                return _reply(False, str(e))
        peer = _msgpack.unpackb(body)["addr"]
        if route == HANDSHAKE:
            # Register the caller WITHOUT dialing back: a reverse
            # handshake here would recurse; the send path dials lazily.
            self._neighbors.add(peer, non_direct=False, dial=False)
        else:
            self._neighbors.remove(peer, disconnect_msg=False)
        return _reply(True)

    def _on_stream(self, frames: list[bytes]) -> bytes:
        try:
            self.handle_message(Message.from_bytes(reassemble_frames(frames)))
            return _reply(True)
        except ChunkIntegrityError as e:
            # Corrupt / truncated stream: dropped whole, the sender's
            # gossip loop re-pushes; a partial reassembly never reaches
            # the decoder.
            logger.error(self._addr, f"RPC stream rejected: {e}")
            return _reply(False, str(e))
        except Exception as e:
            logger.error(self._addr, f"RPC stream failed: {e}")
            return _reply(False, str(e))

    # --- client side ---

    def _dial(self, addr: str) -> _Peer:
        return _Peer(addr, _open_socket(addr))

    def _call(self, conn: _Peer, route: bytes, parts: list[bytes], timeout: float) -> dict:
        """One request and its reply on a socket of ``conn``'s pool."""
        deadline = _Deadline(timeout, f"RPC {ROUTES[route]} to {conn.addr}")
        sock = conn.acquire()
        ok = False
        try:
            _send_all(sock, [route, *parts], deadline)
            out = _msgpack.unpackb(_read_body(sock, deadline))
            ok = True
            return out
        except (ConnectionTimeoutError, CommunicationError):
            raise
        except socket.timeout as e:
            raise ConnectionTimeoutError(
                f"RPC to {conn.addr} exceeded its deadline ({timeout:.1f}s)") from e
        except (OSError, ValueError, _Oversized) as e:
            raise CommunicationError(f"RPC {ROUTES[route]} to {conn.addr} failed: {e}") from e
        finally:
            conn.release(sock, ok)

    def _unary(self, conn: _Peer, route: bytes, body: bytes, timeout: float) -> dict:
        if len(body) > Settings.MAX_MESSAGE_SIZE:
            raise CommunicationError(f"message of {len(body)} bytes exceeds MAX_MESSAGE_SIZE "
                                     f"({Settings.MAX_MESSAGE_SIZE})")
        return self._call(conn, route, [_LEN.pack(len(body)), body], timeout)

    def _stream(self, conn: _Peer, frames: list[bytes]) -> dict:
        parts = [p for f in frames for p in (_LEN.pack(len(f)), f)] + [_LEN.pack(0)]
        return self._call(conn, SEND_STREAM, parts,
                          Settings.GRPC_TIMEOUT * (1 + 0.25 * len(frames)))

    def _handshake(self, addr: str, conn: _Peer) -> None:
        out = self._unary(conn, HANDSHAKE, _msgpack.packb({"addr": self._addr}),
                          Settings.GRPC_TIMEOUT)
        if not out.get("ok"):
            raise CommunicationError(f"Handshake with {addr} refused")

    def _transport_send(self, addr: str, conn: _Peer, msg: Message) -> None:
        data = msg.to_bytes()
        chunk = Settings.WIRE_CHUNK_SIZE
        logger.metrics.counter("tpfl_wire_bytes_total", float(len(data)),
                               labels={"node": self._addr})
        if chunk and len(data) > chunk:
            frames = list(chunk_frames(data, chunk))
            logger.metrics.counter("tpfl_wire_chunks_total", float(len(frames)),
                                   labels={"node": self._addr})
            out = self._stream(conn, frames)
        else:
            out = self._unary(conn, SEND, data, Settings.GRPC_TIMEOUT)
        if not out.get("ok"):
            raise CommunicationError(out.get("error", "unknown send error"))

    def _transport_send_corrupted(self, addr: str, conn: _Peer, msg: Message) -> None:
        """Fault-injection hook (communication.faults): ship the message
        as a chunk stream with the final frame's last byte (payload: the
        frame packs ``b`` last) flipped, so the receiver's real per-chunk
        CRC check does the rejecting. Always streams, even under the
        unary size threshold."""
        data = msg.to_bytes()
        chunk = Settings.WIRE_CHUNK_SIZE or 64 * 1024
        frames = list(chunk_frames(data, chunk))
        bad = bytearray(frames[-1])
        bad[-1] ^= 0x5A
        frames[-1] = bytes(bad)
        out = self._stream(conn, frames)
        if not out.get("ok"):
            raise CommunicationError(out.get("error", "corrupted stream rejected"))

    def _close_conn(self, conn: Any) -> None:
        if conn is not None:
            conn.close()

    def _send_disconnect(self, addr: str, conn: Any) -> None:
        ephemeral = conn is None
        try:
            if conn is None:
                conn = self._dial(addr)
            self._unary(conn, DISCONNECT, _msgpack.packb({"addr": self._addr}),
                        Settings.GRPC_TIMEOUT)
        except Exception:
            pass
        finally:
            if ephemeral:
                self._close_conn(conn)
