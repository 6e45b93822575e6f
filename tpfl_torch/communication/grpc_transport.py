"""gRPC transport — the real-network protocol implementation, the port's
counterpart of :mod:`tpfl.communication.grpc_transport`, and wire-
compatible with it: a port node and a JAX node (or any gRPC peer of the
service) federate over it.

The reference uses no protobuf. It moves its msgpack envelopes through
gRPC's generic method handlers with identity serializers, on four routes
of the service ``tpfl.NodeServices``: ``Handshake``, ``Disconnect`` and
``Send`` (unary) and ``SendStream`` (a client stream of CRC-tagged chunk
frames). The port speaks the same wire without ``grpcio``: HTTP/2
(:mod:`~tpfl_torch.communication.http2`) and HPACK
(:mod:`~tpfl_torch.communication.hpack`) on the standard library, and on
top of them gRPC's own layer from the "gRPC over HTTP2" protocol
document:

- a message is a 5-byte prefix (a compressed flag, a 4-byte big-endian
  length) and its bytes; neither side compresses, so a set flag is
  refused with ``UNIMPLEMENTED``;
- a request is ``:method POST``, ``:scheme``, ``:path
  /tpfl.NodeServices/<Route>``, ``:authority`` (``localhost`` on a unix
  socket), ``te: trailers``, ``content-type: application/grpc`` and
  ``grpc-timeout`` (units H / M / S / m / u / n);
- a response is ``:status 200``, one message, then trailers with
  ``grpc-status`` and a percent-encoded ``grpc-message``; an error is a
  trailers-only response;
- an unknown path answers ``UNIMPLEMENTED`` (12), a message over
  ``MAX_MESSAGE_SIZE`` ``RESOURCE_EXHAUSTED`` (8), a call past its
  deadline ``DEADLINE_EXCEEDED`` (4); a client whose deadline expires
  resets the stream with ``CANCEL``.

The same as the reference: the four handlers' bodies, replies and error
handling; the client hooks (``_dial`` waits for the connection to be
ready, re-trying a refused connect, for ``max(GRPC_TIMEOUT * 4, 2.0)`` s
and then raises :class:`~tpfl_torch.exceptions.ConnectionTimeoutError`);
the SendStream timeout ``GRPC_TIMEOUT * (1 + 0.25 * n_chunks)``; the
``tpfl_wire_bytes_total`` / ``tpfl_wire_chunks_total`` counters; mutual
TLS under ``USE_SSL`` (ALPN ``h2``, the peer checked against ``CA_CRT``,
client certificates required); IPv4, ``[ipv6]:port``, a random port and
``unix:`` addresses; handler threads named ``grpc-<addr>_<i>``, at most
``GRPC_SERVER_WORKERS``. A channel whose connection has ended dials again
once on its next call, as a gRPC channel reconnects.

:class:`Channel` and :class:`GrpcServer` are the generic client and
server (any path, call metadata); :class:`GrpcCommunicationProtocol`
binds them to the four routes.
"""

from __future__ import annotations

import queue
import socket
import ssl
import struct
import threading
import time
import urllib.parse
from collections import deque
from typing import Any, Callable, Iterable, Iterator, Optional

from tpfl_torch.communication import http2
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

SERVICE = "tpfl.NodeServices"

# gRPC status codes.
STATUS_NAMES = ("OK", "CANCELLED", "UNKNOWN", "INVALID_ARGUMENT", "DEADLINE_EXCEEDED",
                "NOT_FOUND", "ALREADY_EXISTS", "PERMISSION_DENIED", "RESOURCE_EXHAUSTED",
                "FAILED_PRECONDITION", "ABORTED", "OUT_OF_RANGE", "UNIMPLEMENTED", "INTERNAL",
                "UNAVAILABLE", "DATA_LOSS", "UNAUTHENTICATED")
OK, CANCELLED, UNKNOWN, DEADLINE_EXCEEDED = 0, 1, 2, 4
PERMISSION_DENIED, RESOURCE_EXHAUSTED, UNIMPLEMENTED = 7, 8, 12
INTERNAL, UNAVAILABLE, UNAUTHENTICATED = 13, 14, 16
# A response's HTTP status, when it is not 200, as a gRPC status.
_HTTP_STATUS = {"400": INTERNAL, "401": UNAUTHENTICATED, "403": PERMISSION_DENIED,
                "404": UNIMPLEMENTED, "429": UNAVAILABLE, "502": UNAVAILABLE,
                "503": UNAVAILABLE, "504": UNAVAILABLE}
_PREFIX = struct.Struct(">BI")
_TIMEOUT_UNITS = {"H": 3600.0, "M": 60.0, "S": 1.0, "m": 1e-3, "u": 1e-6, "n": 1e-9}


class RpcError(CommunicationError):
    """A call that ended with a gRPC status other than OK."""

    def __init__(self, code: int, details: str = "") -> None:
        super().__init__(f"{STATUS_NAMES[code]}: {details}")
        self._code = code
        self._details = details

    def code(self) -> int:
        return self._code

    def details(self) -> str:
        return self._details


def frame_message(body: bytes) -> bytes:
    """One gRPC message: the uncompressed flag, the length, the bytes."""
    return _PREFIX.pack(0, len(body)) + body


def encode_timeout(seconds: float) -> str:
    """``grpc-timeout``: at most 8 digits in the finest unit that fits,
    rounded up."""
    ns = max(1, round(seconds * 1e9))
    for unit in "numSMH":
        value = -(-ns // round(_TIMEOUT_UNITS[unit] * 1e9))
        if value < 10 ** 8:
            return f"{value}{unit}"
    return "99999999H"


def parse_timeout(value: str) -> float:
    if not 2 <= len(value) <= 9 or not value[:-1].isdigit() or value[-1] not in _TIMEOUT_UNITS:
        raise ValueError(f"bad grpc-timeout {value!r}")
    return int(value[:-1]) * _TIMEOUT_UNITS[value[-1]]


def encode_message(details: str) -> str:
    """``grpc-message``: UTF-8, percent-encoding every byte outside
    0x20-0x7E and ``%``."""
    return "".join(chr(b) if 0x20 <= b <= 0x7E and b != 0x25 else f"%{b:02X}"
                   for b in details.encode("utf-8"))


def decode_message(value: str) -> str:
    return urllib.parse.unquote(value, errors="replace")


class _MessageParser:
    """gRPC messages out of a stream's DATA, refused from their prefix
    alone when compressed or over ``MAX_MESSAGE_SIZE``, and the receive
    window that what it holds leaves the stream."""

    def __init__(self) -> None:
        self.buf = bytearray()
        self.limit = Settings.MAX_MESSAGE_SIZE
        self.held = 0  # bytes (prefixes included) of whole messages not yet taken

    def taken(self, item: bytes) -> None:
        self.held -= _PREFIX.size + len(item)

    def window(self, size: int) -> int:
        """The window to grant the peer: ``size`` less what is buffered,
        but, while whole messages not yet taken hold less than ``size``,
        never less than the rest of the message in progress, so that a
        message larger than the window can arrive."""
        if self.held >= size:
            return 0
        if len(self.buf) < _PREFIX.size:
            rest = _PREFIX.size - len(self.buf)
        else:
            rest = _PREFIX.size + _PREFIX.unpack_from(self.buf)[1] - len(self.buf)
        return max(size - self.held - len(self.buf), rest)

    def feed(self, data: bytes) -> list[bytes]:
        self.buf += data
        out = []
        while len(self.buf) >= _PREFIX.size:
            compressed, n = _PREFIX.unpack_from(self.buf)
            if compressed:
                raise RpcError(UNIMPLEMENTED, "compressed messages are not supported")
            if n > self.limit:
                raise RpcError(RESOURCE_EXHAUSTED, f"message of {n} bytes exceeds "
                               f"MAX_MESSAGE_SIZE ({self.limit})")
            if len(self.buf) < _PREFIX.size + n:
                break
            out.append(bytes(self.buf[_PREFIX.size:_PREFIX.size + n]))
            del self.buf[:_PREFIX.size + n]
            self.held += _PREFIX.size + n
        return out


# --- client ----------------------------------------------------------------------


class _Call:
    """The client side of one call: its response, as the connection's
    reader thread delivers it."""

    def __init__(self, window: int) -> None:
        self.cv = threading.Condition(make_lock("GrpcCall.cv"))
        self.window = window  # the connection's stream window
        self.parser = _MessageParser()
        self.headers: Optional[dict[str, str]] = None
        self.messages: list[bytes] = []
        self.status: Optional[tuple[int, str]] = None

    def _finish(self, code: int, details: str) -> None:
        if self.status is None:
            self.status = (code, details)
            self.cv.notify_all()

    def on_headers(self, fields: list[tuple[str, str]], end_stream: bool) -> None:
        d = dict(fields)
        with self.cv:
            if self.headers is None:
                self.headers = d
                http = d.get(":status", "200")
                if http != "200" and "grpc-status" not in d:
                    self._finish(_HTTP_STATUS.get(http, UNKNOWN), f"HTTP status {http}")
            if "grpc-status" in d:
                try:
                    code = int(d["grpc-status"])
                except ValueError:
                    code = UNKNOWN
                self._finish(code if 0 <= code < len(STATUS_NAMES) else UNKNOWN,
                             decode_message(d.get("grpc-message", "")))
            elif end_stream:
                self._finish(INTERNAL, "response ended without a grpc-status")

    def on_data(self, data: bytes, end_stream: bool) -> Optional[int]:
        with self.cv:
            try:
                self.messages += self.parser.feed(data)
            except RpcError as e:
                self._finish(e.code(), e.details())
            if end_stream:
                self._finish(INTERNAL, "response ended without trailers")
            # The response is taken whole at the end: a peer that sends
            # more than the window in whole messages waits.
            return self.parser.window(self.window)

    def on_reset(self, code: int) -> None:
        with self.cv:
            self._finish(CANCELLED if code == http2.CANCEL else
                         UNAVAILABLE if code == http2.REFUSED_STREAM else INTERNAL,
                         f"stream reset by the peer (HTTP/2 error {code})")

    def on_closed(self) -> None:
        with self.cv:
            self._finish(UNAVAILABLE, "connection closed")

    def wait(self, deadline: float) -> bool:
        with self.cv:
            while self.status is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self.cv.wait(left)
            return True

    def result(self) -> bytes:
        code, details = self.status
        if code != OK:
            raise RpcError(code, details)
        if len(self.messages) != 1:
            raise RpcError(INTERNAL, f"expected one response message, got {len(self.messages)}")
        return self.messages[0]


class Channel:
    """A client connection to one peer; every call is a stream of one
    HTTP/2 connection. ``owner`` names the connection's threads."""

    def __init__(self, addr: str, owner: str) -> None:
        self.addr = addr
        self.owner = owner
        family, self._where, self._server_name = endpoint(addr)
        self._family = family
        self.authority = "localhost" if family == socket.AF_UNIX else AddressParser(addr).address
        self.scheme = "https" if Settings.USE_SSL else "http"
        self._lock = make_lock("GrpcChannel._lock")
        self._closed = False
        wait = dial_timeout()
        deadline = time.monotonic() + wait
        delay = 0.05
        while True:  # grpc.channel_ready_future: wait for READY
            try:
                self.conn = self._connect(deadline)
                return
            except (OSError, ssl.SSLError, TimeoutError) as e:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise ConnectionTimeoutError(
                        f"Channel to {addr} not ready within {wait:.1f}s ({e})") from e
                time.sleep(min(delay, left))
                delay = min(2 * delay, 1.0)

    def _connect(self, deadline: float) -> http2.Connection:
        sock = socket.socket(self._family, socket.SOCK_STREAM)
        try:
            sock.settimeout(max(1e-3, deadline - time.monotonic()))
            sock.connect(self._where)
            if self._family != socket.AF_UNIX:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            pipe: http2.Pipe = http2.Pipe(sock)
            if Settings.USE_SSL:
                pipe = http2.TlsPipe(sock, client_context(["h2"]), False, self._server_name)
                pipe.handshake()
            sock.settimeout(None)
        except BaseException:
            sock.close()
            raise
        conn = http2.Connection(f"grpc-{self.owner}", True, sock, setup=lambda _: pipe)
        if not conn.ready.wait(max(0.0, deadline - time.monotonic())) or conn.ended.is_set():
            conn.close()
            raise TimeoutError(f"no HTTP/2 SETTINGS from {self.addr}"
                               + (f" ({conn.error})" if conn.error else ""))
        return conn

    def _live(self) -> http2.Connection:
        with self._lock:
            if self._closed:
                raise RpcError(UNAVAILABLE, f"channel to {self.addr} is closed")
            if not self.conn.usable:
                old = self.conn
                try:
                    self.conn = self._connect(time.monotonic() + dial_timeout())
                except (OSError, ssl.SSLError, TimeoutError) as e:
                    raise RpcError(UNAVAILABLE, f"cannot reach {self.addr}: {e}") from e
                finally:
                    old.close()
            return self.conn

    def _call(self, method: str, bodies: Iterable[bytes], streaming: bool,
              timeout: float) -> bytes:
        deadline = time.monotonic() + timeout
        conn = self._live()
        call = _Call(conn.local_window)
        fields = [(":method", "POST"), (":scheme", self.scheme), (":path", method),
                  (":authority", self.authority), ("te", "trailers"),
                  ("content-type", "application/grpc"),
                  ("grpc-timeout", encode_timeout(timeout))]
        try:
            stream = conn.open_stream(call, fields, deadline)
        except http2.ConnectionClosed as e:
            raise RpcError(UNAVAILABLE, str(e)) from e
        except TimeoutError as e:
            raise RpcError(DEADLINE_EXCEEDED, str(e)) from e
        try:
            for body in bodies:
                if len(body) > Settings.MAX_MESSAGE_SIZE:
                    conn.reset(stream, http2.CANCEL)
                    raise RpcError(RESOURCE_EXHAUSTED, f"message of {len(body)} bytes exceeds "
                                   f"MAX_MESSAGE_SIZE ({Settings.MAX_MESSAGE_SIZE})")
                if call.status is not None:
                    break  # answered before the request ended
                conn.send_data(stream, frame_message(body), not streaming, deadline)
            else:
                if streaming:
                    conn.send_data(stream, b"", True, deadline)
        except (http2.StreamReset, http2.ConnectionClosed):
            pass  # the call's status says why
        except TimeoutError:
            pass  # the wait below resets the stream
        done = call.wait(deadline)
        if not stream.local_closed:  # timed out, or answered before the request ended
            conn.reset(stream, http2.CANCEL)
        if not done:
            raise RpcError(DEADLINE_EXCEEDED, f"Deadline Exceeded ({timeout:.1f}s)")
        return call.result()

    def unary(self, method: str, body: bytes, timeout: float) -> bytes:
        return self._call(method, [body], False, timeout)

    def stream_unary(self, method: str, bodies: Iterable[bytes], timeout: float) -> bytes:
        return self._call(method, bodies, True, timeout)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            conn = self.conn
        conn.close()


# --- server ----------------------------------------------------------------------


class _Abort(Exception):
    def __init__(self, code: int, details: str) -> None:
        super().__init__(details)
        self.code = code
        self.details = details


class ServerCall:
    """The server side of one call: its request messages as they arrive,
    its metadata and deadline (the handler's ``context``)."""

    def __init__(self, conn: http2.Connection, stream: http2.Stream,
                 fields: list[tuple[str, str]], end_stream: bool) -> None:
        self.conn = conn
        self.stream = stream
        self.cv = threading.Condition(make_lock("GrpcServerCall.cv"))
        self.parser = _MessageParser()
        self.items: deque[bytes] = deque()
        self.ended = end_stream
        self.abort: Optional[tuple[int, str]] = None
        self.responded = False
        self.headers = dict(fields)
        self.metadata = [(k, v) for k, v in fields if not k.startswith(":")]
        self.deadline: Optional[float] = None
        if "grpc-timeout" in self.headers:
            self.deadline = time.monotonic() + parse_timeout(self.headers["grpc-timeout"])

    def invocation_metadata(self) -> list[tuple[str, str]]:
        return list(self.metadata)

    def expired(self) -> bool:
        return self.deadline is not None and time.monotonic() >= self.deadline

    # --- stream events (reader thread) ---

    def on_headers(self, fields: list[tuple[str, str]], end_stream: bool) -> None:
        if end_stream:
            with self.cv:
                self.ended = True
                self.cv.notify_all()

    def on_data(self, data: bytes, end_stream: bool) -> Optional[int]:
        with self.cv:
            try:
                self.items.extend(self.parser.feed(data))
            except RpcError as e:
                self.abort = (e.code(), e.details())
            self.ended |= end_stream
            self.cv.notify_all()
            refused = self.abort
            window = self.parser.window(self.conn.local_window)
        if refused is not None:
            self.respond(*refused)
            return None
        return window

    def on_reset(self, code: int) -> None:
        with self.cv:
            self.abort = self.abort or (CANCELLED, f"stream reset (HTTP/2 error {code})")
            self.cv.notify_all()

    def on_closed(self) -> None:
        self.on_reset(http2.CANCEL)

    # --- handler side ---

    def messages(self) -> Iterator[bytes]:
        """The request messages, until the client half-closes; raises
        :class:`_Abort` on a reset, a refused message or the deadline."""
        while True:
            with self.cv:
                while not self.items and not self.ended and self.abort is None:
                    left = None if self.deadline is None else self.deadline - time.monotonic()
                    if left is not None and left <= 0:
                        self.abort = (DEADLINE_EXCEEDED, "Deadline Exceeded")
                        break
                    self.cv.wait(left)
                if self.abort is not None:
                    raise _Abort(*self.abort)
                if not self.items:
                    if self.parser.buf:
                        raise _Abort(INTERNAL, "request ended inside a message")
                    return
                item = self.items.popleft()
                self.parser.taken(item)
                window = self.parser.window(self.conn.local_window)
            self.conn.grant(self.stream, window)
            yield item

    def respond(self, code: int, details: str = "", body: bytes = b"") -> None:
        """Send the response once: the message and OK trailers, or a
        trailers-only error. Then, if the client is still sending, reset
        the stream with NO_ERROR so that it stops."""
        with self.cv:
            if self.responded:
                return
            self.responded = True
        head = [(":status", "200"), ("content-type", "application/grpc")]
        deadline = self.deadline if self.deadline is not None else \
            time.monotonic() + dial_timeout()
        try:
            if code == OK:
                self.conn.send_headers(self.stream, head)
                self.conn.send_data(self.stream, frame_message(body), False, deadline)
                self.conn.send_headers(self.stream, [("grpc-status", "0")], end_stream=True)
            else:
                fields = head + [("grpc-status", str(code))]
                if details:
                    fields.append(("grpc-message", encode_message(details)))
                self.conn.send_headers(self.stream, fields, end_stream=True)
            if not self.stream.remote_closed:
                self.conn.reset(self.stream, http2.NO_ERROR)
        except (http2.StreamReset, http2.ConnectionClosed, TimeoutError):
            pass  # the client is gone or gave up


class _Workers:
    """At most ``size`` handler threads, started as calls wait, named
    ``<name>_<i>`` as a ``ThreadPoolExecutor``'s are."""

    def __init__(self, name: str, size: int) -> None:
        self.name = name
        self.size = max(1, size)
        self.q: "queue.SimpleQueue[Optional[tuple]]" = queue.SimpleQueue()
        self.threads: list[threading.Thread] = []  # guarded-by: _lock
        self.idle = 0  # guarded-by: _lock
        self.pending = 0  # guarded-by: _lock
        self._lock = make_lock("GrpcWorkers._lock")

    def submit(self, fn: Callable[..., None], *args: Any) -> None:
        with self._lock:
            self.pending += 1
            if self.pending > self.idle and len(self.threads) < self.size:
                t = threading.Thread(target=self._work, name=f"{self.name}_{len(self.threads)}",
                                     daemon=True)
                self.threads.append(t)
                t.start()
        self.q.put((fn, args))

    def _work(self) -> None:
        while True:
            with self._lock:
                self.idle += 1
            item = self.q.get()
            with self._lock:
                self.idle -= 1
                self.pending -= item is not None
            if item is None:
                return
            fn, args = item
            fn(*args)

    def stop(self, deadline: float) -> None:
        with self._lock:
            threads = list(self.threads)
        for _ in threads:
            self.q.put(None)
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))


class GrpcServer:
    """The receiving side: a listening socket, an accept thread, one
    :class:`~tpfl_torch.communication.http2.Connection` for each client
    and a handler pool. ``handlers`` maps a full path
    (``/service/Method``) to ``(streaming, fn)``; ``fn(request, call)``
    gets the request bytes (or, streaming, an iterator of them) and the
    :class:`ServerCall`, and returns the response bytes."""

    def __init__(self, addr: str, handlers: dict[str, tuple[bool, Callable[..., bytes]]]) -> None:
        self.addr = addr
        self.name = f"grpc-{addr}"
        self.handlers = handlers
        self.tls = server_context(["h2"]) if Settings.USE_SSL else None
        family, where, _ = endpoint(addr)
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
            raise CommunicationError(f"Cannot bind {addr}: {e}") from e
        self.listener.settimeout(1.0)
        self.pool = _Workers(self.name, Settings.GRPC_SERVER_WORKERS)
        self.conns: set[http2.Connection] = set()  # guarded-by: _lock
        self._lock = make_lock("GrpcServer._lock")
        self.stopping = threading.Event()
        self.loop = threading.Thread(target=self._accept_loop, name=f"{self.name}-accept",
                                     daemon=True)
        self.loop.start()

    def _accept_loop(self) -> None:
        while not self.stopping.is_set():
            try:
                sock, _ = self.listener.accept()
            except socket.timeout:
                continue
            except OSError:
                if self.stopping.is_set():
                    return
                time.sleep(0.05)
                continue
            if self.stopping.is_set():  # the wake-up dial of stop()
                sock.close()
                return
            sock.settimeout(None)
            if sock.family != socket.AF_UNIX:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = http2.Connection(self.name, False, sock, setup=self._setup,
                                    on_request=self._on_request, on_close=self._forget)
            with self._lock:
                if not conn.ended.is_set():
                    self.conns.add(conn)

    def _setup(self, sock: socket.socket) -> http2.Pipe:
        if self.tls is None:
            return http2.Pipe(sock)
        sock.settimeout(dial_timeout())
        pipe = http2.TlsPipe(sock, self.tls, True)
        pipe.handshake()  # raises on a client without a CA-signed certificate
        sock.settimeout(None)
        return pipe

    def _forget(self, conn: http2.Connection) -> None:
        with self._lock:
            self.conns.discard(conn)

    def _on_request(self, conn: http2.Connection, stream: http2.Stream,
                    fields: list[tuple[str, str]], end_stream: bool) -> ServerCall:
        try:
            call = ServerCall(conn, stream, fields, end_stream)
        except ValueError as e:  # a malformed grpc-timeout
            call = ServerCall(conn, stream, [f for f in fields if f[0] != "grpc-timeout"],
                              end_stream)
            call.respond(INTERNAL, str(e))
            return call
        head = call.headers
        entry = self.handlers.get(head.get(":path", ""))
        if head.get(":method") != "POST" or \
                not head.get("content-type", "").startswith("application/grpc"):
            call.respond(INTERNAL, "not a gRPC request")
        elif entry is None:
            call.respond(UNIMPLEMENTED, f"Method not found: {head.get(':path')}")
        elif self.stopping.is_set():
            call.respond(UNAVAILABLE, "server is stopping")
        else:
            self.pool.submit(self._serve, call, *entry)
        return call

    @staticmethod
    def _serve(call: ServerCall, streaming: bool, fn: Callable[..., bytes]) -> None:
        try:
            if streaming:
                reply = fn(call.messages(), call)
            else:
                requests = list(call.messages())
                if len(requests) != 1:
                    call.respond(UNIMPLEMENTED if requests else INTERNAL,
                                 f"expected one request message, got {len(requests)}")
                    return
                reply = fn(requests[0], call)
        except _Abort as e:
            call.respond(e.code, e.details)
            return
        except Exception as e:  # a failing handler must not kill its worker
            call.respond(UNKNOWN, f"Exception calling application: {e}")
            return
        if call.abort is not None:  # the handler swallowed a reset or refusal
            call.respond(*call.abort)
        elif call.expired():
            call.respond(DEADLINE_EXCEEDED, "Deadline Exceeded")
        else:
            call.respond(OK, body=reply)

    def stop(self, timeout: float = 5.0) -> None:
        """GOAWAY to every client and join every thread within ``timeout``."""
        deadline = time.monotonic() + timeout
        self.stopping.set()
        family, where, _ = endpoint(self.addr)
        try:  # wakes accept() at once
            with socket.socket(family, socket.SOCK_STREAM) as wake:
                wake.settimeout(1.0)
                wake.connect(where)
        except OSError:
            pass
        self.loop.join(max(0.0, deadline - time.monotonic()))
        self.listener.close()
        with self._lock:
            conns, self.conns = list(self.conns), set()
        for conn in conns:
            conn.close(timeout=max(0.0, deadline - time.monotonic()))
        self.pool.stop(deadline)
        if self.unix_path is not None:
            unlink_socket(self.unix_path)


# --- the protocol ------------------------------------------------------------------


def _path(route: str) -> str:
    return f"/{SERVICE}/{route}"


class GrpcCommunicationProtocol(ThreadedCommunicationProtocol):
    """Real-network transport (mTLS-capable) over the reference's gRPC
    wire."""

    def __init__(self, addr: Optional[str] = None) -> None:
        super().__init__(AddressParser(addr).address)
        self._server: Optional[GrpcServer] = None

    # --- server side ---

    def _server_start(self) -> None:
        self._server = GrpcServer(self._addr, {
            _path("Handshake"): (False, self._rpc_handshake),
            _path("Disconnect"): (False, self._rpc_disconnect),
            _path("Send"): (False, self._rpc_send),
            # Chunked weight transfers: one multi-MB unary message would
            # hold the connection's windows until it is through, and
            # heartbeats and votes would queue behind it. As a client
            # stream of WIRE_CHUNK_SIZE frames, other calls interleave
            # between chunks, and each chunk's CRC is checked.
            _path("SendStream"): (True, self._rpc_send_stream),
        })

    def _server_stop(self) -> None:
        if self._server is not None:
            self._server.stop()
            self._server = None

    # The RPC handlers (the reference's).

    def _rpc_handshake(self, request: bytes, context: Any) -> bytes:
        peer = _msgpack.unpackb(request)["addr"]
        # Register the caller WITHOUT dialing back: a reverse handshake
        # here would recurse; the send path dials lazily.
        self._neighbors.add(peer, non_direct=False, dial=False)
        return _msgpack.packb({"ok": True})

    def _rpc_disconnect(self, request: bytes, context: Any) -> bytes:
        peer = _msgpack.unpackb(request)["addr"]
        self._neighbors.remove(peer, disconnect_msg=False)
        return _msgpack.packb({"ok": True})

    def _rpc_send(self, request: bytes, context: Any) -> bytes:
        try:
            self.handle_message(Message.from_bytes(request))
            return _msgpack.packb({"ok": True})
        except Exception as e:  # handler errors must not kill the server
            logger.error(self._addr, f"RPC send failed: {e}")
            return _msgpack.packb({"ok": False, "error": str(e)})

    def _rpc_send_stream(self, request_iterator: Iterator[bytes], context: Any) -> bytes:
        try:
            self.handle_message(Message.from_bytes(reassemble_frames(request_iterator)))
            return _msgpack.packb({"ok": True})
        except ChunkIntegrityError as e:
            # Corrupt / truncated stream: dropped whole, the sender's
            # gossip loop re-pushes; a partial reassembly never reaches
            # the decoder.
            logger.error(self._addr, f"RPC stream rejected: {e}")
            return _msgpack.packb({"ok": False, "error": str(e)})
        except Exception as e:
            logger.error(self._addr, f"RPC stream failed: {e}")
            return _msgpack.packb({"ok": False, "error": str(e)})

    # --- client side ---

    def _dial(self, addr: str) -> Channel:
        return Channel(addr, self._addr)

    def _handshake(self, addr: str, conn: Channel) -> None:
        resp = conn.unary(_path("Handshake"), _msgpack.packb({"addr": self._addr}),
                          Settings.GRPC_TIMEOUT)
        if not _msgpack.unpackb(resp).get("ok"):
            raise CommunicationError(f"Handshake with {addr} refused")

    def _transport_send(self, addr: str, conn: Channel, msg: Message) -> None:
        data = msg.to_bytes()
        chunk = Settings.WIRE_CHUNK_SIZE
        logger.metrics.counter("tpfl_wire_bytes_total", float(len(data)),
                               labels={"node": self._addr})
        try:
            if chunk and len(data) > chunk:
                n_chunks = -(-len(data) // chunk)
                logger.metrics.counter("tpfl_wire_chunks_total", float(n_chunks),
                                       labels={"node": self._addr})
                # The timeout scales with the transfer: GRPC_TIMEOUT is
                # tuned for control messages, not a multi-MB model.
                resp = conn.stream_unary(_path("SendStream"), chunk_frames(data, chunk),
                                         Settings.GRPC_TIMEOUT * (1 + 0.25 * n_chunks))
            else:
                resp = conn.unary(_path("Send"), data, Settings.GRPC_TIMEOUT)
        except RpcError as e:
            if e.code() == DEADLINE_EXCEEDED:
                raise ConnectionTimeoutError(f"RPC to {addr} exceeded its deadline") from e
            raise
        out = _msgpack.unpackb(resp)
        if not out.get("ok"):
            raise CommunicationError(out.get("error", "unknown send error"))

    def _transport_send_corrupted(self, addr: str, conn: Channel, msg: Message) -> None:
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
        resp = conn.stream_unary(_path("SendStream"), frames,
                                 Settings.GRPC_TIMEOUT * (1 + 0.25 * len(frames)))
        out = _msgpack.unpackb(resp)
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
            conn.unary(_path("Disconnect"), _msgpack.packb({"addr": self._addr}),
                       Settings.GRPC_TIMEOUT)
        except Exception:
            pass
        finally:
            if ephemeral:
                self._close_conn(conn)
