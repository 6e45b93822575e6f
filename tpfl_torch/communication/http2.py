"""HTTP/2 (RFC 9113) in the standard library: one connection object that
both ends of the gRPC wire use (:mod:`tpfl_torch.communication.grpc_transport`).

- **Frames.** The 9-byte header and every frame type: DATA and HEADERS
  with padding (and HEADERS' PRIORITY fields), CONTINUATION, PRIORITY,
  RST_STREAM, SETTINGS and PING with their ACKs, GOAWAY and
  WINDOW_UPDATE. PUSH_PROMISE is a connection error, since this side
  sends ``SETTINGS_ENABLE_PUSH 0``; unknown frame types and settings are
  ignored.
- **Threads.** One reader thread per connection takes every frame off
  the socket and hands it to its stream; it answers PING and SETTINGS at
  once and never blocks on a write. One writer thread per connection
  sends the queued frames: control frames (ACKs, WINDOW_UPDATE) first,
  then the others in order. Writes are serialized by frame, not by
  message, and at most :data:`OUT_CAP` bytes wait in the queue, so a
  small call on one stream goes out between the frames of a large one.
  Both threads are named ``grpc-<addr>-...`` after their owner.
- **Flow control**, per stream and per connection. Sends honour the
  peer's windows and ``SETTINGS_MAX_FRAME_SIZE``; a change of the peer's
  ``SETTINGS_INITIAL_WINDOW_SIZE`` moves every open stream's window,
  which may go negative. This side gives each stream a window of
  :data:`STREAM_WINDOW` and grants it back as its user takes the data
  (``on_data`` returns the window it wants, :meth:`Connection.grant`
  raises it later), so a sender that outruns a slow handler waits; a
  stream that overruns its window is reset with ``FLOW_CONTROL_ERROR``.
  The connection's window is the largest HTTP/2 allows (2^31 - 1),
  topped up as data arrives, so a stream that waits for its handler
  never stalls the others.
- **TLS** runs through ``ssl.SSLObject`` over memory BIOs, with one lock
  around the TLS state: the reader and the writer thread share no
  ``SSLSocket``, which OpenSSL does not allow.
- **GOAWAY** on close.

Stream events reach a handler object of the caller's (``on_headers``,
``on_data``, ``on_reset``, ``on_closed``) in the reader thread; those
methods only record and must not block. ``on_data`` returns the receive
window the stream should have now, or None to leave it.
"""

from __future__ import annotations

import itertools
import socket
import ssl
import struct
import threading
import time
from collections import deque
from typing import Any, Callable, Iterable, Optional

from tpfl_torch.communication import hpack
from tpfl_torch.concurrency import make_lock

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

# Frame types (RFC 9113 section 6).
DATA, HEADERS, PRIORITY, RST_STREAM, SETTINGS, PUSH_PROMISE, PING, GOAWAY, \
    WINDOW_UPDATE, CONTINUATION = range(10)
# Flags.
END_STREAM = ACK = 0x1
END_HEADERS = 0x4
PADDED = 0x8
PRIORITY_FLAG = 0x20
# Settings (section 6.5.2).
HEADER_TABLE_SIZE, ENABLE_PUSH, MAX_CONCURRENT_STREAMS, INITIAL_WINDOW_SIZE, \
    MAX_FRAME_SIZE, MAX_HEADER_LIST_SIZE = range(1, 7)
# Error codes (section 7).
NO_ERROR, PROTOCOL_ERROR, INTERNAL_ERROR, FLOW_CONTROL_ERROR, SETTINGS_TIMEOUT, \
    STREAM_CLOSED, FRAME_SIZE_ERROR, REFUSED_STREAM, CANCEL, COMPRESSION_ERROR = range(10)

MAX_WINDOW = 2 ** 31 - 1
DEFAULT_WINDOW = 65_535
# The receive window of each stream (SETTINGS_INITIAL_WINDOW_SIZE): the
# bytes a peer may send ahead of what the stream's user has taken.
STREAM_WINDOW = 8 << 20
DEFAULT_MAX_FRAME = 16_384
# The largest frame this side accepts (advertised in SETTINGS).
LOCAL_MAX_FRAME = 1 << 20
# Bytes of DATA / HEADERS frames that may wait in a connection's queue.
OUT_CAP = 1 << 20
_RECV_CHUNK = 1 << 18

_HEAD = struct.Struct(">HBBBI")
_ids = itertools.count()


class ConnectionClosed(ConnectionError):
    """The connection is gone (closed, GOAWAY'd or broken)."""


class StreamReset(ConnectionError):
    """The stream was reset by either side."""

    def __init__(self, code: int) -> None:
        super().__init__(f"stream reset (HTTP/2 error {code})")
        self.code = code


class _ProtocolError(Exception):
    def __init__(self, code: int, why: str) -> None:
        super().__init__(why)
        self.code = code


def frame(ftype: int, flags: int, sid: int, payload: bytes = b"") -> bytes:
    n = len(payload)
    return _HEAD.pack(n >> 8, n & 0xFF, ftype, flags, sid & MAX_WINDOW) + payload


def _settings_payload(values: dict[int, int]) -> bytes:
    return b"".join(struct.pack(">HI", k, v) for k, v in values.items())


# --- the byte pipe -------------------------------------------------------------


class Pipe:
    """A connected socket: ``sendall`` from the writer thread, ``recv``
    from the reader thread."""

    def __init__(self, sock: socket.socket) -> None:
        self.sock = sock

    def sendall(self, data: bytes) -> None:
        self.sock.sendall(data)

    def recv(self, n: int) -> bytes:
        return self.sock.recv(n)


def _shutdown(sock: socket.socket) -> None:
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass


class TlsPipe(Pipe):
    """TLS over a connected socket through ``SSLObject`` and memory BIOs.
    ``_tls`` guards the TLS state; ``_send`` keeps the records in the
    order they were made on their way to the socket."""

    def __init__(self, sock: socket.socket, ctx: ssl.SSLContext, server_side: bool,
                 server_hostname: Optional[str] = None) -> None:
        super().__init__(sock)
        self._in, self._out = ssl.MemoryBIO(), ssl.MemoryBIO()
        self.obj = ctx.wrap_bio(self._in, self._out, server_side=server_side,
                                server_hostname=server_hostname)
        self._tls = make_lock("TlsPipe._tls")
        self._send = make_lock("TlsPipe._send")

    def handshake(self) -> None:
        """Run the TLS handshake on the blocking socket (its timeout
        bounds each read); raises ``ssl.SSLError`` on a refused peer."""
        while True:
            try:
                with self._tls:
                    self.obj.do_handshake()
                break
            except ssl.SSLWantReadError:
                self._flush()
            except ssl.SSLError:
                self._flush()  # the alert, so that the peer learns why
                raise
            data = self.sock.recv(_RECV_CHUNK)
            if not data:
                raise ConnectionClosed("closed during the TLS handshake")
            with self._tls:
                self._in.write(data)
        self._flush()
        if self.obj.selected_alpn_protocol() != "h2":
            raise ssl.SSLError(f"ALPN chose {self.obj.selected_alpn_protocol()!r}, not h2")

    def _flush(self) -> None:
        with self._send:
            with self._tls:
                data = self._out.read()
            if data:
                self.sock.sendall(data)

    def sendall(self, data: bytes) -> None:
        view = memoryview(data)
        with self._send:
            with self._tls:
                while view:
                    view = view[self.obj.write(view):]
                out = self._out.read()
            self.sock.sendall(out)

    def recv(self, n: int) -> bytes:
        while True:
            with self._tls:
                try:
                    data: Optional[bytes] = self.obj.read(n)
                except ssl.SSLWantReadError:
                    data = None
                except ssl.SSLZeroReturnError:
                    data = b""
                pending = self._out.pending
            if pending:  # a record the read made (a key update, an alert)
                self._flush()
            if data is not None:
                return data
            raw = self.sock.recv(_RECV_CHUNK)
            if not raw:
                return b""
            with self._tls:
                self._in.write(raw)


# --- streams and the connection ------------------------------------------------


class Stream:
    """One HTTP/2 stream: its id, windows and handler. Its fields are
    guarded by the connection's condition."""

    __slots__ = ("sid", "handler", "send_window", "recv_window", "local_closed",
                 "remote_closed", "reset")

    def __init__(self, sid: int, handler: Any, send_window: int, recv_window: int) -> None:
        self.sid = sid
        self.handler = handler
        self.send_window = send_window
        self.recv_window = recv_window  # what the peer may still send
        self.local_closed = False
        self.remote_closed = False
        self.reset: Optional[int] = None


class Connection:
    """An HTTP/2 connection over a connected socket.

    ``client``: this side opens odd streams and sends the preface.
    ``on_request(conn, stream, fields, end_stream)`` (server side) is
    called in the reader thread for each new stream and returns its
    handler. ``setup(sock)`` runs first in the reader thread (the
    server's TLS handshake) and returns the pipe (by default the plain
    socket); ``on_close(conn)`` runs once when the connection ends."""

    def __init__(self, name: str, client: bool, sock: socket.socket,
                 setup: Optional[Callable[[socket.socket], Pipe]] = None,
                 on_request: Optional[Callable[..., Any]] = None,
                 on_close: Optional[Callable[["Connection"], None]] = None) -> None:
        self.name = name
        self.client = client
        self.sock = sock
        self._setup = setup or Pipe
        self._on_request = on_request
        self._on_close = on_close
        self.pipe: Optional[Pipe] = None
        self.local_window = STREAM_WINDOW
        self._cv = threading.Condition(make_lock("Http2Connection._cv"))
        # --- guarded by _cv ---
        self._streams: dict[int, Stream] = {}
        self._next_sid = 1 if client else 2
        self._last_peer_sid = 0
        self._send_window = DEFAULT_WINDOW
        self._peer_initial_window = DEFAULT_WINDOW
        self._peer_max_frame = DEFAULT_MAX_FRAME
        self._peer_max_streams = MAX_WINDOW
        self._peer_table_size = 4096
        self._ctrl: deque[bytes] = deque()
        self._out: deque[bytes] = deque()
        self._out_bytes = 0
        self._recv_unacked = 0
        self._closing = False
        self._goaway = False
        self.error: Optional[BaseException] = None
        # --- reader thread only ---
        self._decoder = hpack.Decoder()
        self._buf = bytearray()
        self._pos = 0
        self._encoder = hpack.Encoder()  # used under _cv
        self.ready = threading.Event()  # the peer's first SETTINGS arrived
        self.ended = threading.Event()
        k = next(_ids)
        self._reader = threading.Thread(target=self._read_loop, name=f"{name}-read-{k}",
                                        daemon=True)
        self._writer = threading.Thread(target=self._write_loop, name=f"{name}-write-{k}",
                                        daemon=True)
        self._reader.start()

    # --- sending ---

    def _enqueue(self, data: bytes, control: bool = False) -> None:
        """Queue frames (caller holds ``_cv``)."""
        if control:
            self._ctrl.append(data)
        else:
            self._out.append(data)
            self._out_bytes += len(data)
        self._cv.notify_all()

    @property
    def usable(self) -> bool:
        """Neither closed nor told by the peer to go away."""
        return not (self._closing or self._goaway or self.ended.is_set())

    def _check(self, stream: Stream) -> None:
        if stream.reset is not None:
            raise StreamReset(stream.reset)
        if self._closing:
            raise ConnectionClosed(f"{self.name}: connection closed") from self.error

    def _header_frames(self, sid: int, fields: Iterable[tuple[str, str]],
                       end_stream: bool) -> bytes:
        block = self._encoder.encode((n.encode(), v.encode()) for n, v in fields)
        size = self._peer_max_frame
        pieces = [block[i:i + size] for i in range(0, len(block), size)] or [b""]
        out = []
        for i, piece in enumerate(pieces):
            flags = END_HEADERS if i == len(pieces) - 1 else 0
            if i == 0:
                out.append(frame(HEADERS, flags | (END_STREAM if end_stream else 0), sid, piece))
            else:
                out.append(frame(CONTINUATION, flags, sid, piece))
        return b"".join(out)

    def open_stream(self, handler: Any, fields: Iterable[tuple[str, str]],
                    deadline: float) -> Stream:
        """Open a stream with its request headers (client side)."""
        with self._cv:
            while True:
                if self._closing or self._goaway:
                    raise ConnectionClosed(f"{self.name}: connection closed") from self.error
                if len(self._streams) < self._peer_max_streams:
                    break
                if not self._cv.wait(max(0.0, deadline - time.monotonic())):
                    raise TimeoutError("no stream slot before the deadline")
            sid = self._next_sid
            self._next_sid += 2
            stream = Stream(sid, handler, self._peer_initial_window, self.local_window)
            self._streams[sid] = stream
            self._enqueue(self._header_frames(sid, fields, False))
            return stream

    def send_headers(self, stream: Stream, fields: Iterable[tuple[str, str]],
                     end_stream: bool = False) -> None:
        with self._cv:
            self._check(stream)
            self._enqueue(self._header_frames(stream.sid, fields, end_stream))
            if end_stream:
                self._local_end(stream)

    def send_data(self, stream: Stream, data: bytes, end_stream: bool,
                  deadline: Optional[float] = None) -> None:
        """Send ``data`` within the flow-control windows, one frame at a
        time; raises ``TimeoutError`` past ``deadline``."""
        view = memoryview(data)
        while True:
            with self._cv:
                while True:
                    self._check(stream)
                    avail = min(self._send_window, stream.send_window, self._peer_max_frame)
                    if not view or (avail > 0 and self._out_bytes < OUT_CAP):
                        break
                    left = None if deadline is None else deadline - time.monotonic()
                    if left is not None and left <= 0:
                        raise TimeoutError("send window not granted before the deadline")
                    self._cv.wait(left)
                n = min(avail, len(view)) if view else 0
                last = end_stream and n == len(view)
                self._send_window -= n
                stream.send_window -= n
                self._enqueue(frame(DATA, END_STREAM if last else 0, stream.sid, bytes(view[:n])))
                view = view[n:]
                if last:
                    self._local_end(stream)
                if not view:
                    return

    def grant(self, stream: Stream, window: int) -> None:
        """Let the peer have up to ``window`` bytes in flight on
        ``stream``: a WINDOW_UPDATE for the difference, once it is half a
        stream window or the peer's window has run below a quarter."""
        with self._cv:
            if stream.remote_closed or stream.reset is not None or self._closing:
                return
            inc = min(window, MAX_WINDOW) - stream.recv_window
            if inc > 0 and (inc >= self.local_window // 2
                            or stream.recv_window < self.local_window // 4):
                stream.recv_window += inc
                self._enqueue(frame(WINDOW_UPDATE, 0, stream.sid, struct.pack(">I", inc)),
                              control=True)

    def reset(self, stream: Stream, code: int) -> None:
        with self._cv:
            if stream.reset is None and not self._closing and stream.sid in self._streams:
                self._enqueue(frame(RST_STREAM, 0, stream.sid, struct.pack(">I", code)))
            self._drop(stream, code)

    def _local_end(self, stream: Stream) -> None:
        stream.local_closed = True
        if stream.remote_closed:
            self._streams.pop(stream.sid, None)

    def _drop(self, stream: Stream, code: int) -> None:
        if stream.reset is None:
            stream.reset = code
        self._streams.pop(stream.sid, None)
        self._cv.notify_all()

    def _write_loop(self) -> None:
        try:
            while True:
                with self._cv:
                    while not (self._ctrl or self._out or self._closing):
                        self._cv.wait()
                    if not (self._ctrl or self._out):
                        return
                    parts = list(self._ctrl) + list(self._out)
                    self._ctrl.clear()
                    self._out.clear()
                    self._out_bytes = 0
                    self._cv.notify_all()
                self.pipe.sendall(b"".join(parts))
        except OSError as e:
            self._fail(e)

    # --- closing ---

    def close(self, timeout: float = 5.0) -> None:
        """GOAWAY, flush, and end both threads (joined within ``timeout``)."""
        with self._cv:
            if not self._closing:
                if self.pipe is not None:
                    self._enqueue(frame(GOAWAY, 0, 0, struct.pack(">II", self._last_peer_sid,
                                                                  NO_ERROR)))
                self._closing = True
                self._cv.notify_all()
        me = threading.current_thread()
        end = time.monotonic() + timeout
        if self._writer.is_alive() and self._writer is not me:
            self._writer.join(max(0.0, end - time.monotonic()))
        _shutdown(self.sock)
        if self._reader is not me:
            self._reader.join(max(0.0, end - time.monotonic()))

    def _fail(self, error: BaseException) -> None:
        with self._cv:
            if self.error is None:
                self.error = error
            self._closing = True
            self._cv.notify_all()
        _shutdown(self.sock)

    def _finish(self) -> None:
        """Reader thread's exit: fail every stream, close the socket."""
        with self._cv:
            self._closing = True
            streams = list(self._streams.values())
            self._streams.clear()
            for s in streams:
                if s.reset is None:
                    s.reset = CANCEL
            self._cv.notify_all()
        for s in streams:
            s.handler.on_closed()
        if self._writer.is_alive() and self._writer is not threading.current_thread():
            self._writer.join(5.0)
        _shutdown(self.sock)
        try:
            self.sock.close()
        except OSError:
            pass
        self.ready.set()
        self.ended.set()
        if self._on_close is not None:
            self._on_close(self)

    # --- reading ---

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) - self._pos < n:
            if self._pos > _RECV_CHUNK:
                del self._buf[:self._pos]
                self._pos = 0
            chunk = self.pipe.recv(_RECV_CHUNK)
            if not chunk:
                raise ConnectionClosed(f"{self.name}: peer closed the connection")
            self._buf += chunk
        out = bytes(self._buf[self._pos:self._pos + n])
        self._pos += n
        return out

    def _read_loop(self) -> None:
        try:
            self.pipe = self._setup(self.sock)
            with self._cv:
                if self.client:
                    self._ctrl.append(PREFACE)
                self._ctrl.append(frame(SETTINGS, 0, 0, _settings_payload({
                    ENABLE_PUSH: 0, INITIAL_WINDOW_SIZE: self.local_window,
                    MAX_FRAME_SIZE: LOCAL_MAX_FRAME})))
                self._ctrl.append(frame(WINDOW_UPDATE, 0, 0,
                                        struct.pack(">I", MAX_WINDOW - DEFAULT_WINDOW)))
            self._writer.start()
            if not self.client and self._read_exact(len(PREFACE)) != PREFACE:
                raise _ProtocolError(PROTOCOL_ERROR, "bad client preface")
            self._frames()
        except _ProtocolError as e:
            self.error = e
            with self._cv:
                if not self._closing:
                    self._enqueue(frame(GOAWAY, 0, 0, struct.pack(">II", self._last_peer_sid,
                                                                  e.code) + str(e).encode()))
                    self._closing = True
                    self._cv.notify_all()
        except (OSError, ssl.SSLError, ValueError) as e:
            if self.error is None:
                self.error = e
        finally:
            self._finish()

    def _frames(self) -> None:
        block: Optional[bytearray] = None  # a header block awaiting CONTINUATION
        block_sid = block_end = 0
        while True:
            hi, lo, ftype, flags, sid = _HEAD.unpack(self._read_exact(9))
            length, sid = (hi << 8) | lo, sid & MAX_WINDOW
            if length > LOCAL_MAX_FRAME:
                raise _ProtocolError(FRAME_SIZE_ERROR, f"frame of {length} bytes")
            payload = self._read_exact(length)
            if block is not None:
                if ftype != CONTINUATION or sid != block_sid:
                    raise _ProtocolError(PROTOCOL_ERROR, "expected CONTINUATION")
                block += payload
                if flags & END_HEADERS:
                    self._on_headers(block_sid, bytes(block), block_end)
                    block = None
                continue
            if ftype == DATA:
                self._on_data(sid, flags, payload, length)
            elif ftype == HEADERS:
                if sid == 0:
                    raise _ProtocolError(PROTOCOL_ERROR, "HEADERS on stream 0")
                payload = self._unpad(flags, payload)
                if flags & PRIORITY_FLAG:
                    payload = payload[5:]
                if flags & END_HEADERS:
                    self._on_headers(sid, payload, flags & END_STREAM)
                else:
                    block, block_sid, block_end = bytearray(payload), sid, flags & END_STREAM
            elif ftype == CONTINUATION:
                raise _ProtocolError(PROTOCOL_ERROR, "CONTINUATION without HEADERS")
            elif ftype == RST_STREAM:
                self._on_rst(sid, struct.unpack(">I", payload[:4])[0] if len(payload) >= 4
                             else PROTOCOL_ERROR)
            elif ftype == SETTINGS:
                self._on_settings(flags, payload)
            elif ftype == PING:
                if len(payload) != 8:
                    raise _ProtocolError(FRAME_SIZE_ERROR, "PING of the wrong size")
                if not flags & ACK:
                    with self._cv:
                        self._enqueue(frame(PING, ACK, 0, payload), control=True)
            elif ftype == GOAWAY:
                self._on_goaway(payload)
            elif ftype == WINDOW_UPDATE:
                self._on_window_update(sid, payload)
            elif ftype == PUSH_PROMISE:
                raise _ProtocolError(PROTOCOL_ERROR, "PUSH_PROMISE with push disabled")
            # PRIORITY and unknown types are ignored.

    @staticmethod
    def _unpad(flags: int, payload: bytes) -> bytes:
        if not flags & PADDED:
            return payload
        if not payload or payload[0] >= len(payload):
            raise _ProtocolError(PROTOCOL_ERROR, "padding exceeds the frame")
        return payload[1:len(payload) - payload[0]]

    def _on_data(self, sid: int, flags: int, payload: bytes, length: int) -> None:
        if sid == 0:
            raise _ProtocolError(PROTOCOL_ERROR, "DATA on stream 0")
        data = self._unpad(flags, payload)
        with self._cv:
            # The connection's window is topped up on receipt, closed
            # streams included (their bytes count against it too).
            self._recv_unacked += length
            if self._recv_unacked >= MAX_WINDOW // 2:
                self._enqueue(frame(WINDOW_UPDATE, 0, 0, struct.pack(">I", self._recv_unacked)),
                              control=True)
                self._recv_unacked = 0
            stream = self._streams.get(sid)
            if stream is None or stream.remote_closed:
                return
            stream.recv_window -= length
            overrun = stream.recv_window < 0
            if overrun:
                self._enqueue(frame(RST_STREAM, 0, sid, struct.pack(">I", FLOW_CONTROL_ERROR)))
                self._drop(stream, FLOW_CONTROL_ERROR)
            elif flags & END_STREAM:
                stream.remote_closed = True
                if stream.local_closed:
                    self._streams.pop(sid, None)
        if overrun:
            stream.handler.on_reset(FLOW_CONTROL_ERROR)
            return
        window = stream.handler.on_data(data, bool(flags & END_STREAM))
        if window is not None:
            self.grant(stream, window)

    def _on_headers(self, sid: int, block: bytes, end_stream: int) -> None:
        try:
            fields = self._decoder.decode(block)
        except hpack.HPACKError as e:
            raise _ProtocolError(COMPRESSION_ERROR, str(e)) from e
        decoded = [(n.decode("latin-1"), v.decode("latin-1")) for n, v in fields]
        with self._cv:
            stream = self._streams.get(sid)
            new = stream is None and not self.client and sid % 2 == 1 \
                and sid > self._last_peer_sid and not self._closing
            if new:
                self._last_peer_sid = sid
                stream = Stream(sid, None, self._peer_initial_window, self.local_window)
                self._streams[sid] = stream
            elif stream is None or stream.remote_closed:
                return  # a stream this side already reset or finished
            if end_stream:
                stream.remote_closed = True
                if stream.local_closed:
                    self._streams.pop(sid, None)
        if new:
            stream.handler = self._on_request(self, stream, decoded, bool(end_stream))
        else:
            stream.handler.on_headers(decoded, bool(end_stream))

    def _on_rst(self, sid: int, code: int) -> None:
        with self._cv:
            stream = self._streams.get(sid)
            if stream is None:
                return
            self._drop(stream, code)
        stream.handler.on_reset(code)

    def _on_settings(self, flags: int, payload: bytes) -> None:
        if flags & ACK:
            return
        if len(payload) % 6:
            raise _ProtocolError(FRAME_SIZE_ERROR, "SETTINGS of the wrong size")
        with self._cv:
            for off in range(0, len(payload), 6):
                key, value = struct.unpack(">HI", payload[off:off + 6])
                if key == INITIAL_WINDOW_SIZE:
                    if value > MAX_WINDOW:
                        raise _ProtocolError(FLOW_CONTROL_ERROR, "initial window too large")
                    delta = value - self._peer_initial_window
                    self._peer_initial_window = value
                    for s in self._streams.values():
                        s.send_window += delta
                elif key == MAX_FRAME_SIZE:
                    if not DEFAULT_MAX_FRAME <= value < 1 << 24:
                        raise _ProtocolError(PROTOCOL_ERROR, f"max frame size {value}")
                    self._peer_max_frame = value
                elif key == HEADER_TABLE_SIZE:
                    if value != self._peer_table_size:
                        self._peer_table_size = value
                        self._encoder.table_size_changed()
                elif key == MAX_CONCURRENT_STREAMS:
                    self._peer_max_streams = value
                elif key == ENABLE_PUSH and value > 1:
                    raise _ProtocolError(PROTOCOL_ERROR, "ENABLE_PUSH above 1")
            self._enqueue(frame(SETTINGS, ACK, 0), control=True)
        self.ready.set()

    def _on_goaway(self, payload: bytes) -> None:
        last_sid = struct.unpack(">I", payload[:4])[0] & MAX_WINDOW if len(payload) >= 4 else 0
        with self._cv:
            self._goaway = True
            refused = [s for sid, s in self._streams.items()
                       if (sid % 2 == 1) == self.client and sid > last_sid]
            for s in refused:
                self._drop(s, REFUSED_STREAM)
        for s in refused:
            s.handler.on_reset(REFUSED_STREAM)

    def _on_window_update(self, sid: int, payload: bytes) -> None:
        if len(payload) != 4:
            raise _ProtocolError(FRAME_SIZE_ERROR, "WINDOW_UPDATE of the wrong size")
        inc = struct.unpack(">I", payload)[0] & MAX_WINDOW
        with self._cv:
            if sid == 0:
                if inc == 0 or self._send_window + inc > MAX_WINDOW:
                    raise _ProtocolError(FLOW_CONTROL_ERROR, "bad connection window update")
                self._send_window += inc
            else:
                stream = self._streams.get(sid)
                if stream is None:
                    return
                if inc == 0 or stream.send_window + inc > MAX_WINDOW:
                    self._enqueue(frame(RST_STREAM, 0, sid, struct.pack(">I", FLOW_CONTROL_ERROR)))
                    self._drop(stream, FLOW_CONTROL_ERROR)
                    handler = stream.handler
                else:
                    stream.send_window += inc
                    handler = None
            self._cv.notify_all()
        if sid and handler is not None:
            handler.on_reset(FLOW_CONTROL_ERROR)
