"""What the two real-network transports share: the chunk frames of a
SendStream, the addresses, the dial deadline and the TLS contexts.

:mod:`tpfl_torch.communication.grpc_transport` (the reference's wire) and
:mod:`tpfl_torch.communication.tcp_transport` both import these from
here. :func:`chunk_frames` gives the reference's bytes
(``tpfl.communication.grpc_transport.chunk_frames``) for the same
``data``, ``chunk_size`` and ``sid``; :func:`reassemble_frames` raises
:class:`~tpfl_torch.exceptions.ChunkIntegrityError` on the same inputs;
:class:`AddressParser` parses every address form as the reference does.
"""

from __future__ import annotations

import itertools
import os
import socket
import ssl
import stat
import threading
import zlib
from typing import Any, Iterable, Iterator, Optional

from tpfl_torch.exceptions import ChunkIntegrityError
from tpfl_torch.learning import _msgpack
from tpfl_torch.settings import Settings

_stream_counter = itertools.count()
_stream_counter_lock = threading.Lock()


def _next_stream_id() -> int:
    with _stream_counter_lock:
        return next(_stream_counter)


def chunk_frames(data: bytes, chunk_size: int, sid: Optional[int] = None) -> Iterator[bytes]:
    """Split one wire message into CRC-tagged stream frames:
    ``{"sid", "seq", "n", "crc", "b"}`` (the reference's bytes)."""
    if sid is None:
        sid = _next_stream_id()
    n = max(1, -(-len(data) // chunk_size))
    for seq in range(n):
        piece = data[seq * chunk_size: (seq + 1) * chunk_size]
        yield _msgpack.packb(
            {"sid": sid, "seq": seq, "n": n, "crc": zlib.crc32(piece), "b": piece}
        )


def reassemble_frames(frames: Iterable[bytes]) -> bytes:
    """Validate and join a chunk stream: per-chunk CRC, in-order
    sequence, constant stream id, and a complete count — anything else
    raises :class:`ChunkIntegrityError` (the whole stream is dropped;
    gossip re-pushes)."""
    chunks: list[bytes] = []
    sid: Optional[int] = None
    total: Optional[int] = None
    for raw in frames:
        try:
            frame = _msgpack.unpackb(raw)
            f_sid, f_seq = frame["sid"], int(frame["seq"])
            f_n, f_crc, piece = int(frame["n"]), frame["crc"], frame["b"]
        except Exception as e:
            raise ChunkIntegrityError(f"Malformed chunk frame: {e}") from e
        if sid is None:
            sid, total = f_sid, f_n
        if f_sid != sid or f_n != total:
            raise ChunkIntegrityError("Stream id/total changed mid-stream")
        if f_seq != len(chunks):
            raise ChunkIntegrityError(f"Chunk gap: expected seq {len(chunks)}, got {f_seq}")
        if zlib.crc32(piece) != f_crc:
            raise ChunkIntegrityError(f"Chunk {f_seq} CRC mismatch")
        chunks.append(piece)
    if total is None or len(chunks) != total:
        raise ChunkIntegrityError(f"Truncated stream: {len(chunks)}/{total} chunks")
    return b"".join(chunks)


class AddressParser:
    """IPv4 / IPv6 / unix-socket / random-port handling (the reference's
    ``AddressParser``)."""

    def __init__(self, addr: Optional[str] = None) -> None:
        addr = addr or "127.0.0.1"
        self.is_unix = addr.startswith("unix:")
        if self.is_unix:
            self.address = addr
            return
        if addr.startswith("[") and "]" in addr:  # [ipv6]:port
            host, _, port = addr.rpartition(":")
            self.host, self.port = host, self._port(port)
        elif addr.count(":") == 1:  # ipv4:port
            host, port = addr.split(":")
            self.host, self.port = host, self._port(port)
        elif ":" in addr:  # bare ipv6
            self.host, self.port = f"[{addr}]", self._random_port()
        else:  # bare host
            self.host, self.port = addr, self._random_port()
        self.address = f"{self.host}:{self.port}"

    @staticmethod
    def _port(p: str) -> int:
        port = int(p)
        if not 0 < port < 65536:
            raise ValueError(f"Invalid port {port}")
        return port

    @staticmethod
    def _random_port() -> int:
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            s.bind(("", 0))
            return s.getsockname()[1]


def endpoint(addr: str) -> tuple[int, Any, str]:
    """(address family, ``connect`` / ``bind`` argument, TLS server name)
    of a parsed address."""
    parsed = AddressParser(addr)
    if parsed.is_unix:
        return socket.AF_UNIX, addr[len("unix:"):], "localhost"
    host = parsed.host.strip("[]")
    family = socket.AF_INET6 if ":" in host else socket.AF_INET
    return family, (host, parsed.port), host


def dial_timeout() -> float:
    return max(Settings.GRPC_TIMEOUT * 4, 2.0)


def server_context(alpn: Optional[list[str]] = None) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(Settings.SERVER_CRT, Settings.SERVER_KEY)
    ctx.load_verify_locations(Settings.CA_CRT)
    ctx.verify_mode = ssl.CERT_REQUIRED  # the mutual part of mTLS
    if alpn:
        ctx.set_alpn_protocols(alpn)
    return ctx


def client_context(alpn: Optional[list[str]] = None) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)  # CERT_REQUIRED, hostname checked
    ctx.load_verify_locations(Settings.CA_CRT)
    ctx.load_cert_chain(Settings.CLIENT_CRT, Settings.CLIENT_KEY)
    if alpn:
        ctx.set_alpn_protocols(alpn)
    return ctx


def unlink_socket(path: str) -> None:
    try:
        if stat.S_ISSOCK(os.stat(path).st_mode):
            os.unlink(path)
    except FileNotFoundError:
        pass
