"""Peer table — a copy of :mod:`tpfl.communication.neighbors`.

Parity with reference ``communication/protocols/neighbors.py:73-167``:
thread-safe ``addr -> (connection, direct?, last_beat)`` map, where
direct neighbors are handshaken transports and non-direct ones are
liveness-only entries learned from gossiped heartbeats.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from tpfl_torch.concurrency import make_lock


def _make_dial_lock() -> "threading.Lock":
    return make_lock("Neighbor.dial_lock")  # type: ignore[return-value]


@dataclass
class Neighbor:
    conn: Any  # transport-specific handle (None for non-direct peers)
    direct: bool
    last_beat: float  # guarded-by Neighbors._lock (the owning table's)
    # Serializes lazy back-channel dials (base.py send path) so
    # concurrent senders don't each open-and-leak a connection.
    dial_lock: threading.Lock = field(default_factory=_make_dial_lock)


class Neighbors:
    """Thread-safe peer table shared by client/gossiper/heartbeater."""

    def __init__(
        self,
        self_addr: str,
        connect_fn: Optional[Callable[[str], Any]] = None,
        disconnect_fn: Optional[Callable[[str, Any], None]] = None,
        close_fn: Optional[Callable[[Any], None]] = None,
    ) -> None:
        self.self_addr = self_addr
        self._connect_fn = connect_fn
        self._disconnect_fn = disconnect_fn
        self._close_fn = close_fn
        # guarded-by: _lock
        self._table: dict[str, Neighbor] = {}
        self._lock = make_lock("Neighbors._lock")

    def add(
        self,
        addr: str,
        non_direct: bool = False,
        conn: Any = None,
        dial: bool = True,
        beat_time: Optional[float] = None,
    ) -> bool:
        """Add a peer; direct adds may build a transport connection via
        the protocol's connect_fn. Returns success.

        ``dial=False`` registers a direct peer *without* dialing back —
        the server-side handshake path (reference
        ``grpc_server.py:135-160`` adds the caller without a reverse
        handshake; the send path dials lazily when first needed).

        ``beat_time``: freshness timestamp for the new entry (default
        now). Digest intake passes the CARRIED observation time — a
        peer learned from a relayed digest must not be stamped fresher
        than anyone actually heard it, or an already-evicted dead peer
        resurrects and its entry ping-pongs between tables forever.
        """
        if addr == self.self_addr:
            return False
        stamp = beat_time if beat_time is not None else time.monotonic()
        with self._lock:
            existing = self._table.get(addr)
            if existing is not None:
                # Upgrade non-direct -> direct if needed.
                if existing.direct or non_direct:
                    existing.last_beat = max(existing.last_beat, stamp)
                    return True
        if not non_direct and dial and self._connect_fn is not None and conn is None:
            try:
                conn = self._connect_fn(addr)
            except Exception:
                return False
            if conn is None:
                return False
        leaked = None
        with self._lock:
            # Re-check: a concurrent add (e.g. the peer's handshake RPC
            # racing our connect) may have inserted while we dialed.
            existing = self._table.get(addr)
            if existing is not None and (existing.direct or non_direct):
                existing.last_beat = max(existing.last_beat, stamp)
                if not non_direct and existing.conn is None and conn is not None:
                    existing.conn = conn  # donate our fresh connection
                else:
                    leaked = conn  # theirs wins; release ours below
            else:
                self._table[addr] = Neighbor(
                    conn=conn, direct=not non_direct, last_beat=stamp
                )
        if leaked is not None and self._close_fn is not None:
            try:
                self._close_fn(leaked)
            except Exception:
                pass
        return True

    def remove(self, addr: str, disconnect_msg: bool = False) -> None:
        with self._lock:
            nei = self._table.pop(addr, None)
        if nei is None:
            return
        if disconnect_msg and nei.direct and self._disconnect_fn is not None:
            try:
                self._disconnect_fn(addr, nei.conn)
            except Exception:
                pass
        # Always release the transport handle: a lingering channel keeps
        # pinging a (possibly stopped) peer server.
        if nei.conn is not None and self._close_fn is not None:
            try:
                self._close_fn(nei.conn)
            except Exception:
                pass

    def refresh_or_add(self, addr: str, beat_time: Optional[float] = None) -> None:
        """Heartbeat intake (reference heartbeater.py:64-78): refresh a
        known peer or learn a non-direct one. Freshness merges
        MONOTONICALLY — a relayed digest carrying an older observation
        of a peer must never regress the freshness a direct beat
        already established."""
        if addr == self.self_addr:
            return
        t = beat_time if beat_time is not None else time.monotonic()
        with self._lock:
            nei = self._table.get(addr)
            if nei is not None:
                nei.last_beat = max(nei.last_beat, t)
                return
        self.add(addr, non_direct=True, beat_time=t)

    def merge_digest(
        self, entries: list[tuple[str, float]], max_age: Optional[float] = None
    ) -> None:
        """Batch heartbeat-digest intake: refresh every known peer under
        ONE lock acquisition (a per-entry refresh_or_add costs a lock
        round-trip each — at 500 nodes x dozens of beats/sec on a
        single-core host that alone saturates the GIL), then add the
        unknown ones as non-direct peers carrying their OBSERVED
        freshness. ``max_age``: unknown entries already older than this
        are dropped — re-learning a peer we (or anyone) evicted, with a
        fresh timestamp, would resurrect dead nodes network-wide."""
        now = time.monotonic()
        unknown: list[tuple[str, float]] = []
        with self._lock:
            for addr, beat_time in entries:
                if addr == self.self_addr:
                    continue
                nei = self._table.get(addr)
                if nei is not None:
                    nei.last_beat = max(nei.last_beat, beat_time)
                elif max_age is None or now - beat_time < max_age:
                    unknown.append((addr, beat_time))
        for addr, beat_time in unknown:
            self.add(addr, non_direct=True, beat_time=beat_time)

    def install_conn(self, addr: str, conn: Any) -> Any:
        """Install a back-channel for a direct peer under the table
        lock. Returns the entry's resulting conn — ``conn`` if it won,
        the already-present one if another thread (or the handshake
        donation path) got there first — or None if the peer has been
        removed meanwhile. Losing/orphaned connections are closed here,
        so callers cannot leak what they dialed."""
        close = None
        with self._lock:
            nei = self._table.get(addr)
            if nei is None or not nei.direct:
                close, result = conn, None
            elif nei.conn is None:
                nei.conn = conn
                result = conn
            else:
                close, result = conn, nei.conn
        if close is not None and self._close_fn is not None:
            try:
                self._close_fn(close)
            except Exception:
                pass
        return result

    def get_conn(self, addr: str) -> Any:
        with self._lock:
            nei = self._table.get(addr)
            return nei.conn if nei is not None else None

    def get(self, addr: str) -> Optional[Neighbor]:
        with self._lock:
            return self._table.get(addr)

    def exists(self, addr: str) -> bool:
        with self._lock:
            return addr in self._table

    def get_all(self, only_direct: bool = False) -> dict[str, Neighbor]:
        with self._lock:
            return {
                a: n
                for a, n in self._table.items()
                if n.direct or not only_direct
            }

    def digest_entries(self) -> list[tuple[str, float]]:
        """``(addr, last_beat)`` snapshot for the heartbeat digest,
        taken under ONE lock acquisition. The heartbeater previously
        read ``nei.last_beat`` off live entries returned by
        :meth:`get_all` — outside the table lock, racing the writers
        that refresh freshness (the guarded-by lint's canonical bare-
        iteration finding)."""
        with self._lock:
            return [(a, n.last_beat) for a, n in self._table.items()]

    def evict_stale(self, timeout: float) -> list[str]:
        """Drop peers not heard from within ``timeout`` (reference
        heartbeater.py:93-103). Returns evicted DIRECT addresses (the
        ones worth logging/acting on).

        Non-direct entries are liveness bookkeeping only (no transport
        connection): they expire in BULK under the table lock — no
        per-entry remove() round-trips, no disconnect hooks, no log
        lines. At 500-node scale, digest entries hovering near the
        timeout previously churned through add→evict→log cycles whose
        logging alone starved a single-core host."""
        now = time.monotonic()
        with self._lock:
            stale_direct = [
                a
                for a, n in self._table.items()
                if n.direct and now - n.last_beat > timeout
            ]
            self._table = {
                a: n
                for a, n in self._table.items()
                if n.direct or now - n.last_beat <= timeout
            }
        for a in stale_direct:
            self.remove(a)
        return stale_direct

    def clear(self) -> None:
        with self._lock:
            addrs = list(self._table)
        for a in addrs:
            self.remove(a, disconnect_msg=True)
