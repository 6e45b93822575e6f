"""Transport resilience: retry backoff + per-neighbor circuit breaker — a
copy of :mod:`tpfl.communication.resilience` (the chaos half is
:mod:`tpfl_torch.communication.faults`).

The reference gives every unary RPC exactly one try with a fixed
timeout and evicts the peer on the first failed send
(grpc_client.py:176-183) — one lost packet looks identical to a dead
node. Here the shared send path
(:meth:`tpfl_torch.communication.base.ThreadedCommunicationProtocol.send`)
retries with exponential backoff and jitter (``Settings.RETRY_*``), and
eviction is owned by a :class:`CircuitBreaker`: a neighbor is marked
*suspect* only after ``Settings.BREAKER_THRESHOLD`` consecutive failed
sends, then evicted so it stops eating send budget, and periodically
re-probed half-open (``Settings.BREAKER_PROBE_PERIOD``, on the
heartbeater cadence) so a restarted peer is re-admitted automatically.

Per-neighbor counters (``sends_ok`` / ``sends_failed`` / ``retries`` /
``breaker_state``) are mirrored into
``logger.transport_metrics`` (:class:`~tpfl_torch.management.metric_storage.
TransportMetricStorage`) so dropped sends are observable instead of
vanishing at debug level.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Optional

from tpfl_torch.concurrency import make_lock
from tpfl_torch.management import tracing
from tpfl_torch.management.logger import logger
from tpfl_torch.settings import Settings


def backoff_delay(
    attempt: int,
    rng: random.Random,
    base: Optional[float] = None,
    max_delay: Optional[float] = None,
) -> float:
    """Sleep before retry ``attempt`` (0-based): ``base * 2**attempt``
    capped at ``max_delay``, scaled by equal jitter in [0.5, 1.5) so
    synchronized senders (a whole train set retrying the same dead
    peer) decorrelate. Deterministic under a seeded ``rng``."""
    if base is None:
        base = Settings.RETRY_BASE_DELAY
    if max_delay is None:
        max_delay = Settings.RETRY_MAX_DELAY
    d = min(max_delay, base * (2.0**attempt))
    return min(max_delay, d * (0.5 + rng.random()))


@dataclass
class _PeerHealth:
    state: str = "closed"  # "closed" | "open"
    consecutive_failures: int = 0
    sends_ok: int = 0
    sends_failed: int = 0
    retries: int = 0
    opens: int = 0
    last_probe: float = field(default_factory=time.monotonic)


class CircuitBreaker:
    """Per-neighbor send-health tracker for one node.

    closed --N consecutive failed sends--> open (suspect; caller
    evicts) --probe handshake ok / incoming beat--> closed.
    """

    def __init__(self, self_addr: str) -> None:
        self._addr = self_addr
        # guarded-by: _lock
        self._peers: dict[str, _PeerHealth] = {}
        self._lock = make_lock("CircuitBreaker._lock")

    def _peer(self, addr: str) -> _PeerHealth:
        h = self._peers.get(addr)
        if h is None:
            h = self._peers[addr] = _PeerHealth()
        return h

    # --- send-path hooks ---

    def is_open(self, addr: str) -> bool:
        with self._lock:
            h = self._peers.get(addr)
            return h is not None and h.state == "open"

    def record_success(self, addr: str, attempts: int = 1) -> None:
        with self._lock:
            h = self._peer(addr)
            h.sends_ok += 1
            h.retries += max(0, attempts - 1)
            h.consecutive_failures = 0
            reopened = h.state == "open"
            if reopened:
                h.state = "closed"
        logger.transport_metrics.record_send(self._addr, addr, True, attempts)
        if reopened:
            logger.transport_metrics.record_breaker(self._addr, addr, "closed")

    def record_failure(self, addr: str, attempts: int = 1) -> bool:
        """Count a failed (post-retry) send; returns True when this
        failure crossed the threshold and OPENED the circuit — the
        caller evicts the peer."""
        with self._lock:
            h = self._peer(addr)
            h.sends_failed += 1
            h.retries += max(0, attempts - 1)
            h.consecutive_failures += 1
            opened = (
                h.state == "closed"
                and h.consecutive_failures >= Settings.BREAKER_THRESHOLD
            )
            if opened:
                h.state = "open"
                h.opens += 1
                h.last_probe = time.monotonic()
        logger.transport_metrics.record_send(self._addr, addr, False, attempts)
        if opened:
            logger.transport_metrics.record_breaker(self._addr, addr, "open")
            # Flight-recorder event: a breaker trip is exactly the kind
            # of thing a post-mortem needs a timestamped record of.
            tracing.event("breaker_open", self._addr, peer=addr)
        return opened

    # --- liveness / probe hooks ---

    def on_peer_alive(self, addr: str) -> None:
        """Incoming traffic from the peer (a beat, a probe handshake)
        proves it back: close its circuit if open."""
        with self._lock:
            h = self._peers.get(addr)
            if h is None or (h.state == "closed" and not h.consecutive_failures):
                return
            was_open = h.state == "open"
            h.state = "closed"
            h.consecutive_failures = 0
        if was_open:
            logger.info(self._addr, f"Circuit to {addr} closed (peer alive again)")
            logger.transport_metrics.record_breaker(self._addr, addr, "closed")
            tracing.event("breaker_close", self._addr, peer=addr)

    def probe_due(self, now: Optional[float] = None) -> list[str]:
        """Open peers due a half-open reconnect probe; marks them
        probed so the next due time moves BREAKER_PROBE_PERIOD out."""
        now = time.monotonic() if now is None else now
        due: list[str] = []
        with self._lock:
            for addr, h in self._peers.items():
                if (
                    h.state == "open"
                    and now - h.last_probe >= Settings.BREAKER_PROBE_PERIOD
                ):
                    h.last_probe = now
                    due.append(addr)
        return due

    def snapshot(self) -> dict[str, dict[str, object]]:
        """Per-neighbor health: counters + breaker state."""
        with self._lock:
            return {
                addr: {
                    "breaker_state": h.state,
                    "consecutive_failures": h.consecutive_failures,
                    "sends_ok": h.sends_ok,
                    "sends_failed": h.sends_failed,
                    "retries": h.retries,
                    "breaker_opens": h.opens,
                }
                for addr, h in self._peers.items()
            }
