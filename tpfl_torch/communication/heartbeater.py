"""Heartbeater — liveness + membership via age-stamped digests, a copy of
:mod:`tpfl.communication.heartbeater`.

Reference behavior (``communication/protocols/heartbeater.py:33-113``):
broadcast a ``beat`` every HEARTBEAT_PERIOD, TTL-flood it so non-direct
peers are discovered passively, evict peers silent for
HEARTBEAT_TIMEOUT. Flooding every beat costs O(N²) deliveries per
period network-wide — enough to collapse a 500-node in-process
federation (tens of thousands of spurious evictions before convergence).

tpfl redesign: beats go to DIRECT neighbors only (ttl=1, no re-flood)
and carry a digest of every peer this node knows with the AGE (seconds
since last heard) of each. Receivers merge: ``last_seen = now - age``,
monotonically (see ``Neighbors.refresh_or_add``). Liveness and full-view
discovery still propagate transitively — in O(diameter) periods — but
the per-period cost drops to O(edges) messages of O(N) size instead of
O(N²) deliveries. Ages are relative, so no cross-node clock sync is
assumed (transit adds sub-second optimism, far below any sane timeout).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from tpfl_torch.communication.message import Message
from tpfl_torch.communication.neighbors import Neighbors
from tpfl_torch.management.logger import logger
from tpfl_torch.settings import Settings

HEARTBEAT_CMD = "beat"


class Heartbeater(threading.Thread):
    def __init__(
        self,
        self_addr: str,
        neighbors: Neighbors,
        broadcast_fn: Callable[[Message], None],
        build_msg_fn: Callable[..., Message],
        probe_fn: Optional[Callable[[], None]] = None,
    ) -> None:
        super().__init__(daemon=True, name=f"heartbeater-{self_addr}")
        self._addr = self_addr
        self._neighbors = neighbors
        self._broadcast = broadcast_fn
        self._build_msg = build_msg_fn
        # Circuit-breaker half-open probes ride the beat cadence: one
        # liveness thread per node, not two (at 500 in-process nodes a
        # second timer thread each is a real GIL tax).
        self._probe = probe_fn
        self._stop_event = threading.Event()

    def beat(self, source: str, args: list[str]) -> None:
        """Incoming beat: refresh the sender, merge its digest.

        ``args``: ``[sender_ts, addr_1, age_1, addr_2, age_2, ...]`` —
        the sender's peer table as (address, seconds-since-heard).
        Stamps are ``time.monotonic()`` — only relative AGES cross the
        wire, every absolute stamp is produced and consumed on this
        node, so the monotonic clock is both sufficient and NTP-step
        immune (and the reference's ``trace`` lint bans ``time.time()``
        outside management)."""
        now = time.monotonic()
        entries = [(source, now)]
        it = iter(args[1:])
        for addr, age in zip(it, it):
            if addr == self._addr or addr == source:
                continue
            try:
                entries.append((addr, now - float(age)))
            except ValueError:
                logger.debug(self._addr, f"Malformed digest entry {addr!r}")
        self._neighbors.merge_digest(
            entries, max_age=Settings.HEARTBEAT_TIMEOUT
        )

    def _digest(self) -> list[str]:
        now = time.monotonic()
        args = [str(now)]
        # One locked snapshot (digest_entries), not a live-entry walk:
        # last_beat is table-lock-guarded state and writers refresh it
        # concurrently with every incoming beat.
        for addr, last_beat in self._neighbors.digest_entries():
            args.append(addr)
            args.append(f"{max(0.0, now - last_beat):.3f}")
        return args

    def run(self) -> None:
        while not self._stop_event.is_set():
            try:
                # ttl=1: direct neighbors only — membership rides the
                # digest, not a flood.
                self._broadcast(
                    self._build_msg(HEARTBEAT_CMD, self._digest(), ttl=1)
                )
            except Exception as e:
                logger.debug(self._addr, f"Heartbeat broadcast failed: {e}")
            logger.metrics.counter(
                "tpfl_heartbeats_total", labels={"node": self._addr}
            )
            evicted = self._neighbors.evict_stale(Settings.HEARTBEAT_TIMEOUT)
            for a in evicted:
                logger.info(self._addr, f"Heartbeat timeout, evicted {a}")
            if evicted:
                logger.metrics.counter(
                    "tpfl_heartbeat_evictions_total", float(len(evicted)),
                    labels={"node": self._addr},
                )
            if self._probe is not None:
                try:
                    self._probe()
                except Exception as e:
                    logger.debug(self._addr, f"Suspect probe failed: {e}")
            self._stop_event.wait(Settings.HEARTBEAT_PERIOD)

    def stop(self) -> None:
        self._stop_event.set()
