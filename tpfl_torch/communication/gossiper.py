"""Gossiper — async control-message flooding + synchronous model gossip, a
copy of :mod:`tpfl.communication.gossiper`.

Parity with reference ``communication/protocols/gossiper.py:31-239``:

- dedup ring buffer ``check_and_set_processed``          (:103-122)
- async fan-out thread respecting GOSSIP_MESSAGES_PER_PERIOD (:124-157)
- synchronous ``gossip_weights`` loop: early-stop → candidates →
  static-status termination → random peer sample → model_fn → send
  (:163-239)

Difference from the p2pfl reference: peer sampling is seeded from (Settings.SEED,
node addr) so simulated federations are reproducible — the reference
uses bare ``random.sample`` (gossiper.py:226), which defeats the fork's
own determinism goal.
"""

from __future__ import annotations

import random
import threading
import time
import zlib
from collections import deque
from typing import Any, Callable, Optional

from tpfl_torch.communication.message import Message
from tpfl_torch.concurrency import make_lock
from tpfl_torch.management.logger import logger
from tpfl_torch.settings import Settings


class Gossiper(threading.Thread):
    """Owns the pending-message queue and the dedup ring buffer."""

    def __init__(
        self,
        self_addr: str,
        send_fn: Callable[[str, Message], None],
        get_neighbors_fn: Callable[[bool], dict[str, Any]],
        link_ok_fn: Optional[Callable[[str], bool]] = None,
    ) -> None:
        super().__init__(daemon=True, name=f"gossiper-{self_addr}")
        self._addr = self_addr
        self._send = send_fn
        self._get_neighbors = get_neighbors_fn
        # Send-health filter (circuit breaker): a suspect peer must not
        # eat per-period flood budget — at a relay hub one dead
        # neighbor otherwise costs a (possibly retried) failed send for
        # EVERY forwarded message until eviction.
        self._link_ok = link_ok_fn or (lambda nei: True)
        # guarded-by: _pending_lock
        self._pending: deque[Message] = deque()
        # guarded-by: _pending_lock
        self._priority: deque[Message] = deque()
        self._pending_lock = make_lock("Gossiper._pending_lock")
        # FIFO eviction ring + set: membership must be O(1) — a plain
        # deque scan is O(AMOUNT_LAST_MESSAGES_SAVED) per message and
        # melts the relay hub of a star topology at scale (every vote /
        # status broadcast crosses it twice).
        # guarded-by: _processed_lock
        self._processed_ring: deque[str] = deque()
        # guarded-by: _processed_lock
        self._processed_set: set[str] = set()
        self._processed_lock = make_lock("Gossiper._processed_lock")
        self._stop_event = threading.Event()
        self._wake = threading.Event()
        seed = (Settings.SEED or 0) + zlib.crc32(self_addr.encode())
        self._rng = random.Random(seed)

    # --- dedup (reference gossiper.py:103-122) ---

    def check_and_set_processed(self, msg_hash: str) -> bool:
        """True if unseen (and marks it seen)."""
        if not msg_hash:
            return True
        with self._processed_lock:
            if msg_hash in self._processed_set:
                return False
            self._processed_set.add(msg_hash)
            self._processed_ring.append(msg_hash)
            while len(self._processed_ring) > Settings.AMOUNT_LAST_MESSAGES_SAVED:
                self._processed_set.discard(self._processed_ring.popleft())
            return True

    # --- async message flood (reference gossiper.py:124-157) ---

    def add_message(self, msg: Message, priority: bool = False) -> None:
        """Queue for re-flood. ``priority`` classes the message as
        liveness traffic (heartbeats): it must not sit behind a vote /
        status burst at a relay hub, or peers evict each other while the
        queue drains. Two FIFO classes — priority drains first each
        period, but when BOTH queues are non-empty priority is capped at
        half the per-period budget, so a relayed-heartbeat flood at a
        large-N hub cannot starve votes/status indefinitely either."""
        with self._pending_lock:
            (self._priority if priority else self._pending).append(msg)
        self._wake.set()

    def run(self) -> None:
        while not self._stop_event.is_set():
            batch: list[Message] = []
            with self._pending_lock:
                budget = Settings.GOSSIP_MESSAGES_PER_PERIOD
                # Reserve half the budget for the normal class whenever
                # it has traffic waiting (see add_message).
                prio_budget = (
                    budget if not self._pending else max(1, budget // 2)
                )
                for _ in range(min(len(self._priority), prio_budget)):
                    batch.append(self._priority.popleft())
                for _ in range(
                    min(len(self._pending), budget - len(batch))
                ):
                    batch.append(self._pending.popleft())
            if batch:
                # One snapshot per batch: get_neighbors copies the table,
                # and a relay hub forwards thousands of messages per
                # round — per-message copies dominate otherwise.
                # Suspect (open-circuit) peers are filtered out here,
                # not per send: same snapshot economics.
                neighbors = [
                    n for n in self._get_neighbors(True) if self._link_ok(n)
                ]
                # Flood-pressure observability: how deep the relay
                # backlog ran when this batch was cut (a hub whose
                # pending gauge grows round-over-round is saturating).
                with self._pending_lock:
                    backlog = len(self._pending) + len(self._priority)
                logger.metrics.gauge(
                    "tpfl_gossip_pending", float(backlog),
                    labels={"node": self._addr},
                )
                logger.metrics.counter(
                    "tpfl_gossip_flooded_total", float(len(batch)),
                    labels={"node": self._addr},
                )
            for msg in batch:
                # Capture before sending: the transport overwrites
                # msg.via with our own address at dispatch time.
                # Skipping the originator AND the hop that delivered it
                # to us — in a star topology the echo back to the hub is
                # half of all flood traffic.
                skip = {msg.source, msg.via}
                for nei in neighbors:
                    if nei not in skip:
                        try:
                            self._send(nei, msg)
                        except Exception as e:
                            logger.debug(
                                self._addr, f"Gossip to {nei} failed: {e}"
                            )
            # Settings read at use-time so tests can zero the period.
            period = Settings.GOSSIP_PERIOD
            if period > 0:
                self._stop_event.wait(period)
            elif not batch:
                # Event-driven idle: sleep until add_message signals (or
                # a 200 ms safety tick). Hundreds of idle gossiper
                # threads polling at 1 ms saturate the GIL by
                # themselves at 500-node scale.
                self._wake.clear()
                with self._pending_lock:
                    empty = not self._pending and not self._priority
                if empty and not self._stop_event.is_set():
                    self._wake.wait(0.2)

    def stop(self) -> None:
        self._stop_event.set()
        self._wake.set()  # break out of an idle wait immediately

    # --- synchronous model gossip (reference gossiper.py:163-239) ---

    def gossip_weights(
        self,
        early_stopping_fn: Callable[[], bool],
        get_candidates_fn: Callable[[], list[str]],
        status_fn: Callable[[], Any],
        model_fn: Callable[[str], Optional[Message]],
        period: Optional[float] = None,
        send_fn: Optional[Callable[[str, Message], None]] = None,
        exit_on_static: Optional[int] = None,
    ) -> None:
        """Push models to sampled peers until convergence or early stop.

        Termination conditions (reference order): ``early_stopping_fn``
        true; no candidates; status unchanged for ``exit_on_static``
        iterations (None = Settings.GOSSIP_EXIT_ON_X_EQUAL_ROUNDS;
        0 = never — callers whose peers have no OTHER supplier, like the
        init-weights diffusion on a tree topology, must keep pushing
        until the candidate set itself empties, or late joiners strand).
        """
        if period is None:
            period = Settings.GOSSIP_MODELS_PERIOD
        if exit_on_static is None:
            exit_on_static = Settings.GOSSIP_EXIT_ON_X_EQUAL_ROUNDS
        send = send_fn or self._send
        # maxlen=None (exit_on_static=0) never satisfies the static-exit
        # check below: len(deque) == None is always False.
        last_statuses: deque[Any] = deque(
            maxlen=exit_on_static if exit_on_static > 0 else None
        )
        while True:
            if early_stopping_fn():
                return
            candidates = get_candidates_fn()
            if not candidates:
                return
            status = status_fn()
            last_statuses.append(status)
            if (
                len(last_statuses) == last_statuses.maxlen
                and all(s == last_statuses[0] for s in last_statuses)
            ):
                logger.info(
                    self._addr,
                    f"Gossip exit: status static for {last_statuses.maxlen} rounds",
                )
                return
            n = min(Settings.GOSSIP_MODELS_PER_ROUND, len(candidates))
            for nei in self._rng.sample(candidates, n):
                msg = model_fn(nei)
                if msg is None:
                    continue
                try:
                    send(nei, msg)
                except Exception as e:
                    logger.debug(self._addr, f"Model gossip to {nei} failed: {e}")
            time.sleep(period)
