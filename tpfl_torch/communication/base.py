"""Shared transport machinery — a copy of :mod:`tpfl.communication.base`,
with its chaos hooks (``_fault_injector``, ``_dispatch_send``,
``_transport_send_corrupted``; see :mod:`tpfl_torch.communication.faults`).

The reference's in-memory protocol is an admitted copy-paste of its gRPC
twin (``memory_communication_protocol.py:35-37``). Here the common 90% —
command dispatch, dedup, TTL re-flood, neighbor lifecycle, gossiper +
heartbeater wiring, message building — lives in
:class:`ThreadedCommunicationProtocol`; a transport only implements how
to dial a peer and how to push one message down the wire.
"""

from __future__ import annotations

import random
import threading
import time
import zlib
from abc import abstractmethod
from typing import Any, Optional

from tpfl_torch.communication.gossiper import Gossiper
from tpfl_torch.communication.heartbeater import HEARTBEAT_CMD, Heartbeater
from tpfl_torch.communication.message import Message
from tpfl_torch.communication.neighbors import Neighbors
from tpfl_torch.communication.protocol import CommandHandler, CommunicationProtocol
from tpfl_torch.communication.resilience import CircuitBreaker, backoff_delay
from tpfl_torch.exceptions import (
    ChunkIntegrityError,
    CommunicationError,
    NeighborNotConnectedError,
)
from tpfl_torch.management import tracing
from tpfl_torch.management.logger import logger
from tpfl_torch.settings import Settings

DISCONNECT_CMD = "_disconnect"


class ThreadedCommunicationProtocol(CommunicationProtocol):
    """Template transport: gossiper + heartbeater threads over a peer
    table, with subclass hooks for the actual wire."""

    # Transport capability: True when sender and receiver share an
    # address space and model payloads may travel BY REFERENCE
    # (InprocModelRef) instead of as encoded bytes. Only the in-memory
    # transport sets it; combined with Settings.INPROC_ZERO_COPY it
    # turns every weights hop into a pointer handoff.
    ZERO_COPY_INPROC: bool = False

    def __init__(self, addr: str) -> None:
        self._addr = addr
        self._started = False
        self._terminated = threading.Event()
        self._commands: dict[str, CommandHandler] = {}
        self._neighbors = Neighbors(
            addr,
            connect_fn=self._dial_and_handshake,
            disconnect_fn=self._send_disconnect,
            close_fn=self._close_conn,
        )
        # Send-health: retry jitter RNG (seeded per node), per-neighbor
        # circuit breaker, and an optional chaos-test fault injector
        # (None in production — see communication.faults).
        self._breaker = CircuitBreaker(addr)
        self._retry_rng = random.Random(
            (Settings.SEED or 0) ^ zlib.crc32(addr.encode())
        )
        self._fault_injector: Any = None
        self._gossiper = Gossiper(
            addr,
            self._gossip_send,
            self._neighbors.get_all,
            # Suspect peers don't eat flood budget; half-open probes
            # re-admit them.
            link_ok_fn=lambda nei: not self._breaker.is_open(nei),
        )
        self._heartbeater = Heartbeater(
            addr,
            self._neighbors,
            self.broadcast,
            self.build_msg,
            probe_fn=self._probe_suspects,
        )
        self.add_command(HEARTBEAT_CMD, self._heartbeat_handler)
        self.add_command(DISCONNECT_CMD, self._disconnect_handler)

    # --- subclass hooks ---

    @abstractmethod
    def _dial(self, addr: str) -> Any:
        """Open a transport connection to ``addr`` (no handshake)."""

    @abstractmethod
    def _handshake(self, addr: str, conn: Any) -> None:
        """Tell the peer to add us as a direct neighbor."""

    @abstractmethod
    def _transport_send(self, addr: str, conn: Any, msg: Message) -> None:
        """Push one message down an open connection."""

    def _transport_send_corrupted(self, addr: str, conn: Any, msg: Message) -> None:
        """Fault-injection hook: deliver a deliberately corrupted copy
        of ``msg`` and raise when the receiver's integrity check rejects
        it (the expected outcome). Transports with a real wire override
        this to exercise their actual checks; this default simulates the
        rejection for wire-less transports (in-memory passes objects by
        reference, so there are no bytes to flip)."""
        raise ChunkIntegrityError(
            f"fault-injected corruption to {addr} rejected (simulated)"
        )

    def _close_conn(self, conn: Any) -> None:
        """Release a transport connection (default: nothing)."""

    def _server_start(self) -> None:
        """Bind/start the receiving side (default: nothing)."""

    def _server_stop(self) -> None:
        """Stop the receiving side (default: nothing)."""

    # --- ABC surface ---

    def get_address(self) -> str:
        return self._addr

    def start(self) -> None:
        if self._started:
            raise CommunicationError(f"{self._addr} already started")
        self._server_start()
        self._terminated.clear()
        self._started = True
        self._heartbeater.start()
        self._gossiper.start()

    def stop(self) -> None:
        if not self._started:
            return
        self._heartbeater.stop()
        self._gossiper.stop()
        # Join before tearing down connections: a mid-flight broadcast
        # would otherwise race the channel closes below.
        for t in (self._heartbeater, self._gossiper):
            if t.is_alive():
                t.join(timeout=3)
        self._neighbors.clear()
        self._server_stop()
        self._started = False
        self._terminated.set()

    def wait_for_termination(self) -> None:
        self._terminated.wait()

    def add_command(self, name: str, handler: CommandHandler) -> None:
        self._commands[name] = handler

    def connect(self, addr: str, non_direct: bool = False) -> bool:
        if not self._started:
            raise CommunicationError(f"{self._addr} not started")
        if addr == self._addr:
            logger.info(self._addr, "Cannot connect to self")
            return False
        if self._neighbors.exists(addr):
            logger.info(self._addr, f"Already connected to {addr}")
            return False
        ok = self._neighbors.add(addr, non_direct=non_direct)
        if not ok:
            logger.info(self._addr, f"Cannot connect to {addr}")
        else:
            # An explicit (re)connect overrides suspicion.
            self._breaker.on_peer_alive(addr)
        return ok

    def disconnect(self, addr: str, disconnect_msg: bool = True) -> None:
        self._neighbors.remove(addr, disconnect_msg=disconnect_msg)

    def build_msg(
        self,
        cmd: str,
        args: Optional[list[str]] = None,
        round: Optional[int] = None,
        ttl: Optional[int] = None,
    ) -> Message:
        """``ttl``: override the flood depth (default Settings.TTL);
        ttl=1 means direct delivery only, no re-flood (heartbeat
        digests)."""
        return Message(
            source=self._addr,
            cmd=cmd,
            round=-1 if round is None else round,
            args=[str(a) for a in (args or [])],
            ttl=Settings.TTL if ttl is None else ttl,
        ).new_hash()

    def build_weights(
        self,
        cmd: str,
        round: int,
        serialized_model: "bytes | Any",
        contributors: Optional[list[str]] = None,
        num_samples: int = 0,
        version: int = -1,
    ) -> Message:
        """``serialized_model``: encoded payload bytes, or — on a
        zero-copy in-process transport — an ``InprocModelRef``. The
        payload's embedded trace id (if telemetry minted one at encode
        time) is mirrored onto the transport envelope so hop spans can
        tag without re-parsing payload bytes downstream. ``version``:
        the model-version ordinal an async contribution trained FROM
        (-1 = untagged; see Message.version)."""
        trace = (
            tracing.payload_trace_id(serialized_model)
            if Settings.TELEMETRY_ENABLED
            else ""
        )
        return Message(
            source=self._addr,
            cmd=cmd,
            round=round,
            payload=serialized_model,
            contributors=list(contributors or []),
            num_samples=num_samples,
            trace=trace,
            version=version,
        )

    def model_payload(self, model: Any, delta_base: Optional[tuple] = None) -> Any:
        """Encode ``model`` for THIS transport — the one sanctioned
        payload-producing seam for the weight-gossip paths.

        On a zero-copy in-process transport (``ZERO_COPY_INPROC`` +
        ``Settings.INPROC_ZERO_COPY``) this skips serialization
        entirely and hands the parameter pytree across by reference
        (``TpflModel.as_ref``: frozen leaves, copied metadata —
        receivers cannot mutate the sender). Everything else gets the
        normal codec-registry encode (``encode_parameters``), byte-
        identical to pre-zero-copy behavior. ``delta_base`` requests a
        residual payload and is ignored on the by-reference path (a ref
        is already exact and costs nothing)."""
        # Trace minting happens HERE — the first encode of a payload is
        # where its identity is born; every later hop (relays forward
        # the bytes verbatim) carries the same id.
        tid = tracing.mint(self._addr) if Settings.TELEMETRY_ENABLED else None
        with tracing.maybe_span(
            "encode", self._addr, trace=tid or "",
            byref=bool(self.ZERO_COPY_INPROC and Settings.INPROC_ZERO_COPY),
        ) as span:
            if self.ZERO_COPY_INPROC and Settings.INPROC_ZERO_COPY:
                return model.as_ref(trace=tid or "")
            if delta_base is not None:
                payload = model.encode_parameters(
                    delta_base=delta_base, trace_id=tid
                )
            else:
                payload = model.encode_parameters(trace_id=tid)
            span.set(bytes=len(payload))
            logger.metrics.counter(
                "tpfl_payload_bytes_total", float(len(payload)),
                labels={"node": self._addr},
            )
            return payload

    def send(
        self,
        nei: str,
        msg: Message,
        create_connection: bool = False,
        raise_error: bool = False,
    ) -> None:
        if self._breaker.is_open(nei):
            # Suspect peer (evicted after BREAKER_THRESHOLD consecutive
            # failed sends): don't burn send budget; the half-open probe
            # — or an incoming beat — re-admits it.
            if raise_error:
                raise NeighborNotConnectedError(f"{nei} circuit open (suspect)")
            logger.debug(self._addr, f"Not sending to suspect {nei} (circuit open)")
            return
        entry = self._neighbors.get(nei)
        conn = entry.conn if entry is not None else None
        ephemeral = False
        if entry is not None and conn is None and entry.direct:
            # Direct neighbor learned via server-side handshake (no
            # back-channel yet): dial lazily and cache. The per-entry
            # lock avoids duplicate concurrent dials (gossiper +
            # heartbeater); install_conn arbitrates under the table
            # lock so a racing donation/removal can't leak a channel.
            try:
                with entry.dial_lock:
                    conn = self._neighbors.get_conn(nei)
                    if conn is None:
                        conn = self._neighbors.install_conn(nei, self._dial(nei))
            except Exception as e:
                if raise_error:
                    raise NeighborNotConnectedError(f"{nei} unreachable: {e}")
                logger.debug(self._addr, f"Dial {nei} failed: {e}")
                return
            if conn is None:
                # Peer was removed while we dialed; the channel is closed.
                if raise_error:
                    raise NeighborNotConnectedError(f"{nei} was removed")
                return
        if entry is None or (conn is None and not entry.direct):
            if not create_connection:
                if raise_error:
                    raise NeighborNotConnectedError(f"{nei} is not a neighbor")
                logger.debug(self._addr, f"Not sending to non-neighbor {nei}")
                return
            try:
                conn = self._dial(nei)
                ephemeral = True
            except Exception as e:
                if raise_error:
                    raise NeighborNotConnectedError(f"{nei} unreachable: {e}")
                logger.debug(self._addr, f"Dial {nei} failed: {e}")
                return
        try:
            msg.via = self._addr  # mark the hop (flood skip-back)
            with tracing.maybe_span(
                "send", self._addr, trace=msg.trace, peer=nei, cmd=msg.cmd,
            ) as span:
                attempts = self._send_with_retry(nei, conn, msg)
                span.set(attempts=attempts, ok=True)
        except Exception as e:
            # Unlike the reference's on-first-error eviction
            # (grpc_client.py:176-183), a failed send only counts
            # against the breaker; eviction happens when
            # BREAKER_THRESHOLD consecutive sends (each already
            # retried) have failed — one lost packet is not a death.
            opened = self._breaker.record_failure(
                nei, attempts=max(1, int(Settings.RETRY_MAX_ATTEMPTS))
            )
            if opened:
                self._neighbors.remove(nei)
                logger.warning(
                    self._addr,
                    f"Circuit to {nei} opened after "
                    f"{Settings.BREAKER_THRESHOLD} consecutive send "
                    f"failures; evicted (last error: {e})",
                )
            if raise_error:
                raise CommunicationError(f"Send to {nei} failed: {e}")
            logger.debug(self._addr, f"Send to {nei} failed: {e}")
        else:
            self._breaker.record_success(nei, attempts=attempts)
        finally:
            if ephemeral:
                self._close_conn(conn)

    def _send_with_retry(self, nei: str, conn: Any, msg: Message) -> int:
        """Run ``_dispatch_send`` with exponential backoff + jitter
        (Settings.RETRY_*). Returns the attempts used; re-raises the
        last error once the budget is exhausted. Retried deliveries are
        safe: control messages dedup by hash at the receiver, weight
        payloads by round/contributor bookkeeping."""
        attempts = max(1, int(Settings.RETRY_MAX_ATTEMPTS))
        for attempt in range(attempts):
            try:
                self._dispatch_send(nei, conn, msg)
                return attempt + 1
            except Exception as e:
                if attempt + 1 >= attempts:
                    raise
                delay = backoff_delay(attempt, self._retry_rng)
                tracing.event(
                    "retry", self._addr, trace=msg.trace, peer=nei,
                    cmd=msg.cmd, attempt=attempt + 1, delay=round(delay, 4),
                )
                logger.debug(
                    self._addr,
                    f"Send to {nei} failed ({e}); retry "
                    f"{attempt + 1}/{attempts - 1} in {delay:.3f}s",
                )
                time.sleep(delay)
        return attempts  # unreachable; keeps type-checkers honest

    def _dispatch_send(self, nei: str, conn: Any, msg: Message) -> None:
        """One transport attempt, routed through the fault injector when
        one is attached (chaos tests/bench; None in production)."""
        fi = self._fault_injector
        if fi is None:
            self._transport_send(nei, conn, msg)
            return
        decision = fi.decide(self._addr, nei)
        if decision.action == "block":
            raise CommunicationError(f"fault: link {self._addr}->{nei} is down")
        if decision.action == "drop":
            raise CommunicationError(f"fault: dropped {self._addr}->{nei}")
        if decision.action == "corrupt":
            try:
                self._transport_send_corrupted(nei, conn, msg)
            except Exception:
                fi.count(self._addr, nei, "corrupt_rejected")
                raise
            # The receiver ACCEPTED corrupted bytes — an integrity hole
            # the chaos tests assert never happens.
            fi.count(self._addr, nei, "corrupt_accepted")
            return
        if decision.delay > 0:
            time.sleep(decision.delay)
        for _ in range(decision.copies):
            self._transport_send(nei, conn, msg)
        fi.count(self._addr, nei, "delivered", decision.copies)

    def broadcast(self, msg: Message, node_list: Optional[list[str]] = None) -> None:
        targets = node_list or list(self._neighbors.get_all(only_direct=True))
        for nei in targets:
            self.send(nei, msg)

    def get_neighbors(self, only_direct: bool = False) -> dict[str, Any]:
        return dict(self._neighbors.get_all(only_direct))

    def gossip_weights(
        self,
        early_stopping_fn,
        get_candidates_fn,
        status_fn,
        model_fn,
        period: Optional[float] = None,
        create_connection: bool = False,
        exit_on_static: Optional[int] = None,
    ) -> None:
        self._gossiper.gossip_weights(
            early_stopping_fn,
            # Suspect (open-circuit) peers are not worth a model encode
            # + push; they rejoin the candidate pool when a probe or
            # beat re-admits them.
            lambda: [
                c for c in get_candidates_fn() if not self._breaker.is_open(c)
            ],
            status_fn,
            model_fn,
            period=period,
            send_fn=lambda nei, msg: self.send(
                nei, msg, create_connection=create_connection
            ),
            exit_on_static=exit_on_static,
        )

    # --- internals shared by all transports ---

    def _dial_and_handshake(self, addr: str) -> Any:
        # Chaos: a blocked link (crashed/partitioned peer) must fail
        # the dial too, or the half-open probe would "successfully"
        # handshake an injector-crashed peer (the in-memory transport
        # dials via a registry lookup, not the wire) and the breaker
        # would flap evict -> re-admit -> evict for as long as the
        # fault lasts.
        fi = self._fault_injector
        if fi is not None and fi.link_blocked(self._addr, addr):
            raise CommunicationError(
                f"fault: link {self._addr}->{addr} is down"
            )
        conn = self._dial(addr)
        self._handshake(addr, conn)
        return conn

    def _send_disconnect(self, addr: str, conn: Any) -> None:
        """Notify a peer we are leaving. ``conn`` (if any) is closed by
        the caller (Neighbors.remove close hook); an ephemeral dial is
        closed here."""
        ephemeral = conn is None
        try:
            if conn is None:
                conn = self._dial(addr)
            self._transport_send(
                addr, conn, Message(source=self._addr, cmd=DISCONNECT_CMD).new_hash()
            )
        except Exception:
            pass
        finally:
            if ephemeral:
                self._close_conn(conn)

    def _disconnect_handler(self, source: str, **kwargs: Any) -> None:
        self._neighbors.remove(source, disconnect_msg=False)

    def _heartbeat_handler(self, source: str, args: list[str], **kwargs: Any) -> None:
        # A beat is positive liveness evidence: close the source's
        # circuit if it was suspect (a restarted peer that handshook us
        # starts beating within one HEARTBEAT_PERIOD).
        self._breaker.on_peer_alive(source)
        self._heartbeater.beat(source, args)

    def _gossip_send(self, nei: str, msg: Message) -> None:
        self.send(nei, msg)

    def _probe_suspects(self) -> None:
        """Half-open reconnect probes (heartbeater cadence): re-dial
        each suspect peer at most once per BREAKER_PROBE_PERIOD; a
        successful handshake re-admits it and closes the circuit."""
        for addr in self._breaker.probe_due():
            logger.info(self._addr, f"Half-open probe: re-dialing {addr}")
            try:
                ok = self._neighbors.add(addr, non_direct=False)
            except Exception:
                ok = False
            if ok:
                self._breaker.on_peer_alive(addr)
                logger.info(
                    self._addr, f"{addr} re-admitted (probe handshake succeeded)"
                )

    def get_transport_stats(self) -> dict[str, dict[str, Any]]:
        """Per-neighbor send health: sends_ok / sends_failed / retries /
        breaker_state / breaker_opens (also mirrored into
        ``logger.transport_metrics``)."""
        return self._breaker.snapshot()

    def handle_message(self, msg: Message) -> None:
        """Server receive path (reference grpc_server.py:161-215): dedup,
        dispatch, TTL re-flood."""
        if not self._started:
            return
        if self._fault_injector is not None and self._fault_injector.is_down(
            self._addr
        ):
            return  # chaos: a crashed node hears nothing
        if not msg.is_weights:
            if not self._gossiper.check_and_set_processed(msg.msg_hash):
                return
        handler = self._commands.get(msg.cmd)
        if handler is None:
            logger.error(
                self._addr, f"Unknown command {msg.cmd!r} from {msg.source}"
            )
            return
        try:
            if msg.is_weights:
                # Weights hops are the traced path: the recv span
                # brackets handler execution (decode + fold included),
                # and the payload's trace id flows to the handler so
                # its inner spans join the same timeline.
                with tracing.maybe_span(
                    "recv", self._addr, trace=msg.trace,
                    peer=msg.source, cmd=msg.cmd,
                ):
                    handler(
                        source=msg.source,
                        round=msg.round,
                        weights=msg.payload,
                        contributors=msg.contributors,
                        num_samples=msg.num_samples,
                        trace=msg.trace,
                        version=msg.version,
                    )
            else:
                handler(source=msg.source, round=msg.round, args=msg.args)
        except Exception as e:
            logger.error(
                self._addr, f"Command {msg.cmd} from {msg.source} failed: {e}"
            )
        if not msg.is_weights and msg.ttl > 1:
            self._gossiper.add_message(
                Message(
                    source=msg.source,
                    cmd=msg.cmd,
                    round=msg.round,
                    args=msg.args,
                    ttl=msg.ttl - 1,
                    msg_hash=msg.msg_hash,
                    # Preserve the hop we received from, so the re-flood
                    # skips echoing straight back at it.
                    via=msg.via,
                ),
                # Liveness beats jump the relay queue: behind a vote
                # burst they would arrive after HEARTBEAT_TIMEOUT and
                # cause spurious evictions at scale.
                priority=(msg.cmd == HEARTBEAT_CMD),
            )
